"""The eikonal batch preparation's wrapper and its engine path on the CPU
(kiwi_tpu_torch.ops.eik_prepare, sources/eikonal.BatchDiscretizer).

On the CPU the wrapper runs the plain version (ops/eik_prepare.
_prepare_batch_vec) and launches nothing; its arrays are the plain
version's, cast as the kernel writes them; the rows' [B, 25] packing and
the context's tensor round trip; the summary maps to the discretizer's
static shape and to the host's ValueErrors; a zero-radius batch takes the
host's per-source loop and counts `eik.host_prepares`.  The kernel itself
is held against the plain version on the card (tests/test_torch_cuda.py).
No JAX.
"""

import numpy as np
import pytest
import torch

import eik_prepare_cases as cases
from kiwi_tpu_torch import profiling
from kiwi_tpu_torch.ops import eik_prepare
from kiwi_tpu_torch.sources import eikonal as eiksrc


def _rows(name):
    model, rows, ctx, error = cases.case(name)
    return eiksrc.named_params_batch(model, rows), ctx, error


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_cpu_dispatch_runs_the_plain_version(name):
    named, ctx, error = _rows(name)
    before = eik_prepare.launches["eik_prepare"]
    rows = eik_prepare.rows_on(named, "cpu")
    if error is not None:
        with pytest.raises(ValueError, match=error):
            eik_prepare.eik_prepare(rows, ctx, cases.EDT)
        with pytest.raises(ValueError, match=error):
            eiksrc.prepare_batch(named, cases.EDT, ctx)
        return
    summary, got = eik_prepare.eik_prepare(rows, ctx, cases.EDT)
    assert eik_prepare.launches["eik_prepare"] == before
    static, want = cases.host_prepare(name)
    assert set(got) == set(want) | {"status"}
    assert not got["status"].any()
    for k, w in want.items():
        dtype = torch.int32 if w.dtype.kind == "i" else torch.float32
        assert got[k].dtype == dtype and got[k].is_contiguous(), k
        assert torch.equal(got[k], torch.as_tensor(w, dtype=dtype)), k
    assert summary.dtype == torch.int64 and summary.shape == (eik_prepare.NSUMMARY,)
    got_static, ntmax_hard = eik_prepare.static_from_summary(summary.numpy())
    assert got_static == static
    diag = np.hypot(want["cdelta"][:, 0], want["cdelta"][:, 1])
    assert ntmax_hard == int(np.floor(4.0 * diag / np.maximum(want["minspeed"], 1.0)
                                      / cases.EDT).max()) + 2


@pytest.mark.parametrize("name", ["shallow", "oblique", "mt_eikonal"])
def test_cases_clip(name):
    """The constraints cut a good share of these ruptures (the benchmark's
    cell never clips, so the tests must)."""
    model, rows, ctx, _error = cases.case(name)
    _static, clipped = cases.host_prepare(name)
    _static, whole = eiksrc._prepare_batch_vec(*eiksrc.named_params_batch(model, rows),
                                               cases.EDT, cases.context([]))
    assert (clipped["ndims"] != whole["ndims"]).any(axis=1).mean() > 0.2


@pytest.mark.parametrize("name", ["eikonal", "mt_eikonal"])
def test_rows_round_trip(name):
    _model, rows, _ctx, _error = cases.case("mt_eikonal" if name == "mt_eikonal" else "dips")
    pv, m6s, rotmats = named = eiksrc.named_params_batch(name, rows)
    packed = eik_prepare.pack_rows(named)
    assert packed.dtype == np.float64 and packed.shape == (len(rows), eik_prepare.NROW)
    for i, k in enumerate(eik_prepare.NAMED):
        np.testing.assert_array_equal(packed[:, i], pv[k])
    np.testing.assert_array_equal(packed[:, 10:19], rotmats.reshape(-1, 9))
    np.testing.assert_array_equal(packed[:, 19:], m6s)
    back = eik_prepare.unpack_rows(packed)
    assert set(back[0]) == set(pv)
    for k in pv:
        np.testing.assert_array_equal(back[0][k], pv[k])
    np.testing.assert_array_equal(back[1], m6s)
    np.testing.assert_array_equal(back[2], rotmats)
    on = eik_prepare.rows_on(named, "cpu")
    assert on.dtype == torch.float64 and np.array_equal(on.numpy(), packed)


def _split_context(arr, sizes):
    """The context tensor's layout, as csrc/eik_prepare.cu reads it:
    (constraints [(point, normal)], depths, vs, cos, sin)."""
    ncons, nd, nv = sizes
    cons = arr[:6 * ncons].reshape(ncons, 6)
    rest = arr[6 * ncons:]
    return ([(c[:3], c[3:]) for c in cons], rest[:nd], rest[nd:nd + nv],
            rest[nd + nv:nd + nv + 180], rest[nd + nv + 180:])


@pytest.mark.parametrize("constraints", [cases.DEFAULT, cases.OBLIQUE, []])
def test_context_round_trip(constraints):
    ctx = cases.context(constraints)
    arr, sizes = eik_prepare.context_array(ctx.constraints, ctx.layer_depths, ctx.layer_vs)
    assert arr.dtype == np.float64 and sizes == (len(constraints), 5, 6)
    assert arr.size == 6 * len(constraints) + 5 + 6 + 2 * eik_prepare.NPOINTS
    cons, depths, vs, cos, sin = _split_context(arr, sizes)
    assert len(cons) == len(constraints)
    for (p, n), (wp, wn) in zip(cons, constraints):
        np.testing.assert_array_equal(p, wp)
        np.testing.assert_array_equal(n, wn)
    np.testing.assert_array_equal(depths, cases.DEPTHS)
    np.testing.assert_array_equal(vs, cases.VS)
    # the unit circle of _prepare_batch_vec
    ang = np.arange(1, 181) * 2.0 * np.pi / 180
    np.testing.assert_array_equal(cos, np.cos(ang))
    np.testing.assert_array_equal(sin, np.sin(ang))


def _summary(nd=(157, 161), nc=(9, 10), empty=0, nukl=0, overflow=0, ntmax=3):
    return np.array([*nd, *nc, empty, nukl, overflow, ntmax], np.int64)


@pytest.mark.parametrize("summary,error", [
    (_summary(empty=1), cases.EMPTY),
    (_summary(nukl=1), cases.NUKL),
    (_summary(empty=1, nukl=1), cases.EMPTY),   # as the host: the area first
    (_summary(overflow=1, empty=1), "over 180 \\+ 2 vertices"),
])
def test_summary_raises_the_host_errors(summary, error):
    with pytest.raises(ValueError, match=error):
        eik_prepare.static_from_summary(summary)


@pytest.mark.parametrize("nd,nc,ntmax,static", [
    ((157, 161), (9, 10), 3, {"NF": (160, 168), "NC": (9, 10)}),
    ((320, 320), (10, 10), 0, {"NF": (320, 320), "NC": (10, 10)}),
    ((1, 1), (1, 1), 7, {"NF": (8, 8), "NC": (1, 1)}),
])
def test_summary_gives_the_static_shape(nd, nc, ntmax, static):
    """NF: the largest fine grid padded to a multiple of 8; NC: the largest
    coarse grid; the hard bound on time cells 2 over the summary's floor."""
    assert eik_prepare.static_from_summary(_summary(nd, nc, ntmax=ntmax)) == (static, ntmax + 2)


def test_snapshot_carries_the_launch_counter():
    snap = profiling.snapshot()
    assert snap["launches.eik_prepare"] == eik_prepare.launches["eik_prepare"]


def test_discretizer_takes_the_prepared_tensors():
    """discretize_device_batch on the wrapper's tensors equals it on the
    plain version's host arrays, and copies none of the 14 arrays."""
    model, rows, ctx, _error = cases.case("shallow")
    named = eiksrc.named_params_batch(model, rows[:6])
    static, arrays = eiksrc.prepare_batch(named, cases.EDT, ctx)
    _summary, tensors = eik_prepare.eik_prepare(eik_prepare.rows_on(named, "cpu"), ctx, cases.EDT)
    copies, out = [], []
    for a in (arrays, tensors):
        before = profiling.snapshot().get("h2d_pageable", 0)
        out.append(eiksrc.discretize_device_batch(static, a, cases.EDT, ctx, nt_cell_max=2,
                                                  ncell_budget=64, device="cpu"))
        copies.append(profiling.snapshot().get("h2d_pageable", 0) - before)
    assert copies[0] - copies[1] == len(arrays) == 14
    want, got = out
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


ROWS = eik_prepare.rows_on(_rows("dips")[0], "cpu")


@pytest.mark.parametrize("rows,error", [
    (ROWS.float(), ValueError),                     # not float64
    (ROWS[:, :24], ValueError),                     # not 25 columns
    (ROWS[0], ValueError),                          # not [B, 25]
    (ROWS[:0], ValueError),                         # no rows
    (ROWS.clone().requires_grad_(), RuntimeError),  # no backward
])
def test_wrapper_refuses(rows, error):
    with pytest.raises(error):
        eik_prepare.eik_prepare(rows, cases.context(), cases.EDT)


@pytest.fixture
def engine():
    return cases.session("cpu")


def _host_prepares(fn):
    before = profiling.snapshot().get("eik.host_prepares", 0)
    out = fn()
    return profiling.snapshot().get("eik.host_prepares", 0) - before, out


def test_zero_radius_batch_takes_the_host_loop(engine):
    """A batch with a zero-radius rupture is prepared by the host's
    per-source loop (one `eik.host_prepares`); every other batch by the
    wrapper (none), here on the CPU its plain version.  The other rows'
    misfits are the same either way."""
    batch = cases.session_batch()
    n, whole = _host_prepares(lambda: engine.global_misfits_for_source_batch(batch).numpy())
    assert n == 0
    batch[1, 10] = 0.0  # the same shapes: no calibration, no cross-check
    batch[1, 11:13] = 0.0
    n, degenerate = _host_prepares(lambda: engine.global_misfits_for_source_batch(batch).numpy())
    assert n == 1
    np.testing.assert_array_equal(degenerate[[0, 2, 3]], whole[[0, 2, 3]])


def test_device_discretization_waits(engine, monkeypatch):
    """A device discretization at a calibrated shape waits for the card once,
    for the prepared batch's summary; the discretizer reads the session's
    context as a tensor and copies nothing, nor the 14 prepared arrays.
    Counted by site, as on the card (tests/test_torch_cuda.py), but for the
    plain sweep's diagonal indices, which the kernel has no copies of."""
    from kiwi_tpu_torch.ops import eik_sweep

    monkeypatch.setattr(eik_sweep, "to_device",
                        lambda x, dev, dtype=None: torch.as_tensor(x, dtype=dtype, device=dev))
    batch = cases.session_batch()
    engine.discretize(batch)
    assert cases.waits(lambda: engine.discretize(batch)) == cases.SESSION_WAITS
