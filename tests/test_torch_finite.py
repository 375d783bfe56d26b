"""The finite-source slice as a whole: kiwi_tpu_torch.engine.Engine on the
CPU against the JAX Engine on the 40x8 fullspace store and 4 `ned`
receivers of tests/test_synth_window.py, with a bilateral finite fault
(3x2 subfaults x 3 time cells = 18 centroids, groups of G = 3).

The JAX side runs its default CPU formulations (the XLA synthesis and the
vmapped per-source evaluation), so every comparison is against an
independent path.  Misfits, norms and global misfits compare at rtol 2e-5
with an absolute floor of 2e-5 of the largest value (the row at the true
source has a misfit near 0, which no relative bound can hold), floating
shifts exactly, synthetic traces at 1e-5 of their max (18 centroids summed
in another order), discretized centroids at tests/test_torch_synth.py's
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu.sources import get_source_model as jmodel
from kiwi_tpu_torch import misfit as tmf
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.ops import synth_window as tsw
from kiwi_tpu_torch.sources import get_source_model as tmodel

EDT = 0.1
FAULT = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                  2500.0, 0.2], np.float32)
STRIKES = np.array([20.0, 91.0, 150.0, 260.0], np.float32)
TAPER = ([0.0, 1.0, 6.0, 9.0], [0.0, 1.0, 1.0, 0.0])
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])
# the other device-discretized sources, each at a point of the store
SOURCES = {
    "moment_tensor": np.array([0.2, 60.0, -40.0, 400.0, 1e12, -2e12, 1e12, 3e12, 5e11,
                               -1e12, 0.3], np.float32),
    "point_lp": np.array([0.1, 60.0, -40.0, 400.0, 1e12, 0.5, -2.0, 2.0, 9.0, 0.3, -1.0,
                          1.0, 0.8], np.float32),
    "circular": np.array([0.0, 0.0, 0.0, 400.0, 1e12, 40.0, 60.0, 110.0, 200.0, 2500.0, 0.2],
                         np.float32),
}


def _close(got, want, rtol=2e-5):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def engines():
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=40, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return JEngine(store), TEngine(tstore, device="cpu")


def _configure(eng, method, processing=(), base=FAULT, source="bilateral", under=1):
    """A full session from scratch (set_receivers clears refs/tapers/filters)."""
    rec = JReceiver if isinstance(eng, JEngine) else TReceiver
    olat, olon = 30.0, 70.0
    recs = []
    for i in range(4):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), 1200.0 + 400.0 * i, 0.3 * i)
        recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(EDT)
    eng.set_local_interpolation(True)
    eng.set_spacial_undersampling(under, under)
    eng.set_source_params(source, base)
    for irec in range(4):
        if "filter" in processing:
            eng.set_misfit_filter(irec, *BAND)
        if "taper" in processing:
            eng.set_misfit_taper(irec, *TAPER)
    eng.set_misfit_method(method)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(-0.5, 0.5)


def _batch(base=FAULT, col=5, values=STRIKES):
    pb = np.tile(base, (len(values), 1))
    pb[:, col] = values
    return pb


def _both(engines, pb):
    je, te = engines
    m, n, fs = je.misfits_for_source_batch(pb)
    return (np.asarray(m), np.asarray(n), np.asarray(fs)), te.misfits_for_source_batch(pb)


def _check(want, got):
    m, n, fs = want
    _close(got[0], m)
    _close(got[1], n)
    assert got[2].shape == fs.shape
    np.testing.assert_array_equal(got[2].numpy(), fs)


@pytest.mark.parametrize("processing", [(), ("filter",), ("taper",)])
@pytest.mark.parametrize("method", ["floating_l1norm", "floating_l2norm"])
def test_finite_batch_matches(engines, monkeypatch, method, processing):
    for eng in engines:
        _configure(eng, method, processing)
    calls = {"window": 0, "scan": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tsw, "synthesize_ard_batch", spy("window", tsw.synthesize_ard_batch))
    monkeypatch.setattr(tmf, "scan_sums", spy("scan", tmf.scan_sums))
    pb = _batch()
    want, got = _both(engines, pb)
    _check(want, got)
    # the main path: the window synthesis, then the scan kernel unless filtered
    assert calls == {"window": 1, "scan": 0 if "filter" in processing else 1}
    je, te = engines
    _close(te.global_misfits_for_source_batch(pb), je.global_misfits_for_source_batch(pb))


def test_finite_sweep_matches(engines):
    """A strike sweep of a finite fault is not shared-kinematics: the port
    answers it through global_misfits_for_source_batch, as the JAX fallback."""
    je, te = engines
    for eng in engines:
        _configure(eng, "floating_l1norm")
    strikes = np.linspace(0.0, 350.0, 8).astype(np.float32)
    want = np.asarray(je.sweep_global_misfits(FAULT, 5, strikes))
    got = te.sweep_global_misfits(FAULT, 5, strikes)
    _close(got, want)
    assert int(np.argmin(got.numpy())) == int(np.argmin(want))


def test_sweep_across_grid_shapes(engines):
    """A length-a sweep (column 9) changes the fault's subfault grid: both
    engines evaluate each grid shape's rows apart and scatter them back."""
    je, te = engines
    for eng in engines:
        _configure(eng, "floating_l1norm")
    lengths = np.linspace(500.0, 1500.0, 6).astype(np.float32)
    shapes = {tmodel("bilateral").grid_shape(r, EDT) for r in _batch(col=9, values=lengths)}
    assert len(shapes) == 6, shapes  # one subfault grid per length
    want = np.asarray(je.sweep_global_misfits(FAULT, 9, lengths))
    got = te.sweep_global_misfits(FAULT, 9, lengths)
    assert got.dtype == torch.float32 and got.device == te.device
    _close(got, want)
    # a batch with mixed shapes is the caller's to bucket
    for eng in engines:
        with pytest.raises(ValueError, match="mixed grid shapes"):
            eng.misfits_for_source_batch(_batch(col=9, values=lengths))


@pytest.mark.parametrize("method", ["floating_l1norm", "l2norm"])
def test_observed_reference_matches(engines, method):
    """References installed through set_ref_seismogram (the JAX engine's
    synthetics scaled by 1.3, zero-padded, moved 2 samples earlier, seeded
    noise), receiver 1 switched off: the finite batch on both engines."""
    je, te = engines
    for eng in engines:
        _configure(eng, method)
    rng = np.random.default_rng(6)
    traces = []
    for values, itmin in je.get_synthetic_seismograms():
        v = np.pad(1.3 * values, 3)
        v = v + 0.05 * float(np.abs(values).max()) * rng.standard_normal(v.shape)
        traces.append((v.astype(np.float32), itmin - 5))
    for eng in engines:
        for irc, (v, itmin) in enumerate(traces):
            eng.set_ref_seismogram(irc // 3, "ned"[irc % 3], v, itmin)
        eng.switch_receiver(1, False)
    pb = _batch()
    want, got = _both(engines, pb)
    _check(want, got)
    _close(te.global_misfits_for_source_batch(pb), je.global_misfits_for_source_batch(pb))
    assert not te.receivers[1].enabled
    assert not got[0][:, 3:6].any()  # the switched-off receiver's rows weigh nothing


@pytest.mark.parametrize("method", ["floating_l1norm", "floating_l2norm"])
def test_shared_sweep_beyond_the_fused_kernel(engines, method):
    """A slip-rake sweep of the fault keeps every centroid in place (shared
    kinematics), but its contraction depth C*ng = 180 exceeds the fused
    kernel's 64: the matmul forward, then the scan kernel."""
    je, te = engines
    for eng in engines:
        _configure(eng, method)
    pb = _batch(col=7, values=np.array([100.0, 164.0, 200.0, 300.0], np.float32))
    assert tmodel("bilateral").shared_kin_check(pb)
    want, got = _both(engines, pb)
    assert not te._plan["use_fused_scan"]
    _check(want, got)


def test_finite_reference_matches(engines):
    je, te = engines
    for eng in engines:
        _configure(eng, "floating_l1norm")
    want = je.get_synthetic_seismograms()
    got = te.get_synthetic_seismograms()
    assert len(got) == len(want) == 12
    for (gv, gi), (wv, wi) in zip(got, want):
        assert gi == wi and gv.shape == wv.shape and gv.dtype == np.float32
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5 * np.abs(wv).max())
    for irc in range(12):  # installed references: the same data spans
        assert te._refs[irc][1] == je._refs[irc][1]
        assert len(te._refs[irc][0]) == len(je._refs[irc][0])


def test_finite_tiny_amplitudes(engines):
    """Moment 1.0: samples ~1e-19, squares in the float32 flush range."""
    p = FAULT.copy()
    p[4] = 1.0
    for eng in engines:
        _configure(eng, "floating_l2norm", base=p)
    want, got = _both(engines, _batch(base=p))
    _check(want, got)
    g = engines[1].global_misfits_for_source_batch(_batch(base=p)).numpy()
    assert g[1] < 1e-3 < g[0], g  # the true strike (91) fits, 20 does not


def test_chunking_is_invisible(engines, monkeypatch):
    """The same rows through balanced memory-budget chunks (2, 2, 1) and in
    one piece; the window and scan run per row, so only float32 reduction
    order could differ."""
    _je, te = engines
    _configure(te, "floating_l1norm")
    pb = _batch(values=np.array([20.0, 91.0, 150.0, 260.0, 300.0], np.float32))
    whole = te.misfits_for_source_batch(pb)
    calls = []
    monkeypatch.setattr(tsw, "synthesize_ard_batch",
                        lambda *a, _f=tsw.synthesize_ard_batch: calls.append(a[2]["ish"].shape[0])
                        or _f(*a))
    te.memory_budget = 2 * te._plan["per_source_bytes"]
    try:
        parts = te.misfits_for_source_batch(pb)
    finally:
        del te.memory_budget
    assert calls == [2, 2, 1]
    for a, b in zip(parts, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


def test_undersampled_stencil_matches(engines):
    """xunder = zunder = 2: the window kernel's neighbour strides and the
    span tables follow the undersampled stencil."""
    for eng in engines:
        _configure(eng, "floating_l1norm", under=2)
    want, got = _both(engines, _batch())
    assert engines[1]._plan["cfg"].xunder == engines[1]._plan["cfg"].zunder == 2
    _check(want, got)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_source_discretize_matches(source):
    p = SOURCES[source]
    pb = np.tile(p, (4, 1))
    pb[:, 3] = (350.0, 400.0, 420.0, 480.0)  # depth
    pb[:, 1] = (0.0, 30.0, -60.0, 90.0)  # north shift
    jm, tm = jmodel(source), tmodel(source)
    assert tm.names == jm.names and tm.shape_param_idx == jm.shape_param_idx
    for k in ("norm", "min_hard", "max_hard", "min_soft", "max_soft", "defaults"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))
    shape = jm.grid_shape(p, EDT)
    assert tm.grid_shape(p, EDT) == shape
    assert tm.param_stats(pb, EDT) == jm.param_stats(pb, EDT)
    assert tm.shared_kin_check(pb) == jm.shared_kin_check(pb) is False
    want = jax.jit(jax.vmap(lambda q: jm.discretize(q, EDT, shape)))(jnp.asarray(pb))
    got = tm.discretize(torch.as_tensor(pb), EDT, shape)
    for k in ("north", "east", "depth", "time", "m"):
        assert got[k].dtype == torch.float32
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * max(float(np.abs(w).max()), 1e-30))
    np.testing.assert_array_equal(got["active"].numpy(), np.asarray(want["active"]))
    mj, rj = jm.post_factors_batch(pb)
    mt, rt = tm.post_factors_batch(torch.as_tensor(pb))
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(rt.numpy(), rj)


def test_circular_batch_matches(engines):
    """The second finite source on the window kernel: a strike sweep."""
    p = SOURCES["circular"]
    for eng in engines:
        _configure(eng, "floating_l1norm", base=p, source="circular")
    pb = _batch(base=p, values=np.array([10.0, 40.0, 120.0], np.float32))
    want, got = _both(engines, pb)
    assert engines[1]._plan["forward_batch"] is not None
    _check(want, got)


@pytest.mark.parametrize("source", ["moment_tensor", "point_lp"])
def test_point_source_batch_matches(engines, source):
    """The point sources on the shared paths: a sweep of one moment-tensor
    component (moment_tensor: C*ng = 40, the fused kernel; point_lp: 110,
    the matmul forward)."""
    p = SOURCES[source]
    for eng in engines:
        _configure(eng, "floating_l2norm", base=p, source=source)
    col = 4 if source == "moment_tensor" else 5
    pb = _batch(base=p, col=col, values=np.array([-2e12, 0.0, 1e12, 4e12], np.float32))
    want, got = _both(engines, pb)
    assert engines[1]._plan["use_fused_scan"] == (source == "moment_tensor")
    _check(want, got)
