"""The eikonal discretizer's fine-grid passes on the CPU
(kiwi_tpu_torch.ops.eik_tables: eik_speeds, eik_tables).

On the CPU the wrappers run the plain versions and launch nothing: on the
seeded cases of eik_prepare_cases.py, with and without a cell budget, the
speeds and the tables keep their layout and their weights.  The plain
versions are held against the JAX package through the discretizer
(tests/test_torch_eikonal.py::test_discretize_device_batch_matches), the
kernels against the plain versions on the card (tests/test_torch_cuda.py).
The wrappers refuse what the kernels do not take.  No JAX.
"""

import functools

import numpy as np
import pytest
import torch

import eik_prepare_cases as cases
from kiwi_tpu_torch import profiling
from kiwi_tpu_torch.ops import eik_prepare, eik_sweep, eik_tables
from kiwi_tpu_torch.sources import eikonal as eiksrc

F32, I32 = torch.float32, torch.int32
CASES = ("radius_sweep", "dips", "radii_on_the_grid", "shallow", "oblique", "mt_eikonal")
NROWS = 4  # rows of each case, spread over its batch: the CPU solves them


@functools.lru_cache(maxsize=None)
def _solved(name):
    """(static, arrays, ctx, times) of NROWS rows of case `name`, prepared
    and solved on the CPU."""
    model, rows, ctx, _error = cases.case(name)
    rows = rows[np.linspace(0, len(rows) - 1, NROWS).astype(int)]
    named = eiksrc.named_params_batch(model, rows)
    summary, arrays = eik_prepare.eik_prepare(eik_prepare.rows_on(named, "cpu"), ctx, cases.EDT)
    static, _hard = eik_prepare.static_from_summary(summary.numpy())
    ctx_arr, sizes = eik_tables.context_on("cpu", ctx)
    speeds = eik_tables.speeds_reference(arrays, ctx_arr, sizes, static["NF"])
    times = eik_sweep.sweep_solve_batch(speeds, arrays["delta"], arrays["first"], arrays["nukl"],
                                        n_rounds=2)
    return static, arrays, ctx, times


def _launches():
    return dict(eik_tables.launches)


@pytest.mark.parametrize("name", CASES)
def test_plain_speeds_on_the_cpu(name):
    """On the CPU the wrapper runs the plain version and launches nothing;
    each speed is a layer's speed times rel-rupture-velocity inside the
    rupture, or half the least speed outside it, and both occur."""
    static, arrays, ctx, _times = _solved(name)
    before = _launches()
    ctx_arr, sizes = eik_tables.context_on("cpu", ctx)
    got = eik_tables.eik_speeds(arrays, ctx_arr, sizes, static["NF"])
    want = eik_tables.speeds_reference(arrays, ctx_arr, sizes, static["NF"])
    assert _launches() == before
    assert got.dtype == F32 and got.shape == (NROWS, *static["NF"]) and got.is_contiguous()
    assert torch.equal(got.view(I32), want.view(I32))
    half = 0.5 * arrays["minspeed"][:, None, None]
    inside = torch.as_tensor(np.asarray(ctx.layer_vs), dtype=F32)[:, None] * arrays["relv"]
    for b in range(NROWS):
        live = got[b][got[b] != half[b]]
        assert torch.isin(live, inside[:, b]).all(), b
    assert (got >= arrays["minspeed"][:, None, None]).any()
    assert (got == half).any()


@pytest.mark.parametrize("budget", [None, 24])
@pytest.mark.parametrize("name", CASES)
def test_plain_tables_on_the_cpu(name, budget):
    """On the CPU the wrapper runs the plain version and launches nothing.
    The tables hold a coarse cell's nt_cell_max time cells in a row, the
    active ones first, each 1 / nt of its cell's weight, so a source's
    moment weights sum to 1 with no budget and to at most 1 under one; the
    cases outgrow a budget of 24 cells, which the overflow count says."""
    static, arrays, ctx, times = _solved(name)
    before = _launches()
    ctx_arr, sizes = eik_tables.context_on("cpu", ctx)
    args = (arrays, times, ctx_arr, sizes, static["NC"], 2, budget, cases.EDT)
    got = eik_tables.eik_tables(*args)
    want = eik_tables.tables_reference(*args)
    assert _launches() == before
    assert list(got) == list(want) == list(eik_tables.TABLE_FIELDS)
    ncell = budget or static["NC"][0] * static["NC"][1]
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.is_contiguous(), k
        assert g.shape == ((NROWS,) if k == "overflow" else
                           (NROWS, ncell * 2, 6) if k == "m" else (NROWS, ncell * 2)), k
        assert torch.equal(g.view(I32) if w.dtype == F32 else g,
                           w.view(I32) if w.dtype == F32 else w), k
    active = got["active"].view(NROWS, ncell, 2)
    assert not (active[:, :, 1] & ~active[:, :, 0]).any()  # live time cells first
    weights = (got["m"] / arrays["m6"][:, None, :]).double().nanmean(-1).sum(-1)
    assert (got["m"][~got["active"]] == 0).all()
    if budget is None:
        np.testing.assert_allclose(weights.numpy(), 1.0, rtol=1e-5)
    else:
        assert (weights <= 1.0 + 1e-5).all()
        assert (got["overflow"] > 0).any()  # these cases outgrow 24 cells


@pytest.mark.parametrize("constraints", [cases.DEFAULT, cases.OBLIQUE, []])
def test_context_on_the_cpu(constraints):
    ctx = cases.context(constraints)
    arr, sizes = eik_tables.context_on("cpu", ctx)
    want, want_sizes = eik_prepare.context_array(ctx.constraints, ctx.layer_depths, ctx.layer_vs)
    assert arr.dtype == torch.float64 and sizes == want_sizes
    np.testing.assert_array_equal(arr.numpy(), want)


def test_coarse_index_stays_the_sources_name():
    assert eiksrc.coarse_index is eik_tables.coarse_index
    # the middle fine cell of an odd grid under an even coarse grid: upper
    assert eik_tables.coarse_index(2, 2, 5) == 1
    assert list(eik_tables.coarse_index(np.arange(6), 3, 6)) == [0, 0, 1, 1, 2, 2]


def test_snapshot_carries_the_launch_counters():
    snap = profiling.snapshot()
    for k in ("eik_speeds", "eik_tables"):
        assert snap["launches." + k] == eik_tables.launches[k]


def _operands():
    static, arrays, ctx, times = _solved("dips")
    ctx_arr, sizes = eik_tables.context_on("cpu", ctx)
    return static, dict(arrays), ctx_arr, sizes, times


def _with(arrays, **kw):
    return {**arrays, **kw}


@pytest.mark.parametrize("case,error", [
    ("first_f64", ValueError),       # not float32
    ("ndims_f32", ValueError),       # not int32
    ("rotmat_flat", ValueError),     # not [B, 3, 3]
    ("radius_short", ValueError),    # not [B]
    ("strided", ValueError),         # not contiguous
    ("ctx_f32", ValueError),         # the context not float64
    ("ctx_short", ValueError),       # the context shorter than its sizes
    ("no_speeds", ValueError),       # no layer speeds
    ("meta", ValueError),            # a device that is neither cpu nor cuda
    ("two_devices", ValueError),     # operands on two devices
    ("grad", RuntimeError),          # no backward
])
def test_wrappers_refuse(case, error):
    static, arrays, ctx_arr, sizes, times = _operands()
    B = arrays["first"].shape[0]
    if case == "first_f64":
        arrays = _with(arrays, first=arrays["first"].double())
    elif case == "ndims_f32":
        arrays = _with(arrays, ndims=arrays["ndims"].float())
    elif case == "rotmat_flat":
        arrays = _with(arrays, rotmat=arrays["rotmat"].reshape(B, 9))
    elif case == "radius_short":
        arrays = _with(arrays, radius=arrays["radius"][:-1])
    elif case == "strided":
        arrays = _with(arrays, center=torch.zeros(B, 6)[:, ::2])
    elif case == "ctx_f32":
        ctx_arr = ctx_arr.float()
    elif case == "ctx_short":
        ctx_arr = ctx_arr[:10]
    elif case == "no_speeds":
        sizes = (sizes[0], sizes[1], 0)
    elif case == "meta":
        arrays = {k: v.to("meta") for k, v in arrays.items()}
        ctx_arr, times = ctx_arr.to("meta"), times.to("meta")
    elif case == "two_devices":
        ctx_arr = ctx_arr.to("meta")
    elif case == "grad":
        arrays = _with(arrays, delta=arrays["delta"].clone().requires_grad_())
    with pytest.raises(error):
        eik_tables.eik_speeds(arrays, ctx_arr, sizes, static["NF"])
    with pytest.raises(error):
        eik_tables.eik_tables(arrays, times, ctx_arr, sizes, static["NC"], 2, None, cases.EDT)


@pytest.mark.parametrize("times_case", ["f64", "2d", "batch"])
def test_tables_refuse_times(times_case):
    static, arrays, ctx_arr, sizes, times = _operands()
    times = {"f64": times.double(), "2d": times[0], "batch": times[:-1]}[times_case]
    with pytest.raises(ValueError, match="times"):
        eik_tables.eik_tables(arrays, times, ctx_arr, sizes, static["NC"], 2, None, cases.EDT)


@pytest.mark.parametrize("NC,nt,budget", [((0, 10), 2, None), ((10, 10), 0, None),
                                          ((10, 10), 2, 0)])
def test_tables_refuse_empty_tables(NC, nt, budget):
    _static, arrays, ctx_arr, sizes, times = _operands()
    with pytest.raises(ValueError, match="empty tables"):
        eik_tables.eik_tables(arrays, times, ctx_arr, sizes, NC, nt, budget, cases.EDT)
