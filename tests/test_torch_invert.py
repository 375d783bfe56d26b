"""The inversion path of the port against the JAX package on the CPU: the
engine's read-back getters, parameter masks and subparameters, the probe
length floor, principal axes, and kiwi_tpu_torch.invert (Source,
make_global_misfits, MisfitGrid with bootstrap statistics, minimize_lm)
against kiwi_tpu.invert, on tests/test_invert.py's 45 x 8 fullspace store
with its 4 `ned` receivers and finite bilateral fault (5 x 3 subfaults).

Misfits, norms and global misfits compare at rtol 2e-5 with an absolute
floor of 2e-5 of the largest value (tests/test_torch_finite.py's bar; the
true source's misfits are near 0), floating shifts exactly, the numpy-only
parts (principal axes, outer norms, bootstrap statistics over equal
inputs) exactly or to float64 rounding.
"""

import logging

import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu import invert as jinv
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu.invert import lmdif as jlmdif
from kiwi_tpu_torch import invert as tinv
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.invert import lmdif as tlmdif

TRUE = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                 2500.0, 0.2], np.float32)
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])


def _close(got, want, rtol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def engines():
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0),
        stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64),
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return JEngine(store), TEngine(tstore, device="cpu")


def _configure(eng, method="l2norm", shiftrange=(0.0, 0.0), filtered=False,
               min_probe_length=0):
    """tests/test_invert.py's session, its own synthetic as the reference."""
    rec = JReceiver if isinstance(eng, JEngine) else TReceiver
    olat, olon = 30.0, 70.0
    recs = []
    for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0), (2700.0, 2.6)]:
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d * np.cos(az),
                                  d * np.sin(az))
        recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.min_probe_length = min_probe_length
    if filtered:
        eng.set_misfit_filter(None, *BAND)
    eng.set_source_params("bilateral", TRUE)
    eng.set_misfit_method(method)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(*shiftrange)


def _perturbed():
    p = TRUE.copy()
    p[[0, 5, 6, 7]] += np.array([0.05, 5.0, -4.0, 6.0], np.float32)
    return p


@pytest.mark.parametrize("method,shiftrange", [("floating_l1norm", (-0.3, 0.3)),
                                               ("l2norm", (0.0, 0.0))])
def test_getters_match(engines, method, shiftrange):
    je, te = engines
    p = _perturbed()
    p[0] = 0.2  # two samples late
    for eng in engines:
        _configure(eng, method, shiftrange)
        eng.set_source_params("bilateral", p)
    (jm, jn, jfs), (tm, tn, tfs) = je.get_misfits(), te.get_misfits()
    for got in (tm, tn, tfs):
        assert isinstance(got, np.ndarray)
    _close(tm, np.asarray(jm))
    _close(tn, np.asarray(jn))
    np.testing.assert_array_equal(tfs, np.asarray(jfs))
    assert np.abs(tm).max() > 0
    g = te.get_global_misfit()
    assert isinstance(g, float) and g > 0.01
    _close(g, je.get_global_misfit())
    sj, st = je.get_floating_shifts(), te.get_floating_shifts()
    assert st.dtype == sj.dtype and st.shape == sj.shape
    np.testing.assert_array_equal(st, sj)
    if method == "floating_l1norm":
        assert np.abs(st).max() > 0  # the time offset shows in the shifts
    for got, want in zip(te.get_distances(), je.get_distances()):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_get_misfits_warns_on_nan(engines, monkeypatch, caplog):
    _je, te = engines
    _configure(te)
    real = te.misfits_for_source_batch

    def with_nan(pb):
        m, n, fs = real(pb)
        return m.index_fill(1, torch.tensor([2]), float("nan")), n, fs

    monkeypatch.setattr(te, "misfits_for_source_batch", with_nan)
    with caplog.at_level(logging.WARNING, logger="kiwi_tpu_torch"):
        m, _n, _fs = te.get_misfits()
    assert np.isnan(m[2]) and not np.isnan(np.delete(m, 2)).any()
    assert any("NaN misfit" in r.message and "[2]" in r.message for r in caplog.records)


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - the error is the outcome compared
        return type(e), str(e)
    return out


def test_mask_and_subparams_match(engines):
    """Every setter and getter, normalized and not, and every error case, on
    both engines: the same results, the same exception types and messages."""
    je, te = engines
    steps = [
        lambda e: e.set_source_subparams([1.0]),  # no params yet
        lambda e: e.set_source_params("bilateral", TRUE),
        lambda e: e.get_source_subparams(),  # no mask
        lambda e: e.set_source_subparams([1.0]),
        lambda e: e.set_source_params_mask(np.ones(13, bool)),  # wrong length
        lambda e: e.set_source_subparams_limits([0.0], [1.0]),  # no mask: 0 limits
        lambda e: e.set_source_params_mask([True, False, False, False, False, True, True,
                                            True, False, False, False, False, False, False]),
        lambda e: e.get_source_subparams(),
        lambda e: e.get_source_subparams(normalized=True),
        lambda e: e.set_source_subparams([0.1, 80.0, 60.0]),  # too few
        lambda e: e.set_source_subparams([0.1, 80.0, 60.0, 150.0]),
        lambda e: e.source_params.copy(),
        lambda e: e.set_source_subparams([-0.2, 0.25, 0.5, 0.4], normalized=True),
        lambda e: e.source_params.copy(),
        lambda e: e.get_source_subparams(normalized=True),
        lambda e: e.set_source_subparams_limits([-1.0, 0.0], [1.0, 360.0]),  # too few
        lambda e: e.set_source_subparams_limits([-1.0, 0.0, 0.0, -180.0],
                                                [1.0, 360.0, 90.0, 180.0]),
        lambda e: (e.subparam_mins.copy(), e.subparam_maxs.copy()),
        lambda e: e.set_source_params_mask(np.ones(14, bool)),  # clears the limits
        lambda e: (e.subparam_mins, e.subparam_maxs, e.params_mask.copy()),
    ]
    fresh = (JEngine(je.store), TEngine(te.store, device="cpu"))
    for i, step in enumerate(steps):
        want, got = _outcome(lambda: step(fresh[0])), _outcome(lambda: step(fresh[1]))
        if isinstance(want, tuple) and isinstance(want[0], type):  # an exception
            assert got == want, (i, got, want)
            continue
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            if w is None:
                assert g is None, i
            else:
                assert np.asarray(g).dtype == np.asarray(w).dtype, i
                np.testing.assert_array_equal(g, w, err_msg=f"step {i}")


def test_min_probe_length_matches(engines):
    """The probe length floor: the port's plan takes the JAX engine's probe
    length, and the filtered misfits stay equal to JAX's on that grid."""
    je, te = engines
    pls = {}
    for floor in (0, 1024):
        for eng in engines:
            _configure(eng, "floating_l1norm", (-0.3, 0.3), filtered=True,
                       min_probe_length=floor)
            eng.set_source_params("bilateral", _perturbed())
        (jm, jn, jfs), (tm, tn, tfs) = je.get_misfits(), te.get_misfits()
        tst, jst = te._plan["st"], je._plan["st"]
        assert (tst.ps0, tst.pl, tst.dt) == (jst.ps0, jst.pl, jst.dt)
        pls[floor] = te._plan["st"].pl
        _close(tm, np.asarray(jm))
        _close(tn, np.asarray(jn))
        np.testing.assert_array_equal(tfs, np.asarray(jfs))
    assert pls[0] < 1024 and pls[1024] == 1024


def _capture_fcn(monkeypatch, module):
    """minimize_lm's fcn_batch, caught at its lmdif call (which then returns
    the start unchanged)."""
    seen = []

    def fake(fcn_batch, x0, **kw):
        seen.append(fcn_batch)
        return np.asarray(x0, np.float64), None, 1, 0

    monkeypatch.setattr(module, "lmdif", fake)
    return seen


def test_fcn_batch_rows_match(engines, monkeypatch):
    """lmdif's residual rows at the same X on both engines: time, strike and
    length-a free, rows that straddle a grid-shape boundary (length-a 300
    and 180 m: 5 and 4 subfaults along strike) and a clipped row."""
    je, te = engines
    mask = np.zeros(14, bool)
    mask[[0, 5, 9]] = True
    fcns = []
    for eng, inv, mod in ((je, jinv, jlmdif), (te, tinv, tlmdif)):
        _configure(eng)
        eng.set_source_params("bilateral", _perturbed())
        seen = _capture_fcn(monkeypatch, mod)
        inv.minimize_lm(eng, mask=mask, subparam_mins=[-1.0, 0.0, 0.0],
                        subparam_maxs=[1.0, 360.0, 1000.0])
        fcns.append(seen[0])
    sub = np.array([0.05, 96.0 / 360.0, 0.03])
    X = np.stack([sub, sub + [0.01, 0, 0], sub - [0, 0.004, 0], sub * [1, 1, 0.6],
                  sub + [2.0, 0, 0]])  # the last one clipped at time 1 s
    want, got = fcns[0](X), fcns[1](X)
    assert got.dtype == np.float64 and got.shape == want.shape == (5, 12)
    _close(got, want)
    assert np.abs(got[4]).max() > np.abs(got[1]).max()  # the clip penalty
    # a trial step (one row padded with repeats to n + 1) and a lone row in
    # its shape bucket: the port evaluates each distinct row once, the JAX
    # package pads both to k rows
    sizes = []
    real = te.misfits_for_source_batch

    def counted(pb):
        sizes.append(pb.shape[0])
        return real(pb)

    monkeypatch.setattr(te, "misfits_for_source_batch", counted)
    short = sub * [1, 1, 0.6]
    for X, calls in ((np.stack([sub] * 4), [1]),
                     (np.stack([sub, sub + [0.01, 0, 0], short, short]), [2, 1])):
        sizes.clear()
        want, got = fcns[0](X), fcns[1](X)
        assert got.shape == want.shape == (4, 12)
        _close(got, want)
        assert sorted(sizes, reverse=True) == calls
        np.testing.assert_array_equal(got[-1], got[-2])


def test_shape_buckets_match():
    """The port's buckets hold the rows of the JAX package's, unpadded."""
    from kiwi_tpu.invert.lm import shape_buckets as jbuckets
    from kiwi_tpu.sources import get_source_model as jmodel
    from kiwi_tpu_torch.sources import get_source_model as tmodel

    rows = np.tile(TRUE, (5, 1))
    rows[:, 9] = [300.0, 180.0, 300.0, 310.0, 180.0]  # 5, 4, 5, 5, 4 subfaults
    want = list(jbuckets(jmodel("bilateral"), 0.1, rows, 5))
    got = list(tinv.shape_buckets(tmodel("bilateral"), 0.1, rows))
    assert len(got) == len(want) == 2
    for (tsel, trows), (jsel, jrows) in zip(got, want):
        np.testing.assert_array_equal(tsel, jsel)
        np.testing.assert_array_equal(trows, np.asarray(jrows)[: jsel.size])


@pytest.mark.parametrize("method", ["batched", "scipy"])
def test_lm_refines_to_truth(engines, method):
    """tests/test_invert.py:92-108's start and bars, both lmdif routes;
    the batched one through the engine's mask and minimize_lm."""
    _je, te = engines
    _configure(te)
    start = TRUE.copy()
    start[5] = 96.0  # strike off by 5 degrees
    start[0] = 0.05  # time off by half a sample
    te.set_source_params("bilateral", start)
    mask = np.zeros(14, dtype=bool)
    mask[[0, 5]] = True
    if method == "batched":
        te.set_source_params_mask(mask)
        info, nfev, gm = te.minimize_lm()
    else:
        info, nfev, gm = tinv.minimize_lm(te, mask=mask, method="scipy")
    assert info in (1, 2, 3, 4)
    assert nfev > 2
    assert gm < 0.02, (info, nfev, gm)
    assert abs(te.source_params[5] - 91.0) < 0.5
    assert gm == te.get_global_misfit()


def _grids(engines, method, ranges, chunk):
    out = []
    for eng, inv in zip(engines, (jinv, tinv)):
        _configure(eng, method)
        grid = inv.MisfitGrid(inv.Source("bilateral", TRUE), ranges)
        grid.compute(eng, chunk=chunk)
        out.append(grid)
    return out


def _same_postprocess(jgrid, tgrid, outer, iterations):
    (jb, jg, js), (tb, tg, ts) = (g.postprocess(bootstrap_iterations=iterations, seed=3,
                                                outer_norm=outer) for g in (jgrid, tgrid))
    np.testing.assert_array_equal(tb.params, jb.params)
    _close(tg, jg)
    assert js.keys() == ts.keys()
    for name in js:
        a, b = js[name], ts[name]
        np.testing.assert_array_equal(b.distribution, a.distribution)
        for key in ("best", "mean", "std", "median", "percentile16", "percentile84",
                    "percentile16_warn", "percentile84_warn"):
            assert getattr(b, key) == getattr(a, key), (name, key)
        assert str(b) == str(a) and b.as_xml() == a.as_xml()
        c = b.converted("x2", lambda v: 2.0 * np.asarray(v))
        d = a.converted("x2", lambda v: 2.0 * np.asarray(v))
        assert (c.best, c.percentile16, c.percentile84) == (d.best, d.percentile16, d.percentile84)
    return tb, ts


def test_gridsearch_1d_matches(engines):
    """tests/test_invert.py's strike search (l2norm, chunks of 5 models)."""
    jgrid, tgrid = _grids(engines, "l2norm", [("strike", np.arange(31.0, 151.0, 10.0))], 5)
    assert tgrid.misfits_by_src.dtype == np.float64
    _close(tgrid.misfits_by_src, jgrid.misfits_by_src)
    _close(tgrid.norms_by_src, jgrid.norms_by_src)
    best, stats = _same_postprocess(jgrid, tgrid, "l2norm", 50)
    assert best["strike"] == pytest.approx(91.0)
    assert stats["strike"].percentile16 <= 91.0 <= stats["strike"].percentile84


def test_gridsearch_2d_matches(engines):
    """tests/test_invert.py's strike x depth search (l1norm) and a
    strike x length-a one whose models fall into two grid-shape buckets."""
    jgrid, tgrid = _grids(engines, "l1norm", [("strike", np.array([71.0, 91.0, 111.0])),
                                              ("depth", np.array([300.0, 400.0, 500.0]))], 512)
    _close(tgrid.misfits_by_src, jgrid.misfits_by_src)
    _close(tgrid.norms_by_src, jgrid.norms_by_src)
    best, _stats = _same_postprocess(jgrid, tgrid, "l1norm", 10)
    assert (best["strike"], best["depth"]) == (91.0, 400.0)
    jgrid, tgrid = _grids(engines, "l1norm", [("strike", np.array([81.0, 91.0])),
                                              ("length-a", np.array([180.0, 300.0]))], 512)
    _close(tgrid.misfits_by_src, jgrid.misfits_by_src)
    best, _stats = _same_postprocess(jgrid, tgrid, "l2norm", 10)
    assert (best["strike"], best["length-a"]) == (91.0, 300.0)


@pytest.mark.parametrize("outer", ["l1norm", "l2norm"])
@pytest.mark.parametrize("anarchy", [False, True])
def test_make_global_misfits_matches(outer, anarchy):
    rng = np.random.default_rng(5)
    m = rng.uniform(0.0, 2.0, (7, 4, 3))
    n = rng.uniform(0.5, 3.0, (7, 4, 3))
    n[2, 1] = 0.0  # a receiver without a norm
    for weights in (1.0, rng.uniform(0.5, 2.0, 4)):
        for bweights in (None, np.array([2.0, 0.0, 1.0, 1.0])):
            kw = dict(receiver_weights=weights, outer_norm=outer, anarchy=anarchy,
                      bweights=bweights)
            for got, want in zip(tinv.make_global_misfits(m, n, **kw),
                                 jinv.make_global_misfits(m, n, **kw)):
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown outer norm"):
        tinv.make_global_misfits(m, n, outer_norm="l3norm")


def test_source_matches():
    for cls in (tinv.Source, jinv.Source):
        with pytest.raises(ValueError, match="needs 14 params"):
            cls("bilateral", TRUE[:5])
    t, j = tinv.Source("bilateral", TRUE, dip=60.0), jinv.Source("bilateral", TRUE, dip=60.0)
    assert t["strike"] == j["strike"] == pytest.approx(91.0) and t["dip"] == 60.0
    t["strike"], j["strike"] = 45.0, 45.0
    assert t.keys() == j.keys() and "moment" in t.keys()
    assert repr(t) == repr(j) and repr(t.copy()) == repr(j)
    np.testing.assert_array_equal(tinv.Source("circular").params, jinv.Source("circular").params)
    t.params[6], j.params[6] = 1e30, 1e30
    np.testing.assert_array_equal(t.clip_to_hard_limits().params, j.clip_to_hard_limits().params)
    np.testing.assert_array_equal(t.randomize(np.random.default_rng(4)).params,
                                  j.randomize(np.random.default_rng(4)).params)
    ranges = [("strike", [10.0, 20.0, 30.0]), ("depth", [300.0, 400.0])]

    def shallow(p):
        return p[3] < 350.0 or p[5] > 15.0

    for constraint in (None, shallow):
        (tp, tc), (jp, jc) = (mod.source_grid(mod.Source("bilateral", TRUE), ranges, constraint)
                              for mod in (tinv, jinv))
        np.testing.assert_array_equal(tp, jp)
        assert tc == jc
    assert len(tc) == 5


@pytest.mark.parametrize("source,params", [
    ("bilateral", TRUE),
    ("bilateral", np.array([0, 0, 0, 400.0, 1e12, 200.0, 30.0, -60.0, 0, 0, 0, 0, 2500.0, 0.2],
                           np.float32)),
    ("circular", np.array([0.0, 0.0, 0.0, 400.0, 1e12, 40.0, 60.0, 110.0, 200.0, 2500.0, 0.2],
                          np.float32)),
    ("moment_tensor", np.array([0.2, 60.0, -40.0, 400.0, 1e12, -2e12, 1e12, 3e12, 5e11, -1e12,
                                0.3], np.float32)),
])
def test_principal_axes_match(engines, source, params):
    je, te = engines
    for eng in engines:
        eng.set_source_params(source, params)
    for got, want in zip(te.get_principal_axes(), je.get_principal_axes()):
        np.testing.assert_array_equal(got, np.asarray(want))
    if source == "moment_tensor":
        assert not np.any(te.get_principal_axes())
