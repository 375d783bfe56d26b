"""The port's eikonal-rupture path (kiwi_tpu_torch: geometry, crust2x2,
eikonal, ops/eik_sweep, sources/eikonal and the engine's eikonal surface) on
the CPU against the JAX package, on the same seeded inputs.

Tolerances:
* the carried numpy modules (geometry, crust2x2, fmm_solve, prepare_batch,
  named_params_batch, discretize_eikonal_host) give identical results;
* the fast-sweeping solves agree with jax.vmap(kiwi_tpu.eikonal.sweep_solve)
  to 1e-4 relative (tests/test_eikonal.py's kernel-vs-XLA bar) and with the
  Pallas kernel in interpret mode, whose formula they share, to 1e-5;
* the device discretizer agrees with the JAX one (its XLA sweep) at
  tests/test_eikonal.py:248-258's tolerances;
* engine global misfits agree to atol 1e-5 with argmin at the true radius
  (tests/test_invert.py:151-216's bars), host-path misfits and norms to
  rtol 1e-5 (misfits with a floor of 1e-5 of their max: the true radius's
  row is rounding noise).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiwi_tpu import crust2x2 as jcrust
from kiwi_tpu import eikonal as jeik
from kiwi_tpu import geo
from kiwi_tpu import geometry as jgeom
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu.ops import eik_sweep as jsweep
from kiwi_tpu.sources import get_source_model as jget
from kiwi_tpu.sources import eikonal as jsrc
from kiwi_tpu_torch import crust2x2 as tcrust
from kiwi_tpu_torch import eikonal as teik
from kiwi_tpu_torch import geometry as tgeom
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.ops import eik_sweep as tsweep
from kiwi_tpu_torch.sources import get_source_model as tget
from kiwi_tpu_torch.sources import eikonal as tsrc

CONSTRAINTS = [
    (np.array([0.0, 0.0, 50.0]), np.array([0.0, 0.0, -1.0])),
    (np.array([0.0, 0.0, 700.0]), np.array([0.0, 0.0, 1.0])),
]
LAYERS = dict(layer_depths=np.array([100.0, 400.0, 900.0]),
              layer_vs=np.array([1500.0, 2400.0, 3200.0, 3800.0]))
EIK_P = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0, 0.0, 0.0, 250.0, 50.0, -50.0,
                  0.9, 0.3], dtype=np.float32)
MTE_P = np.zeros(20, dtype=np.float32)
MTE_P[:13] = [0.0, 0.0, 0.0, 400.0, 1.0, 30.0, 80.0, 0.0, 0.0, 250.0, 50.0, -50.0, 0.9]
MTE_P[13:19] = [1e12, -5e11, 2e11, 3e11, -1e11, 5e11]
MTE_P[19] = 0.2
MODELS = {"eikonal": (EIK_P, 10), "mt_eikonal": (MTE_P, 9)}  # params, radius column
RADII = np.array([200.0, 250.0, 300.0, 350.0], dtype=np.float32)


def _ctx(src, constraints=CONSTRAINTS):
    return src.EikonalContext(constraints=constraints, **LAYERS)


def _named(src, seed=11, B=3, name="eikonal"):
    """tests/test_eikonal.py:225-237's sources (the mt_eikonal rows carry
    the same geometry in that model's columns)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(B):
        p = np.array([0.1 * i, 8.0 * i, -15.0 * i, 300.0 + 10.0 * i, 1e12, 10.0 * i,
                      30.0 + 2.0 * i, 40.0, 10.0 * rng.random(), 10.0 * rng.random(),
                      150.0 + 8.0 * i, 20.0 * rng.random(), -20.0 * rng.random(),
                      0.7 + 0.01 * i, 0.3], dtype=np.float32)
        if name == "mt_eikonal":
            q = np.zeros(20, np.float32)
            q[:7] = p[:7]
            q[7:13] = p[8:14]
            q[13:19] = [1e12, -5e11, 2e11, 3e11, -1e11, 5e11]
            q[19] = 0.2
            p = q
        rows.append(p)
    return [src.NAMED_PARAMS[name](p) for p in rows], np.stack(rows)


# -- the carried numpy modules ------------------------------------------------


def test_geometry_matches():
    rng = np.random.default_rng(0)
    B, n = 6, 40
    ang = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    polys = np.stack([np.stack([300.0 * np.cos(ang) + rng.normal(0, 20, n),
                                300.0 * np.sin(ang) + rng.normal(0, 20, n),
                                rng.uniform(0.0, 600.0, n)], axis=-1) for _ in range(B)])
    counts = rng.integers(3, n + 1, B)
    hp, hn = np.array([50.0, 0.0, 300.0]), np.array([0.3, -0.2, 1.0])
    want = jgeom.trim_polygon_batch(polys, counts, hp, hn)
    got = tgeom.trim_polygon_batch(polys, counts, hp, hn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rot = rng.normal(size=(3, 3))
    circ = jgeom.circle_to_polygon(np.array([10.0, 20.0, 300.0]), rot, 180)
    np.testing.assert_array_equal(tgeom.circle_to_polygon(np.array([10.0, 20.0, 300.0]), rot, 180),
                                  circ)
    cons = CONSTRAINTS + [(hp, hn)]
    np.testing.assert_array_equal(tgeom.trim_polygon_multi(circ, cons),
                                  jgeom.trim_polygon_multi(circ, cons))
    np.testing.assert_array_equal(tgeom.trim_polygon(circ, hp, hn), jgeom.trim_polygon(circ, hp, hn))
    for g, w in zip(tgeom.polygon_box(circ), jgeom.polygon_box(circ)):
        np.testing.assert_array_equal(g, w)
    for q in circ[::17]:
        assert tgeom.point_in_constraints(q, cons) == jgeom.point_in_constraints(q, cons)


def test_crust2x2_matches():
    tm, jm = tcrust.default_model(), jcrust.default_model()
    for lat, lon in ((30.0, 70.0), (-12.5, 171.0), (64.0, -20.0)):
        for g, w in zip(tm.layers_at(lat, lon), jm.layers_at(lat, lon)):
            np.testing.assert_array_equal(g, w)
        prof = tm.profile(lat, lon)
        for g, w in zip(prof, jm.profile(lat, lon)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tm.profile_averages(*prof[:4]),
                                      jm.profile_averages(*prof[:4]))
    assert "kiwi_tpu_torch" in str(tcrust.DATA_DIR)


def test_fmm_solve_matches():
    rng = np.random.default_rng(5)
    speed = 2000.0 + 800.0 * rng.random((37, 29))
    speed[10:14, :20] = 400.0
    args = ((50.0, 70.0), (-100.0, 30.0), (600.0, 900.0))
    np.testing.assert_array_equal(teik.fmm_solve(speed, *args), jeik.fmm_solve(speed, *args))


@pytest.mark.parametrize("name", ["eikonal", "mt_eikonal"])
def test_named_params_batch_matches(name):
    rng = np.random.default_rng(3)
    pb = rng.normal(size=(16, 15 if name == "eikonal" else 20)).astype(np.float32) * 100.0
    want = jsrc.named_params_batch(name, pb)
    got = tsrc.named_params_batch(name, pb)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_prepare_batch_matches():
    """The vectorized and the per-source prepare, and the zero-radius member
    that routes the public API to the loop."""
    cons = CONSTRAINTS + [(np.array([250.0, 0.0, 0.0]), np.array([1.0, 0.3, 0.0]))]
    jnamed, pb = _named(jsrc, seed=7, B=12)
    tnamed, _ = _named(tsrc, seed=7, B=12)
    p0 = EIK_P.copy()
    p0[10] = 0.0
    p0[11:13] = 0.0
    for jn, tn in ((jnamed, tnamed), ([jsrc.NAMED_PARAMS["eikonal"](p0)],
                                      [tsrc.NAMED_PARAMS["eikonal"](p0)])):
        for fn in ("prepare_batch", "_prepare_batch_loop"):
            ws, wa = getattr(jsrc, fn)(jn, 0.1, _ctx(jsrc, cons))
            gs, ga = getattr(tsrc, fn)(tn, 0.1, _ctx(tsrc, cons))
            assert gs == ws
            assert set(ga) == set(wa)
            for k in wa:
                np.testing.assert_array_equal(ga[k], wa[k], err_msg=f"{fn} {k}")
    # the batched named params take the vectorized route too
    ws, wa = jsrc.prepare_batch(jsrc.named_params_batch("eikonal", pb), 0.1, _ctx(jsrc, cons))
    gs, ga = tsrc.prepare_batch(tsrc.named_params_batch("eikonal", pb), 0.1, _ctx(tsrc, cons))
    assert gs == ws
    for k in wa:
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)


@pytest.mark.parametrize("name", ["eikonal", "mt_eikonal"])
def test_discretize_host_matches(name):
    p, col = MODELS[name]
    for radius in (200.0, 320.0):
        q = p.copy()
        q[col] = radius
        want = jget(name).discretize(q, 0.1, _ctx(jsrc))
        got = tget(name).discretize(q, 0.1, _ctx(tsrc))
        assert got["stats"] == want["stats"]
        for k in ("north", "east", "depth", "time", "m", "active"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_default_constraints_match():
    """Without user constraints the rupture is confined by the crust2x2
    defaults (surface at 1500 m, the crust bottom, capped by the thickness
    limit), read from the port's own copy of the tables."""
    engs = (JEngine(), TEngine(device="cpu"))
    for eng in engs:
        eng.set_source_location(30.0, 70.0)
    for limit in (0.0, 20000.0):
        for eng in engs:
            eng.set_source_crustal_thickness_limit(limit)
        assert engs[1].get_source_crustal_thickness() == engs[0].get_source_crustal_thickness()
        want, got = engs[0].eikonal_context(), engs[1].eikonal_context()
        assert got.content_key() == want.content_key()
        assert len(got.constraints) == 2


# -- the fast-sweeping solve ----------------------------------------------------


def _sweep_inputs():
    """tests/test_eikonal.py:191-197's inputs."""
    rng = np.random.default_rng(3)
    B, nx, ny = 5, 48, 40
    speed = rng.uniform(1000.0, 4000.0, (B, nx, ny)).astype(np.float32)
    delta = rng.uniform(50.0, 300.0, (B, 2)).astype(np.float32)
    first = rng.uniform(-1000.0, 0.0, (B, 2)).astype(np.float32)
    ip = first + rng.uniform(0.2, 0.8, (B, 2)).astype(np.float32) * (delta * [nx - 1, ny - 1])
    return speed, delta, first, ip.astype(np.float32)


@pytest.fixture(scope="module")
def sweep_refs():
    args = _sweep_inputs()
    xla = np.asarray(jax.vmap(lambda s, d, f, p: jeik.sweep_solve(s, d, f, p, n_rounds=2))(
        *(jnp.asarray(a) for a in args)))
    pallas = np.asarray(jsweep.sweep_solve_batch(*args, n_rounds=2, interpret=True))
    return args, xla, pallas


def _rel(got, want):
    assert (want < 1e29).all()
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-6)).max())


@pytest.mark.parametrize("solver", ["sweep_solve", "sweep_solve_batch"])
def test_sweep_matches(sweep_refs, solver):
    (speed, delta, first, ip), xla, pallas = sweep_refs
    if solver == "sweep_solve":
        got = np.stack([teik.sweep_solve(torch.as_tensor(speed[b]), delta[b], first[b], ip[b],
                                         n_rounds=2).numpy() for b in range(len(speed))])
    else:
        before = dict(tsweep.launches)
        got = tsweep.sweep_solve_batch(*(torch.as_tensor(a) for a in (speed, delta, first, ip)),
                                       n_rounds=2).numpy()
        assert tsweep.launches == before  # a CPU tensor runs the plain version
    assert got.shape == xla.shape and got.dtype == np.float32
    assert _rel(got, xla) <= 1e-4
    assert _rel(got, pallas) <= 1e-5


def test_sweep_batch_rejects():
    speed, delta, first, ip = (torch.as_tensor(a) for a in _sweep_inputs())
    with pytest.raises(ValueError, match="f32"):
        tsweep.sweep_solve_batch(speed.double(), delta, first, ip)
    with pytest.raises(ValueError, match="delta"):
        tsweep.sweep_solve_batch(speed, delta[:2], first, ip)


# -- the device discretizer -----------------------------------------------------


@pytest.mark.parametrize("name", ["eikonal", "mt_eikonal"])
@pytest.mark.parametrize("budget", [None, 2])
def test_discretize_device_batch_matches(monkeypatch, name, budget):
    """The port's batched discretizer against the JAX one with its XLA sweep
    (KIWI_SWEEP_KERNEL=0), with and without a cell budget below the cell
    count (then `overflow` counts the dropped active cells)."""
    monkeypatch.setenv("KIWI_SWEEP_KERNEL", "0")
    jnamed, _ = _named(jsrc, name=name)
    tnamed, _ = _named(tsrc, name=name)
    static, arrays = jsrc.prepare_batch(jnamed, 0.5, _ctx(jsrc))
    tstatic, tarrays = tsrc.prepare_batch(tnamed, 0.5, _ctx(tsrc))
    want = jsrc.discretize_device_batch(static, arrays, 0.5, _ctx(jsrc), nt_cell_max=8,
                                        ncell_budget=budget, _cache={})
    got = tsrc.discretize_device_batch(tstatic, tarrays, 0.5, _ctx(tsrc), nt_cell_max=8,
                                       ncell_budget=budget, device="cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["active"].numpy(), np.asarray(want["active"]))
    np.testing.assert_array_equal(got["overflow"].numpy(), np.asarray(want["overflow"]))
    if budget is not None:
        assert (got["overflow"].numpy() > 0).all()
    for k in ("north", "east", "depth", "m"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["time"].numpy(), np.asarray(want["time"]), rtol=1e-4,
                               atol=1e-3)


# -- the engine -------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """tests/test_invert.py:13-32's session (45x8 fullspace store, 4 `ned`
    receivers) in both packages."""
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    out = (JEngine(store), TEngine(tstore, device="cpu"))
    olat, olon = 30.0, 70.0
    for eng in out:
        rec = JReceiver if isinstance(eng, JEngine) else TReceiver
        recs = []
        for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0), (2700.0, 2.6)]:
            la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d * np.cos(az),
                                      d * np.sin(az))
            recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
        eng.set_receivers(recs)
        eng.set_source_location(olat, olon, 0.0)
        eng.set_effective_dt(0.1)
        eng.set_local_interpolation(True)
    return out


def _eik_session(eng, name="eikonal", method="l2norm"):
    eng.set_misfit_method(method)
    eng.set_source_constraints([[0, 0, 50.0], [0, 0, 700.0]], [[0, 0, -1.0], [0, 0, 1.0]])
    eng.set_source_params(name, MODELS[name][0])
    eng.set_synthetic_reference()
    p, col = MODELS[name]
    batch = np.tile(p, (len(RADII), 1))
    batch[:, col] = RADII
    return batch


@pytest.mark.parametrize("name", ["eikonal", "mt_eikonal"])
def test_engine_batch_matches(engines, name):
    """set_synthetic_reference (host FMM), then a 4-radius batch on the host
    pipeline and on the device discretizer, in both packages."""
    out = {}
    for eng in engines:
        batch = _eik_session(eng, name)
        for dev in (False, True):
            eng.eikonal_device = dev
            eng._eikonal_checked_keys.clear()
            eng._invalidate()
            m, n, fs = eng.misfits_for_source_batch(batch)
            g = eng.global_misfits_for_source_batch(batch)
            assert eng.eikonal_device is dev  # no fallback
            out[isinstance(eng, TEngine), dev] = [np.asarray(x) for x in (m, n, fs, g)]
        eng.eikonal_device = True
    for dev in (False, True):
        (jm, jn, jfs, jg), (tm, tn, tfs, tg) = out[False, dev], out[True, dev]
        assert tg.dtype == np.float32 and tg.shape == (len(RADII),)
        assert np.argmin(tg) == np.argmin(jg) == 1
        np.testing.assert_allclose(tg, jg, atol=1e-5)
        np.testing.assert_array_equal(tfs, jfs)
        if not dev:
            # the true radius's row is the reference itself: its misfits are
            # rounding noise, held to 1e-5 of the largest misfit
            np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5 * np.abs(jm).max())
            np.testing.assert_allclose(tn, jn, rtol=1e-5)
    # the device discretizer tracks the host pipeline in the port too
    np.testing.assert_allclose(out[True, True][3], out[True, False][3], atol=1e-5)


def test_engine_synthetics_match(engines):
    """A single eikonal source (B = 1) takes the host pipeline, as
    set_synthetic_reference does; the traces match the JAX package's."""
    for eng in engines:
        _eik_session(eng)
    want = engines[0].get_synthetic_seismograms()
    got = engines[1].get_synthetic_seismograms()
    assert len(got) == len(want) == 12
    for (gv, gi), (wv, wi) in zip(got, want):
        assert gi == wi and gv.shape == wv.shape
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6 * np.abs(wv).max())


def test_eikonal_crosscheck_catches_corrupt_member(engines, monkeypatch, caplog):
    """tests/test_invert.py:219's check on the port: a corruption of the
    device discretizer on members i > 0 is caught by the first-use
    cross-check (>= 3 members, not just source 0) and falls back to the host
    pipeline with a warning."""
    te = engines[1]
    batch = _eik_session(te)
    real = tsrc.discretize_device_batch

    def corrupt(*args, **kw):
        out = dict(real(*args, **kw))
        north = out["north"].clone()
        north[1:] += 3000.0
        out["north"] = north
        return out

    monkeypatch.setattr(tsrc, "discretize_device_batch", corrupt)
    te.eikonal_device = True
    te._eikonal_checked_keys.clear()
    te._invalidate()
    with caplog.at_level(logging.WARNING):
        g = te.global_misfits_for_source_batch(batch)
    assert te.eikonal_device is False, "corruption not caught"
    assert any("disagrees" in r.message for r in caplog.records)
    assert np.argmin(g.numpy()) == 1  # the host pipeline answered
    te.eikonal_device = True
    te._invalidate()


def test_eikonal_table_calibration(engines, caplog):
    """tests/test_invert.py:308's check on the port: the table budgets come
    from the host tables (ntmax below the rigorous bound), and a too-tight
    calibration is caught by the deferred overflow guard one batch later."""
    te = engines[1]
    batch = _eik_session(te)
    te.eikonal_device = True
    te._eikonal_checked_keys.clear()
    te._eik_calib.clear()
    te._eik_pending.clear()
    _cb, *_rest, gsize = te._discretize_batch(batch)
    (ckey, calib), = te._eik_calib.items()
    ntmax, _budget, ntmax_hard = calib
    assert ntmax < ntmax_hard, "calibration should beat the hard bound here"
    assert gsize == ntmax
    assert len(te._eik_pending) == 1
    te._check_eik_overflow()  # on the CPU the counter is ready at once
    assert not te._eik_pending
    assert te._eik_calib[ckey] == calib, "overflow guard fired wrongly"

    te._eik_calib[ckey] = (1, 8, ntmax_hard)
    te._invalidate()
    te._discretize_batch(batch)
    with caplog.at_level(logging.WARNING):
        te._check_eik_overflow(force=True)
    assert te._eik_calib[ckey] == (ntmax_hard, None, ntmax_hard)
    assert any("overflow" in r.message for r in caplog.records)
    te._invalidate()


def test_time_domain_sweep_on_a_point_source(engines):
    """The time-domain norms serve the other sources too: a point-source
    strike sweep under l1norm through sweep_global_misfits (the batch path)
    matches the JAX package's."""
    base = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0, 2500.0, 0.2],
                    dtype=np.float32)
    strikes = np.linspace(61.0, 121.0, 7).astype(np.float32)
    out = []
    for eng in engines:
        eng.set_misfit_method("l1norm")
        eng.set_floating_shiftrange(0.0, 0.0)
        eng.set_source_params("bilateral", base)
        eng.set_synthetic_reference()
        out.append(np.asarray(eng.sweep_global_misfits(base, 5, strikes)))
    np.testing.assert_allclose(out[1], out[0], rtol=2e-5, atol=1e-6)
    assert np.argmin(out[1]) == 3
