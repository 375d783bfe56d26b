"""Parity of the port's synthesis pieces (kiwi_tpu_torch.synth, sources,
gf) with the JAX package on the 40x6 fullspace store of
tests/test_fused_scan.py.

Integer outputs (GF node indices, integer shifts, spans, window config)
must match exactly.  Float outputs use rtol 1e-6 (with an absolute floor
at 1e-6 of each array's max): both sides compute in float32 in the same
operation order, but XLA's and torch's CPU kernels for sin/cos/atan2/sqrt
may differ in the last ulp, and f32 ulp is 6e-8.  The one exception is what
the bilinear weights inherit from the centroid distance: wsp is
(dist - node)/dx, so one ulp of a float32 distance (2.4e-4 m at 2.4 km)
moves it by 2.4e-6 absolute -- those compare at 2 ulp(dist)/dx, and the
blended values rows at twice that times the GF amplitude.
"""

import jax
import numpy as np
import pytest
import torch

from kiwi_tpu import geo as jgeo
from kiwi_tpu import synth as js
from kiwi_tpu.gf import elseis as jelseis
from kiwi_tpu.gf.store import GFStore as JStore
from kiwi_tpu.gf.trace import jnint as jjnint
from kiwi_tpu.sources import bilat as jbilat
from kiwi_tpu_torch import synth as ts
from kiwi_tpu_torch.gf import elseis as telseis
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.gf.trace import fnint, jnint
from kiwi_tpu_torch.sources import bilat as tbilat

STF = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
EDT = 0.1


def _close(got, want, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    floor = max(1e-6 * max(float(np.abs(want).max()), 1e-30), atol)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=floor)


def _exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def world():
    jstore = jelseis.build_ahfull_store(
        nx=40, nz=6, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=STF,
    )
    tstore = TStore.from_numpy(jstore.dt, jstore.dx, jstore.dz, jstore.firstx,
                               jstore.firstz, jstore.data, jstore.itmin, jstore.nsamples)
    olat, olon = np.radians(30.0), np.radians(70.0)
    lats, lons = [], []
    for i in range(4):
        la, lo = jgeo.ne_to_latlon(olat, olon, 1200.0 + 400.0 * i, 0.3 * i)
        lats.append(float(la))
        lons.append(float(lo))
    jgeom = js.precompute_receiver_geometry(olat, olon, lats, lons)
    tgeom = ts.precompute_receiver_geometry(olat, olon, lats, lons)
    # a point source and a small finite fault (several cells and time cells)
    p_point = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0,
                        0.0, 0.0, 0.0, 2500.0, 0.2], np.float32)
    p_fault = np.array([0.3, 120.0, -80.0, 350.0, 1e12, 40.0, 60.0, 110.0, 20.0,
                        300.0, 150.0, 200.0, 2500.0, 0.25], np.float32)
    return jstore, tstore, jgeom, tgeom, p_point, p_fault


def _cfg(store, geom, pb, mod):
    ext, d, t = jbilat.param_stats(pb, EDT)
    return mod.plan_config(store, geom, ext * 1.1 + 400.0, (d[0] - 200.0, d[1] + 200.0),
                           (t[0] - 0.8, t[1] + 0.8), interpolate=True)


def test_rounding_half_away_from_zero():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 2.4999, -0.49], np.float32)
    want = np.array([-3, -2, -1, 1, 2, 3, 2, 0])
    _exact(jnint(torch.as_tensor(x)), want)
    _exact(jnint(torch.as_tensor(x)), np.asarray(jjnint(jax.numpy.asarray(x))))
    _exact(fnint(x), want)
    assert jnint(torch.as_tensor(x)).dtype == torch.int32


def test_store_roundtrips_between_packages(world, tmp_path):
    jstore, tstore, *_ = world
    tstore.save(tmp_path / "t.npz")
    back = JStore.load(tmp_path / "t.npz")
    jstore.save(tmp_path / "j.npz")
    fwd = TStore.load(tmp_path / "j.npz")
    for a, b in ((back, jstore), (fwd, tstore)):
        assert (a.dt, a.dx, a.dz, a.firstx, a.firstz) == (b.dt, b.dx, b.dz, b.firstx, b.firstz)
        for k in ("data", "itmin", "nsamples"):
            _exact(getattr(a, k), getattr(b, k))
    # the port's carried elseis builds the same store
    rebuilt = telseis.build_ahfull_store(
        nx=40, nz=6, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=STF)
    for k in ("data", "itmin", "nsamples"):
        _exact(getattr(rebuilt, k), getattr(jstore, k))


@pytest.mark.parametrize("which", ["point", "fault"])
def test_discretize_matches(world, which):
    *_, p_point, p_fault = world
    p = p_point if which == "point" else p_fault
    pb = np.tile(p, (5, 1))
    pb[:, 5] = np.linspace(0.0, 300.0, 5)
    pb[:, 7] = np.linspace(100.0, 180.0, 5)
    shape = jbilat.grid_shape(p, EDT)
    assert tbilat.grid_shape(p, EDT) == shape
    want = jax.jit(jax.vmap(lambda q: jbilat.discretize(q, EDT, shape)))(jax.numpy.asarray(pb))
    got = tbilat.discretize(torch.as_tensor(pb), EDT, shape)
    for k in ("north", "east", "depth", "time", "m"):
        assert got[k].dtype == torch.float32
        _close(got[k], want[k])
    _exact(got["active"], want["active"])


@pytest.mark.parametrize("which", ["point", "fault"])
def test_kinematics_values_spans_match(world, which):
    jstore, tstore, jgeom, tgeom, p_point, p_fault = world
    p = p_point if which == "point" else p_fault
    for k in ("azi", "bazi", "dist", "sin_b", "cos_b"):
        _exact(getattr(tgeom, k), getattr(jgeom, k))
    cfg_j = _cfg(jstore, jgeom, p[None], js)
    cfg = _cfg(tstore, tgeom, p[None], ts)
    assert dataclass_fields(cfg) == dataclass_fields(cfg_j)

    shape = jbilat.grid_shape(p, EDT)
    cent_j = jbilat.discretize(jax.numpy.asarray(p), EDT, shape)
    cent = {k: v[0] for k, v in tbilat.discretize(torch.as_tensor(p[None]), EDT, shape).items()}
    recs_j = jgeom.device()
    recs = tgeom.to("cpu")

    kin_j = jax.jit(jax.vmap(lambda rec: js._centroid_kinematics(cfg_j, rec, cent_j)))(recs_j)
    kin = ts._centroid_kinematics(cfg, recs, cent)
    for k in ("ixs", "izs", "ish", "valid"):
        _exact(kin[k], kin_j[k])
    for k in ("wg", "frac", "sin_az", "cos_az", "sin_l", "cos_l"):
        assert kin[k].dtype == torch.float32
        _close(kin[k], kin_j[k])
    # one f32 ulp of the centroid distance, over the node spacing
    dist_tol = 2 * float(np.spacing(np.float32(tgeom.dist.max() + 1000.0))) / cfg.dx
    _close(kin["wsp"], kin_j["wsp"], atol=dist_tol)

    gfd_j, gfi_j = js.window_arrays(jstore, cfg_j)
    gfd, gfi, gfn = ts.window_arrays(tstore, cfg, "cpu")
    ext_j = jax.jit(js.materialize_window, static_argnums=2)(gfd_j, gfi_j, cfg_j)
    ext = ts.materialize_window(gfd, gfi, cfg)
    _exact(ext, ext_j)  # a pure gather: bit-identical

    g = shape[-1]
    v_j = jax.jit(jax.vmap(lambda k: js.values_matrix(ext_j, cfg_j, k, group_size=g)))(kin_j)
    v = ts.values_matrix(ext, cfg, kin, group_size=g)
    _close(v, v_j, atol=2 * dist_tol * float(ext.abs().max()))

    sl = np.s_[cfg.ix0:cfg.ix0 + cfg.nxw, cfg.iz0:cfg.iz0 + cfg.nzw]
    gfn_j = jax.numpy.asarray(jstore.nsamples[sl])
    lo_j, hi_j = jax.jit(jax.vmap(lambda k: js.physical_spans(gfi_j, gfn_j, cfg_j, k)))(kin_j)
    lo, hi = ts.physical_spans(gfi, gfn, cfg, kin)
    _exact(lo, lo_j)
    _exact(hi, hi_j)

    # per-model weights for a batch of new moment tensors on fixed kinematics
    rng = np.random.default_rng(5)
    mb = rng.standard_normal((7,) + cent_j["m"].shape).astype(np.float32)
    wv_j = jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda m6: js.weights_from_angles(k, m6, cfg_j.ng))(jax.numpy.asarray(mb))))(kin_j)
    angles = {k: kin[k][:, None, :] for k in ("sin_az", "cos_az", "sin_l", "cos_l")}
    wv = ts.weights_from_angles(angles, torch.as_tensor(mb), cfg.ng)
    _close(wv, wv_j)


def test_components_match(world):
    *_, jgeom, tgeom, _p, _q = world
    rng = np.random.default_rng(2)
    ard = rng.standard_normal((3, 20)).astype(np.float32)
    ids = tuple(ts.COMPONENT_IDS[c] for c in "nedscw")
    assert ts.COMPONENT_IDS == js.COMPONENT_IDS
    for i in range(len(jgeom.bazi)):
        want = js.ard_to_components(jax.numpy.asarray(ard), jax.numpy.asarray(jgeom.bazi[i]), ids)
        got = ts.ard_to_components(torch.as_tensor(ard), torch.as_tensor(tgeom.bazi[i]), ids)
        _close(got, want)


def dataclass_fields(cfg):
    import dataclasses

    return dataclasses.astuple(cfg)
