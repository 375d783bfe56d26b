"""The port's host-side data preparation against kiwi_tpu: geo (float64
numpy against jnp under x64, 1e-12 relative), save_dataset ->
standard_setup round trips (the same tables, decoded samples, receivers
and itmins from both packages), the shift rounding of standard_setup at
exactly half a sample (fnint: half away from zero), and
prepare.save_kiwi_dataset (tests/test_tools_dataset.py's scenario) writing
the same files as the reference's."""

import filecmp
import os

import numpy as np
import pytest

from kiwi_tpu import dataset as jds, geo as jgeo, prepare as jprep
from kiwi_tpu.cli.autokiwi import Event as JEvent
from kiwi_tpu.config import Config as JConfig
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu.gf.trace import fnint
from kiwi_tpu.io import readseismogram as jread
from kiwi_tpu_torch import dataset as tds, geo as tgeo, prepare as tprep
from kiwi_tpu_torch.cli.autokiwi import Event as TEvent
from kiwi_tpu_torch.config import Config as TConfig
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.io import readseismogram as tread

TRUE = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                 2500.0, 0.2], np.float32)


def _points(n=64, seed=0):
    """Seeded lat/lon pairs in radians, with a few coincident, antipodal-ish
    and polar ones."""
    rng = np.random.default_rng(seed)
    alat = rng.uniform(-np.pi / 2, np.pi / 2, n)
    alon = rng.uniform(-np.pi, np.pi, n)
    blat = rng.uniform(-np.pi / 2, np.pi / 2, n)
    blon = rng.uniform(-np.pi, np.pi, n)
    blat[:3], blon[:3] = alat[:3] + 1e-4, alon[:3] - 2e-4  # near neighbours
    blat[3], blon[3] = -alat[3], alon[3] + np.pi * 0.999
    return alat, alon, blat, blon


def _close(got, want, rtol=1e-12):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w, np.float64)
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["cosdelta", "azimuth", "azibazi", "arcdistance", "distance",
                                  "distance_accurate50m", "azidist"])
def test_geo_pairs(name):
    args = _points()
    _close(getattr(tgeo, name)(*args), getattr(jgeo, name)(*args))


def test_geo_differential_and_units():
    rng = np.random.default_rng(1)
    n = 64
    dx, dy = rng.normal(0, 5000.0, n), rng.normal(0, 5000.0, n)
    dx[:2], dy[:2] = 0.0, 0.0  # the r == 0 branch
    azi, bazi = rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n)
    dist = rng.uniform(1e3, 5e6, n)
    _close(tgeo.approx_differential_azidist(dx, dy, azi, bazi, dist),
           jgeo.approx_differential_azidist(dx, dy, azi, bazi, dist))
    x = rng.uniform(-1000.0, 1000.0, n)
    _close(tgeo.wrap(x, -np.pi, np.pi), jgeo.wrap(x, -np.pi, np.pi))
    _close(tgeo.d2r(x), jgeo.d2r(x))
    _close(tgeo.r2d(x), jgeo.r2d(x))
    la, lo = tgeo.ne_to_latlon(0.5, 1.2, dx, dy)
    _close((la, lo), jgeo.ne_to_latlon(0.5, 1.2, dx, dy))


@pytest.fixture(scope="module")
def stores():
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0),
        stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64),
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return store, tstore


def _session(eng, rec, depth=0.0, name=""):
    """tests/test_pipeline.py's 3 receivers, its own synthetic as the reference."""
    olat, olon = 30.0, 70.0
    recs = []
    for i, (d, az) in enumerate([(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0)]):
        la, lo = jgeo.ne_to_latlon(np.radians(olat), np.radians(olon), d * np.cos(az),
                                   d * np.sin(az))
        recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned", depth=depth,
                        name=f"{name}{i}" if name else ""))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 12.5)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_params("bilateral", TRUE)
    eng.set_misfit_method("l2norm")
    eng.set_synthetic_reference()
    return eng


@pytest.mark.parametrize("fmt,rich", [("mseed", False), ("table", False), ("sac", True)])
def test_save_dataset_standard_setup_round_trip(stores, tmp_path, fmt, rich):
    """Each package saves its engine's references; both tables agree byte for
    byte and the samples within 1e-5 of their largest; then both packages'
    standard_setup read the JAX package's directory to the same receivers,
    reference samples and itmins."""
    store, tstore = stores
    kw = dict(depth=250.0, name="st") if rich else {}
    je = _session(JEngine(store), JReceiver, **kw)
    te = _session(TEngine(tstore, device="cpu"), TReceiver, **kw)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jds.save_dataset(jdir, je, fmt=fmt)
    tds.save_dataset(tdir, te, fmt=fmt)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert len(os.listdir(jdir)) == 2 + 9
    for fn in ("source-origin.table", "receivers.table"):
        assert filecmp.cmp(os.path.join(jdir, fn), os.path.join(tdir, fn), shallow=False)
    for fn in os.listdir(jdir):
        if fn.startswith("reference-"):
            (a, ta, da), (b, tb, db) = jread(os.path.join(jdir, fn)), tread(os.path.join(tdir, fn))
            assert a.shape == b.shape and ta == tb and da == db
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * float(np.abs(a).max()))

    jl = jds.standard_setup(jdir, store, effective_dt=0.1, ref_seismogram_format=fmt)
    tl = tds.standard_setup(jdir, tstore, effective_dt=0.1, ref_seismogram_format=fmt,
                            device="cpu")
    assert tl.device.type == "cpu" and tl.ref_time == jl.ref_time == 12.5
    assert [(r.lat_deg, r.lon_deg, r.components, r.depth, r.name, r.enabled)
            for r in tl.receivers] == [(r.lat_deg, r.lon_deg, r.components, r.depth, r.name,
                                        r.enabled) for r in jl.receivers]
    assert sorted(tl._refs) == sorted(jl._refs) == list(range(9))
    for irc, (v, it) in jl._refs.items():
        assert tl._refs[irc][1] == it
        np.testing.assert_array_equal(tl._refs[irc][0], v)
    # the port reads back what it saved (the table format keeps 1e-6)
    back = tds.standard_setup(tdir, tstore, effective_dt=0.1, ref_seismogram_format=fmt,
                              device="cpu")
    for irc, (v, it) in te._refs.items():
        assert back._refs[irc][1] == it
        np.testing.assert_allclose(back._refs[irc][0], v, rtol=0,
                                   atol=1e-6 * float(np.abs(v).max()) if fmt == "table" else 0)


def test_save_dataset_synthetics(stores, tmp_path):
    """which="synthetics" writes each package's current synthetics under the
    synthetic- stem: the same files, samples within 1e-5 of their largest."""
    store, tstore = stores
    je = _session(JEngine(store), JReceiver)
    te = _session(TEngine(tstore, device="cpu"), TReceiver)
    for eng in (je, te):
        p = TRUE.copy()
        p[5] += 20.0
        eng.set_source_params("bilateral", p)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jds.save_dataset(jdir, je, which="synthetics", fmt="table")
    tds.save_dataset(tdir, te, which="synthetics", fmt="table")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert len([n for n in names if n.startswith("synthetic-")]) == 9
    for fn in names:
        if fn.startswith("synthetic-"):
            (a, ta, _da), (b, tb, _db) = jread(os.path.join(jdir, fn)), tread(os.path.join(tdir, fn))
            assert a.shape == b.shape and ta == tb
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * float(np.abs(a).max()))


def test_standard_setup_options_and_half_sample_shifts(stores, tmp_path):
    """shifts of exactly +-0.5 and 2.5 samples round half away from zero
    (fnint; torch.round would give 0, 0, 2), a blacklist, the undersampling
    and a store given by path, in both packages."""
    store, tstore = stores
    je = _session(JEngine(store), JReceiver)
    datadir = str(tmp_path / "d")
    jds.save_dataset(datadir, je)
    dbfile = str(tmp_path / "db.npz")
    store.save(dbfile)
    dt32 = np.float32(store.dt)
    shifts = [float(dt32 * np.float32(0.5)), float(dt32 * np.float32(-0.5)),
              float(dt32 * np.float32(2.5))]
    ratios = [np.float32(s) / dt32 for s in shifts]
    assert ratios[:2] == [0.5, -0.5] and abs(ratios[2] - 2.5) < 1e-6
    kw = dict(effective_dt=0.1, shifts=shifts, blacklist=[1], spacial_undersampling=(2, 1))
    jl = jds.standard_setup(datadir, dbfile, **kw)
    tl = tds.standard_setup(datadir, dbfile, device="cpu", **kw)
    assert isinstance(tl.store, TStore)
    assert (tl.xunder, tl.zunder) == (jl.xunder, jl.zunder) == (2, 1)
    assert [r.enabled for r in tl.receivers] == [r.enabled for r in jl.receivers] \
        == [True, False, True]
    base = {irc: it for irc, (_v, it) in je._refs.items()}
    want = [int(fnint(r)) for r in ratios]
    assert want[:2] == [1, -1]
    for irc, (_v, it) in jl._refs.items():
        assert tl._refs[irc][1] == it == base[irc] + want[irc // 3]


def test_standard_setup_defaults_to_the_card(stores, tmp_path):
    """No device argument means the card: without one, the engine's first
    computation raises instead of falling back to the CPU."""
    import torch

    store, tstore = stores
    datadir = str(tmp_path / "d")
    jds.save_dataset(datadir, _session(JEngine(store), JReceiver))
    eng = tds.standard_setup(datadir, tstore, effective_dt=0.1)
    assert eng.device.type == "cuda"
    if not torch.cuda.is_available():
        eng.set_source_params("bilateral", TRUE)
        with pytest.raises((AssertionError, RuntimeError)):
            eng.get_global_misfit()


def _prepare_inputs(pkg, seed=3):
    """tests/test_tools_dataset.py::test_prepare_kiwi_dataset's stations and
    traces through `pkg`'s prepare module."""
    prep, event_cls = pkg
    olat, olon = 30.0, 70.0
    ev = event_cls(name="ev-test", time=1000000.0, lat=olat, lon=olon, depth=400.0,
                   magnitude=5.0, region="here")
    stations, traces = [], []
    rng = np.random.default_rng(seed)
    for i, d in enumerate((2600.0, 1500.0)):
        la, lo = jgeo.ne_to_latlon(np.radians(olat), np.radians(olon), d, 0.2)
        stations.append(prep.Station("XX", f"S{i}", "", np.degrees(float(la)),
                                     np.degrees(float(lo))))
        y1 = rng.normal(size=40).astype(np.float32)
        y2 = rng.normal(size=40).astype(np.float32)
        y1[-1] = y2[-1] = 0
        t1 = prep.RawTrace("XX", f"S{i}", "", "BH1", ev.time + 2.0, 0.1, y1)
        t2 = prep.RawTrace("XX", f"S{i}", "", "BH2", ev.time + 2.0, 0.1, y2)
        n, e = prep.rotate_to_ned(t1, t2, 30.0, 120.0)
        n.channel, e.channel = "BHN", "BHE"
        z = prep.RawTrace("XX", f"S{i}", "", "BHZ", ev.time + 2.0, 0.1,
                          rng.normal(size=40).astype(np.float32))
        z.ydata[-1] = 0
        traces += [n, e, z]
    return stations, traces, ev


def _prepare_config(cfg_cls, ddir, time_zero):
    return cfg_cls(
        wanted_channels=["BHN", "BHE", "BHZ"],
        kiwi_component_map={"BHN": "n", "BHE": "e", "BHZ": "d"},
        trace_time_zero=time_zero, trace_factor=2.0, nsets=1,
        receivers_path=os.path.join(ddir, "receivers.table"),
        displacement_trace_path=os.path.join(ddir, "reference-%(ireceiver)i-%(component)s.mseed"),
        source_origin_path=os.path.join(ddir, "source-origin.table"),
        reference_time_path=os.path.join(ddir, "reference-time.txt"),
        event_info_path=os.path.join(ddir, "event.txt"),
        stations_path=os.path.join(ddir, "stations.txt"),
    )


@pytest.mark.parametrize("time_zero", ["event", "system"])
def test_save_kiwi_dataset_same_files(stores, tmp_path, time_zero):
    """Both packages' prepare.save_kiwi_dataset on the same stations and
    traces write the same files, byte for byte; the port's standard_setup
    loads the result (stations sorted by distance, components sorted)."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    sj, trj, evj = _prepare_inputs((jprep, JEvent))
    st, trt, evt = _prepare_inputs((tprep, TEvent))
    for a, b in zip(trj, trt):
        np.testing.assert_array_equal(b.ydata, a.ydata)
    nj = jprep.save_kiwi_dataset(sj, trj, evj, _prepare_config(JConfig, jdir, time_zero))
    nt = tprep.save_kiwi_dataset(st, trt, evt, _prepare_config(TConfig, tdir, time_zero))
    assert nj == nt == 2
    assert [s.dist_m for s in st] == [s.dist_m for s in sj]
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(tdir)) and len(files) == 5 + 6
    for fn in files:
        assert filecmp.cmp(os.path.join(jdir, fn), os.path.join(tdir, fn), shallow=False), fn
    row = open(os.path.join(tdir, "receivers.table")).read().splitlines()[0].split()
    assert row[3] == "end" and row[4] == "XX.S1."
    if time_zero == "event":
        eng = tds.standard_setup(tdir, stores[1], effective_dt=0.1, device="cpu")
        assert len(eng.receivers) == 2 and len(eng._refs) == 6
        assert {it for _v, it in eng._refs.values()} == {20}  # event + 2 s at 0.1 s
