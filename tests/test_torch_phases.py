"""The port's phases module against kiwi_tpu.phases: its table files are a
byte-identical copy, every table gives the same travel times at seeded
distances and depths, Timing chains and Tapers give the same control
points, and apply_taper_to_engine sets the same tapers and enabled flags on
a port engine as on a JAX engine (tests/test_phases.py's session)."""

import filecmp
import os

import numpy as np
import pytest

from kiwi_tpu import geo
from kiwi_tpu import phases as jph
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu_torch import phases as tph
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore

TABLES = sorted(os.listdir(jph.DATA_DIR))


def test_twelve_tables_copied():
    assert len(TABLES) == 12
    assert sorted(os.listdir(tph.DATA_DIR)) == TABLES
    assert os.path.realpath(tph.DATA_DIR) != os.path.realpath(jph.DATA_DIR)


@pytest.mark.parametrize("name", TABLES)
def test_table_byte_identical(name):
    assert filecmp.cmp(os.path.join(jph.DATA_DIR, name), os.path.join(tph.DATA_DIR, name),
                       shallow=False)


@pytest.mark.parametrize("name", TABLES)
def test_phase_equal(name):
    """Seeded distances across and beyond the table's range (None outside it)
    and seeded depths; the port's lookups equal the reference's exactly."""
    jp, tp = jph.Phase(name), tph.Phase(name)
    assert tp.have_depth == jp.have_depth
    assert tp.filename == os.path.join(tph.DATA_DIR, name)
    rng = np.random.default_rng(sum(map(ord, name)))
    lo, hi = float(jp._dists[0]), float(jp._dists[-1])
    span = hi - lo
    dists = np.concatenate([rng.uniform(lo - 0.1 * span, hi + 0.1 * span, 48),
                            jp._dists[:: max(1, len(jp._dists) // 8)], [lo, hi]])
    depths = rng.uniform(0.0, 700e3, dists.size)
    n_avail = 0
    for d, z in zip(dists, depths):
        want = jp(d, z)
        assert tp(d, z) == want
        assert tp(d) == jp(d)
        n_avail += want is not None
    assert n_avail > 0


def test_timing_and_taper_equal():
    rng = np.random.default_rng(7)
    jt = jph.Timing(["S", "Sn"], -10.0)
    tt = tph.Timing(["S", "Sn"], -10.0)
    jtap = jph.Taper(phases=("P", "S"), offsets=[-10.0, 0.0, 40.0, 50.0])
    ttap = tph.Taper(phases=("P", "S"), offsets=[-10.0, 0.0, 40.0, 50.0])
    jtap2 = jph.Taper(timings=[jph.Timing("begin", o) for o in (0.0, 5.0, 60.0, 80.0)],
                      amplitudes=[0.0, 1.0, 0.5, 0.0])
    ttap2 = tph.Taper(timings=[tph.Timing("begin", o) for o in (0.0, 5.0, 60.0, 80.0)],
                      amplitudes=[0.0, 1.0, 0.5, 0.0])
    for d, z in zip(rng.uniform(0.0, 2e7, 64), rng.uniform(0.0, 6e5, 64)):
        assert tt(d, z) == jt(d, z)
        assert ttap(d, z) == jtap(d, z)
        assert ttap2(d, z) == jtap2(d, z)
    with pytest.raises(ValueError):
        tph.Taper(timings=[tt, tt])


@pytest.fixture(scope="module")
def engines():
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return JEngine(store), TEngine(tstore, device="cpu")


@pytest.mark.parametrize("phases,offsets,depth,enabled", [
    (("begin",), (0.0, 0.5, 3.0, 3.5), 400.0, True),
    (("P", "begin"), (-1.0, 0.0, 2.0, 3.0), 400.0, True),  # P is out: falls back
    (("end",), (-4.0, -3.0, 0.0, 1.0), 12000.0, True),
    (("P",), (-1.0, 0.0, 2.0, 3.0), 400.0, False),  # P's rows start at 1,112 km
])
def test_apply_taper_to_engine_equal(engines, phases, offsets, depth, enabled):
    """Receivers at 1.5-3.1 km: the same taper control points per rc row and
    the same enabled flags (a receiver outside the table is switched off)."""
    p = np.array([0.0, 0.0, 0.0, depth, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0,
                  2500.0, 0.2], np.float32)
    olat, olon = 30.0, 70.0
    for eng, rec, ph in ((engines[0], JReceiver, jph), (engines[1], TReceiver, tph)):
        recs = []
        for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0)]:
            la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon),
                                      d * np.cos(az), d * np.sin(az))
            recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
        eng.set_receivers(recs)
        eng.set_source_location(olat, olon, 0.0)
        eng._tapers = {}
        eng.set_source_params("bilateral", p)
        ph.apply_taper_to_engine(eng, ph.Taper(phases=phases, offsets=list(offsets)))
    je, te = engines
    assert [r.enabled for r in te.receivers] == [r.enabled for r in je.receivers]
    assert sorted(te._tapers) == sorted(je._tapers)
    for irc, plf in je._tapers.items():
        np.testing.assert_array_equal(np.asarray(te._tapers[irc].x), np.asarray(plf.x))
        np.testing.assert_array_equal(np.asarray(te._tapers[irc].y), np.asarray(plf.y))
    assert [r.enabled for r in te.receivers] == [enabled] * 3
    assert len(te._tapers) == (9 if enabled else 0)
