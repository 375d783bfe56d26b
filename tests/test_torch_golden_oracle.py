"""Cross-language golden parity: the port's engine vs the C++ oracle.

benchmark/fortran_denominator.cc is a line-faithful transliteration of the
reference's scalar hot loop (seismogram.f90 + sparse_trace.f90 +
receiver.f90 + comparator.f90 norm/taper/filter semantics), independent of
both Python packages.  This test compiles it and replays the committed
sources of tests/test_golden_oracle.py -- bilateral point and finite
sources, plain, tapered, filtered and tapered+filtered, and eikonal
ruptures through the host FMM -- through kiwi_tpu_torch's Engine on the
CPU, against the oracle's dump, at that test's bars: traces within 2e-5
(eikonal 5e-5) of their max, misfits and norms within 1e-5 relative (1e-4
on tapered, filtered and eikonal rows), floating shifts exactly.

It imports neither jax nor kiwi_tpu (the blob writer,
benchmark/prep_denominator.py, needs numpy only), so it also runs where
JAX is not installed (`pytest --noconftest`).  Requires g++; skipped when
unavailable.
"""

import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from kiwi_tpu_torch import geo, synth
from kiwi_tpu_torch.engine import Engine, Receiver
from kiwi_tpu_torch.gf import elseis
from kiwi_tpu_torch.sources import eikonal as eiksrc

HERE = os.path.dirname(os.path.abspath(__file__))
CC = os.path.join(HERE, "..", "benchmark", "fortran_denominator.cc")
sys.path.insert(0, os.path.join(HERE, "..", "benchmark"))
from prep_denominator import write_blob  # noqa: E402

# the committed sources of tests/test_golden_oracle.py (copied: importing
# that module would import jax)
REF = np.array(
    [0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0,
     2500.0, 0.2], np.float32)
DUMPS = [
    np.array([0.0, 0.0, 0.0, 400.0, 1e12, 121.0, 87.0, 164.0, 0.0, 0.0,
              0.0, 0.0, 2500.0, 0.2], np.float32),
    np.array([0.2, 50.0, -80.0, 430.0, 8e11, 91.0, 70.0, 120.0, 0.0, 0.0,
              0.0, 0.0, 2500.0, 0.2], np.float32),
    np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0,
              200.0, 250.0, 2500.0, 0.2], np.float32),
    np.array([-0.1, 0.0, 0.0, 420.0, 1e12, 40.0, 60.0, 164.0, 30.0, 300.0,
              200.0, 250.0, 2200.0, 0.3], np.float32),
]
SHIFTRANGE = (-0.3, 0.3)  # 7-shift scan at dt 0.1
TAPER_X = (0.5, 1.5, 6.0, 9.0)
TAPER_Y = (0.0, 1.0, 1.0, 0.0)
FILTER_X = (0.0, 0.3, 2.5, 4.0)
FILTER_Y = (0.0, 1.0, 1.0, 0.0)
EIK_REF = np.array(
    [0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0,
     0.0, 0.0, 250.0, 50.0, -50.0, 0.9, 0.0], np.float32)
EIK_DUMPS = [
    np.array([0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0,
              0.0, 0.0, 300.0, 50.0, -50.0, 0.9, 0.0], np.float32),
    np.array([0.1, 0.0, 0.0, 420.0, 8e11, 45.0, 70.0, 164.0,
              20.0, -30.0, 260.0, 0.0, 0.0, 0.8, 0.0], np.float32),
    np.array([-0.1, 30.0, -40.0, 410.0, 1e12, 30.0, 80.0, 120.0,
              0.0, 0.0, 250.0, -60.0, 40.0, 1.0, 0.0], np.float32),
]
EIK_CONSTRAINTS = ([[0, 0, 50.0], [0, 0, 700.0]],
                   [[0, 0, -1.0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def store():
    return elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0),
        stf=np.array([0, 0, 0, 0.2, 0.5, 0.8, 1, 1, 1], dtype=np.float64),
    )


@pytest.fixture(scope="module")
def oracle_bin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available")
    out = str(tmp_path_factory.mktemp("oracle") / "fden")
    subprocess.run([gxx, "-O3", "-o", out, CC], check=True)
    return out


def make_engine(store, taper, filt=False):
    olat, olon = 30.0, 70.0
    eng = Engine(store, device="cpu")
    recs, rlat, rlon = [], [], []
    for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0)]:
        la, lo = geo.ne_to_latlon(
            np.radians(olat), np.radians(olon), d * np.cos(az), d * np.sin(az))
        rlat.append(float(la))
        rlon.append(float(lo))
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    if taper:
        eng.set_misfit_taper(0, TAPER_X, TAPER_Y)
    if filt:
        eng.set_misfit_filter(1, FILTER_X, FILTER_Y)
        # spectral-filter weights live on the k/(pl*dt) grid: pin the probe
        # length to the oracle's
        eng.min_probe_length = 256
    g = synth.precompute_receiver_geometry(
        np.radians(olat), np.radians(olon), np.asarray(rlat), np.asarray(rlon))
    return eng, (np.asarray(g.azi), np.asarray(g.bazi), np.asarray(g.dist))


def run_oracle(oracle_bin, tmp, store, geom, workload, tapers=(), filters=()):
    blob = os.path.join(tmp, "blob.bin")
    dump = os.path.join(tmp, "dump.bin")
    write_blob(blob, store, geom, nshift=7, tapers=tapers, filters=filters,
               workload=workload)
    subprocess.run([oracle_bin, blob, "0", "--dump", dump], check=True,
                   stdout=subprocess.DEVNULL)
    return _read_dump(dump)


def _read_dump(dump):
    with open(dump, "rb") as f:
        R, ncomp, pl, ps0, nmod = struct.unpack("<5i", f.read(20))
        (dt,) = struct.unpack("<f", f.read(4))
        nrc = R * ncomp
        ref = np.frombuffer(f.read(4 * nrc * pl), "<f4").reshape(nrc, pl)
        ref_lo = np.frombuffer(f.read(4 * nrc), "<i4")
        ref_hi = np.frombuffer(f.read(4 * nrc), "<i4")
        models = []
        for _ in range(nmod):
            syn = np.frombuffer(f.read(4 * nrc * pl), "<f4").reshape(nrc, pl)
            syn_lo = np.frombuffer(f.read(4 * nrc), "<i4")
            syn_hi = np.frombuffer(f.read(4 * nrc), "<i4")
            m1 = np.frombuffer(f.read(8 * nrc), "<f8")
            n1 = np.frombuffer(f.read(8 * nrc), "<f8")
            m2 = np.frombuffer(f.read(8 * nrc), "<f8")
            n2 = np.frombuffer(f.read(8 * nrc), "<f8")
            fs = np.frombuffer(f.read(4 * R), "<i4")
            models.append((syn, syn_lo, syn_hi, m1, n1, m2, n2, fs))
    return dict(R=R, pl=pl, ps0=ps0, dt=dt, ref=ref, ref_lo=ref_lo,
                ref_hi=ref_hi, models=models)


def check_traces(eng, rows, ps0, atol, label):
    """The engine's trimmed synthetic traces against the oracle's probes."""
    for irc, (values, itmin) in enumerate(eng.get_synthetic_seismograms()):
        row = rows[irc]
        want = row[itmin - ps0 : itmin - ps0 + len(values)]
        np.testing.assert_allclose(values, want, atol=atol * max(np.abs(row).max(), 1e-30),
                                   err_msg=f"{label} trace rc={irc}")


def check_models(eng, source_type, dumps, gold, rtol, trace_atol, label):
    """Per model: traces, floating_l1norm misfits, norms and shifts, then
    l2norm misfits and norms without a floating shift."""
    ps0 = gold["ps0"]
    for k, p in enumerate(dumps):
        syn, _lo, _hi, m1, n1, m2, n2, fs = gold["models"][k]
        eng.set_source_params(source_type, p)
        check_traces(eng, syn, ps0, trace_atol, f"{label} model {k}")

        eng.set_misfit_method("floating_l1norm")
        m, n, fshift = eng.get_misfits()
        np.testing.assert_allclose(m, m1, rtol=rtol, atol=1e-5 * max(np.abs(m1).max(), 1e-30),
                                   err_msg=f"{label} model {k} floating_l1 misfits")
        np.testing.assert_allclose(n, n1, rtol=rtol,
                                   err_msg=f"{label} model {k} floating_l1 norms")
        np.testing.assert_array_equal(fshift, fs, err_msg=f"{label} model {k} floating shifts")
        np.testing.assert_array_equal(eng.get_floating_shifts(), fs * eng.store.dt)

        eng.set_misfit_method("l2norm")
        eng.set_floating_shiftrange(0.0, 0.0)
        m, n, _ = eng.get_misfits()
        np.testing.assert_allclose(m, m2, rtol=rtol, atol=1e-5 * max(np.abs(m2).max(), 1e-30),
                                   err_msg=f"{label} model {k} l2 misfits")
        np.testing.assert_allclose(n, n2, rtol=rtol, err_msg=f"{label} model {k} l2 norms")
        eng.set_floating_shiftrange(*SHIFTRANGE)


@pytest.mark.parametrize(
    "taper,filt",
    [(False, False), (True, False), (False, True), (True, True)],
    ids=["plain", "tapered", "filtered", "tapered+filtered"])
def test_engine_matches_cpp_oracle(store, oracle_bin, tmp_path, taper, filt):
    """Bilateral sources (two point, two finite; mixed grid shapes, so one
    model at a time) vs the oracle.  The filtered cases carry a band-pass on
    receiver 1's rows, which the oracle evaluates with its own float64
    radix-2 FFT."""
    eng, geom = make_engine(store, taper, filt)
    gold = run_oracle(
        oracle_bin, str(tmp_path), store, geom,
        {"kind": "bilat", "edt": 0.1, "ref_params": REF, "nsweep": 0, "dump_params": DUMPS},
        tapers=[(comp, TAPER_X, TAPER_Y) for comp in range(3)] if taper else (),
        filters=[(3 + comp, FILTER_X, FILTER_Y) for comp in range(3)] if filt else ())
    if filt:
        assert gold["pl"] == 256
    eng.set_source_params("bilateral", REF)
    check_traces(eng, gold["ref"], gold["ps0"], 2e-5, "REF")
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(*SHIFTRANGE)
    # tapered rows amplify the f32 centroid geodesy (~1e-6 relative at trace
    # level) and filtered rows run f32 FFTs against the oracle's f64 one
    rtol = 1e-4 if (taper or filt) else 1e-5
    check_models(eng, "bilateral", DUMPS, gold, rtol, 2e-5, "bilateral")


def test_eikonal_matches_cpp_oracle(store, oracle_bin, tmp_path):
    """Eikonal ruptures through the host FMM pipeline vs the oracle, which
    rebuilds each centroid table itself (double-precision heap FMM,
    psm_downsample_grid, boxcar time cells, source_eikonal.f90:435-712)
    from the rupture grid the port's host discretizer prepares."""
    eng, geom = make_engine(store, False)
    eng.set_source_constraints(*EIK_CONSTRAINTS)
    eng.batch_discretizer("eikonal").on_device = False  # the host FMM path
    ctx = eng.eikonal_context()
    models = []
    for p in [EIK_REF] + EIK_DUMPS:
        pv, m6s, rotmats = eiksrc.named_params_batch("eikonal", p[None, :])
        pd = {k: float(v[0]) for k, v in pv.items()}
        sd = {}
        eiksrc.discretize_eikonal_host(pd, 0.1, ctx, m6s[0], rotmats[0], solve_dump=sd)
        models.append(dict(
            speed=sd["speed"], inside=sd["inside"], delta=sd["delta"], first=sd["first"],
            nukl=sd["nukl"], coarse=sd["coarse"], cdelta=sd["cdelta"], rotmat=rotmats[0],
            center=[pd["north"], pd["east"], pd["depth"]],
            m6=np.asarray(m6s[0], np.float64) * float(p[4]),  # moment folded
            time0=pd["time"],
        ))
    gold = run_oracle(oracle_bin, str(tmp_path), store, geom,
                      {"kind": "eikonal", "edt": 0.1, "models": models})
    # not vacuous: the oracle synthesized real energy and real misfits
    assert np.abs(gold["ref"]).max() > 0
    assert all(np.abs(mod[3]).max() > 0 for mod in gold["models"])

    eng.set_source_params("eikonal", EIK_REF)
    check_traces(eng, gold["ref"], gold["ps0"], 5e-5, "EIK REF")
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(*SHIFTRANGE)
    check_models(eng, "eikonal", EIK_DUMPS, gold, 1e-4, 5e-5, "eikonal")
