"""The port's slice as a whole: kiwi_tpu_torch.engine.Engine on the CPU
against the JAX Engine, on the configuration of tests/test_fused_scan.py
(40x6 fullspace store, 4 `ned` receivers, point bilateral source).

The JAX side runs its fused sweep with the Pallas kernel in interpret mode
(KIWI_FLOAT_SCAN_INTERPRET=1, as tests/test_fused_scan.py does).  Sweep
global misfits compare at rtol 2e-5 (tests/test_fused_scan.py's bar),
synthetic reference traces at 1e-6 of their max (float32 rounding of the
same linear map, summed in another order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0, 2500.0, 0.2],
                dtype=np.float32)
STRIKES = np.linspace(0.0, 350.0, 8).astype(np.float32)
TAPER = ([0.0, 1.0, 6.0, 9.0], [0.0, 1.0, 1.0, 0.0])
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])


@pytest.fixture(scope="module")
def engines():
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=40, nz=6, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return JEngine(store), TEngine(tstore, device="cpu")


def _configure(eng, method, processing=(), base=BASE):
    """A full session from scratch (set_receivers clears refs/tapers/filters)."""
    rec = JReceiver if isinstance(eng, JEngine) else TReceiver
    olat, olon = 30.0, 70.0
    recs = []
    for i in range(4):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), 1200.0 + 400.0 * i, 0.3 * i)
        recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_params("bilateral", base)
    eng.set_floating_shiftrange(-0.5, 0.5)
    for irec in range(4):
        if "filter" in processing:
            eng.set_misfit_filter(irec, *BAND)
        if "taper" in processing:
            eng.set_misfit_taper(irec, *TAPER)
    eng.set_misfit_method(method)
    eng.set_synthetic_reference()


def _jax_sweep(eng, monkeypatch, base, strikes):
    monkeypatch.setenv("KIWI_FLOAT_SCAN_INTERPRET", "1")
    monkeypatch.delenv("KIWI_FLOAT_SCAN", raising=False)
    monkeypatch.delenv("KIWI_FUSED_SCAN", raising=False)
    eng._invalidate()
    g = np.asarray(eng.sweep_global_misfits(base, 5, strikes))
    assert any(k[-1] for k in eng._plan.get("sweep", {})), "JAX sweep not fused"
    return g


def test_synthetic_reference_matches(engines):
    je, te = engines
    for eng in engines:
        _configure(eng, "floating_l1norm")
    want = je.get_synthetic_seismograms()
    got = te.get_synthetic_seismograms()
    assert len(got) == len(want) == 12
    for (gv, gi), (wv, wi) in zip(got, want):
        assert gi == wi and gv.shape == wv.shape and gv.dtype == np.float32
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6 * np.abs(wv).max())
    for irc in range(12):  # installed references: same data spans
        assert te._refs[irc][1] == je._refs[irc][1]
        assert len(te._refs[irc][0]) == len(je._refs[irc][0])


@pytest.mark.parametrize("processing", [(), ("filter",), ("taper",), ("filter", "taper")])
@pytest.mark.parametrize("method", ["floating_l1norm", "floating_l2norm"])
def test_sweep_matches(engines, monkeypatch, method, processing):
    je, te = engines
    for eng in engines:
        _configure(eng, method, processing)
    want = _jax_sweep(je, monkeypatch, BASE, STRIKES)
    got = te.sweep_global_misfits(BASE, 5, STRIKES)
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # a repeat of the same sweep spec takes the memo and gives the same values
    assert len(te._sweep_memo) == 1
    np.testing.assert_array_equal(te.sweep_global_misfits(BASE, 5, STRIKES[::-1]).numpy(),
                                  got.numpy()[::-1])


def test_tiny_amplitude_sweep(engines, monkeypatch):
    """Moment 1.0: samples ~1e-19, squares in the float32 flush range.  The
    misfit curve must stay nonzero and strictly increasing away from the
    optimum (tests/test_engine.py's pattern) and match JAX."""
    je, te = engines
    p = BASE.copy()
    p[4] = 1.0
    for eng in engines:
        _configure(eng, "floating_l2norm", base=p)
    strikes = np.array([91.0, 93.0, 96.0, 99.0], np.float32)
    got = te.sweep_global_misfits(p, 5, strikes).numpy()
    want = _jax_sweep(je, monkeypatch, p, strikes)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * want.max())
    assert got[1] > 1e-4, got
    assert got[1] < got[2] < got[3], got


def test_memo_key_has_effective_dt(engines):
    _je, te = engines
    _configure(te, "floating_l1norm")
    te.sweep_global_misfits(BASE, 5, STRIKES)
    te.set_effective_dt(0.05)  # does not invalidate the plan
    te.sweep_global_misfits(BASE, 5, STRIKES)
    assert len(te._sweep_memo) == 2
    assert {k[3] for k in te._sweep_memo} == {0.1, 0.05}


def test_outside_the_slice_raises(engines):
    _je, te = engines
    _configure(te, "l2norm")
    with pytest.raises(NotImplementedError, match="item 11"):
        te.sweep_global_misfits(BASE, 5, STRIKES)
    fault = BASE.copy()
    fault[9:12] = (300.0, 100.0, 200.0)  # a finite fault: strike moves centroids
    _configure(te, "floating_l1norm", base=fault)
    with pytest.raises(NotImplementedError, match="item 9"):
        te.sweep_global_misfits(fault, 5, STRIKES)
    with pytest.raises(NotImplementedError, match="not ported"):
        te.set_source_params("moment_tensor", np.zeros(7, np.float32))


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, kiwi_tpu_torch\n"
        "for m in pkgutil.walk_packages(kiwi_tpu_torch.__path__, 'kiwi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'kiwi_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('kiwi_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 15
