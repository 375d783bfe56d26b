"""The port's slice as a whole: kiwi_tpu_torch.engine.Engine on the CPU
against the JAX Engine, on the configuration of tests/test_fused_scan.py
(40x6 fullspace store, 4 `ned` receivers, point bilateral source).

The JAX side runs its fused sweep with the Pallas kernel in interpret mode
(KIWI_FLOAT_SCAN_INTERPRET=1, as tests/test_fused_scan.py does).  Sweep
global misfits compare at rtol 2e-5 (tests/test_fused_scan.py's bar),
synthetic reference traces at 1e-6 of their max (float32 rounding of the
same linear map, summed in another order).
"""

import ast
import os
import pathlib
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
    """The spectral norms are ported now (they raised before): the point
    sweep and a batch under ampspec_l2norm answer as kiwi_tpu does, through
    the batch path (the fused kernel is floating-only;
    tests/test_torch_spectral.py holds the rest).  An unknown source type
    still raises naming the ported ones."""
    je, te = engines
    for eng in engines:
        _configure(eng, "ampspec_l2norm")
    got = te.sweep_global_misfits(BASE, 5, STRIKES)
    assert not te._plan["use_fused_scan"]
    np.testing.assert_allclose(got.numpy(), np.asarray(je.sweep_global_misfits(BASE, 5, STRIKES)),
                               rtol=2e-5)
    pb = np.tile(BASE, (2, 1))
    pb[1, 5] = 120.0
    m, n, _fs = te.misfits_for_source_batch(pb)
    wm, wn, _wfs = je.misfits_for_source_batch(pb)
    for a, b in ((m, wm), (n, wn)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-5 * np.abs(b).max())
    with pytest.raises(KeyError, match="eikonal"):
        te.set_source_params("no_such_source", np.zeros(7, np.float32))


def test_engine_defaults_to_the_card(engines):
    """Engine(store) with no device runs on "cuda"; without a card its first
    tensor operation raises instead of falling back to the CPU."""
    _je, te = engines
    eng = TEngine(te.store)
    assert eng.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            _configure(eng, "floating_l1norm")


def test_set_source_location_takes_ref_time(engines):
    """The JAX signature's third argument (bench.py calls it with 0.0)."""
    for eng in engines:
        eng.set_source_location(30.0, 70.0)
        assert eng.ref_time == 0.0
        eng.set_source_location(30.0, 70.0, 1.5)
        assert eng.ref_time == 1.5
    _configure(engines[1], "floating_l1norm")  # the plan was invalidated
    assert engines[1]._plan is None


def test_synthetics_factor_matches(engines, monkeypatch):
    """set_synthetics_factor scales every synthetic inside the misfits (the
    misfit setup's syn_factor), on the fused sweep as in JAX."""
    je, te = engines
    for eng in engines:
        _configure(eng, "floating_l1norm")
    plain = te.sweep_global_misfits(BASE, 5, STRIKES)
    for eng in engines:
        eng.set_synthetics_factor(2.0)
        assert eng._plan is None
    want = _jax_sweep(je, monkeypatch, BASE, STRIKES)
    got = te.sweep_global_misfits(BASE, 5, STRIKES)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    assert (got > plain).all()  # twice the synthetic fits its own reference worse
    for eng in engines:
        eng.set_synthetics_factor(1.0)


def test_spacial_undersampling_matches(engines, monkeypatch):
    je, te = engines
    for eng in engines:
        with pytest.raises(ValueError, match="invalid undersampling"):
            eng.set_spacial_undersampling(0, 1)
        _configure(eng, "floating_l1norm")
    te.sweep_global_misfits(BASE, 5, STRIKES)
    plan = te._plan
    for eng in engines:
        eng.set_spacial_undersampling(2, 2)
        eng.set_synthetic_reference()
    want = _jax_sweep(je, monkeypatch, BASE, STRIKES)
    got = te.sweep_global_misfits(BASE, 5, STRIKES)
    assert te._plan is not plan and te._plan["cfg"].xunder == te._plan["cfg"].zunder == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5 * want.max())
    for eng in engines:
        eng.set_spacial_undersampling(1, 1)


def _observed(je, seed=6):
    """An observed reference neither engine synthesized: the JAX engine's
    synthetics scaled by 1.3, zero-padded by 3 samples on each side, moved
    2 samples earlier, with seeded noise at 5% of each trace's max."""
    rng = np.random.default_rng(seed)
    out = []
    for values, itmin in je.get_synthetic_seismograms():
        v = np.pad(1.3 * values, 3)
        v = v + 0.05 * float(np.abs(values).max()) * rng.standard_normal(v.shape)
        out.append((v.astype(np.float32), itmin - 3 - 2))
    return out


def _set_refs(eng, traces):
    for irc, (v, itmin) in enumerate(traces):
        eng.set_ref_seismogram(irc // 3, "ned"[irc % 3], v, itmin)


@pytest.mark.parametrize("method", ["floating_l1norm", "floating_l2norm"])
def test_observed_reference_matches(engines, monkeypatch, method):
    """References installed through set_ref_seismogram, then receiver 1
    switched off: the fused sweep on both engines."""
    je, te = engines
    for eng in engines:
        _configure(eng, method)
    traces = _observed(je)
    for eng in engines:
        _set_refs(eng, traces)
    assert te._plan is None
    for irc, (v, itmin) in enumerate(traces):
        assert te._refs[irc][0].dtype == np.float32 and te._refs[irc][1] == itmin
        np.testing.assert_array_equal(te._refs[irc][0], je._refs[irc][0])
    all_on = te.sweep_global_misfits(BASE, 5, STRIKES).numpy()
    np.testing.assert_allclose(all_on, _jax_sweep(je, monkeypatch, BASE, STRIKES), rtol=2e-5)
    for eng in engines:
        eng.switch_receiver(1, False)
    assert te._plan is None and not te.receivers[1].enabled
    want = _jax_sweep(je, monkeypatch, BASE, STRIKES)
    got = te.sweep_global_misfits(BASE, 5, STRIKES)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    assert np.abs(got.numpy() - all_on).max() > 1e-3 * np.abs(all_on).max()
    assert got.numpy().min() > 1e-3  # the noise keeps every row off 0


def test_set_ref_seismogram_needs_the_component(engines):
    for eng in engines:
        _configure(eng, "floating_l1norm")
        refs = dict(eng._refs)
        for irec, comp in ((0, "z"), (0, "a"), (4, "n")):
            with pytest.raises(KeyError, match=f"receiver {irec} has no component"):
                eng.set_ref_seismogram(irec, comp, np.ones(5), 10)
        assert eng._refs.keys() == refs.keys()
        eng.set_ref_seismogram(2, "d", np.arange(4.0), -3)  # row 2 * 3 + 2 replaced
        assert eng._refs[8][0].dtype == np.float32 and eng._refs[8][1] == -3


def test_set_database_matches(engines, monkeypatch):
    """set_database to a second store (another material) keeps the session's
    references and invalidates the plan: both engines then sweep the second
    store's synthetics against the first store's reference."""
    je, te = engines
    for eng in engines:
        _configure(eng, "floating_l2norm")
    first = te.sweep_global_misfits(BASE, 5, STRIKES).numpy()
    store = elseis.build_ahfull_store(
        nx=40, nz=6, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2500.0, 3500.0, 1800.0), stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1.0]),
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    old = je.store, te.store
    try:
        je.set_database(store)
        te.set_database(tstore)
        assert te.store is tstore and te._plan is None and len(te._refs) == 12
        want = _jax_sweep(je, monkeypatch, BASE, STRIKES)
        got = te.sweep_global_misfits(BASE, 5, STRIKES).numpy()
    finally:
        je.set_database(old[0])
        te.set_database(old[1])
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert np.abs(got - first).max() > 1e-2 * np.abs(first).max()


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, kiwi_tpu_torch\n"
        "for m in pkgutil.walk_packages(kiwi_tpu_torch.__path__, 'kiwi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'kiwi_tpu', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "new = ('cli.minimizer', 'io', 'io.mseed', 'io.sac', 'io.table', 'io.gfdb_hdf5',\n"
        "       'native', 'dataset', 'gf.interpolation', 'invert.gradient', 'geo', 'phases',\n"
        "       'pipeline', 'plotting', 'prepare', 'config', 'cli.kiwi_main', 'cli.autokiwi',\n"
        "       'gf.builder', 'gf.qseis', 'gf.poel', 'cli.gfdb_tools', 'acquisition',\n"
        "       'cli.tools', 'profiling', 'web', 'web.server', 'parallel',\n"
        "       'parallel.sharding', 'parallel.gfshard')\n"
        "missing = [m for m in new if 'kiwi_tpu_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules if m.startswith('kiwi_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) >= 63


def _imported_modules(path):
    """The absolute module names a port module imports from (for `from X
    import a, b` both X and X.a, X.b: a name may be a submodule)."""
    parts = list(path.relative_to(REPO).with_suffix("").parts)
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = parts[:len(parts) - node.level] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def _layering_faults(rule):
    pkg = pathlib.Path(REPO) / "kiwi_tpu_torch"
    if rule == "ops_import_no_sources_or_engine":
        return {str(p): sorted(m for m in _imported_modules(p)
                               if m.startswith(("kiwi_tpu_torch.sources", "kiwi_tpu_torch.engine")))
                for p in (pkg / "ops").glob("*.py")}
    if rule == "engine_imports_no_eik_prepare":
        return {"engine.py": sorted(m for m in _imported_modules(pkg / "engine.py")
                                    if m.startswith("kiwi_tpu_torch.ops.eik_prepare"))}
    # no module but the engine calls a private _discretize* method
    calls = {}
    for p in [*pkg.rglob("*.py"), pathlib.Path(REPO) / "chip_smoke.py"]:
        if p.name != "engine.py" or p.parent != pkg:
            calls[str(p)] = sorted(
                n.attr for n in ast.walk(ast.parse(p.read_text()))
                if isinstance(n, ast.Attribute) and n.attr.startswith("_discretize"))
    return calls


@pytest.mark.parametrize("rule", ["ops_import_no_sources_or_engine",
                                  "engine_imports_no_eik_prepare", "no_private_discretize_calls"])
def test_layering(rule):
    """The kernel layer imports nothing above it, the engine reaches the
    eikonal preparation only through the source model, and other modules
    discretize through Engine.discretize alone (read with ast)."""
    faults = _layering_faults(rule)
    assert faults, "no module checked"
    assert not any(faults.values()), {k: v for k, v in faults.items() if v}
