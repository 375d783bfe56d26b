"""The amplitude-spectrum norms and the engine's diagnostics:
kiwi_tpu_torch on the CPU against kiwi_tpu on the same seeded inputs.

Function level: `_next_pow2_i32`, `amp_grid`, `ampspec_pair_misfits` (both
norms, plain, tapered, filtered, tapered and filtered, with pair spans long
enough and far enough off centre to need the 4x extended grid),
`cross_correlation`, `peak_amplitude` and `arias_intensity` on seeded
MisfitSetups built the same way in both packages.  Engine level, on
tests/test_torch_finite.py's 40x8 store and 4 `ned` receivers: both ampspec
norms through misfits_for_source_batch (finite faults through the window
kernel, chunked under memory_budget; a point source's shared-kinematics
batch; a sweep), and the seven diagnostics (get_processed_seismograms,
get_amp_spectra, get_cross_correlations, autoshift_ref_seismograms,
shift_ref_seismogram, get_peak_amplitudes, get_arias_intensities) on a
receiver set whose component groups differ.

The bar is the port's: rtol 2e-5 with an absolute floor of 2e-5 of the
largest value; shifts, spans and sample starts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu import misfit as jmf
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.plf import PLF as JPLF
from kiwi_tpu_torch import misfit as tmf
from kiwi_tpu_torch.engine import Receiver as TReceiver
from kiwi_tpu_torch.ops import synth_window as tsw
from kiwi_tpu_torch.plf import PLF as TPLF
from test_torch_finite import BAND, FAULT, STRIKES, TAPER, _close, _configure, engines  # noqa: F401

TOL = 2e-5
ST = dict(ps0=-37, pl=256, dt=0.1)
RIDS = np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int32)
PROCESSING = [(), ("taper",), ("filter",), ("taper", "filter")]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _allclose(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _setups(processing, scale=1.0, seed=0):
    """The same seeded MisfitSetup in both packages: references of several
    lengths and starts (one long and right-aligned), tapers and filters on
    some rows."""
    rng = np.random.default_rng(seed)
    out = []
    for mod, plf in ((jmf, JPLF), (tmf, TPLF)):
        setup = mod.MisfitSetup(mod.ProbeStatic(**ST), RIDS)
        rng = np.random.default_rng(seed)
        for irc in range(RIDS.size):
            n = int(rng.integers(20, 140)) if irc != 3 else 200
            itmin = ST["ps0"] + (int(rng.integers(0, ST["pl"] - n)) if irc != 3 else 50)
            setup.set_ref(irc, (scale * rng.standard_normal(n)).astype(np.float32), itmin)
            if "taper" in processing and irc % 2 == 0:
                setup.set_taper(irc, plf([-1.0, 0.5, 8.0, 12.0], [0.0, 1.0, 1.0, 0.0]))
            if "filter" in processing and irc % 3 != 1:
                setup.set_filter(irc, plf(*BAND))
        setup.syn_factor[:] = 1.3
        setup.enabled[5] = False
        out.append(setup)
    return out


def _ctxs(processing, **kw):
    js, ts = _setups(processing, **kw)
    return (js.device(), ts.to("cpu", tmf.AMPSPEC_L2NORM), jmf.ProbeStatic(**ST),
            tmf.ProbeStatic(**ST))


def _synthetics(B, scale=1.0, seed=1):
    """Probe-placed synthetics [B, RC, PL] with spans inside the probe, one
    row long and off centre."""
    rng = np.random.default_rng(seed)
    RC, pl, ps0 = RIDS.size, ST["pl"], ST["ps0"]
    lo = ps0 + rng.integers(0, pl // 2, (B, RC))
    hi = np.minimum(lo + rng.integers(10, pl // 2, (B, RC)), ps0 + pl - 1)
    lo[:, 2], hi[:, 2] = ps0 + 8, ps0 + pl - 1  # long, right-aligned
    j = ps0 + np.arange(pl)
    syn = scale * rng.standard_normal((B, RC, pl))
    syn = np.where(j < lo[..., None], 0.0, syn)
    syn = np.where(j > hi[..., None], syn[np.arange(B)[:, None], np.arange(RC), hi - ps0][..., None],
                   syn)
    return syn.astype(np.float32), lo.astype(np.int32), hi.astype(np.int32)


def test_next_pow2_and_amp_grid_match():
    x = np.concatenate([np.arange(0, 1100), 2 ** np.arange(31) - 1, 2 ** np.arange(31),
                        2 ** np.arange(30) + 1]).astype(np.int32)
    got = tmf._next_pow2_i32(torch.as_tensor(x))
    np.testing.assert_array_equal(_np(got), np.asarray(jmf._next_pow2_i32(jnp.asarray(x))))
    assert got.dtype == torch.int32
    for ps0, pl in ((-37, 256), (0, 1), (5, 300), (-1000, 2048)):
        assert tmf.amp_grid(ps0, pl) == jmf.amp_grid(ps0, pl)


@pytest.mark.parametrize("processing", PROCESSING)
@pytest.mark.parametrize("method", [jmf.AMPSPEC_L2NORM, jmf.AMPSPEC_L1NORM])
def test_ampspec_pair_misfits_match(method, processing):
    jctx, tctx, jst, tst = _ctxs(processing)
    for key in ("amp_taper_w", "amp_filter_w"):
        _allclose(tctx[key], jctx[key], tol=0)
    syn, lo, hi = _synthetics(3)
    want = jax.vmap(lambda s, a, b: jmf.ampspec_pair_misfits(jctx, s, a, b, method, jst))(
        jnp.asarray(syn), jnp.asarray(lo), jnp.asarray(hi))
    got = tmf.ampspec_pair_misfits(tctx, torch.as_tensor(syn), torch.as_tensor(lo),
                                   torch.as_tensor(hi), method, tst)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _allclose(g, w)
    assert float(got[0].abs().max()) > 0


@pytest.mark.parametrize("processing", PROCESSING)
def test_cross_correlation_matches(processing):
    # moment-1.0 amplitudes in the reference (s0 ~ 1e-19): the answers stay
    # above float32's normal range only through the chained (m * s0) * s0
    jctx, tctx, jst, tst = _ctxs(processing, scale=1e-19)
    syn = 1e-16 * _synthetics(1, seed=2)[0][0]
    want = jmf.cross_correlation(jctx, jnp.asarray(syn), (-4, 5), jst)
    got = tmf.cross_correlation(tctx, torch.as_tensor(syn), (-4, 5), tst)
    assert got.shape == (10, RIDS.size) and float(got.abs().max()) > 0
    _allclose(got, want)


@pytest.mark.parametrize("differentiate", [1, 2])
def test_peak_amplitude_and_arias_intensity_match(differentiate):
    rng = np.random.default_rng(differentiate)
    st = (jmf.ProbeStatic(**ST), tmf.ProbeStatic(**ST))
    rows = (1e-19 * rng.standard_normal((3, ST["pl"]))).astype(np.float32)
    mask = (np.arange(ST["pl"]) < 180 - differentiate).astype(np.float64)
    want = jmf.peak_amplitude(None, jnp.asarray(rows), jnp.asarray(mask), differentiate, st[0])
    got = tmf.peak_amplitude(torch.as_tensor(rows), torch.as_tensor(mask),
                             differentiate, st[1])
    assert got.dtype == torch.float64 and float(got) > 0
    _allclose(got, want)
    want = jmf.arias_intensity(jnp.asarray(rows), jnp.asarray(mask), st[0])
    got = tmf.arias_intensity(torch.as_tensor(rows), torch.as_tensor(mask), st[1])
    assert float(got) > 0
    _allclose(got, want)
    # batched over groups: each group as alone
    batch = np.stack([rows, 3.0 * rows[::-1]])
    got = tmf.peak_amplitude(torch.as_tensor(batch), torch.as_tensor(mask),
                             differentiate, st[1])
    for g, r in zip(got, batch):
        _allclose(g, jmf.peak_amplitude(None, jnp.asarray(r), jnp.asarray(mask), differentiate,
                                        st[0]))


@pytest.mark.parametrize("processing", [(), ("taper",), ("filter",)])
@pytest.mark.parametrize("method", ["ampspec_l2norm", "ampspec_l1norm"])
def test_ampspec_norms_through_the_engine(engines, monkeypatch, method, processing):
    je, te = engines
    for eng in engines:
        _configure(eng, method, processing)
    calls = []
    real = tsw.synthesize_ard_batch
    monkeypatch.setattr(tsw, "synthesize_ard_batch",
                        lambda *a, **k: calls.append(a[2]["ish"].shape[0]) or real(*a, **k))
    pb = np.tile(FAULT, (len(STRIKES), 1))
    pb[:, 5] = STRIKES
    pb[:, 0] = [0.0, 0.1, -0.1, 0.2]  # time shifts: nonzero misfits at every strike
    m, n, fs = je.misfits_for_source_batch(pb)
    got = te.misfits_for_source_batch(pb)
    _close(got[0], np.asarray(m))
    _close(got[1], np.asarray(n))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(fs))
    assert calls == [len(STRIKES)]  # the window kernel's path
    assert float(got[0].min()) > 0
    # chunked under the memory budget: the same rows
    monkeypatch.setattr(te, "memory_budget", te._plan["per_source_bytes"] * 3)
    chunked = te.misfits_for_source_batch(pb)
    assert calls[1:] == [2, 2]
    for a, b in zip(chunked, got):
        assert torch.equal(a, b)
    _close(te.global_misfits_for_source_batch(pb), je.global_misfits_for_source_batch(pb))
    for eng in engines:
        eng.set_source_params("bilateral", pb[1])
    for a, b in zip(te.get_misfits(), je.get_misfits()):
        _close(a, np.asarray(b)) if a.dtype == np.float32 else np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["ampspec_l2norm", "ampspec_l1norm"])
def test_ampspec_point_source_batch_and_sweep(engines, method):
    """A point source's strike batch is shared-kinematics (the matmul
    forward, not the fused scan, which is floating-only); its sweep goes
    through the batch path."""
    je, te = engines
    base = FAULT.copy()
    base[9:12] = 0.0  # a point source
    for eng in engines:
        _configure(eng, method, ("filter",), base=base)
    strikes = np.array([30.0, 91.0, 140.0, 300.0], np.float32)
    want = np.asarray(je.sweep_global_misfits(base, 5, strikes))
    got = te.sweep_global_misfits(base, 5, strikes)
    assert not te._plan["use_fused_scan"]
    _close(got, want)
    assert float(got.min()) < 1e-3 * float(got.max())  # the true strike fits
    pb = np.tile(base, (len(strikes), 1))
    pb[:, 5] = strikes
    m, n, _fs = je.misfits_for_source_batch(pb)
    got = te.misfits_for_source_batch(pb)
    _close(got[0], np.asarray(m))
    _close(got[1], np.asarray(n))


def _diag_session(eng, processing):
    """Four receivers whose component groups differ (ned; the vertical
    alone; a, r; n, e without a vertical), one switched off; the reference
    the true fault, the source a perturbed one."""
    rec = JReceiver if isinstance(eng, JEngine) else TReceiver
    olat, olon = 30.0, 70.0
    recs = []
    for i, comps in enumerate(("ned", "u", "rda", "ne", "ned")):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), 1200.0 + 400.0 * i,
                                  0.3 * i)
        recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), comps))
    eng.set_receivers(recs)
    eng.switch_receiver(4, False)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_params("bilateral", FAULT)
    for irec in range(5):
        if "filter" in processing and irec != 1:
            eng.set_misfit_filter(irec, *BAND)
        if "taper" in processing and irec != 3:
            eng.set_misfit_taper(irec, *TAPER)
    eng.set_misfit_method("floating_l2norm")
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(-0.5, 0.5)
    p = FAULT.copy()
    p[[0, 5, 6]] = (0.15, 101.0, 80.0)
    eng.set_source_params("bilateral", p)


def _rows_close(got, want):
    assert len(got) == len(want)
    for (gv, gi), (wv, wi) in zip(got, want):
        assert gi == wi
        _allclose(gv, wv)


@pytest.mark.parametrize("processing", [(), ("taper",), ("filter",), ("taper", "filter")])
def test_engine_diagnostics_match(engines, processing):
    je, te = engines
    for eng in engines:
        _diag_session(eng, processing)
    for which in ("synthetics", "references"):
        for proc in ("plain", "tapered", "filtered"):
            _rows_close(te.get_processed_seismograms(which, proc),
                        je.get_processed_seismograms(which, proc))
        for proc in ("plain", "filtered"):
            got, want = te.get_amp_spectra(which, proc), je.get_amp_spectra(which, proc)
            assert [d for _a, d in got] == [d for _a, d in want]
            for (ga, _), (wa, _) in zip(got, want):
                _allclose(ga, wa)
    cc, shifts = te.get_cross_correlations((-0.3, 0.35))
    wcc, wshifts = je.get_cross_correlations((-0.3, 0.35))
    np.testing.assert_array_equal(shifts, wshifts)
    assert cc.shape == (len(shifts), 12) and np.abs(cc).max() > 0
    _allclose(cc, np.asarray(wcc))
    for args in ((1,), (2,)):
        got = te.get_peak_amplitudes(*args)
        assert got.shape == (4,) and (got > 0).all()
        _allclose(got, je.get_peak_amplitudes(*args))
    _allclose(te.get_arias_intensities(), je.get_arias_intensities())
    # shifts: one receiver by hand, then every receiver to its power maximum
    for eng in engines:
        eng.shift_ref_seismogram(2, 3)
    assert te._refs.keys() == je._refs.keys()
    for irc in te._refs:
        assert te._refs[irc][1] == je._refs[irc][1]
    _close(te.get_misfits()[0], np.asarray(je.get_misfits()[0]))
    for target in (0, None):
        got = te.autoshift_ref_seismograms((-0.5, 0.5), target)
        want = je.autoshift_ref_seismograms((-0.5, 0.5), target)
        np.testing.assert_array_equal(got, want)
        assert {irc: v[1] for irc, v in te._refs.items()} == {
            irc: v[1] for irc, v in je._refs.items()}
    assert np.abs(want).max() > 0
    m, n, fs = te.get_misfits()
    wm, wn, wfs = je.get_misfits()
    _close(m, np.asarray(wm))
    _close(n, np.asarray(wn))
    np.testing.assert_array_equal(fs, np.asarray(wfs))
