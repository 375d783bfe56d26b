"""Parity of the port's misfit path (kiwi_tpu_torch.misfit: the floating and
the time-domain norms) with the JAX package, on seeded random probes: the
reference context (shifted, tapered, filtered references and their norm
factors) and the evaluations, the JAX side running its Pallas kernels in
interpret mode.

Tolerances: processed references and norms 1e-6 of the max (the FFT and
the sums run in other orders); misfits 2e-5 of the max
(tests/test_fused_scan.py's bar); selected shifts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiwi_tpu import misfit as jmf
from kiwi_tpu.plf import PLF as JPLF
from kiwi_tpu_torch import misfit as tmf
from kiwi_tpu_torch.plf import PLF as TPLF

ST = dict(ps0=-20, pl=128, dt=0.1)
NREC, K = 2, 3
RC = NREC * K
TAPER = ([0.0, 1.0, 6.0, 9.0], [0.0, 1.0, 1.0, 0.0])
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])


def _setups(taper, filt, seed=0, amp=1.0):
    """The same misfit setup built in both packages."""
    rng = np.random.default_rng(seed)
    rids = np.repeat(np.arange(NREC), K)
    out = []
    for mf, plf in ((jmf, JPLF), (tmf, TPLF)):
        st = mf.ProbeStatic(**ST)
        s = mf.MisfitSetup(st, rids)
        out.append((mf, st, s, plf))
    for irc in range(RC):
        n = 30 + 5 * irc
        vals = (amp * rng.standard_normal(n)).astype(np.float32)
        itmin = 5 + 3 * irc
        for mf, st, s, plf in out:
            s.set_ref(irc, vals, itmin)
            if taper:
                s.set_taper(irc, plf(*TAPER))
            if filt:
                s.set_filter(irc, plf(*BAND))
    for _mf, _st, s, _plf in out:
        s.shift_lo[K:] = -1  # receiver 1 scans a narrower range
        s.shift_hi[K:] = 2
        s.enabled[1] = False
    (_, jst, jsetup, _), (_, tst, tsetup, _) = out
    return jst, jsetup.device(), tst, tsetup.to("cpu")


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-38))


@pytest.mark.parametrize("taper,filt", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("method", [jmf.FLOATING_L1NORM, jmf.FLOATING_L2NORM])
def test_ref_context_matches(taper, filt, method):
    jst, jctx, tst, tctx = _setups(taper, filt, seed=1)
    want = jmf.precompute_ref_context(jctx, method, jst, (-3, 3), taper, filt)
    got = tmf.precompute_ref_context(tctx, method, tst, (-3, 3), taper, filt)
    _close(got["ref_proc"], want["ref_proc"], 1e-6)
    _close(got["norm"], want["norm"], 1e-6)
    for k in ("shifts", "ref_lo_s", "ref_hi_s"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("taper,filt,fold", [
    (False, False, 0), (False, False, 2), (True, False, 0), (False, True, 0), (True, True, 2),
])
@pytest.mark.parametrize("method", [jmf.FLOATING_L1NORM, jmf.FLOATING_L2NORM])
def test_fused_eval_matches(monkeypatch, taper, filt, fold, method):
    jst, jctx, tst, tctx = _setups(taper, filt, seed=2)
    rng = np.random.default_rng(3)
    T, NT, B = 8, 40, 16
    k_share = 1 if (taper or filt) else K
    v = rng.standard_normal((RC // k_share, T, NT)).astype(np.float32)
    wgt = (rng.standard_normal((RC, T, B)) / T).astype(np.float32)
    moments = rng.uniform(0.5, 2.0, B).astype(np.float32)
    syn_it0 = 8
    syn_lo = rng.integers(syn_it0, syn_it0 + 10, RC).astype(np.int32)
    syn_hi = (syn_lo + rng.integers(5, 25, RC)).astype(np.int32)
    risetime0 = np.float32(0.3)
    eval_win = (ST["ps0"] + 10, ST["ps0"] + 100)
    sr = (-3, 3)

    jr = jmf.precompute_ref_context(jctx, method, jst, sr, taper, filt)
    want = jmf.evaluate_misfits_floating_fused(
        jctx, jnp.asarray(v), jnp.asarray(wgt), syn_it0, jnp.asarray(syn_lo),
        jnp.asarray(syn_hi), method, jst, NREC, jnp.asarray(moments), jnp.float32(risetime0),
        fold_nshift_max=fold, rctx=jr, shiftrange=sr, any_taper=taper, any_filter=filt,
        eval_win=eval_win, k_share=k_share, interpret=True)
    tr = tmf.precompute_ref_context(tctx, method, tst, sr, taper, filt)
    got = tmf.evaluate_misfits_floating_fused(
        tctx, torch.as_tensor(v), torch.as_tensor(wgt), syn_it0, torch.as_tensor(syn_lo),
        torch.as_tensor(syn_hi), tst, NREC, torch.as_tensor(moments),
        torch.tensor(risetime0), tr, fold_nshift_max=fold, any_taper=taper, any_filter=filt,
        eval_win=eval_win, k_share=k_share)
    m, n, fs = want
    _close(got[0], m, 2e-5)
    _close(got[1], n, 2e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(fs))
    assert got[0].dtype == got[1].dtype == torch.float32


def test_global_misfit_tiny_amplitudes():
    """Moment-1.0 sessions put misfits near 1e-19 and their squares in the
    float32 flush range; the max-scaled reduction keeps the ratio."""
    rng = np.random.default_rng(4)
    m = (rng.uniform(0.1, 1.0, (5, RC)) * 1e-19).astype(np.float32)
    n = (rng.uniform(0.5, 1.0, (5, RC)) * 3e-19).astype(np.float32)
    got = tmf.global_misfit(torch.as_tensor(m), torch.as_tensor(n)).numpy()
    want = np.asarray(jax.vmap(jmf.global_misfit)(jnp.asarray(m), jnp.asarray(n)))
    exact = np.sqrt((m.astype(np.float64) ** 2).sum(-1) / (n.astype(np.float64) ** 2).sum(-1))
    assert (got > 0.1).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, exact, rtol=1e-6)


def test_fold_matches():
    rng = np.random.default_rng(6)
    vals = rng.standard_normal((3, 25)).astype(np.float32)
    for risetime in (0.0, 0.15, 0.3, 0.55):
        wj = jmf.fold_stf_weights(jnp.float32(risetime), jnp.float32(0.1), 4)
        wt = tmf.fold_stf_weights(torch.tensor(risetime, dtype=torch.float32), 0.1, 4)
        _close(wt, wj, 1e-6)
        _close(tmf.apply_fold(torch.as_tensor(vals), wt),
               jmf.apply_fold(jnp.asarray(vals), wj), 1e-6)


def _batch_inputs(seed, B=16, NT=40):
    """Per-model synthetics [B, RC, NT] with per-model spans and factors."""
    rng = np.random.default_rng(seed)
    syn = rng.standard_normal((B, RC, NT)).astype(np.float32)
    moments = rng.uniform(0.5, 2.0, B).astype(np.float32)
    risetimes = rng.uniform(0.05, 0.5, B).astype(np.float32)
    lo = rng.integers(8, 18, (B, RC)).astype(np.int32)
    hi = (lo + rng.integers(5, 25, (B, RC))).astype(np.int32)
    return syn, lo, hi, moments, risetimes


@pytest.mark.parametrize("taper,fold", [(False, 0), (True, 0), (False, 2), (True, 2)])
@pytest.mark.parametrize("method", [jmf.FLOATING_L1NORM, jmf.FLOATING_L2NORM])
def test_floating_batch_eval_matches(taper, fold, method):
    """The scan-kernel evaluation of precomputed synthetics (unfiltered
    plans), with a per-model rise-time fold, against the JAX package's
    (Pallas scan in interpret mode)."""
    jst, jctx, tst, tctx = _setups(taper, False, seed=5)
    syn, lo, hi, moments, risetimes = _batch_inputs(7 + fold)
    syn_it0, sr = 8, (-3, 3)
    # the window holds every norm span, the taper's included (the engine's
    # eval window does by construction): the tail correction needs it
    eval_win = (ST["ps0"] + 10, ST["ps0"] + 115)
    jr = jmf.precompute_ref_context(jctx, method, jst, sr, taper, False)
    want = jmf.evaluate_misfits_floating_batch(
        jctx, jnp.asarray(syn), syn_it0, jnp.asarray(lo), jnp.asarray(hi), method, jst, NREC,
        jnp.asarray(moments), jnp.asarray(risetimes), fold_nshift_max=fold, rctx=jr,
        shiftrange=sr, any_taper=taper, eval_win=eval_win, interpret=True)
    tr = tmf.precompute_ref_context(tctx, method, tst, sr, taper, False)
    got = tmf.evaluate_misfits_floating_batch(
        tctx, torch.as_tensor(syn), syn_it0, torch.as_tensor(lo), torch.as_tensor(hi), tst,
        NREC, torch.as_tensor(moments), torch.as_tensor(risetimes), tr, fold_nshift_max=fold,
        eval_win=eval_win)
    m, n, fs = want
    _close(got[0], m, 2e-5)
    _close(got[1], n, 2e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(fs))


@pytest.mark.parametrize("taper,filt,fold", [
    (False, True, 0), (True, True, 2), (True, False, 0), (False, False, 2)])
@pytest.mark.parametrize("method", [jmf.FLOATING_L1NORM, jmf.FLOATING_L2NORM])
def test_floating_eval_matches(taper, filt, fold, method):
    """The per-model evaluation with exact span masks and the FFT filter
    chain (filtered finite plans) against the JAX package's
    evaluate_misfits under vmap."""
    jst, jctx, tst, tctx = _setups(taper, filt, seed=6)
    syn, lo, hi, moments, risetimes = _batch_inputs(9 + fold, B=6)
    syn_it0, sr = 8, (-3, 3)
    eval_win = (ST["ps0"] + 10, ST["ps0"] + 100)
    jr = jmf.precompute_ref_context(jctx, method, jst, sr, taper, filt)

    def one(s, lo1, hi1, mo, rt):
        return jmf.evaluate_misfits(jctx, s, syn_it0, lo1, hi1, method, jst, NREC, moment=mo,
                                    risetime=rt, fold_nshift_max=fold, shiftrange=sr, rctx=jr,
                                    any_taper=taper, any_filter=filt, eval_win=eval_win)

    want = jax.vmap(one)(*(jnp.asarray(a) for a in (syn, lo, hi, moments, risetimes)))
    tr = tmf.precompute_ref_context(tctx, method, tst, sr, taper, filt)
    got = tmf.evaluate_misfits(
        tctx, torch.as_tensor(syn), syn_it0, torch.as_tensor(lo), torch.as_tensor(hi), tst,
        NREC, torch.as_tensor(moments), torch.as_tensor(risetimes), tr, fold_nshift_max=fold,
        any_filter=filt, eval_win=eval_win, chunk_elems=2 * 7 * RC * 90)  # three chunks
    m, n, fs = want
    _close(got[0], m, 2e-5)
    _close(got[1], n, 2e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(fs))


@pytest.mark.parametrize("taper,filt,fold,amp", [
    (False, False, 0, 1.0), (True, False, 2, 1.0), (False, True, 0, 1.0), (True, True, 2, 1.0),
    (False, False, 2, 1e-19)])
@pytest.mark.parametrize("method", [jmf.L2NORM, jmf.L1NORM, jmf.SCALAR_PRODUCT, jmf.PEAK])
def test_time_domain_eval_matches(taper, filt, fold, amp, method):
    """The time-domain norms (no shift scan: the eikonal grid search's
    l2norm and its siblings) against the JAX package's evaluate_misfits
    under vmap, with and without a taper and a filter, at rtol 1e-5.  The
    moment-1.0 scale (amp 1e-19) pins the amplitude unscaling, which the
    scalar product applies twice."""
    jst, jctx, tst, tctx = _setups(taper, filt, seed=10, amp=amp)
    syn, lo, hi, moments, risetimes = _batch_inputs(11 + fold, B=6)
    syn = syn * np.float32(amp)
    syn_it0 = 8
    eval_win = (ST["ps0"] + 10, ST["ps0"] + 100)
    jr = jmf.precompute_ref_context(jctx, method, jst, (0, 0), taper, filt)

    def one(s, lo1, hi1, mo, rt):
        return jmf.evaluate_misfits(jctx, s, syn_it0, lo1, hi1, method, jst, NREC, moment=mo,
                                    risetime=rt, fold_nshift_max=fold, rctx=jr,
                                    any_taper=taper, any_filter=filt, eval_win=eval_win)

    want = jax.vmap(one)(*(jnp.asarray(a) for a in (syn, lo, hi, moments, risetimes)))
    tr = tmf.precompute_ref_context(tctx, method, tst, (0, 0), taper, filt)
    np.testing.assert_allclose(tr["norm"].numpy(), np.asarray(jr["norm"]), rtol=1e-5)
    got = tmf.evaluate_misfits(
        tctx, torch.as_tensor(syn), syn_it0, torch.as_tensor(lo), torch.as_tensor(hi), tst,
        NREC, torch.as_tensor(moments), torch.as_tensor(risetimes), tr, fold_nshift_max=fold,
        any_filter=filt, eval_win=eval_win)
    m, n, fs = (np.asarray(x) for x in want)
    # the floor: XLA flushes float32 subnormals to zero and torch keeps them,
    # which the scalar product's 1e-38 values at amp 1e-19 reach
    tiny = float(np.finfo(np.float32).tiny)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert np.abs(m).max() > 0 and np.abs(n).max() > 0
    np.testing.assert_allclose(got[0].numpy(), m, rtol=1e-5,
                               atol=max(1e-6 * np.abs(m).max(), tiny))
    np.testing.assert_allclose(got[1].numpy(), n, rtol=1e-5,
                               atol=max(1e-6 * np.abs(n).max(), tiny))
    np.testing.assert_array_equal(got[2].numpy(), fs)
    assert not fs.any()


def test_spectral_norms_raise():
    jst, jctx, tst, tctx = _setups(False, False)
    for method in (tmf.AMPSPEC_L2NORM, tmf.AMPSPEC_L1NORM):
        with pytest.raises(NotImplementedError, match="queue 1, item 4"):
            tmf.precompute_ref_context(tctx, method, tst)
