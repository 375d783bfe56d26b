"""Waveform misfits: the floating, time-domain and amplitude-spectrum norms
and the diagnostics built on the probes (port of kiwi_tpu/misfit.py).

A "probe" is a power-of-two-length float32 array over a static absolute
index span [ps0, ps0+pl), with the reference's extension convention: zeros
left of the data span, last value repeated to the right
(comparator.f90:59, :264-267).  The floating norms scan a reference-shift
range and keep the minimum summed misfit per receiver
(receiver.f90:439-510).  Their scan sums come from the fused synthesis +
scan kernel on shared-kinematics plans, from the scan kernel over
precomputed synthetics on unfiltered finite-source plans (both in
ops/float_scan.py), and from plain torch with exact span masks on filtered
finite-source plans (evaluate_misfits).  The time-domain norms (l2norm,
l1norm, scalar_product, peak) and the amplitude-spectrum norms
(ampspec_l2norm, ampspec_l1norm) have no kernel in either package:
evaluate_misfits computes them in plain torch, batched over sources, the
spectra with torch.fft (the JAX package's are XLA FFTs outside any Pallas
kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.float_scan import fused_scan_sums, scan_sums
from .plf import PLF
from .profiling import to_device, to_host

F32 = torch.float32
I32 = torch.int32

L2NORM = 1
L1NORM = 2
AMPSPEC_L2NORM = 3
AMPSPEC_L1NORM = 4
SCALAR_PRODUCT = 5
PEAK = 6
FLOATING_L2NORM = 7
FLOATING_L1NORM = 8

NORM_NAMES = {
    "l2norm": L2NORM,
    "l1norm": L1NORM,
    "ampspec_l2norm": AMPSPEC_L2NORM,
    "ampspec_l1norm": AMPSPEC_L1NORM,
    "scalar_product": SCALAR_PRODUCT,
    "peak": PEAK,
    "floating_l2norm": FLOATING_L2NORM,
    "floating_l1norm": FLOATING_L1NORM,
}
FLOATING = (FLOATING_L2NORM, FLOATING_L1NORM)
TIME_DOMAIN = (L2NORM, L1NORM, SCALAR_PRODUCT, PEAK)
AMPSPEC = (AMPSPEC_L2NORM, AMPSPEC_L1NORM)


def next_pow2(n):
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


def allowed_span(span, minlength):
    """Pow2 padding of a span (comparator.f90:1092-1109)."""
    lo, hi = int(span[0]), int(span[1])
    length = hi - lo + 1
    lengthp = next_pow2(max(length, minlength))
    lo2 = lo - int(np.floor((lengthp - length) / 2.0))
    return lo2, lo2 + lengthp - 1


# ---------------------------------------------------------------------------
# host-side setup
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProbeStatic:
    """Static probe-grid parameters."""

    ps0: int  # absolute index of first probe sample
    pl: int  # probe length (power of two)
    dt: float

    @property
    def df(self):
        return 1.0 / (self.pl * self.dt)


class MisfitSetup:
    """Host-side builder of the misfit context: nrc (receiver, component)
    rows, receiver_ids mapping each row to its receiver."""

    def __init__(self, static: ProbeStatic, receiver_ids):
        self.static = static
        self.receiver_ids = np.asarray(receiver_ids, dtype=np.int32)
        nrc = self.receiver_ids.shape[0]
        self.nrc = nrc
        pl = static.pl
        nf = pl // 2 + 1
        self.ref = np.zeros((nrc, pl), dtype=np.float32)
        self.ref_lo = np.full(nrc, static.ps0, dtype=np.int32)
        self.ref_hi = np.full(nrc, static.ps0, dtype=np.int32)
        self.has_ref = np.zeros(nrc, dtype=bool)
        self.taper_w = np.ones((nrc, pl), dtype=np.float32)
        self.taper_zero_one = np.ones((nrc, pl), dtype=np.float32)
        self.has_taper = np.zeros(nrc, dtype=bool)
        self.taper_lo = np.full(nrc, static.ps0, dtype=np.int32)
        self.taper_hi = np.full(nrc, static.ps0 + pl - 1, dtype=np.int32)
        self.filter_w = np.ones((nrc, nf), dtype=np.float32)
        self.has_filter = np.zeros(nrc, dtype=bool)
        self.taper_plfs = {}
        self.filter_plfs = {}
        self.syn_factor = np.ones(nrc, dtype=np.float32)
        self.enabled = np.ones(nrc, dtype=bool)
        # per-row floating shift ranges (samples); defaults allow the whole
        # plan-wide scan range (receiver.f90:94 floating_shiftrange)
        self.shift_lo = np.full(nrc, -(1 << 30), dtype=np.int32)
        self.shift_hi = np.full(nrc, 1 << 30, dtype=np.int32)

    def set_ref(self, irc, values, itmin):
        """Place a reference trace (absolute start index itmin) on the probe
        span with probe extension semantics (probe_set_array,
        comparator.f90:222-271)."""
        ps0, pl = self.static.ps0, self.static.pl
        v = np.asarray(values, dtype=np.float32)
        arr = np.zeros(pl, dtype=np.float32)
        lo = itmin - ps0
        hi = lo + v.shape[0] - 1
        if lo < 0 or hi >= pl:
            raise ValueError(
                f"reference trace [{itmin}, {itmin + len(v) - 1}] exceeds probe span "
                f"[{ps0}, {ps0 + pl - 1}]"
            )
        arr[lo : hi + 1] = v
        arr[hi + 1 :] = v[-1]
        self.ref[irc] = arr
        self.ref_lo[irc] = itmin
        self.ref_hi[irc] = itmin + v.shape[0] - 1
        self.has_ref[irc] = True

    def set_taper(self, irc, taper: PLF):
        """receiver_set_taper -> probe taper (comparator.f90:1173-1184)."""
        ps0, pl, dt = self.static.ps0, self.static.pl, self.static.dt
        span = (ps0, ps0 + pl - 1)
        self.taper_w[irc] = taper.taper_weights(span, dt, ip="cos").astype(np.float32)
        self.taper_zero_one[irc] = taper.taper_weights(span, dt, ip="zero_one").astype(
            np.float32
        )
        dlo, dhi = taper.discrete_span(dt)
        self.taper_lo[irc] = max(dlo, span[0])
        self.taper_hi[irc] = min(dhi, span[1])
        self.has_taper[irc] = True
        self.taper_plfs[irc] = taper

    def set_filter(self, irc, filt: PLF):
        """Spectral filter on rfft bins, coordinate k*df
        (comparator.f90:1218-1231)."""
        nf = self.static.pl // 2 + 1
        self.filter_w[irc] = filt.taper_weights((0, nf - 1), self.static.df, ip="cos").astype(
            np.float32
        )
        self.has_filter[irc] = True
        self.filter_plfs[irc] = filt

    def to(self, device, method=None, amp_scale=None):
        """The misfit context as tensors on `device`.

        Amplitude normalization: every norm runs on ref/s0 and
        syn_factor/s0, and the eval multiplies the 1-homogeneous outputs
        back by s0.  Without it a moment-1.0 source (samples ~1e-19) has
        squares ~1e-38, which flush to zero in float32.  `amp_scale` stays a
        Python float (it multiplies host-side into the outputs).  s0 is the
        largest |ref| of these rows, or amp_scale where given: a shard of a
        session's rows takes the whole session's, so that its rows are
        normalized, and their floating shifts chosen, as unsharded.

        The amplitude-spectrum norms (`method` in AMPSPEC) run on
        amp_grid's extended grid (every pair's centred pow2 window lies
        inside it, see ampspec_pair_misfits), so for them the tapers and
        filters are evaluated there too: amp_taper_w f32[RC, 4P] and
        amp_filter_w f32[RC, 2P + 1], P = next_pow2(pl).  Other methods'
        contexts leave them out."""
        s0 = float(np.abs(self.ref).max()) if amp_scale is None else float(amp_scale)
        if not np.isfinite(s0) or s0 == 0.0:
            s0 = 1.0
        t = lambda a: to_device(a, device)  # noqa: E731
        ctx = {
            "amp_scale": s0,
            "ref": t(self.ref / np.float32(s0)),
            "ref_lo": t(self.ref_lo),
            "ref_hi": t(self.ref_hi),
            "taper_w": t(self.taper_w),
            "taper_zero_one": t(self.taper_zero_one),
            "has_taper": t(self.has_taper),
            "taper_lo": t(self.taper_lo),
            "taper_hi": t(self.taper_hi),
            "filter_w": t(self.filter_w),
            "has_filter": t(self.has_filter),
            "syn_factor": t(self.syn_factor / np.float32(s0)),
            "enabled": t(self.enabled),
            "receiver_ids": t(self.receiver_ids),
            "shift_lo": t(self.shift_lo),
            "shift_hi": t(self.shift_hi),
        }
        if method in AMPSPEC:
            ctx.update({k: t(v) for k, v in self._amp_weights().items()})
        return ctx

    def _amp_weights(self):
        """The tapers and filters on amp_grid's extended grid (host arrays)."""
        ps0, pl, dt = self.static.ps0, self.static.pl, self.static.dt
        aps0, apl, _ncap = amp_grid(ps0, pl)
        anf = apl // 2 + 1
        adf = 1.0 / (apl * dt)
        amp_taper_w = np.ones((self.nrc, apl), dtype=np.float32)
        for irc, plf in self.taper_plfs.items():
            amp_taper_w[irc] = plf.taper_weights((aps0, aps0 + apl - 1), dt, ip="cos")
        amp_filter_w = np.ones((self.nrc, anf), dtype=np.float32)
        for irc, plf in self.filter_plfs.items():
            amp_filter_w[irc] = plf.taper_weights((0, anf - 1), adf, ip="cos")
        return {"amp_taper_w": amp_taper_w, "amp_filter_w": amp_filter_w}


# ---------------------------------------------------------------------------
# probe processing
# ---------------------------------------------------------------------------


def place_on_probe(values, it0, st: ProbeStatic):
    """Put trace rows f32[..., NT] starting at absolute it0 onto the probe
    span with zero-left / repeat-right extension."""
    nt = values.shape[-1]
    rel = st.ps0 + torch.arange(st.pl, device=values.device) - it0
    out = values.index_select(-1, rel.clamp(0, nt - 1))
    return torch.where(rel < 0, 0.0, out)


def shift_probe(arr, lo, hi, s, st: ProbeStatic):
    """probe_shift: move the data span of every row by s samples,
    re-extending (comparator.f90:273-288).  arr f32[RC, PL]; lo/hi the
    absolute data spans; s an int, or an int tensor [S, 1, 1] of shifts
    (then f32[S, RC, PL])."""
    rel = torch.arange(st.pl, device=arr.device)[None, :] - s
    lo_rel = lo[:, None].long() - st.ps0
    hi_rel = hi[:, None].long() - st.ps0
    relc = torch.minimum(torch.maximum(rel, lo_rel), hi_rel)  # edge extension
    shape = torch.broadcast_shapes(relc.shape, arr.shape)
    v = torch.gather(arr.expand(shape), -1, relc.expand(shape))
    return torch.where(rel < lo_rel, 0.0, v)


def _taper_arrays(ctx, arr):
    """array_tapered per row (no-op rows keep the plain array)."""
    return torch.where(ctx["has_taper"][..., None], arr * ctx["taper_w"], arr)


def processed_arrays(ctx, arr, st: ProbeStatic, use_fft=True):
    """(tapered, filtered) per row: taper with cosine interpolation, rfft,
    spectral PLF filter, irfft, zero where the taper is zero
    (comparator.f90:1171-1263).  With use_fft=False (no filters in the
    plan) `filtered` aliases `tapered`."""
    tapered = _taper_arrays(ctx, arr)
    if not use_fft:
        return tapered, tapered
    spec = torch.fft.rfft(tapered, dim=-1)
    filtered = torch.fft.irfft(spec * ctx["filter_w"], n=st.pl, dim=-1).to(F32)
    filtered = torch.where(ctx["has_taper"][..., None],
                           filtered * ctx["taper_zero_one"], filtered)
    filtered = torch.where(ctx["has_filter"][..., None], filtered, tapered)
    return tapered, filtered


def amp_spectra(ctx, tapered):
    """(amp, amp_filtered) per row from the tapered rows: |rfft| and the
    same under the row's spectral PLF filter (processed_arrays' spectral
    outputs in the JAX package; kept apart so no time-domain path computes
    them)."""
    amp = torch.abs(torch.fft.rfft(tapered, dim=-1)).to(F32)
    ampf = torch.where(ctx["has_filter"][..., None], amp * ctx["filter_w"], amp)
    return amp, ampf


def _span_mask(lo, hi, st: ProbeStatic):
    j = st.ps0 + torch.arange(st.pl, device=lo.device)
    return ((j >= lo[..., None]) & (j <= hi[..., None])).to(F32)


def gsqrt(s):
    """sqrt, 0 at 0 without a NaN gradient (forward-identical)."""
    is0 = s == 0.0
    return torch.where(is0, 0.0, torch.sqrt(torch.where(is0, 1.0, s)))


def uniform_rec_major(rids, nrec):
    """k if the rc rows are rec-major with k rows per receiver
    (rids == repeat(arange(nrec), k)), else None."""
    rids = np.asarray(rids)
    if nrec <= 0 or rids.shape[0] % nrec:
        return None
    k = rids.shape[0] // nrec
    return k if (rids == np.repeat(np.arange(nrec), k)).all() else None


def fold_half(risetime, dt):
    """The live half width nint(0.5 * risetime / dt) of the post-synthesis
    rise time's fold (nshifts = 1 + 2 * half, receiver.f90:866-886): the
    samples by which the fold grows each side of a trace's data span, as
    trace_multiply_add grows a span by the shifts it adds (the fold's
    margin nshift_max, a plan's bound over its batch, is wider).
    risetime: f32 tensor of any shape; dt a number or an f32 tensor beside
    it (float32 arithmetic either way); int32 of risetime's shape."""
    from .gf.trace import jnint

    return jnint(0.5 * torch.as_tensor(risetime, dtype=F32) / dt)


def fold_stf_weights(risetime, dt, nshift_max):
    """Boxcar-fold weights f32[..., 2*nshift_max+1] for post-synthesis rise
    times (receiver.f90:866-886); integer shifts are k - nshift_max.
    risetime: f32 tensor of any shape (a scalar gives [K], a batch [B, K])."""
    risetime = torch.as_tensor(risetime, dtype=F32)[..., None]
    dt = to_device(dt, risetime.device, F32)
    k = torch.arange(2 * nshift_max + 1, dtype=F32, device=risetime.device) - nshift_max
    ts = k * dt
    lo = torch.maximum(-risetime / 2.0, ts - dt / 2.0)
    hi = torch.minimum(risetime / 2.0, ts + dt / 2.0)
    w = torch.clamp(hi - lo, min=0.0)
    # live taps per the reference: |k| <= half
    half = fold_half(risetime, dt)
    w = torch.where(torch.abs(k) <= half.to(F32), w, 0.0)
    total = torch.sum(w, dim=-1, keepdim=True)
    return torch.where(total > 0, w / torch.where(total > 0, total, 1.0),
                       torch.where(k == 0, 1.0, 0.0))


def apply_fold(vals, w):
    """Fold rows [..., NT] with the integer-shift kernel w[..., K]
    (K = 2*h+1; w's leading axes broadcast against vals'), edge-extended
    like strip_fold + trace_multiply_add: out[j] = sum_k w[k] * x_ext(j - (k - h))."""
    k = w.shape[-1]
    h = (k - 1) // 2
    nt = vals.shape[-1]
    dev = vals.device
    idx = torch.arange(nt, device=dev)[None, :] - (torch.arange(k, device=dev)[:, None] - h)
    gathered = vals[..., idx.clamp(0, nt - 1)]  # [..., K, NT]
    gathered = torch.where(idx < 0, 0.0, gathered)
    return (w[..., :, None] * gathered).sum(dim=-2)


def norm_spans(ctx, syn_lo, syn_hi, st: ProbeStatic):
    """Span over which time-domain norms integrate
    (probes_norm_timedomain, comparator.f90:770-822): the taper span when
    tapers are set, else the union of data spans.  syn_lo/syn_hi [..., RC]."""
    lo = torch.where(ctx["has_taper"], ctx["taper_lo"], torch.minimum(ctx["ref_lo"], syn_lo))
    hi = torch.where(ctx["has_taper"], ctx["taper_hi"], torch.maximum(ctx["ref_hi"], syn_hi))
    return lo, hi


def pair_norms(ctx, ref_arr, syn_arr, mask, method, st: ProbeStatic):
    """misfit = |ref - syn| and norm factor = |ref| under a time-domain
    `method`, summed over the last axis (l2norm_func etc.,
    comparator.f90:627-697).  ref/syn are the processed arrays to compare
    (filtered > tapered > plain, chosen by the caller); syn is scaled by the
    rows' syn_factor.  Shapes broadcast: ref [RC, W] against syn [B, RC, W].
    Sums are float32, as in the JAX package."""
    dt = np.float32(st.dt)
    fb = ctx["syn_factor"][..., None]
    if method == L2NORM:
        diff = ref_arr - fb * syn_arr
        m = gsqrt(dt * torch.sum(diff * diff * mask, dim=-1))
        n = gsqrt(dt * torch.sum(ref_arr * ref_arr * mask, dim=-1))
    elif method == L1NORM:
        diff = ref_arr - fb * syn_arr
        m = dt * torch.sum(torch.abs(diff) * mask, dim=-1)
        n = dt * torch.sum(torch.abs(ref_arr) * mask, dim=-1)
    elif method == SCALAR_PRODUCT:
        m = torch.sum(ref_arr * fb * syn_arr * mask, dim=-1)
        n = torch.sum(ref_arr * ref_arr * mask, dim=-1)
    elif method == PEAK:
        m = torch.amax(gsqrt(ref_arr**2 + (fb * syn_arr) ** 2) * mask, dim=-1)
        n = torch.amax(torch.abs(ref_arr) * mask, dim=-1)
    else:
        raise ValueError(f"unsupported time-domain method {method}")
    return m, n


def _next_pow2_i32(x):
    """Next power of two of positive int32 tensors by bit smearing: exact on
    powers of two (no float log2), 1 for x <= 1."""
    y = torch.clamp(x.to(I32), min=1) - 1
    for k in (1, 2, 4, 8, 16):
        y = y | (y >> k)
    return y + 1


def amp_grid(ps0, pl):
    """Extended-grid geometry (aps0, apl, ntrans_cap) of the exact per-pair
    amplitude-spectrum norms.

    With P = next_pow2(pl): apl = 4P, so every pow2 pair length up to the
    cap 2P divides apl (pair bins coincide with grid bins at stride
    apl // ntrans), and the margins ((4P - pl) // 2 >= 1.5P per side)
    contain the worst centred window: data spans live within the probe
    +- the fold widening (<= P/2 in any physical plan, the probe being sized
    to 2x the longest content), so ntrans <= next_pow2(pl + 4*fold) <= 2P
    and the centred window overhangs the union span by at most P per side.
    A 2x grid does NOT contain pairs longer than pl/2 placed off centre:
    their repeat-right content is truncated (2.7e-2 norm error measured on
    a right-aligned fold-widened span in the JAX package)."""
    p2 = 1 << (int(pl) - 1).bit_length()
    apl = 4 * p2
    return ps0 - (apl - pl) // 2, apl, 2 * p2


def ampspec_pair_misfits(ctx, syn, syn_lo, syn_hi, method, st: ProbeStatic):
    """Exact per-pair amplitude-spectrum misfits and reference norm factors,
    batched over the leading axes of syn.

    The reference grows each (ref, syn) probe pair onto its own pow2 span
    (probes_adjust_spans, comparator.f90:464-486: ntrans =
    next_pow2(max(len(union of the data spans), 2*max(len_ref, len_syn))),
    centred on the union), FFTs the tapered (else the raw zero-left /
    repeat-right) content over that span (update_spectrum,
    comparator.f90:1186-1215) and integrates with df = 1/(ntrans*dt).  The
    engine's probes share ONE span, so this rebuilds the per-pair semantics
    on amp_grid's extended grid: a signal supported on one ntrans-long
    window folds into period ntrans as a circular shift, so |FFT_apl(x *
    pairmask)| at stride apl // ntrans is the pair's own |FFT_ntrans|, and
    pair bin k' sits at extended bin k' * stride, where amp_filter_w holds
    the PLF filter.

    syn: probe-placed synthetics f32[..., RC, PL] (moment applied,
    untapered); syn_lo/syn_hi int[..., RC] absolute data spans.  Returns
    (misfit, norm) shaped like syn_lo, on ctx's normalized amplitudes.
    Right of syn_hi the rows hold the raw accumulation (usually zero) where
    the reference repeats the strip's last sample: the end-repeat
    regularization of the time-domain path (tests/test_golden_oracle.py);
    tapered rows are unaffected."""
    ps0, pl, dt = st.ps0, st.pl, st.dt
    aps0, apl, ncap = amp_grid(ps0, pl)
    dev = syn.device
    ref_lo, ref_hi = ctx["ref_lo"], ctx["ref_hi"]

    # per-pair span (probes_adjust_spans + allowed_span)
    u_lo = torch.minimum(ref_lo, syn_lo)
    u_hi = torch.maximum(ref_hi, syn_hi)
    ulen = u_hi - u_lo + 1
    minlen = 2 * torch.maximum(ref_hi - ref_lo + 1, syn_hi - syn_lo + 1)
    ntrans = torch.clamp(_next_pow2_i32(torch.maximum(ulen, minlen)), max=ncap)
    pair_lo = u_lo - torch.div(ntrans - ulen, 2, rounding_mode="floor")

    j = aps0 + torch.arange(apl, device=dev)  # absolute extended-grid indices
    rel = j - ps0
    relc = rel.clamp(0, pl - 1)

    def tapered_ext(arr):
        # the probe content on the extended grid: zeros left of the probe
        # span, its (repeat-right) last value beyond; then the taper
        ext = torch.where(rel < 0, 0.0, arr.index_select(-1, relc))
        return torch.where(ctx["has_taper"][..., None], ext * ctx["amp_taper_w"], ext)

    pmask = (j >= pair_lo[..., None]) & (j <= (pair_lo + ntrans - 1)[..., None])
    amp_r = torch.abs(torch.fft.rfft(tapered_ext(ctx["ref"]) * pmask, dim=-1)).to(F32)
    amp_s = torch.abs(torch.fft.rfft(tapered_ext(syn) * pmask, dim=-1)).to(F32)
    use_f = ctx["has_filter"][..., None]
    amp_r = torch.where(use_f, amp_r * ctx["amp_filter_w"], amp_r)
    amp_s = torch.where(use_f, amp_s * ctx["amp_filter_w"], amp_s)

    # pair bins = extended bins at stride apl // ntrans; df of the pair span
    k = torch.arange(apl // 2 + 1, device=dev)
    stride = torch.div(apl, ntrans, rounding_mode="floor")
    binmask = (k % stride[..., None]) == 0
    df = 1.0 / (ntrans.to(F32) * np.float32(dt))
    diff = amp_r - ctx["syn_factor"][..., None] * amp_s
    if method == AMPSPEC_L2NORM:
        m = gsqrt(df * torch.sum(diff * diff * binmask, dim=-1))
        n = torch.sqrt(df * torch.sum(amp_r * amp_r * binmask, dim=-1))
    elif method == AMPSPEC_L1NORM:
        m = df * torch.sum(torch.abs(diff) * binmask, dim=-1)
        n = df * torch.sum(torch.abs(amp_r) * binmask, dim=-1)
    else:
        raise ValueError(f"unsupported frequency-domain method {method}")
    return m, n


def ref_norm_spans(ctx, shift=0):
    """Span of the reference-only norm factor (probe_norm_timedomain,
    comparator.f90:824-859): the taper span if defined, else the ref data
    span moved by `shift`."""
    lo = torch.where(ctx["has_taper"], ctx["taper_lo"], ctx["ref_lo"] + shift)
    hi = torch.where(ctx["has_taper"], ctx["taper_hi"], ctx["ref_hi"] + shift)
    return lo, hi


def _ref_norm(ref_proc, mask, method, st: ProbeStatic):
    """Reference norm factor of a time-domain method over the masked span."""
    dt = np.float32(st.dt)
    if method == L2NORM:
        return torch.sqrt(dt * torch.sum(ref_proc * ref_proc * mask, dim=-1))
    if method == L1NORM:
        return dt * torch.sum(torch.abs(ref_proc) * mask, dim=-1)
    if method == SCALAR_PRODUCT:
        return torch.sum(ref_proc * ref_proc * mask, dim=-1)
    if method == PEAK:
        return torch.amax(torch.abs(ref_proc) * mask, dim=-1)
    raise ValueError(f"unsupported method {method}")


def precompute_ref_context(ctx, method, st: ProbeStatic, shiftrange=(0, 0),
                           any_taper=True, any_filter=True):
    """Source-independent misfit quantities, computed once per plan.  For a
    floating norm: the processed reference for every trial shift
    ref_proc f32[S, RC, PL], the shifted data spans, and the reference norm
    factors (averaged over each row's allowed shifts).  For a time-domain
    norm: the processed reference ref_proc f32[RC, PL] and its norm
    factors.  An amplitude-spectrum norm has none (its windows and norm
    factors depend on each synthetic's span: ampspec_pair_misfits)."""
    if method in AMPSPEC:
        return {"method": method}
    if method in TIME_DOMAIN:
        tap_r, filt_r = processed_arrays(ctx, ctx["ref"], st, use_fft=any_filter)
        ref_proc = torch.where(ctx["has_filter"][..., None], filt_r, tap_r)
        nlo, nhi = ref_norm_spans(ctx)
        norm = _ref_norm(ref_proc, _span_mask(nlo, nhi, st), method, st)
        return {"method": method, "ref_proc": ref_proc,
                "norm": torch.where(ctx["enabled"], norm, 0.0)}
    if method not in FLOATING:
        raise ValueError(f"unknown misfit method {method}")
    base = L2NORM if method == FLOATING_L2NORM else L1NORM
    s1, s2 = int(shiftrange[0]), int(shiftrange[1])
    dev = ctx["ref"].device
    refs = []
    norms = []
    for s in range(s1, s2 + 1):
        ref_s = shift_probe(ctx["ref"], ctx["ref_lo"], ctx["ref_hi"], s, st)
        tap_r, filt_r = processed_arrays(ctx, ref_s, st, use_fft=any_filter)
        ref_proc = torch.where(ctx["has_filter"][..., None], filt_r, tap_r)
        nlo, nhi = ref_norm_spans(ctx, s)
        norms.append(_ref_norm(ref_proc, _span_mask(nlo, nhi, st), base, st))
        refs.append(ref_proc)
    shifts = torch.arange(s1, s2 + 1, dtype=I32, device=dev)
    in_range = (shifts[:, None] >= ctx["shift_lo"][None, :]) & (
        shifts[:, None] <= ctx["shift_hi"][None, :])
    cnt = torch.clamp(in_range.sum(dim=0), min=1)
    norm = torch.where(in_range, torch.stack(norms), 0.0).sum(dim=0) / cnt
    return {
        "method": method,
        "base": base,
        "shifts": shifts,
        "ref_proc": torch.stack(refs),  # [S, RC, PL]
        "ref_lo_s": ctx["ref_lo"][None, :] + shifts[:, None],
        "ref_hi_s": ctx["ref_hi"][None, :] + shifts[:, None],
        "norm": torch.where(ctx["enabled"], norm, 0.0),
    }


# ---------------------------------------------------------------------------
# fused floating-norm evaluation
# ---------------------------------------------------------------------------


def eval_window_slice(eval_win, st: ProbeStatic, mult=8):
    """Probe-relative slice [i0, i0 + wk) covering the static absolute eval
    window, its length rounded up to `mult` (and kept inside the probe)."""
    if eval_win is not None:
        i0 = max(int(eval_win[0]) - st.ps0, 0)
        i1 = min(int(eval_win[1]) - st.ps0 + 1, st.pl)
    else:
        i0, i1 = 0, st.pl
    wk = min(-(-(i1 - i0) // mult) * mult, st.pl)
    return max(min(i0, st.pl - wk), 0), wk


def evaluate_misfits_floating_fused(
    ctx,
    v_rtw,
    wgt_rtb,
    syn_it0,
    syn_lo,
    syn_hi,
    st: ProbeStatic,
    nrec,
    moments,
    risetime0,
    rctx,
    fold_nshift_max=0,
    any_taper=True,
    any_filter=False,
    eval_win=None,
    k_share=1,
    rids=None,
):
    """Shared-kinematics floating-norm evaluation with the synthesis
    contraction fused into the scan kernel (ops/float_scan.fused_scan_sums):
    the synthetic block syn[b, rc] = sum_t wgt[rc, t, b] * v[rc, t] is never
    materialized.  Every processing step (fold, place_on_probe, taper,
    rfft -> PLF filter -> irfft, syn_factor, moment) is linear, so it is
    applied to the T values rows once instead of to B synthetics.

    v_rtw: f32[RV, T, NT] raw values rows, RV = RC // k_share (k_share > 1:
        rows shared across each receiver's channel rows; taper/filter-free
        plans only) or RC.
    wgt_rtb: f32[RC, T, B] per-source weights (rotation + signs folded).
    moments: f32[B]; risetime0: the batch-uniform risetime.
    syn_lo/syn_hi: int[RC] batch-shared physical spans.
    rctx: precompute_ref_context output.  rids: host numpy receiver ids
    (layout decisions stay on the host; defaults to ctx's, copied back).
    Returns (m [B, RC], norm [B, RC], floating_shift [B, R]).
    """
    base = rctx["base"]
    l2 = base == L2NORM
    RC, _T, B = wgt_rtb.shape

    if fold_nshift_max > 0:
        wf = fold_stf_weights(risetime0, st.dt, fold_nshift_max)
        v_rtw = apply_fold(v_rtw, wf)
        half = torch.clamp(fold_half(risetime0, st.dt), max=fold_nshift_max)
        syn_lo = syn_lo - half
        syn_hi = syn_hi + half

    v_p = place_on_probe(v_rtw, syn_it0, st)  # [RV, T, PL]
    if any_taper or any_filter:
        if k_share != 1:
            raise ValueError("taper/filter rows need per-rc values rows (k_share=1)")
        v_p = torch.where(ctx["has_taper"][:, None, None],
                          v_p * ctx["taper_w"][:, None, :], v_p)
    if any_filter:
        # probe processing chain on the values rows (processed_arrays
        # semantics): T*RC small FFTs per batch instead of B*RC
        spec = torch.fft.rfft(v_p, dim=-1)
        filt = torch.fft.irfft(spec * ctx["filter_w"][:, None, :], n=st.pl, dim=-1).to(F32)
        filt = torch.where(ctx["has_taper"][:, None, None],
                           filt * ctx["taper_zero_one"][:, None, :], filt)
        v_p = torch.where(ctx["has_filter"][:, None, None], filt, v_p)
    # per-rc syn_factor and per-source moment fold into the weights
    wgt = wgt_rtb * ctx["syn_factor"][:, None, None] * moments.to(F32)[None, None, :]

    i0, wk = eval_window_slice(eval_win, st)
    ref_sl = rctx["ref_proc"][..., i0:i0 + wk]  # [S, RC, W]
    v_sl = v_p[..., i0:i0 + wk].contiguous()  # [RV, T, W]
    ref_rsw = ref_sl.transpose(0, 1).contiguous()  # [RC, S, W]
    basei = st.ps0 + i0

    if any_filter:
        # exact per-(shift, rc) span masks in the kernel: filtered rows ring
        # to the probe edges, so the misfit integrates over the taper span
        # or the union of data spans, not full-window-minus-tail
        lo = torch.where(ctx["has_taper"][None, :], ctx["taper_lo"][None, :],
                         torch.minimum(rctx["ref_lo_s"], syn_lo[None, :]))  # [S, RC]
        hi = torch.where(ctx["has_taper"][None, :], ctx["taper_hi"][None, :],
                         torch.maximum(rctx["ref_hi_s"], syn_hi[None, :]))
        out = fused_scan_sums(ref_rsw, v_sl, wgt, lo=lo, hi=hi, basei=basei,
                              k_share=k_share, l2=l2)  # [RC, S, B]
        sums = torch.clamp(out.transpose(0, 1), min=0.0)
    else:
        out = fused_scan_sums(ref_rsw, v_sl, wgt, k_share=k_share, l2=l2)
        # exact tail correction: right of hi = max(ref span, syn span) both
        # arrays repeat their edge values (zero for tapered rows)
        hi = torch.maximum(rctx["ref_hi_s"], syn_hi[None, :])  # [S, RC]
        hi_loc = torch.clamp(hi - basei, 0, wk - 1)
        hi_loc = torch.where(ctx["has_taper"][None, :], wk - 1, hi_loc)
        count = (wk - 1 - hi_loc).to(F32)  # [S, RC]
        v_edge = v_sl[..., -1]  # [RV, T]
        if k_share > 1:
            v_edge = v_edge.repeat_interleave(k_share, dim=0)
        syn_edge = torch.einsum("rtb,rt->rb", wgt, v_edge)  # [RC, B]
        dlast = ref_sl[..., -1][:, :, None] - syn_edge[None, :, :]  # [S, RC, B]
        tail = count[..., None] * (dlast * dlast if l2 else torch.abs(dlast))
        # f32 rounding can leave out - tail a hair negative when the span
        # contributes ~nothing; clamp before the L2 sqrt
        sums = torch.clamp(out.transpose(0, 1) - tail, min=0.0)
    return _floating_select(ctx, rctx, sums, st, nrec, rids)


def _floating_select(ctx, rctx, sums, st: ProbeStatic, nrec, rids=None):
    """Scan sums f32[S, RC, B] -> (m [B, RC], norm [B, RC], floating_shift
    [B, R]): the l1/l2 misfit per trial shift, the per-receiver shift with
    the least summed misfit (first minimum on ties, as jnp.argmin), and the
    amplitude normalization undone."""
    l2 = rctx["base"] == L2NORM
    RC, B = sums.shape[1], sums.shape[2]
    dtc = np.float32(st.dt)
    ms = gsqrt(dtc * sums) if l2 else dtc * sums  # [S, RC, B]
    ms = torch.where(ctx["enabled"][None, :, None], ms, 0.0)

    # per-receiver shift selection: the receiver's allowed window is the
    # min/max over its rows (segment_min/max in the reference)
    if rids is None:
        rids = to_host(ctx["receiver_ids"])[0]
    rid_t = ctx["receiver_ids"].long()
    rlo = torch.full((nrec,), 1 << 30, dtype=I32, device=ms.device).scatter_reduce(
        0, rid_t, ctx["shift_lo"], reduce="amin")
    rhi = torch.full((nrec,), -(1 << 30), dtype=I32, device=ms.device).scatter_reduce(
        0, rid_t, ctx["shift_hi"], reduce="amax")
    shifts = rctx["shifts"]
    allowed = (shifts[:, None] >= rlo[None, :]) & (shifts[:, None] <= rhi[None, :])  # [S, R]

    S = shifts.shape[0]
    msq = ms * ms if l2 else ms  # [S, RC, B]
    ku = uniform_rec_major(rids, nrec)
    if ku is not None:
        per_rec = msq.reshape(S, nrec, ku, B).sum(dim=2)  # [S, R, B]
    else:
        per_rec = torch.zeros((S, nrec, B), dtype=F32, device=ms.device).index_add_(
            1, rid_t, msq)
    per_rec = torch.where(allowed[..., None], per_rec, torch.inf)
    iloc = torch.argmin(per_rec, dim=0)  # [R, B]; first minimum on ties
    shift_sel = shifts[iloc].T  # [B, R]
    m = torch.gather(ms, 0, iloc[rid_t][None])[0].T  # [B, RC]
    n = rctx["norm"][None, :].expand(B, RC)
    s0 = ctx["amp_scale"]
    return m * s0, n * s0, shift_sel


# ---------------------------------------------------------------------------
# floating-norm evaluation of precomputed synthetics (finite sources)
# ---------------------------------------------------------------------------


def _scaled_probes(ctx, syn_traces_b, syn_it0, syn_lo_b, syn_hi_b, st, moments,
                   risetimes, fold_nshift_max):
    """Per-model STF fold, probe placement and moment: syn [B, RC, PL] and
    the batch's [B, RC] data spans (kiwi_tpu.misfit's batched prologue)."""
    B, RC, _nt = syn_traces_b.shape
    syn_lo_b = torch.broadcast_to(syn_lo_b, (B, RC))
    syn_hi_b = torch.broadcast_to(syn_hi_b, (B, RC))
    if risetimes is not None and fold_nshift_max > 0:
        wf = fold_stf_weights(risetimes, st.dt, fold_nshift_max)  # [B, K]
        syn_traces_b = apply_fold(syn_traces_b, wf[:, None, :])
        # each model's span grows by the half width of its own live taps,
        # not by the plan's margin (a row's misfit must not depend on the
        # rise times of its batch)
        half = torch.clamp(fold_half(risetimes, st.dt), max=fold_nshift_max)[:, None]
        syn_lo_b = syn_lo_b - half
        syn_hi_b = syn_hi_b + half
    syn = place_on_probe(syn_traces_b, syn_it0, st) * moments.to(F32)[:, None, None]
    return syn, syn_lo_b, syn_hi_b


def evaluate_misfits_floating_batch(ctx, syn_traces_b, syn_it0, syn_lo_b, syn_hi_b,
                                    st: ProbeStatic, nrec, moments, risetimes, rctx,
                                    fold_nshift_max=0, eval_win=None, rids=None):
    """Batched floating-norm evaluation of precomputed synthetics through the
    scan kernel (ops/float_scan.scan_sums), for plans WITHOUT filters
    (kiwi_tpu.misfit.evaluate_misfits_floating_batch): tapered rows are zero
    outside the taper span, and untapered rows repeat their edge values
    right of their data spans, so the unmasked window sum minus a closed-form
    tail is the span integral.

    syn_traces_b: f32[B, RC, NT] raw synthetics starting at absolute syn_it0;
    syn_lo_b/syn_hi_b: int[B, RC] or [RC] data spans; moments f32[B];
    risetimes f32[B] or None (per-model STF fold).  The window slice is
    eval_window_slice's (its length rounded up to 8 samples, where the JAX
    package rounds to 128 lanes): the tail correction makes the sums
    independent of that length in exact arithmetic.
    Returns (m [B, RC], norm [B, RC], floating_shift [B, R]).
    """
    l2 = rctx["base"] == L2NORM
    syn, _lo, syn_hi_b = _scaled_probes(ctx, syn_traces_b, syn_it0, syn_lo_b, syn_hi_b,
                                        st, moments, risetimes, fold_nshift_max)
    syn_s = _taper_arrays(ctx, syn) * ctx["syn_factor"][None, :, None]

    i0, wk = eval_window_slice(eval_win, st)
    ref_sl = rctx["ref_proc"][..., i0:i0 + wk]  # [S, RC, W]
    syn_sl = syn_s[..., i0:i0 + wk]  # [B, RC, W]
    S, RC = ref_sl.shape[:2]
    out = scan_sums(ref_sl.reshape(S * RC, wk), syn_sl.transpose(0, 1), l2=l2)  # [S, B, RC]

    # exact tail correction: right of hi = max(ref span, syn span) both
    # arrays repeat their edge values (zero for tapered rows)
    basei = st.ps0 + i0
    hi = torch.maximum(rctx["ref_hi_s"][:, None, :], syn_hi_b[None])  # [S, B, RC]
    hi_loc = torch.clamp(hi - basei, 0, wk - 1)
    hi_loc = torch.where(ctx["has_taper"][None, None, :], wk - 1, hi_loc)
    count = (wk - 1 - hi_loc).to(F32)
    dlast = ref_sl[..., -1][:, None, :] - syn_sl[..., -1][None]  # [S, B, RC]
    tail = count * (dlast * dlast if l2 else torch.abs(dlast))
    # f32 rounding can leave out - tail a hair negative; clamp before the sqrt
    sums = torch.clamp(out - tail, min=0.0).transpose(1, 2)  # [S, RC, B]
    return _floating_select(ctx, rctx, sums, st, nrec, rids)


def evaluate_misfits(ctx, syn_traces_b, syn_it0, syn_lo_b, syn_hi_b, st: ProbeStatic,
                     nrec, moments, risetimes, rctx, fold_nshift_max=0, any_filter=True,
                     eval_win=None, rids=None, chunk_elems=1 << 25):
    """Per-model evaluation with exact span masks: kiwi_tpu.misfit.
    evaluate_misfits (which the JAX engine vmaps over sources) for the
    floating and the time-domain norms, batched over B.  It runs the probe
    chain (taper -> rfft -> PLF filter -> irfft) on every synthetic, so it
    serves the filtered floating plans the scan kernel cannot take, every
    time-domain plan and the amplitude-spectrum norms (on the raw probes:
    ampspec_pair_misfits); the JAX package has no kernel for any of them.
    Floating norms are chunked over B so that the [S, b, RC, W] difference
    block stays under `chunk_elems` elements.

    Arguments as evaluate_misfits_floating_batch.  Returns (m [B, RC],
    norm [B, RC], floating_shift [B, R]); the time-domain and spectral
    norms shift nothing (zeros).
    """
    syn, syn_lo_b, syn_hi_b = _scaled_probes(ctx, syn_traces_b, syn_it0, syn_lo_b,
                                             syn_hi_b, st, moments, risetimes,
                                             fold_nshift_max)
    if rctx["method"] in AMPSPEC:
        m, n = ampspec_pair_misfits(ctx, syn, syn_lo_b, syn_hi_b, rctx["method"], st)
        s0 = ctx["amp_scale"]
        m = torch.where(ctx["enabled"], m, 0.0) * s0
        n = torch.where(ctx["enabled"], n, 0.0) * s0
        return m, n, torch.zeros((m.shape[0], nrec), dtype=I32, device=m.device)
    tap_s, filt_s = processed_arrays(ctx, syn, st, use_fft=any_filter)
    syn_proc = torch.where(ctx["has_filter"][:, None], filt_s, tap_s)  # [B, RC, PL]

    if eval_win is not None:
        i0 = max(int(eval_win[0]) - st.ps0, 0)
        i1 = min(int(eval_win[1]) - st.ps0 + 1, st.pl)
    else:
        i0, i1 = 0, st.pl
    if rctx["method"] in TIME_DOMAIN:
        return _time_domain_misfits(ctx, rctx, syn_proc[..., i0:i1], syn_lo_b, syn_hi_b,
                                    st, nrec, i0)
    l2 = rctx["base"] == L2NORM
    # misfit spans per shift: the taper span or the union of data spans
    has_taper = ctx["has_taper"][None, None, :]
    lo = torch.where(has_taper, ctx["taper_lo"][None, None, :],
                     torch.minimum(rctx["ref_lo_s"][:, None, :], syn_lo_b[None]))  # [S, B, RC]
    hi = torch.where(has_taper, ctx["taper_hi"][None, None, :],
                     torch.maximum(rctx["ref_hi_s"][:, None, :], syn_hi_b[None]))
    j = st.ps0 + i0 + torch.arange(i1 - i0, device=syn.device)
    ref_sl = rctx["ref_proc"][:, None, :, i0:i1]  # [S, 1, RC, W]
    syn_sl = ctx["syn_factor"][:, None] * syn_proc[..., i0:i1]  # [B, RC, W]
    S, RC, B = ref_sl.shape[0], ref_sl.shape[2], syn.shape[0]
    sums = torch.empty((S, B, RC), dtype=F32, device=syn.device)
    step = max(1, chunk_elems // max(S * RC * (i1 - i0), 1))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        mask = ((j >= lo[:, sl, :, None]) & (j <= hi[:, sl, :, None])).to(F32)
        diff = ref_sl - syn_sl[None, sl]  # [S, b, RC, W]
        u = diff * diff if l2 else torch.abs(diff)
        sums[:, sl] = torch.sum(u * mask, dim=-1)
    return _floating_select(ctx, rctx, sums.transpose(1, 2), st, nrec, rids)


def _time_domain_misfits(ctx, rctx, syn_sl, syn_lo_b, syn_hi_b, st: ProbeStatic, nrec, i0):
    """The time-domain branch of evaluate_misfits: syn_sl the processed,
    moment-scaled synthetics [B, RC, W] on the probe slice from i0.  The
    amplitude normalization is undone as in the JAX package: misfit and norm
    are 1-homogeneous in (ref, syn_factor * syn), the scalar product
    2-homogeneous, its s0 applied as chained multiplies (a bare s0 * s0
    flushes to zero in float32 at moment-1.0 scales)."""
    method = rctx["method"]
    lo, hi = norm_spans(ctx, syn_lo_b, syn_hi_b, st)  # [B, RC]
    j = st.ps0 + i0 + torch.arange(syn_sl.shape[-1], device=syn_sl.device)
    mask = ((j >= lo[..., None]) & (j <= hi[..., None])).to(F32)
    m, _ = pair_norms(ctx, rctx["ref_proc"][..., i0:i0 + syn_sl.shape[-1]], syn_sl, mask,
                      method, st)
    m = torch.where(ctx["enabled"], m, 0.0)
    n = rctx["norm"][None, :].expand_as(m)
    s0 = ctx["amp_scale"]
    m, n = m * s0, n * s0
    if method == SCALAR_PRODUCT:
        m, n = m * s0, n * s0
    return m, n, torch.zeros((m.shape[0], nrec), dtype=I32, device=m.device)


def global_misfit(misfits, norms):
    """sqrt(sum m^2)/sqrt(sum n^2) over the last axis
    (minimizer_engine.f90:935-942), max-scaled with one shared scale so tiny
    amplitude scales (moment-1.0 sessions: m ~ 1e-19) do not flush their
    squares to zero."""
    m = misfits.to(F32)
    n = norms.to(F32)
    a = torch.maximum(torch.abs(m).amax(dim=-1), torch.abs(n).amax(dim=-1))
    a_s = torch.where(a == 0.0, 1.0, a)[..., None]
    m = m / a_s
    n = n / a_s
    return torch.sqrt(torch.sum(m * m, dim=-1)) / torch.sqrt(torch.sum(n * n, dim=-1))


def stable_l2(x):
    """sqrt(sum x^2) over the last axis, max-scaled as minpack's enorm (a
    moment-1.0 session's squares sit near 1e-38 and flush to zero in
    float32), with a gradient that stays finite where every x is 0: the
    double where and gsqrt give the 0 subgradient (kiwi_tpu.engine's
    global_misfits_and_grad; global_misfit's bare sqrt has no such guard)."""
    x = x.to(F32)
    a = torch.abs(x).amax(dim=-1)
    a_s = torch.where(a == 0.0, 1.0, a)
    y = x / a_s[..., None]
    return a * gsqrt(torch.sum(y * y, dim=-1))


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def cross_correlation(ctx, syn, shiftrange, st: ProbeStatic):
    """Windowed cross correlation: scalar products of the processed
    synthetics syn f32[RC, PL] (probe-placed) against the processed
    reference shifted through shiftrange (probes_windowed_cross_corr,
    comparator.f90:1061-1090), all shifts at once.  Returns f32[S, RC].

    ctx holds ref/s0 and syn_factor/s0 (MisfitSetup.to); the scalar product
    is 2-homogeneous, so s0 comes back as chained multiplies (m * s0) * s0:
    a bare s0 * s0 flushes to zero in float32 at s0 ~ 1e-19."""
    s1, s2 = int(shiftrange[0]), int(shiftrange[1])
    shifts = torch.arange(s1, s2 + 1, device=syn.device)
    ref_s = shift_probe(ctx["ref"], ctx["ref_lo"], ctx["ref_hi"], shifts[:, None, None], st)
    tap_r, filt_r = processed_arrays(ctx, ref_s, st)
    ref_proc = torch.where(ctx["has_filter"][..., None], filt_r, tap_r)  # [S, RC, PL]
    tap_s, filt_s = processed_arrays(ctx, syn, st)
    syn_proc = torch.where(ctx["has_filter"][..., None], filt_s, tap_s)  # [RC, PL]
    # norm_spans with the synthetic spanning the whole probe
    ref_lo = ctx["ref_lo"][None, :] + shifts[:, None]
    ref_hi = ctx["ref_hi"][None, :] + shifts[:, None]
    lo = torch.where(ctx["has_taper"], ctx["taper_lo"], torch.clamp(ref_lo, max=st.ps0))
    hi = torch.where(ctx["has_taper"], ctx["taper_hi"],
                     torch.clamp(ref_hi, min=st.ps0 + st.pl - 1))
    m, _ = pair_norms(ctx, syn_proc, ref_proc, _span_mask(lo, hi, st), SCALAR_PRODUCT, st)
    s0 = ctx["amp_scale"]
    return m * s0 * s0


def _first_differences(rows, order):
    """First (order 1: x[k] - x[k+1]) or second (x[k] - 2 x[k+1] + x[k+2])
    differences along the last axis, float64."""
    rows = rows.to(torch.float64)
    if order == 1:
        return rows[..., :-1] - rows[..., 1:]
    return rows[..., :-2] - 2.0 * rows[..., 1:-1] + rows[..., 2:]


def _max_scale(d):
    """The largest |d| per group [..., 1, 1] (1 where it is 0)."""
    a = torch.abs(d).amax(dim=(-2, -1), keepdim=True)
    return a, torch.where(a == 0.0, 1.0, a)


def peak_amplitude(syn_rows, mask, differentiate, st: ProbeStatic):
    """max |d^k u/dt^k| vector norm over grouped components
    (max_vecnorm_d1/d2, comparator.f90:519-589), float64.  syn_rows
    f32[..., G, PL]: the groups' component rows; mask [..., PL] applies to
    the first sample of each finite difference.  Returns [...].  The
    differences are max-scaled per group before squaring, as in the JAX
    package."""
    d = _first_differences(syn_rows, differentiate)
    dmask = mask[..., : d.shape[-1]]
    a, a_s = _max_scale(d)
    power = torch.sum((d / a_s) ** 2, dim=-2)
    root = a[..., 0, 0] * gsqrt(torch.amax(power * dmask, dim=-1))
    dt = float(st.dt)
    return root / (dt if differentiate == 1 else dt**2)


def arias_intensity(syn_rows, mask, st: ProbeStatic):
    """pi/(2g) * dt * the summed squared second differences / dt^2
    (arias_intensity_*, comparator.f90:591-625), float64; shapes as
    peak_amplitude's."""
    d = _first_differences(syn_rows, 2)
    a, a_s = _max_scale(d)
    total = (a[..., 0, 0] * a[..., 0, 0]) * torch.sum(
        torch.sum((d / a_s) ** 2, dim=-2) * mask[..., :-2], dim=-1)
    dt = float(st.dt)
    return np.pi / (2.0 * 9.81) * dt * total / dt**2
