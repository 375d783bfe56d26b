"""Waveform misfits: the floating norms and the time-domain norms (port of
the parts of kiwi_tpu/misfit.py that the point sweep, the finite-source
batches and the eikonal grid search reach).

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
l1norm, scalar_product, peak) have no kernel in either package:
evaluate_misfits computes them in plain torch, batched over sources.  The
spectral norms raise NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.float_scan import fused_scan_sums, scan_sums
from .plf import PLF

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
_TODO_SPECTRAL = ("the spectral misfit norms (ampspec_l2norm, ampspec_l1norm) are not "
                  "ported yet (ROADMAP.md queue 1, item 4)")


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

    def set_filter(self, irc, filt: PLF):
        """Spectral filter on rfft bins, coordinate k*df
        (comparator.f90:1218-1231)."""
        nf = self.static.pl // 2 + 1
        self.filter_w[irc] = filt.taper_weights((0, nf - 1), self.static.df, ip="cos").astype(
            np.float32
        )
        self.has_filter[irc] = True

    def to(self, device):
        """The misfit context as tensors on `device`.

        Amplitude normalization: every norm runs on ref/s0 and
        syn_factor/s0, and the eval multiplies the 1-homogeneous outputs
        back by s0.  Without it a moment-1.0 source (samples ~1e-19) has
        squares ~1e-38, which flush to zero in float32.  `amp_scale` stays a
        Python float (it multiplies host-side into the outputs)."""
        s0 = float(np.abs(self.ref).max())
        if not np.isfinite(s0) or s0 == 0.0:
            s0 = 1.0
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return {
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
    absolute data spans."""
    rel = torch.arange(st.pl, device=arr.device)[None, :] - s
    lo_rel = lo[:, None].long() - st.ps0
    hi_rel = hi[:, None].long() - st.ps0
    relc = torch.minimum(torch.maximum(rel, lo_rel), hi_rel)  # edge extension
    v = torch.gather(arr, -1, relc.expand(arr.shape))
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


def fold_stf_weights(risetime, dt, nshift_max):
    """Boxcar-fold weights f32[..., 2*nshift_max+1] for post-synthesis rise
    times (receiver.f90:866-886); integer shifts are k - nshift_max.
    risetime: f32 tensor of any shape (a scalar gives [K], a batch [B, K])."""
    from .gf.trace import jnint

    risetime = torch.as_tensor(risetime, dtype=F32)[..., None]
    dt = torch.as_tensor(dt, dtype=F32, device=risetime.device)
    k = torch.arange(2 * nshift_max + 1, dtype=F32, device=risetime.device) - nshift_max
    ts = k * dt
    lo = torch.maximum(-risetime / 2.0, ts - dt / 2.0)
    hi = torch.minimum(risetime / 2.0, ts + dt / 2.0)
    w = torch.clamp(hi - lo, min=0.0)
    # live count per the reference: nshifts = 1 + 2*nint(0.5*risetime/dt)
    nlive = 1 + 2 * jnint(0.5 * risetime / dt)
    half = torch.div(nlive - 1, 2, rounding_mode="floor")
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
    factors."""
    if method in TIME_DOMAIN:
        tap_r, filt_r = processed_arrays(ctx, ctx["ref"], st, use_fft=any_filter)
        ref_proc = torch.where(ctx["has_filter"][..., None], filt_r, tap_r)
        nlo, nhi = ref_norm_spans(ctx)
        norm = _ref_norm(ref_proc, _span_mask(nlo, nhi, st), method, st)
        return {"method": method, "ref_proc": ref_proc,
                "norm": torch.where(ctx["enabled"], norm, 0.0)}
    if method not in FLOATING:
        raise NotImplementedError(_TODO_SPECTRAL)
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
        syn_lo = syn_lo - fold_nshift_max
        syn_hi = syn_hi + fold_nshift_max

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
        rids = ctx["receiver_ids"].cpu().numpy()
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
        syn_lo_b = syn_lo_b - fold_nshift_max
        syn_hi_b = syn_hi_b + fold_nshift_max
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
    serves the filtered floating plans the scan kernel cannot take and every
    time-domain plan; the JAX package has no kernel for either.  Floating
    norms are chunked over B so that the [S, b, RC, W] difference block
    stays under `chunk_elems` elements.

    Arguments as evaluate_misfits_floating_batch.  Returns (m [B, RC],
    norm [B, RC], floating_shift [B, R]); the time-domain norms shift
    nothing (zeros).
    """
    if rctx is None:
        raise NotImplementedError(_TODO_SPECTRAL)
    syn, syn_lo_b, syn_hi_b = _scaled_probes(ctx, syn_traces_b, syn_it0, syn_lo_b,
                                             syn_hi_b, st, moments, risetimes,
                                             fold_nshift_max)
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
