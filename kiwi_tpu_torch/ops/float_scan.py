"""Floating-shift scan sums: the CUDA kernels' wrappers and their plain
PyTorch versions.  `fused_scan_sums` fuses the shared-kinematics synthesis
into the scan; `scan_sums` (end of the file) scans precomputed synthetics.

For shared-kinematics plans the synthetic of model b on receiver-channel
row rc is a weight contraction against batch-invariant values rows,
syn[w, b] = sum_t v[rc // k_share, t, w] * wgt[rc, t, b].  The floating
norms need, for every trial reference shift s, the window sum
out[rc, s, b] = sum_w u(ref[rc, s, w] - syn[w, b]) (u = |d| or d^2), masked
per (s, rc) span on filtered plans.  The kernel (csrc/float_scan.cu) fuses
both, so the [B, RC, W] synthetic block never exists in device memory.

It replaces the TPU kernels kiwi_tpu/ops/float_scan.py:_fused_kernel and
_fused_kernel_masked.  Their lane-broadcast operand tiles existed only for
the TPU's (8, 128) layout; here the operands are compact and the kernel
turns lo/hi into per-shift window ranges itself.  What bounds it on an H100
is float32 instruction issue: T FFMAs per sample of the synthesis and two
adds per live (shift, sample) of the scan, 5,184 per (model, rc) at the
point sweep's shapes, against 4*T bytes of weights.  Its design: one or two
models per thread, weights and running sums in registers, the window copied
into shared memory once, 16-byte shared-memory broadcasts that each feed
four FMAs or eight adds a model, shift buckets that fit the odd S of
symmetric shift ranges, and on filtered plans only the samples some span
reaches, with dead (shift, quad) pairs skipped.  A NaN or
Inf outside every span therefore does not reach the kernel's output, where
the plain version propagates it.  See the source's header.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, refuse_grad

# kernel launches per kernel since the last reset (plain-version calls are
# not counted): "fused_scan" replaces _fused_kernel, "fused_scan_masked"
# _fused_kernel_masked, "scan_sums" _scan_kernel and _scan_kernel_blocked
launches = {"fused_scan": 0, "fused_scan_masked": 0, "scan_sums": 0}

MAX_T = 64  # the kernel's largest register array of weights


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("float_scan.cu")
    fn = lib.kiwi_fused_scan_sums
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(ref, v, wgt, lo, hi, k_share):
    for name, x in (("ref", ref), ("v", v), ("wgt", wgt)):
        if x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError(f"{name} must be a 3-d float32 tensor, got {x.dtype} {tuple(x.shape)}")
    RC, S, W = ref.shape
    RV, T, W2 = v.shape
    RC3, T3, B = wgt.shape
    if W2 != W or RC3 != RC or T3 != T or RV * k_share != RC:
        raise ValueError(
            f"shape mismatch: ref {tuple(ref.shape)}, v {tuple(v.shape)}, "
            f"wgt {tuple(wgt.shape)}, k_share {k_share}")
    if (lo is None) != (hi is None):
        raise ValueError("lo and hi go together")
    tensors = [ref, v, wgt] + ([lo, hi] if lo is not None else [])
    if lo is not None:
        for name, x in (("lo", lo), ("hi", hi)):
            if x.dtype != torch.int32 or tuple(x.shape) != (S, RC):
                raise ValueError(f"{name} must be int32 [S, RC] = ({S}, {RC}), "
                                 f"got {x.dtype} {tuple(x.shape)}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    return RC, S, T, W, B


def fused_scan_sums(ref, v, wgt, lo=None, hi=None, basei=0, k_share=1, l2=False):
    """Fused synthesis + full-window scan sums.

    ref: f32[RC, S, W] processed + shifted references.
    v:   f32[RV, T, W] processed values rows, RV = RC // k_share.
    wgt: f32[RC, T, B] per-model weights (moment and syn_factor folded in).
    lo, hi: optional i32[S, RC] absolute span bounds; when given, sample w
        (absolute index basei + w) counts only where lo <= basei + w <= hi.
    Returns f32[RC, S, B]; the caller applies the tail correction
    (unmasked), dt and the floating-shift selection.
    """
    RC, S, T, W, B = _check(ref, v, wgt, lo, hi, k_share)
    refuse_grad("fused_scan_sums", ref, v, wgt)
    dev = ref.device
    if dev.type == "cpu":
        return fused_scan_sums_reference(ref, v, wgt, lo, hi, basei, k_share, l2)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan_sums runs on cpu or cuda tensors, not {dev}")
    if T > MAX_T:
        raise ValueError(f"fused_scan_sums takes T <= {MAX_T} contraction rows, got {T}")
    masked = lo is not None
    ref, v, wgt = ref.contiguous(), v.contiguous(), wgt.contiguous()
    if masked:
        lo, hi = lo.contiguous(), hi.contiguous()
    out = torch.empty((RC, S, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_fused_scan_sums(
            ref.data_ptr(), v.data_ptr(), wgt.data_ptr(),
            lo.data_ptr() if masked else None, hi.data_ptr() if masked else None,
            out.data_ptr(), RC, S, T, W, B, k_share, int(basei), int(masked),
            int(bool(l2)), stream)
    if err != 0:
        raise build.KernelError(f"kiwi_fused_scan_sums launch failed: CUDA error {err}")
    launches["fused_scan_masked" if masked else "fused_scan"] += 1
    return out


def fused_scan_sums_reference(ref, v, wgt, lo=None, hi=None, basei=0, k_share=1,
                              l2=False, chunk_elems=1 << 24):
    """The same function in plain torch, chunked over B so that the
    [RC, S, W, b] difference block stays under `chunk_elems` elements.
    The contraction runs in the TPU kernel's order (t = 0, 1, ...)."""
    RC, S, W = ref.shape
    T = v.shape[1]
    B = wgt.shape[2]
    vr = v.repeat_interleave(k_share, dim=0) if k_share > 1 else v  # [RC, T, W]
    mask = None
    if lo is not None:
        j = basei + torch.arange(W, device=ref.device)
        mask = ((j >= lo.T[..., None]) & (j <= hi.T[..., None])).to(torch.float32)  # [RC, S, W]
    out = torch.empty((RC, S, B), dtype=torch.float32, device=ref.device)
    step = max(1, chunk_elems // max(RC * S * W, 1))
    for b0 in range(0, B, step):
        w_ = wgt[:, :, b0:b0 + step]  # [RC, T, b]
        syn = vr[:, 0, :, None] * w_[:, 0, None, :]
        for t in range(1, T):
            syn = syn + vr[:, t, :, None] * w_[:, t, None, :]  # [RC, W, b]
        d = ref[..., None] - syn[:, None]  # [RC, S, W, b]
        u = d * d if l2 else torch.abs(d)
        if mask is not None:
            u = u * mask[..., None]
        out[:, :, b0:b0 + step] = u.sum(dim=2)
    return out


# ---------------------------------------------------------------------------
# scan over precomputed synthetics (finite-source and unfused shared plans)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scan_library():
    lib = build.load("scan_sums.cu")
    fn = lib.kiwi_scan_sums
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def scan_sums(ref, syn, l2=False):
    """Full-window floating-shift scan sums.

    ref: f32[S*RC, W] processed + shifted references (row s*RC + rc).
    syn: f32[RC, B, W] processed synthetics (syn_factor and moment folded in).
    Both may be strided views (the finite caller's slices of its [S, RC, PL]
    and [B, RC, PL] probes): any strides, unit stride along W.
    Returns f32[S, B, RC]: out[s, b, rc] = sum_w u(ref[s*RC + rc, w] -
    syn[rc, b, w]), u = |d| or d^2 (l2).  B may be any size: there is no
    padding to a block.  The caller applies the tail correction, dt and the
    shift selection.

    Replaces the TPU kernels kiwi_tpu/ops/float_scan.py:_scan_kernel and
    _scan_kernel_blocked (csrc/scan_sums.cu: one CUDA kernel, which takes
    the views' row strides, so nothing is copied).  At the finite path's
    shapes its work and its bytes are each about a microsecond on an H100,
    so latency bounds it.  Its design: a block of 8 warps per (32 models,
    rc), lane l on model l, each warp a contiguous share of the window,
    every shift's running sum in registers; a lane loads its synthetic
    samples straight into registers, the warp stages its share of the
    reference rows in shared memory with cp.async and reads each shift's
    quad as a 16-byte broadcast feeding 8 FP32 instructions; the warps' sums
    meet in shared memory.  The result is a [S, B, RC] view of the [S, RC, B]
    buffer the kernel writes (whole sectors).  See the source's header.
    """
    for name, x in (("ref", ref), ("syn", syn)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    if ref.dim() != 2 or syn.dim() != 3 or ref.shape[1] != syn.shape[2] \
            or ref.shape[0] % max(syn.shape[0], 1):
        raise ValueError(f"shape mismatch: ref {tuple(ref.shape)} (want [S*RC, W]), "
                         f"syn {tuple(syn.shape)} (want [RC, B, W])")
    for name, x in (("ref", ref), ("syn", syn)):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along W, got strides {x.stride()}")
    if ref.device != syn.device:
        raise ValueError("ref and syn must be on one device")
    refuse_grad("scan_sums", ref, syn)
    RC, B, W = syn.shape
    S = ref.shape[0] // RC
    dev = ref.device
    if dev.type == "cpu":
        return scan_sums_reference(ref, syn, l2)
    if dev.type != "cuda":
        raise ValueError(f"scan_sums runs on cpu or cuda tensors, not {dev}")
    out = torch.empty((S, RC, B), dtype=torch.float32, device=dev)  # returned as [S, B, RC]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _scan_library().kiwi_scan_sums(
            ref.data_ptr(), syn.data_ptr(), out.data_ptr(), ref.stride(0), syn.stride(0),
            syn.stride(1), S, RC, B, W, int(bool(l2)), stream)
    if err != 0:
        raise build.KernelError(f"kiwi_scan_sums launch failed: CUDA error {err}")
    launches["scan_sums"] += 1
    return out.transpose(1, 2)


def scan_sums_reference(ref, syn, l2=False, chunk_elems=1 << 24):
    """The same function in plain torch, chunked over B so that the
    [S, RC, b, W] difference block stays under `chunk_elems` elements."""
    RC, B, W = syn.shape
    S = ref.shape[0] // RC
    ref4 = ref.reshape(S, RC, 1, W)
    out = torch.empty((S, B, RC), dtype=torch.float32, device=ref.device)
    step = max(1, chunk_elems // max(S * RC * W, 1))
    for b0 in range(0, B, step):
        d = ref4 - syn[None, :, b0:b0 + step]  # [S, RC, b, W]
        u = d * d if l2 else torch.abs(d)
        out[:, b0:b0 + step] = u.sum(dim=-1).transpose(1, 2)
    return out
