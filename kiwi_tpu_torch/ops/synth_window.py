"""Finite-source window synthesis: the CUDA kernel's wrapper, its plain
PyTorch version, and the packing of batched kinematics into its operands
(port of kiwi_tpu/ops/synth_window.py).

For every (source, receiver) and every group of G centroids that share one
GF node (finite-source discretizers emit runs of G = nt consecutive
centroids at one position), the synthesis blends the group's 4 bilinear
neighbour GF rows, contracts them with each centroid's moment weights,
rotates them into away/right/down, applies the 2-tap fractional time shift
and accumulates at the centroid's integer shift kk: ard f32[B, R, 3, nt_out].

The kernel (csrc/synth_window.cu) replaces the TPU kernels
kiwi_tpu/ops/synth_window.py:_kernel, _kernel_dma and _kernel_compact,
which differ only in TPU memory placement.  Its operands are compact: no
lane broadcasts, no 8-row group split, no receiver packing, no row pitch.
What bounds it on an H100 is the blend's reads of the GF window (L2
resident at the benchmark's 13.5 MB).  It skips groups and centroids whose
moment weights are all zero, blends only the samples the live shifts
reach, and runs a tile of consecutive sources, which mostly read the same
node rows, in one block (launch_plan chooses the tile).  See the source's
header.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, refuse_grad

F32 = torch.float32
I32 = torch.int32

# kernel launches since the last reset (plain-version calls are not counted)
launches = {"window_synth": 0}

NW = 10  # weight row per centroid: f1..f6, cos_l, sin_l, 1 - frac, frac
T_MAX = 2048  # longest extended time axis the kernel takes (80 KB of shared memory)
# launch geometry of csrc/synth_window.cu: a source tile of at most BT
# warps (kTileMaxBt), whose lanes hold at most 8 shifted samples each
# (kTileSlots)
BT = 4  # sources per tile: the fastest of 4, 8 and 16 on an H100 (PERF.md)
TILE_SLOTS = 8
SMEM_MAX = 227 * 1024  # shared memory one block may use on an H100


def usable(cfg):
    """Window-kernel applicability: an extended time axis of at most T_MAX
    samples and a standard GF component count (8 or 10)."""
    return cfg.nt_out + cfg.s_len <= T_MAX and cfg.ng in (8, 10)


def pack_ext(ext, cfg):
    """materialize_window's ext [nxw, nzw, ng, nt_ext] -> [N, ng, nt_ext],
    N = nxw * nzw nodes, x-major (node = ix * nzw + iz)."""
    return ext.reshape(cfg.nxw * cfg.nzw, cfg.ng, ext.shape[-1]).contiguous()


def strides(cfg):
    """Neighbour node strides (s1, s2, s3) = (zu, xu*nzw, xu*nzw + zu) of
    the +zu, +xu and +xu+zu bilinear neighbours, host ints.  A
    nearest-neighbour session weighs the three neighbours 0 exactly, so
    they point at the node itself (0, 0, 0): the blend then reads no other
    node's rows, and a non-finite GF row beside the nearest node (or, at
    the window's last depth, the next column's first one) cannot turn 0 x
    NaN into the output, as one node read alone (kiwi_tpu's XLA path) would
    not."""
    if not cfg.interpolate:
        return 0, 0, 0
    zu, xu = cfg.zunder, cfg.xunder
    return zu, xu * cfg.nzw, xu * cfg.nzw + zu


def pack_kinematics(cfg, kin, G):
    """Batched kinematics (leaves [B, R, C, ...] from
    synth._centroid_kinematics) -> compact kernel operands
    (kiwi_tpu.ops.synth_window.pack_kinematics without its TPU layouts):

    node_rows i32[B, R, P]: each group's bilinear-origin node, clamped so
        that node + s3 stays inside the window (invalid centroids carry zero
        moment weights: they read rows, and the blend drops their terms);
    kk i32[B, P, G]: slice starts, clipped to [0, nt_ext - nt_out - 1].  The
        integer shift derives from the centroid time alone, so receiver 0's
        stands for all receivers, as in the JAX package;
    wrows f32[B, R, P, G, NW]: f1..f6 (zero for invalid centroids), cos_l,
        sin_l, 1 - frac, frac;
    wsp f32[B, R, P, 4]: bilinear weights in (00, 01, 10, 11) order.
    """
    bb, rr, c = kin["ish"].shape
    P = c // G
    ixs = kin["ixs"][:, :, ::G]  # [B, R, P, 2]
    izs = kin["izs"][:, :, ::G]
    node = ixs[..., 0] * cfg.nzw + izs[..., 0]
    node_rows = node.clamp(0, cfg.nxw * cfg.nzw - 1 - strides(cfg)[2]).to(I32)

    start_base = cfg.s_base + cfg.s_len - 1  # out_it0 - e0 - 1
    kk = (start_base - kin["ish"][:, 0].reshape(bb, P, G)).clamp(0, cfg.s_len - 1).to(I32)

    vmask = kin["valid"].reshape(bb, rr, P, G).to(F32)
    f = kin["f"].reshape(bb, rr, P, G, 6) * vmask[..., None]
    fr = kin["frac"].reshape(bb, rr, P, G, 1)
    wrows = torch.cat([
        f, kin["cos_l"].reshape(bb, rr, P, G, 1), kin["sin_l"].reshape(bb, rr, P, G, 1),
        1.0 - fr, fr], dim=-1).to(F32).contiguous()
    wsp = kin["wsp"][:, :, ::G].to(F32).contiguous()
    return node_rows.contiguous(), kk.contiguous(), wrows, wsp


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("synth_window.cu")
    fn = lib.kiwi_window_synth
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch_plan(ng, nt_ext, nt_out, B):
    """Sources per block for these shapes: 2..BT for the source-tile
    instance, 1 for the direct instance.

    The source tile runs bt consecutive sources of one receiver in one
    block, a warp each, with a blend buffer of ng * nt_ext floats per warp;
    its lanes hold the shifted samples 0..nt_out, at most TILE_SLOTS each.
    bt starts at BT, is cut to the batch (a power of two no wider than B
    needs) and halved until the buffers fit SMEM_MAX.  Below a tile of 2
    (one-source batches, windows too long for the buffers or the lanes'
    registers) the direct instance, one block per (source, receiver), takes
    the call.
    """
    if nt_out >= 32 * TILE_SLOTS:
        return 1
    bt = min(BT, 1 << max(B - 1, 0).bit_length())
    while bt >= 2 and bt * 4 * ng * nt_ext > SMEM_MAX:
        bt //= 2
    return max(bt, 1)


def _check(ext, node_rows, s3, kk, wrows, wsp, nt_out):
    if ext.dtype != F32 or ext.dim() != 3:
        raise ValueError(f"ext must be f32[N, ng, nt_ext], got {ext.dtype} {tuple(ext.shape)}")
    N, ng, nt_ext = ext.shape
    if node_rows.dtype != I32 or kk.dtype != I32:
        raise ValueError("node_rows and kk must be int32")
    if node_rows.dim() != 3 or kk.dim() != 3:
        raise ValueError(f"node_rows [B, R, P] and kk [B, P, G] expected, got "
                         f"{tuple(node_rows.shape)}, {tuple(kk.shape)}")
    B, R, P = node_rows.shape
    G = kk.shape[2]
    if (tuple(kk.shape) != (B, P, G) or tuple(wrows.shape) != (B, R, P, G, NW)
            or tuple(wsp.shape) != (B, R, P, 4)):
        raise ValueError(
            f"shape mismatch: node_rows {tuple(node_rows.shape)}, kk {tuple(kk.shape)}, "
            f"wrows {tuple(wrows.shape)}, wsp {tuple(wsp.shape)}")
    if wrows.dtype != F32 or wsp.dtype != F32:
        raise ValueError("wrows and wsp must be float32")
    if ng not in (8, 10) or not 0 < nt_out < nt_ext or nt_ext > T_MAX:
        raise ValueError(f"window_forward takes ng in (8, 10) and nt_out < nt_ext <= {T_MAX}, "
                         f"got ng={ng}, nt_out={nt_out}, nt_ext={nt_ext}")
    if N - 1 - s3 < 0:
        raise ValueError(f"window of {N} nodes is smaller than the bilinear stencil ({s3})")
    if len({x.device for x in (ext, node_rows, kk, wrows, wsp)}) != 1:
        raise ValueError("all operands must be on one device")
    return N, ng, nt_ext, B, R, P, G


def window_forward(ext, node_rows, strides3, kk, wrows, wsp, nt_out):
    """ard f32[B, R, 3, nt_out] from the packed window and operands
    (pack_ext, strides, pack_kinematics)."""
    s1, s2, s3 = (int(s) for s in strides3)
    N, ng, nt_ext, B, R, P, G = _check(ext, node_rows, s3, kk, wrows, wsp, nt_out)
    refuse_grad("window_forward", ext, wrows, wsp)
    dev = ext.device
    if dev.type == "cpu":
        return window_forward_reference(ext, node_rows, strides3, kk, wrows, wsp, nt_out)
    if dev.type != "cuda":
        raise ValueError(f"window_forward runs on cpu or cuda tensors, not {dev}")
    bt = launch_plan(ng, nt_ext, nt_out, B)
    ext, node_rows, kk = ext.contiguous(), node_rows.contiguous(), kk.contiguous()
    wrows, wsp = wrows.contiguous(), wsp.contiguous()
    out = torch.empty((B, R, 3, nt_out), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_window_synth(
            ext.data_ptr(), node_rows.data_ptr(), kk.data_ptr(), wrows.data_ptr(),
            wsp.data_ptr(), out.data_ptr(), N, ng, nt_ext, nt_out, B, R, P, G,
            s1, s2, s3, bt, stream)
    if err != 0:
        raise build.KernelError(f"kiwi_window_synth launch failed: CUDA error {err}")
    launches["window_synth"] += 1
    return out


def window_forward_reference(ext, node_rows, strides3, kk, wrows, wsp, nt_out,
                             chunk_elems=1 << 24):
    """The same function in plain torch, chunked over B so that the
    [b, R, P, G, 3, nt_ext] channel block stays near `chunk_elems` elements
    (the unchunked block at B = 256 of the finite benchmark is ~0.6 GB).
    The 2-tap shift applies after the contraction, as in the TPU kernel.
    A centroid whose f1..f6 are all 0 (an invalid one) adds exact zeros,
    as the CUDA kernel skips it: a non-finite row its stencil reads (at the
    window's last depth, the next column's first row) does not reach the
    output (kiwi_tpu's XLA path clips the stencil to the column and reads no
    such row)."""
    _N, ng, nt_ext = ext.shape
    B, R, P = node_rows.shape
    G = kk.shape[2]
    offs = (0,) + tuple(int(s) for s in strides3)
    t = torch.arange(nt_out, device=ext.device)
    out = torch.empty((B, R, 3, nt_out), dtype=F32, device=ext.device)
    step = max(1, chunk_elems // max(R * P * (G * 3 + ng) * nt_ext, 1))
    for b0 in range(0, B, step):
        nd = node_rows[b0:b0 + step].long()  # [b, R, P]
        ws = wsp[b0:b0 + step]
        blend = ws[..., 0, None, None] * ext[nd + offs[0]]
        for k in range(1, 4):
            blend = blend + ws[..., k, None, None] * ext[nd + offs[k]]  # [b, R, P, ng, T]
        row = blend[:, :, :, None]  # [b, R, P, 1, ng, T]
        w = wrows[b0:b0 + step][..., None]  # [b, R, P, G, NW, 1]
        p1 = w[..., 0, :] * row[..., 0, :] + w[..., 1, :] * row[..., 1, :] \
            + w[..., 2, :] * row[..., 2, :]
        p2 = w[..., 3, :] * row[..., 3, :] + w[..., 4, :] * row[..., 4, :]
        dd = w[..., 0, :] * row[..., 5, :] + w[..., 1, :] * row[..., 6, :] \
            + w[..., 2, :] * row[..., 7, :]
        if ng == 10:
            p1 = p1 + w[..., 5, :] * row[..., 8, :]
            dd = dd + w[..., 5, :] * row[..., 9, :]
        x = torch.stack([w[..., 6, :] * p1 - w[..., 7, :] * p2,
                         w[..., 7, :] * p1 + w[..., 6, :] * p2, dd], dim=-2)  # [b, R, P, G, 3, T]
        idx = kk[b0:b0 + step].long()[:, None, :, :, None, None] + t  # [b, 1, P, G, 1, nt]
        idx = idx.expand(x.shape[:-1] + (nt_out,))
        fr0 = w[..., 8, :, None]  # [b, R, P, G, 1, 1]
        fr1 = w[..., 9, :, None]
        y = fr0 * torch.gather(x, -1, idx + 1) + fr1 * torch.gather(x, -1, idx)
        live = (w[..., :6, 0] != 0).any(-1)  # [b, R, P, G]
        out[b0:b0 + step] = torch.where(live[..., None, None], y, 0.0).sum(dim=(2, 3))
    return out


def synthesize_ard_batch(ext_flat, cfg, kin, G):
    """ard f32[B, R, 3, nt_out] for a (source, receiver) batch: kin leaves
    [B, R, C, ...] with C a multiple of the group size G."""
    node_rows, kk, wrows, wsp = pack_kinematics(cfg, kin, G)
    return window_forward(ext_flat, node_rows, strides(cfg), kk, wrows, wsp, cfg.nt_out)
