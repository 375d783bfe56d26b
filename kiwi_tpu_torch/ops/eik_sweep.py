"""Batched fast-sweeping eikonal solve: the CUDA kernel's wrapper and its
plain PyTorch version (port of kiwi_tpu/ops/eik_sweep.py).

For each source b, the arrival times of the Zhao (2005) anti-diagonal
Gauss-Seidel schedule: the nucleation cell starts at 0 and every other cell
at BIG; n_rounds x the 4 directions (+i+j, +i-j, -i+j, -i-j) each visit the
anti-diagonals i' + j' = k of the flipped grid in increasing k, every cell
reading the new values of its neighbours on diagonal k - 1 and the old ones
on k + 1, with the Godunov upwind update in the TPU kernel's arithmetic
(kiwi_tpu/ops/eik_sweep.py:83-93; no fused multiply-adds, IEEE division and
square root).  Cells outside the grid read as BIG.  Seed cells need no mask:
the update is a running min against a nonnegative candidate.

The kernel (csrc/eik_sweep.cu) replaces the TPU kernel
kiwi_tpu/ops/eik_sweep.py:_sweep_dir_kernel and the XLA skew/unskew and
flips around it: one block per source runs all 4 x n_rounds sweeps in one
launch with the source's time grid in shared memory, one warp per 32 rows
as a pipelined wavefront (lane L one step behind lane L - 1, warp w + 1
behind warp w through a boundary row in shared memory), no block barrier
inside a sweep.  What bounds it is the chain of (nx + ny - 1) x 4 x
n_rounds dependent steps, not bytes or operations.  Grids over 512 rows
or above the shared-memory limit take the first design (one thread per
row, a block barrier per anti-diagonal).  See the source's header.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..profiling import to_device
from . import build, refuse_grad

F32 = torch.float32
I32 = torch.int32
BIG = 1e30

# kernel launches since the last reset (plain-version calls are not counted)
launches = {"eik_sweep": 0}

DIRS = ((False, False), (False, True), (True, False), (True, True))


def seed_cells(delta, first, initial_point, nx, ny):
    """Nucleation cells i32[B, 2]: clip(int((initial_point - first) / delta))
    in float32, truncated toward zero as the JAX package's astype."""
    ix = ((initial_point[:, 0] - first[:, 0]) / delta[:, 0]).to(I32).clamp(0, nx - 1)
    iy = ((initial_point[:, 1] - first[:, 1]) / delta[:, 1]).to(I32).clamp(0, ny - 1)
    return torch.stack([ix, iy], dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("eik_sweep.cu")
    fn = lib.kiwi_eik_sweep
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(speed, delta, first, initial_point, n_rounds):
    if speed.dtype != F32 or speed.dim() != 3:
        raise ValueError(f"speed must be f32[B, nx, ny], got {speed.dtype} {tuple(speed.shape)}")
    B, nx, ny = speed.shape
    for name, a in (("delta", delta), ("first", first), ("initial_point", initial_point)):
        if a.dtype != F32 or tuple(a.shape) != (B, 2):
            raise ValueError(f"{name} must be f32[{B}, 2], got {a.dtype} {tuple(a.shape)}")
        if a.device != speed.device:
            raise ValueError("all operands must be on one device")
    if B < 1 or nx < 1 or ny < 1 or n_rounds < 0:
        raise ValueError(f"empty solve: B={B}, nx={nx}, ny={ny}, n_rounds={n_rounds}")
    return B, nx, ny


def sweep_solve_batch(speed, delta, first, initial_point, n_rounds=3):
    """Arrival times f32[B, nx, ny] (kiwi_tpu.ops.eik_sweep.sweep_solve_batch's
    signature): speed f32[B, nx, ny]; delta, first, initial_point f32[B, 2]."""
    B, nx, ny = _check(speed, delta, first, initial_point, n_rounds)
    refuse_grad("sweep_solve_batch", speed, delta, first, initial_point)
    dev = speed.device
    if dev.type == "cpu":
        return sweep_solve_batch_reference(speed, delta, first, initial_point, n_rounds)
    if dev.type != "cuda":
        raise ValueError(f"sweep_solve_batch runs on cpu or cuda tensors, not {dev}")
    speed, delta = speed.contiguous(), delta.contiguous()
    seed = seed_cells(delta, first, initial_point, nx, ny)
    out = torch.empty((B, nx, ny), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_eik_sweep(speed.data_ptr(), delta.data_ptr(), seed.data_ptr(),
                                        out.data_ptr(), B, nx, ny, n_rounds, stream)
    if err != 0:
        raise build.KernelError(f"kiwi_eik_sweep launch failed: CUDA error {err}")
    launches["eik_sweep"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _diagonals(nx, ny):
    """Per direction, per step k: the flat indices of the cells with
    i' + j' = k in the [nx + 2, ny + 2] grid padded by one BIG cell."""
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    flat = ((i + 1) * (ny + 2) + (j + 1)).astype(np.int64)
    out = []
    for f0, f1 in DIRS:
        ip = nx - 1 - i if f0 else i
        jp = ny - 1 - j if f1 else j
        k = np.broadcast_to(ip + jp, (nx, ny)).ravel()
        order = np.argsort(k, kind="stable")
        bounds = np.searchsorted(k[order], np.arange(nx + ny))
        cells = flat.ravel()[order]
        out.append([cells[bounds[s]:bounds[s + 1]] for s in range(nx + ny - 1)])
    return out


def sweep_solve_batch_reference(speed, delta, first, initial_point, n_rounds=3):
    """The same function in plain torch: the sweeps in place on a grid
    padded by one BIG cell, one vectorized step per anti-diagonal (2232
    dependent steps at the eikonal benchmark's 144 x 136 grids, n_rounds 2),
    with the kernel's arithmetic in the kernel's order."""
    B, nx, ny = speed.shape
    dev = speed.device
    pitch = ny + 2
    seed = seed_cells(delta, first, initial_point, nx, ny).long()
    t = torch.full((B, (nx + 2) * pitch), BIG, dtype=F32, device=dev)
    t[torch.arange(B, device=dev), (seed[:, 0] + 1) * pitch + seed[:, 1] + 1] = 0.0
    f = torch.nn.functional.pad(speed, (1, 1, 1, 1), value=1.0).reshape(B, -1)
    da, dc = delta[:, 0:1], delta[:, 1:2]
    da2, dc2 = da * da, dc * dc
    sum2 = da2 + dc2
    rsum2 = 1.0 / sum2
    da2dc2 = da2 * dc2
    diags = [[to_device(c, dev) for c in steps] for steps in _diagonals(nx, ny)]
    for _ in range(n_rounds):
        for steps in diags:
            for idx in steps:
                told = t[:, idx]
                amin = torch.minimum(t[:, idx - pitch], t[:, idx + pitch])
                cmin = torch.minimum(t[:, idx - 1], t[:, idx + 1])
                ff = f[:, idx]
                rf = 1.0 / ff
                diff = (amin - cmin) * ff
                s = da2dc2 * (sum2 - diff * diff)
                t2d = (amin * dc2 + cmin * da2 + torch.sqrt(torch.clamp(s, min=0.0)) * rf) * rsum2
                t1d = torch.minimum(amin + da * rf, cmin + dc * rf)
                ok = (s >= 0.0) & (t2d >= torch.maximum(amin, cmin))
                t[:, idx] = torch.minimum(told, torch.where(ok, t2d, t1d))
    return t.reshape(B, nx + 2, pitch)[:, 1:-1, 1:-1].contiguous()
