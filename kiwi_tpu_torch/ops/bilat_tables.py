"""The bilateral source's centroid tables: the CUDA kernel's wrapper.

The tables of sources/bilat.py (north, east, depth, time f32[B, C],
m f32[B, C, 6], active bool[B, C], C = nx * ny * nt) from the parameter
rows f32[B, 14], in one launch of csrc/bilat_tables.cu, which rounds every
entry as the plain version (sources/bilat.discretize_reference) rounds it
on the card.  The kernel replaces no TPU kernel: the JAX package leaves the
discretization to XLA, and the plain version's ~280 small launches a call
were what the card waited for.  See the source's header.

The wrapper is where the path is chosen, from the rows' device alone: on a
CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..sources.base import DEG2RAD_F32
from . import build, refuse_grad

F32 = torch.float32
NPARAMS = 14

# kernel launches since the last reset (plain-version calls are not counted)
launches = {"bilat_tables": 0}


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("bilat_tables.cu")
    fn = lib.kiwi_bilat_tables
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(params, shape):
    if params.dtype != F32 or params.dim() != 2 or params.shape[1] != NPARAMS:
        raise ValueError(f"params must be f32[B, {NPARAMS}], got {params.dtype} "
                         f"{tuple(params.shape)}")
    if len(shape) != 3 or any(int(n) != n or n < 1 for n in shape):
        raise ValueError(f"shape must be three positive ints (nx, ny, nt), got {shape}")
    return params.shape[0], *(int(n) for n in shape)


def bilat_tables(params, shape):
    """Centroid tables {north, east, depth, time, m, active} of the rows
    params f32[B, 14] on one grid shape (nx, ny, nt)."""
    B, nx, ny, nt = _check(params, shape)
    refuse_grad("bilat_tables", params)
    dev = params.device
    if dev.type == "cpu":
        from ..sources.bilat import discretize_reference

        return discretize_reference(params, shape)
    if dev.type != "cuda":
        raise ValueError(f"bilat_tables runs on cpu or cuda tensors, not {dev}")
    C = nx * ny * nt
    out = {k: torch.empty((B, C), dtype=F32, device=dev) for k in ("north", "east", "depth", "time")}
    out["m"] = torch.empty((B, C, 6), dtype=F32, device=dev)
    out["active"] = torch.empty((B, C), dtype=torch.bool, device=dev)
    if B == 0:
        return out
    params = params.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_bilat_tables(
            params.data_ptr(), *(out[k].data_ptr() for k in ("north", "east", "depth", "time", "m",
                                                             "active")),
            B, nx, ny, nt, DEG2RAD_F32, stream)
    if err != 0:
        raise build.KernelError(f"kiwi_bilat_tables launch failed: CUDA error {err}")
    launches["bilat_tables"] += 1
    return out
