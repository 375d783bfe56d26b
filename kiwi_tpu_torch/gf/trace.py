"""Dense trace conventions (port of kiwi_tpu/gf/trace.py).

A GF trace is a dense float32 row of fixed length NT plus an int32 itmin:
sample i sits at time i*dt, values before itmin are ZERO, values after the
stored span REPEAT THE LAST SAMPLE (the row is edge-padded up to NT, so
"after the end" only needs an index clamp and "before the start" a zero
mask).
"""

from __future__ import annotations

import numpy as np
import torch


def fnint(x):
    """Fortran NINT on numpy values: round half away from zero."""
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


def jnint(x):
    """Fortran NINT on tensors -> int32.  Not torch.round, which rounds
    half to EVEN (nint(2.5) is 3 here, torch.round(2.5) is 2)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)).to(torch.int32)


def sample_ext(data, itmin, idx):
    """Sample the extended trace at absolute indices idx.

    data: f32[..., NT] edge-padded rows; itmin: i32[...]; idx: int[..., K]
    broadcastable against itmin[..., None].  Returns f32[..., K]: 0 before
    itmin, data within, last value after.  The index is clamped explicitly:
    torch indexing does not clamp (JAX's take_along_axis does).
    """
    nt = data.shape[-1]
    rel = idx - itmin[..., None].to(torch.int64)
    rel = torch.broadcast_to(rel, data.shape[:-1] + rel.shape[-1:])
    vals = torch.gather(data, -1, rel.clamp(0, nt - 1))
    return torch.where(rel < 0, torch.zeros((), dtype=data.dtype, device=data.device), vals)


def dataspan(values, itmin=0):
    """Trimmed data span like strip_dataspan (sparse_trace.f90:347-377).

    Returns (first, last) absolute indices: leading zeros removed, trailing
    samples equal to the final value collapsed to one.  None for an all-zero
    trace.
    """
    v = np.asarray(values)
    if v.size == 0:
        return None
    nz = np.flatnonzero(v != 0.0)
    if nz.size == 0:
        return None
    first = int(nz[0])
    lastval = v[-1]
    diff = np.flatnonzero(v != lastval)
    last = int(diff[-1]) + 1 if diff.size else 0
    last = max(last, first)
    return first + itmin, last + itmin


def multiply_add_ref(acc, acc_it0, data, itmin, factor=1.0, rshift=0.0):
    """Host reference of trace_multiply_add on dense numpy arrays
    (sparse_trace.f90:597-707): adds factor x the trace, shifted by rshift
    samples (linear interpolation for the fraction), into acc, whose first
    sample has absolute index acc_it0 (fixed size, like
    trace_multiply_add_nogrow).  Zero before the trace, its last value after
    it.  Returns acc."""
    acc = np.asarray(acc)
    data = np.asarray(data, dtype=acc.dtype)
    nt = data.shape[0]
    ish = int(np.floor(rshift))
    frac = float(rshift) - ish

    def ext(j):  # absolute index sample with zero-left/edge-right extension
        rel = j - (itmin + ish)
        out = np.zeros(j.shape, dtype=acc.dtype)
        inside = rel >= 0
        out[inside] = data[np.minimum(rel[inside], nt - 1)]
        return out

    j = np.arange(acc_it0, acc_it0 + acc.shape[0])
    acc += factor * ((1.0 - frac) * ext(j) + frac * ext(j - 1))
    return acc


def pack_trace(values, it0):
    """Dense samples starting at absolute index it0 -> (trimmed values, itmin)
    (trace_pack equivalence, sparse_trace.f90:443-555)."""
    v = np.asarray(values, dtype=np.float32)
    span = dataspan(v)
    if span is None:
        return np.zeros(1, dtype=np.float32), int(it0)
    first, last = span
    return v[first : last + 1].copy(), int(it0 + first)


MAXGAP = 5  # sparse_trace.f90:25


def pack_strips(values, itmin):
    """Split a dense trace into sparse strips exactly like trace_pack
    (sparse_trace.f90:443-555): nonzero runs separated by gaps of more than
    MAXGAP zeros; each strip keeps one trailing zero when a gap (or the
    trace end) follows; an all-zero trace yields a single zero sample at the
    span start.  Returns [(start_abs_index, f32 array)]."""
    v = np.asarray(values, dtype=np.float32)
    n = v.shape[0]
    strips = []
    interest = False
    gap = 0
    ibeg = iend = 0
    for i in range(n):
        if v[i] != 0.0:
            if not interest:
                interest = True
                ibeg = i
            gap = 0
            iend = i
        elif interest:
            gap += 1
            if gap > MAXGAP:
                strips.append((ibeg, v[ibeg : iend + 2].copy()))
                interest = False
    if interest:
        if gap > 0:
            strips.append((ibeg, v[ibeg : iend + 2].copy()))
        else:
            strips.append((ibeg, v[ibeg : iend + 1].copy()))
    if not strips:
        return [(int(itmin), np.zeros(1, dtype=np.float32))]
    return [(int(itmin) + s, d) for s, d in strips]
