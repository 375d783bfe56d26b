"""Seeded span tables for the fused scan's tests (no JAX: the card tests
import this too).

A span table is a pair lo, hi of int32 [S, RC] absolute sample indices:
sample w of the window (absolute index basei + w) counts for shift s and
row rc where lo[s, rc] <= basei + w <= hi[s, rc].
"""

import numpy as np

KINDS = ("band", "edges")


def span_table(rng, S, RC, W, basei, kind):
    """kind "band": the filtered point sweep's pattern, lo rising with s and
    then flat, hi flat and then rising (for W = 72 and S = 21: lo - basei
    0, 1, ..., 10, 10, ..., hi - basei 42, ..., 42, 43, ..., 52), shifted a
    little per row; "edges": each (s, rc) one of hi < lo, wholly left of the
    window, wholly right of it, starting left of it (lo < basei), ending
    right of it (hi >= basei + W), a single sample, or the whole window."""
    s = np.arange(S)[:, None]
    rc = np.arange(RC)[None, :]
    if kind == "band":
        half = S // 2
        lo = basei + np.minimum(s, half) + rc % 3
        hi = basei + (7 * W) // 12 + np.maximum(s - half, 0) + rc % 5
    elif kind == "edges":
        pick = rng.integers(0, 7, size=(S, RC))
        mid = basei + W // 2
        lo = np.choose(pick, [mid + 3, basei - 40, basei + W, basei - 9, mid, mid, basei - 1])
        hi = np.choose(pick, [mid - 2, basei - 1, basei + W + 30, mid, basei + W + 4, mid,
                              basei + W - 1])
    else:
        raise ValueError(kind)
    return np.broadcast_to(lo, (S, RC)).astype(np.int32), \
        np.broadcast_to(hi, (S, RC)).astype(np.int32)
