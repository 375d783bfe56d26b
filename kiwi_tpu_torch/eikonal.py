"""Eikonal solvers: rupture-front arrival times on a 2D grid (port of
kiwi_tpu/eikonal.py).

The reference uses Sethian's fast-marching method with a binary heap
(eikonal.f90 + heap.f90) -- inherently sequential.  `fmm_solve` carries it
as host numpy code: it is the parity oracle and the host discretization
pipeline.  `sweep_solve` is fast sweeping (Zhao 2005) in anti-diagonal
order on one source: within a sweep direction, points on the diagonal
i + j = k depend only on diagonal k - 1, so each diagonal updates as one
step with exact point-Gauss-Seidel semantics.  It is a batch of one through
ops/eik_sweep.sweep_solve_batch, the solver the device discretizer runs.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from .ops.eik_sweep import sweep_solve_batch
from .profiling import to_device

BIG = np.float32(1e30)  # an unreached cell of the fast-sweeping solve
F32 = torch.float32


# ---------------------------------------------------------------------------
# host fast-marching (oracle; mirrors eikonal_solver_fmm)
# ---------------------------------------------------------------------------


def fmm_solve(speed, delta, first, initial_point):
    """Fast-marching arrival times (eikonal_solver_fmm, eikonal.f90:29-199).

    speed: [nx, ny]; delta: (dx, dy); first: grid origin; initial_point:
    physical coordinates of the rupture nucleation.
    """
    speed = np.asarray(speed, dtype=np.float64)
    nx, ny = speed.shape
    dx, dy = float(delta[0]), float(delta[1])
    inf = float(np.finfo(np.float32).max) * 0.1

    ix = min(max(int((initial_point[0] - first[0]) / dx), 0), nx - 1)
    iy = min(max(int((initial_point[1] - first[1]) / dy), 0), ny - 1)

    times = np.full((nx, ny), inf)
    times[ix, iy] = 0.0
    if nx == 1 and ny == 1:
        return times

    FAR, ALIVE, BAND = -1, 0, 1
    state = np.full((nx, ny), FAR, dtype=np.int8)
    state[ix, iy] = ALIVE
    heap = []

    def update_neighbor(i, j):
        if state[i, j] == ALIVE:
            return
        a = times[i - 1, j] if i > 0 else inf
        b = times[i + 1, j] if i < nx - 1 else inf
        c = times[i, j - 1] if j > 0 else inf
        d = times[i, j + 1] if j < ny - 1 else inf
        f = speed[i, j]
        t = 0.0
        aa = min(a, b)
        cc = min(c, d)
        if max(aa, cc) != inf:
            s = dx**2 * dy**2 * (dx**2 + dy**2 - ((aa - cc) * f) ** 2)
            if s >= 0.0:
                t = max(t, ((aa * dy**2 + cc * dx**2) * f + np.sqrt(s)) / (f * (dx**2 + dy**2)))
        if min(c, d) == inf:
            if a < inf:
                t = max(t, a + dx / f)
            if b < inf:
                t = max(t, b + dx / f)
        if min(a, b) == inf:
            if c < inf:
                t = max(t, c + dy / f)
            if d < inf:
                t = max(t, d + dy / f)
        if t == 0.0:  # fallback at sharp speed contrasts (eikonal.f90:176-183)
            t = inf
            if a < inf:
                t = min(t, a + dx / f)
            if b < inf:
                t = min(t, b + dx / f)
            if c < inf:
                t = min(t, c + dy / f)
            if d < inf:
                t = min(t, d + dy / f)
        if t != 0.0 and times[i, j] != t:
            times[i, j] = t
            state[i, j] = BAND
            heapq.heappush(heap, (t, i, j))

    # initial narrow band (eikonal.f90:94-102)
    for (i, j) in [(ix - 1, iy), (ix + 1, iy), (ix, iy - 1), (ix, iy + 1)]:
        if 0 <= i < nx and 0 <= j < ny:
            t0 = (dx if j == iy else dy) / speed[i, j]
            times[i, j] = t0
            state[i, j] = BAND
            heapq.heappush(heap, (t0, i, j))

    while heap:
        t, i, j = heapq.heappop(heap)
        if state[i, j] == ALIVE or times[i, j] != t:
            continue  # stale entry
        state[i, j] = ALIVE
        for (a, b) in [(i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)]:
            if 0 <= a < nx and 0 <= b < ny:
                update_neighbor(a, b)

    return times


# ---------------------------------------------------------------------------
# fast sweeping, one source
# ---------------------------------------------------------------------------


def sweep_solve(speed, delta, first, initial_point, n_rounds=3):
    """Fast-sweeping arrival times f32[nx, ny] of one source.

    speed: f32[nx, ny]; delta: (dx, dy); first: (fx, fy); initial_point:
    (px, py) physical coordinates (scalars or f32 tensors).  Runs n_rounds
    of the 4 directional diagonal sweeps; one round is exact for
    characteristics turning < 90 degrees, three covers strongly-curved
    fields.  A batch of one through ops/eik_sweep.sweep_solve_batch: the
    plain version on a CPU tensor, the kernel on a CUDA one.
    """
    speed = torch.as_tensor(speed, dtype=F32)

    def row(x):
        host = torch.stack([torch.as_tensor(v, dtype=F32) for v in x])
        return to_device(host, speed.device)[None]

    return sweep_solve_batch(speed[None], row(delta), row(first), row(initial_point),
                             n_rounds=n_rounds)[0]
