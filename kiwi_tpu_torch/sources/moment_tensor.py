"""Moment-tensor point source (port of kiwi_tpu/sources/moment_tensor.py,
source_moment_tensor.f90)."""

from __future__ import annotations

import numpy as np
import torch

from .base import _cols_const, SourceModel, plf4_cell_weights, register

BIG = np.float32(np.finfo(np.float32).max)

NAMES = (
    "time", "north-shift", "east-shift", "depth",
    "mxx", "myy", "mzz", "mxy", "mxz", "myz", "rise-time",
)
UNITS = ("s", "m", "m", "m", "Nm", "Nm", "Nm", "Nm", "Nm", "Nm", "s")
NORM = np.array([1, 10000, 10000, 10000, 7e18, 7e18, 7e18, 7e18, 7e18, 7e18, 1], np.float32)
MIN_HARD = np.array([-BIG, -100000, -100000, 0, -7e25, -7e25, -7e25, -7e25, -7e25, -7e25, 0],
                    np.float32)
MAX_HARD = np.array([BIG, 100000, 100000, 1000000, 7e25, 7e25, 7e25, 7e25, 7e25, 7e25, 100],
                    np.float32)
MIN_SOFT = np.array([-20, -10000, -10000, 0, -7e25, -7e25, -7e25, -7e25, -7e25, -7e25, 0],
                    np.float32)
MAX_SOFT = np.array([20, 10000, 10000, 150000, 7e25, 7e25, 7e25, 7e25, 7e25, 7e25, 100],
                    np.float32)
DEFAULTS = np.array([0, 0, 0, 10000, 0, 0, 0, 7e18, 0, 0, 1], np.float32)


def grid_shape(params, effective_dt):
    """(nt,) -- source_moment_tensor.f90:229-236."""
    risetime = float(params[10])
    nt = int(np.floor(risetime / effective_dt)) + 1
    return (max(nt, 2),)


def discretize(params, effective_dt, shape):
    """Boxcar-STF time cells at a fixed point for a batch of parameter rows
    f32[B, 11] (source_moment_tensor.f90:205-267): centroid tables [B, nt]."""
    (nt,) = shape
    p = params.to(torch.float32)
    time, north, east, depth = (p[:, i, None] for i in range(4))
    m6 = p[:, 4:10]
    risetime = p[:, 10]

    # stf: boxcar of length risetime, area 1 (:239-242); a zero risetime
    # keeps the degenerate cell centroids at the interval midpoints
    xs = torch.stack([-risetime / 2.0, -risetime / 2.0, risetime / 2.0, risetime / 2.0], -1)
    safe_r = torch.where(risetime > 0, risetime, 1.0)
    h = torch.where(risetime > 0, 1.0 / safe_r, 0.0)
    ys = torch.stack([0.0 * h, h, h, 0.0 * h], -1)

    dt = (risetime / nt)[:, None]
    it = torch.arange(nt, dtype=torch.float32, device=p.device)
    tbeg = xs[:, :1]
    wt, toff = plf4_cell_weights(xs, ys, tbeg + dt * it, tbeg + dt * (it + 1))
    # all-zero risetime: the reference's plf has zero support and all weights
    # vanish; keep the total moment by putting full weight on the first cell
    allzero = torch.sum(wt, dim=-1, keepdim=True) == 0.0
    wt = torch.where(allzero, torch.where(it == 0, 1.0, 0.0), wt)

    ones = torch.ones(nt, dtype=torch.float32, device=p.device)
    return {
        "north": north * ones,
        "east": east * ones,
        "depth": depth * ones,
        "time": time + toff,
        "m": m6[:, None, :] * wt[:, :, None],
        "active": torch.ones(p.shape[0], nt, dtype=torch.bool, device=p.device),
    }


def post_factors_batch(pb):
    """psm_set_moment_tensor keeps moment 1 and risetime 0 post-synthesis
    (source_moment_tensor.f90:201)."""
    ones = torch.ones(pb.shape[0], dtype=torch.float32, device=pb.device)
    return ones, torch.zeros_like(ones)


def param_stats(pb, effective_dt=1.0):
    """Conservative centroid bounds from raw params (host)."""
    pb = np.atleast_2d(pb)
    ext = float(np.hypot(pb[:, 1], pb[:, 2]).max())
    d = (float(pb[:, 3].min()), float(pb[:, 3].max()))
    half = pb[:, 10] / 2.0
    t = (float((pb[:, 0] - half).min()), float((pb[:, 0] + half).max()))
    return ext, d, t


MODEL = register(
    SourceModel(
        name="moment_tensor",
        names=NAMES,
        units=UNITS,
        norm=NORM,
        min_hard=MIN_HARD,
        max_hard=MAX_HARD,
        min_soft=MIN_SOFT,
        max_soft=MAX_SOFT,
        defaults=DEFAULTS,
        grid_shape=grid_shape,
        discretize=discretize,
        param_stats=param_stats,
        shape_param_idx=(10,),
        # positions/times fixed unless origin/depth/rise-time change; the
        # six MT components are weight-only
        shared_kin_check=lambda pb: _cols_const(pb, (0, 1, 2, 3, 10)),
        post_factors_batch=post_factors_batch,
    )
)
