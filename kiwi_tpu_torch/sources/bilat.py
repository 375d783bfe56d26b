"""Bilateral finite-fault source (port of kiwi_tpu/sources/bilat.py,
source_bilat.f90)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bilat_tables
from ..ops.bilat_tables import discretize_reference
from .base import _cols_const, SourceModel, register

BIG = np.float32(np.finfo(np.float32).max)

NAMES = (
    "time", "north-shift", "east-shift", "depth", "moment",
    "strike", "dip", "slip-rake", "rupture-rake",
    "length-a", "length-b", "width", "rupture-velocity", "rise-time",
)
UNITS = ("s", "m", "m", "m", "Nm", "degrees", "degrees", "degrees", "degrees",
         "m", "m", "m", "m/s", "s")
NORM = np.array([1, 10000, 10000, 10000, 7e18, 360, 90, 360, 360,
                 10000, 10000, 10000, 3000, 1], np.float32)
MIN_HARD = np.array([-BIG, -100000, -100000, 0, 1, -BIG, -BIG, -BIG, -BIG,
                     0, 0, 0, 100, 0], np.float32)
MAX_HARD = np.array([BIG, 100000, 100000, 1000000, 7e25, BIG, BIG, BIG, BIG,
                     10000000, 10000000, 10000000, 100000, 10], np.float32)
MIN_SOFT = np.array([-20, -10000, -10000, 0, 1, -180, 0, -180, -180,
                     0, 0, 0, 1000, 0], np.float32)
MAX_SOFT = np.array([20, 10000, 10000, 150000, 7e25, 180, 90, 180, 180,
                     100000, 100000, 100000, 10000, 5], np.float32)
DEFAULTS = np.array([0, 0, 0, 10000, 7e18, 0, 80, 0, 0,
                     10000, 0, 7000, 3500, 1], np.float32)


def grid_shape(params, effective_dt):
    """(nx, ny, nt) -- psm_to_tdsm_size_bilat (source_bilat.f90:274-315)."""
    length = float(params[9]) + float(params[10])
    width = float(params[11])
    rupvel = float(params[12])
    risetime = float(params[13])
    maxdx = 0.5 * effective_dt * rupvel
    maxdy = effective_dt * rupvel

    nx = int(np.floor(length / maxdx)) + 1
    if nx <= 1:
        nx = 2
    if length == 0.0:
        nx = 1

    ny = int(np.floor(width / maxdy)) + 1
    if ny <= 1:
        ny = 2
    if width == 0.0:
        ny = 1

    dursf = length / nx / rupvel
    durfull = risetime + dursf
    nt = int(np.floor(durfull / effective_dt)) + 1
    if nt <= 1:
        nt = 2
    return (nx, ny, nt)


def discretize(params, effective_dt, shape):
    """Centroid tables [B, nx*ny*nt] for a batch of parameter rows
    f32[B, 14] (psm_to_tdsm_table_bilat, source_bilat.f90:318-459).

    Rows that need no gradient go to the tables wrapper (ops/bilat_tables.py:
    one kernel launch on the card, rounded as the plain version rounds there;
    the plain version on the CPU); the gradient paths' leaves take the plain
    version, which is differentiable."""
    if params.requires_grad:
        return discretize_reference(params, shape)
    return bilat_tables.bilat_tables(params.to(torch.float32), shape)


def post_factors_batch(pb):
    """(moments f32[B], risetimes f32[B]) on pb's device: the moment is
    applied post-synthesis (source_bilat.f90:210); the risetime is part of
    the STF here, not a post-fold."""
    moments = pb[:, 4].to(torch.float32)
    return moments, torch.zeros_like(moments)


def param_stats(pb, effective_dt=1.0):
    """Conservative centroid bounds from raw params (host).

    tshift - time lies in +-max(la,lb)/(2 v) (source_bilat.f90:383-384) and
    the STF cell centroids add +-durfull/2 <= (risetime + 0.5*edt)/2."""
    pb = np.atleast_2d(pb)
    length = pb[:, 9] + pb[:, 10]
    halfdiag = np.hypot(length / 2.0, pb[:, 11] / 2.0)
    ext = float((np.hypot(pb[:, 1], pb[:, 2]) + halfdiag).max())
    d = (
        float((pb[:, 3] - halfdiag).min()),
        float((pb[:, 3] + halfdiag).max()),
    )
    tspan = (
        np.maximum(pb[:, 9], pb[:, 10]) / (2.0 * np.maximum(pb[:, 12], 1.0))
        + pb[:, 13] / 2.0
        + effective_dt
    )
    t = (float((pb[:, 0] - tspan).min()), float((pb[:, 0] + tspan).max()))
    return ext, d, t


MODEL = register(
    SourceModel(
        name="bilateral",
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
        shape_param_idx=(9, 10, 11, 12, 13),
        # strike/dip/rupture-rake rotate subfault POSITIONS unless the fault
        # is degenerate (point source); slip-rake and moment are weight-only
        shared_kin_check=lambda pb: _cols_const(pb, (0, 1, 2, 3, 9, 10, 11, 12, 13))
        and (_cols_const(pb, (5, 6, 8))
             or (float(pb[0, 9] + pb[0, 10]) == 0.0 and float(pb[0, 11]) == 0.0)),
        post_factors_batch=post_factors_batch,
    )
)
