"""Long-period point source with an explicit oscillatory STF (port of
kiwi_tpu/sources/point_lp.py, source_point_lp.f90)."""

from __future__ import annotations

import numpy as np
import torch

from .base import _cols_const, SourceModel, register

BIG = np.float32(np.finfo(np.float32).max)
PI_F32 = np.float32(3.14159265358979)

NAMES = (
    "time", "north-shift", "east-shift", "depth", "moment",
    "m_xx", "m_yy", "m_zz", "m_xy", "m_xz", "m_yz",
    "excitation-time", "main-period",
)
UNITS = ("s", "m", "m", "m", "Nm", "Nm", "Nm", "Nm", "Nm", "Nm", "Nm", "s", "s")
# (source_point_lp.f90:54-73)
NORM = np.array([1, 10000, 10000, 10000, 7e18, 1, 0, -1, 1, 1, 1, 20, 1], np.float32)
MIN_HARD = np.array([-BIG, -100000, -100000, 0, 1, -1000, -1000, -1000, -1000, -1000, -1000,
                     0, 0], np.float32)
MAX_HARD = np.array([BIG, 100000, 100000, 1000000, 7e25, 1000, 1000, 1000, 1000, 1000, 1000,
                     120, 120], np.float32)
MIN_SOFT = np.array([-BIG, -10000, -10000, 0, 1, -100, -100, -100, -100, -100, -100,
                     0.001, 0.001], np.float32)
MAX_SOFT = np.array([BIG, 10000, 10000, 150000, 7e24, 100, 100, 100, 100, 100, 100, 90, 50],
                    np.float32)
DEFAULTS = np.array([0, 0, 0, 10000, 7e18, 0, -2, 2, 9, 0, -1, 40, 1], np.float32)


def lp_stf(reltime, prd, dur_exc):
    """The built-in long-period excitation function
    (source_point_lp.f90:408-419)."""
    t1 = 2.0
    t2 = t1 + dur_exc - 5.0
    t3 = t2 / 4.0
    return (
        torch.exp(-((reltime - t3) ** 2) / (2.0 * PI_F32 * dur_exc))
        / (1.0 + torch.exp(-2.0 * (reltime - t1)))
        / (1.0 + torch.exp(0.5 * (reltime - t2)))
        * torch.sin(2.0 * PI_F32 / prd * reltime)
    )


def grid_shape(params, effective_dt):
    """(nt,) -- psm_to_tdsm_point_lp (source_point_lp.f90:237-274)."""
    dur_exc = float(params[11])
    nt = int(np.floor(dur_exc / effective_dt)) + 1
    return (max(nt, 2),)


def discretize(params, effective_dt, shape):
    """Time-sampled MT modulation for a batch of parameter rows f32[B, 13]
    (psm_to_tdsm_table_point_lp, source_point_lp.f90:279-337): rel time
    k*dt, centroid time time0 + (k+1)*dt -- the reference's one-sample
    offset is reproduced.  Centroid tables [B, nt]."""
    (nt,) = shape
    p = params.to(torch.float32)
    time0, north, east, depth = (p[:, i, None] for i in range(4))
    m6 = p[:, 5:11]
    dur_exc, prd = p[:, 11, None], p[:, 12, None]

    dt = np.float32(effective_dt)
    k = torch.arange(nt, dtype=torch.float32, device=p.device)
    tfac = lp_stf(k * dt, prd, dur_exc)  # [B, nt]

    ones = torch.ones(nt, dtype=torch.float32, device=p.device)
    return {
        "north": north * ones,
        "east": east * ones,
        "depth": depth * ones,
        "time": time0 + (k + 1.0) * dt,
        "m": m6[:, None, :] * tfac[:, :, None],
        "active": torch.ones(p.shape[0], nt, dtype=torch.bool, device=p.device),
    }


def post_factors_batch(pb):
    """(moments f32[B], risetimes f32[B]) on pb's device: the moment is a
    post-synthesis factor, there is no rise-time fold."""
    moments = pb[:, 4].to(torch.float32)
    return moments, torch.zeros_like(moments)


def param_stats(pb, effective_dt=1.0):
    pb = np.atleast_2d(pb)
    ext = float(np.hypot(pb[:, 1], pb[:, 2]).max())
    d = (float(pb[:, 3].min()), float(pb[:, 3].max()))
    t = (float(pb[:, 0].min()), float((pb[:, 0] + pb[:, 11] + 1.0).max()))
    return ext, d, t


MODEL = register(
    SourceModel(
        name="point_lp",
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
        shape_param_idx=(11,),
        shared_kin_check=lambda pb: _cols_const(pb, (0, 1, 2, 3, 11, 12)),
        post_factors_batch=post_factors_batch,
    )
)
