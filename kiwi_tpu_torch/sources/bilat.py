"""Bilateral finite-fault source (port of kiwi_tpu/sources/bilat.py,
source_bilat.f90)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bilat_tables
from .base import (
    _cols_const,
    DEG2RAD_F32,
    SourceModel,
    init_euler,
    m3_to_m6,
    mt_rot_from_sdr,
    plf4_cell_weights,
    register,
    trapezoid_stf_points,
)

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


def discretize_reference(params, shape):
    """discretize in plain torch, differentiable: ~280 small device ops."""
    nx, ny, nt = shape
    p = params.to(torch.float32)
    bsz = p.shape[0]
    time, north, east, depth = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    strike, dip, slip_rake, rup_rake = p[:, 5], p[:, 6], p[:, 7], p[:, 8]
    length_a, length_b, width, rupvel, risetime = (p[:, i] for i in range(9, 14))
    length = length_a + length_b

    rotmat_rup = init_euler(dip * DEG2RAD_F32, strike * DEG2RAD_F32,
                            -rup_rake * DEG2RAD_F32)  # [B, 3, 3]
    _, m_rot = mt_rot_from_sdr(strike, dip, slip_rake)

    # spatial grid centered in the fault plane, rupture direction x
    # (source_bilat.f90:377-396); 0-based ix: (2*ix - nx + 1)/(2 nx) * length
    ix = torch.arange(nx, dtype=torch.float32, device=p.device)
    iy = torch.arange(ny, dtype=torch.float32, device=p.device)
    gx = (2.0 * ix - nx + 1.0) / (2.0 * nx) * length[:, None]  # [B, nx]
    gy = (2.0 * iy - ny + 1.0) / (2.0 * ny) * width[:, None]  # [B, ny]
    gxm = gx[:, :, None].expand(bsz, nx, ny)
    gym = gy[:, None, :].expand(bsz, nx, ny)
    c3 = lambda a: a[:, None, None]  # noqa: E731  [B] -> [B, 1, 1]
    tshift = (
        torch.abs(c3(length) / 2.0 - c3(length_b) + gxm) / c3(rupvel)
        + c3(time)
        - c3(torch.maximum(length_a, length_b)) / 2.0 / c3(rupvel)
    )
    # the fault-plane points are (gx, gy, 0): the rotation is two exact f32
    # product terms per axis (the JAX package pins this einsum to HIGHEST;
    # centroid POSITIONS must stay exact)
    rot = [rotmat_rup[:, i, 0, None, None] * gxm + rotmat_rup[:, i, 1, None, None] * gym
           for i in range(3)]
    gn = rot[0] + c3(north)
    ge = rot[1] + c3(east)
    gd = rot[2] + c3(depth)

    # STF cells (source_bilat.f90:403-427)
    dursf = length / nx / rupvel
    xs, ys = trapezoid_stf_points(dursf, risetime)
    durfull = dursf + risetime
    dt_cell = (durfull / nt)[:, None]
    it = torch.arange(nt, dtype=torch.float32, device=p.device)
    wt, toff = plf4_cell_weights(xs, ys, xs[:, :1] + dt_cell * it,
                                 xs[:, :1] + dt_cell * (it + 1))  # [B, nt]

    m6 = m3_to_m6(m_rot) / (nx * ny)  # unit moment spread over subfaults

    # assemble [B, nx*ny*nt] in the reference's (ip, it) nesting order
    def flat(a):
        return a[..., None].expand(bsz, nx, ny, nt).reshape(bsz, -1)

    return {
        "north": flat(gn),
        "east": flat(ge),
        "depth": flat(gd),
        "time": flat(tshift) + toff.repeat(1, nx * ny),
        "m": m6[:, None, :] * wt.repeat(1, nx * ny)[:, :, None],
        "active": torch.ones(bsz, nx * ny * nt, dtype=torch.bool, device=p.device),
    }


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
