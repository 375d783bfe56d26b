"""Circular finite-fault source (port of kiwi_tpu/sources/circular.py,
source_circular.f90)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bilat_tables import (DEG2RAD_F32, init_euler, m3_to_m6, mt_rot_from_sdr,
                                plf4_cell_weights, trapezoid_stf_points)
from ..synth import grad_safe_norm
from .base import _cols_const, SourceModel, register

BIG = np.float32(np.finfo(np.float32).max)

NAMES = (
    "time", "north-shift", "east-shift", "depth", "moment",
    "strike", "dip", "slip-rake", "radius", "rupture-velocity", "rise-time",
)
UNITS = ("s", "m", "m", "m", "Nm", "degrees", "degrees", "degrees", "m", "m/s", "s")
NORM = np.array([1, 10000, 10000, 10000, 7e18, 360, 90, 360, 10000, 3000, 1], np.float32)
MIN_HARD = np.array([-BIG, -100000, -100000, 0, 1, -BIG, -BIG, -BIG, 0, 100, 0], np.float32)
MAX_HARD = np.array([BIG, 100000, 100000, 1000000, 7e25, BIG, BIG, BIG, 1000000, 100000, 10],
                    np.float32)
MIN_SOFT = np.array([-20, -10000, -10000, 0, 1, -180, 0, -180, 0, 1000, 0], np.float32)
MAX_SOFT = np.array([20, 10000, 10000, 150000, 7e25, 180, 90, 180, 100000, 10000, 5],
                    np.float32)
DEFAULTS = np.array([0, 0, 0, 10000, 7e18, 0, 80, 0, 5000, 3500, 1], np.float32)


def grid_shape(params, effective_dt):
    """(nx, nx, nt) -- psm_to_tdsm_size_circular (source_circular.f90:267-302)."""
    radius = float(params[8])
    rupvel = float(params[9])
    risetime = float(params[10])
    length = 2.0 * radius
    maxdx = 0.5 * effective_dt * rupvel

    nx = int(np.floor(length / maxdx)) + 1
    if nx <= 1:
        nx = 2
    if length == 0.0:
        nx = 1
    ny = nx

    dursf = length / nx / rupvel
    durfull = risetime + dursf
    nt = int(np.floor(durfull / effective_dt)) + 1
    if nt <= 1:
        nt = 2
    return (nx, ny, nt)


def discretize(params, effective_dt, shape):
    """Square grid trimmed to the circle for a batch of parameter rows
    f32[B, 11] (psm_to_tdsm_table_circular, source_circular.f90:305-444):
    centroid tables [B, nx*ny*nt].

    Static shapes: points outside the circle stay in the table with zero
    moment and active=False, and the per-point moment normalization 1/np
    uses the live count.  The reference reads the radius as the
    rupture-rake Euler angle of rotmat_rup (source_circular.f90:221-223);
    that is reproduced, as in the JAX package.
    """
    nx, ny, nt = shape
    p = params.to(torch.float32)
    bsz = p.shape[0]
    time, north, east, depth = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    strike, dip, slip_rake = p[:, 5], p[:, 6], p[:, 7]
    radius, rupvel, risetime = p[:, 8], p[:, 9], p[:, 10]
    length = 2.0 * radius

    rotmat_rup = init_euler(dip * DEG2RAD_F32, strike * DEG2RAD_F32,
                            -radius * DEG2RAD_F32)  # [B, 3, 3]
    _, m_rot = mt_rot_from_sdr(strike, dip, slip_rake)

    ix = torch.arange(nx, dtype=torch.float32, device=p.device)
    iy = torch.arange(ny, dtype=torch.float32, device=p.device)
    gx = (2.0 * ix - nx + 1.0) / (2.0 * nx) * length[:, None]  # [B, nx]
    gy = (2.0 * iy - ny + 1.0) / (2.0 * ny) * length[:, None]  # [B, ny]
    gxm = gx[:, :, None].expand(bsz, nx, ny)
    gym = gy[:, None, :].expand(bsz, nx, ny)
    c3 = lambda a: a[:, None, None]  # noqa: E731  [B] -> [B, 1, 1]
    r = grad_safe_norm(gxm, gym)
    inside = r <= c3(radius)

    # the fault-plane points are (gx, gy, 0): two exact f32 product terms
    # per axis (centroid POSITIONS must stay exact, see bilat.discretize)
    rot = [rotmat_rup[:, i, 0, None, None] * gxm + rotmat_rup[:, i, 1, None, None] * gym
           for i in range(3)]
    gn = rot[0] + c3(north)
    ge = rot[1] + c3(east)
    gd = rot[2] + c3(depth)
    tshift = r / c3(rupvel) + c3(time)

    np_live = torch.clamp(inside.to(torch.float32).sum(dim=(1, 2)), min=1.0)  # [B]

    dursf = length / nx / rupvel
    xs, ys = trapezoid_stf_points(dursf, risetime)
    durfull = dursf + risetime
    dt_cell = (durfull / nt)[:, None]
    it = torch.arange(nt, dtype=torch.float32, device=p.device)
    wt, toff = plf4_cell_weights(xs, ys, xs[:, :1] + dt_cell * it,
                                 xs[:, :1] + dt_cell * (it + 1))  # [B, nt]

    m6 = m3_to_m6(m_rot) / np_live[:, None]

    def flat(a):
        return a[..., None].expand(bsz, nx, ny, nt).reshape(bsz, -1)

    active = flat(inside)
    m = m6[:, None, :] * wt.repeat(1, nx * ny)[:, :, None]
    return {
        "north": flat(gn),
        "east": flat(ge),
        "depth": flat(gd),
        "time": flat(tshift) + toff.repeat(1, nx * ny),
        "m": torch.where(active[..., None], m, 0.0),
        "active": active,
    }


def post_factors_batch(pb):
    """(moments f32[B], risetimes f32[B]) on pb's device: the moment is a
    post-synthesis factor; the risetime is part of the STF."""
    moments = pb[:, 4].to(torch.float32)
    return moments, torch.zeros_like(moments)


def param_stats(pb, effective_dt=1.0):
    pb = np.atleast_2d(pb)
    r = pb[:, 8] * np.sqrt(2.0)  # square grid corners may poke past radius
    ext = float((np.hypot(pb[:, 1], pb[:, 2]) + r).max())
    d = (float((pb[:, 3] - r).min()), float((pb[:, 3] + r).max()))
    tspan = 2.0 * pb[:, 8] / np.maximum(pb[:, 9], 1.0) + pb[:, 10]
    t = (float((pb[:, 0] - tspan).min()), float((pb[:, 0] + tspan).max()))
    return ext, d, t


MODEL = register(
    SourceModel(
        name="circular",
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
        shape_param_idx=(8, 9, 10),
        shared_kin_check=lambda pb: _cols_const(pb, (0, 1, 2, 3, 8, 9, 10))
        and (_cols_const(pb, (5, 6)) or float(pb[0, 8]) == 0.0),
        post_factors_batch=post_factors_batch,
    )
)
