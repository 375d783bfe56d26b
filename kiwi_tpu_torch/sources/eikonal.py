"""Eikonal rupture-front finite-fault sources (port of
kiwi_tpu/sources/eikonal.py; source_eikonal.f90, source_mt_eikonal.f90).

Pipeline (psm_to_tdsm_eikonal, source_eikonal.f90:259-316):
1. rupture boundary = circle polygon trimmed by constraint half-spaces,
2. fine rectangular grid over its bbox with speed = vs(z) * rel-vrup inside
   the boundary (crust2x2 profile at the source origin), zero outside,
3. eikonal solve for rupture onset times from the nucleation point,
4. downsample fine -> coarse grid (averaged times/speeds/points; durations
   = 4 * mean |t - mean t| per cell),
5. centroid table with per-cell boxcar time discretization; the global
   rise time is applied *post synthesis* (zero risetime here).

Two pipelines, as in the JAX package:
* host (numpy + the FMM oracle, `discretize_eikonal_host`), one source at a
  time, exactly mirroring the reference dataflow; the engine pads the
  per-source tables to a common length with `active` masks;
* device (`discretize_device_batch`): the host prepares what fixes shapes
  (`prepare_batch`), then the whole batch is discretized in torch on the
  engine's device, the solve through ops/eik_sweep.sweep_solve_batch (the
  CUDA kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import eikonal as eik
from .. import geometry as geom
from ..euler import init_euler
from ..plf import PLF
from .base import SourceModel, register

F32 = torch.float32
I32 = torch.int32
BIG = np.float32(np.finfo(np.float32).max)
DEG2RAD_F32 = np.float32(2.0 / 360.0 * 3.14159265358979)
M_UNROT = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])


@dataclasses.dataclass
class EikonalContext:
    """Session data the eikonal discretizers need (engine-provided)."""

    constraints: list  # [(point[3], normal[3])]
    layer_depths: np.ndarray  # [L] interface depths (m)
    layer_vs: np.ndarray  # [L+?] vs per interval (crust2x2.layers_at)

    def content_key(self):
        """Hashable identity for the engine's calibration keys (the engine
        builds a fresh context object per call)."""
        return (
            tuple((tuple(np.asarray(p)), tuple(np.asarray(n)))
                  for p, n in self.constraints),
            tuple(np.asarray(self.layer_depths).tolist()),
            tuple(np.asarray(self.layer_vs).tolist()),
        )


def _vs_at_depth(ctx: EikonalContext, depth):
    """vs step-function lookup (crust2x2_get_at_depth semantics)."""
    k = np.searchsorted(ctx.layer_depths, depth, side="left")
    return ctx.layer_vs[np.minimum(k, ctx.layer_vs.shape[0] - 1)]


def _discretize_subfault_time(dursf, risetime, maxdt):
    """(tweights, toffsets) (discretize_subfault_time,
    source_eikonal.f90:714-764)."""
    durfull = dursf + risetime
    nt = int(np.floor(durfull / maxdt)) + 1
    if nt == 1:
        return np.array([1.0]), np.array([0.0])
    lo, hi = min(dursf, risetime), max(dursf, risetime)
    stf = PLF(
        [-(hi + lo) / 2.0, -(hi - lo) / 2.0, (hi - lo) / 2.0, (hi + lo) / 2.0],
        [0.0, 1.0 / hi, 1.0 / hi, 0.0],
    )
    dt = durfull / nt
    it = np.arange(nt)
    w, toff = stf.integrate_and_centroid(stf.x[0] + dt * it, stf.x[0] + dt * (it + 1))
    return np.atleast_1d(w), np.atleast_1d(toff)


def discretize_eikonal_host(p, effective_dt, ctx: EikonalContext, m6_unit,
                            rotmat_rup, solve_dump=None):
    """Shared host discretization.

    p: dict with keys time, north, east, depth, bord_shift_x/y, bord_radius,
    nukl_shift_x/y, rel_vrup; m6_unit: the (unscaled) m6 of one centroid;
    rotmat_rup: fault-plane rotation.  Returns centroid dict (numpy) or
    raises ValueError on an empty/invalid rupture configuration.
    """
    center3 = np.array([p["north"], p["east"], p["depth"]])

    def rc_to_ned(point_rc):
        return rotmat_rup @ np.asarray(point_rc) + center3

    def ned_to_rc(point):
        return rotmat_rup.T @ (np.asarray(point) - center3)

    # 1. boundary polygon (psm_borderline_eikonal, source_eikonal.f90:318-348)
    circle_center = rc_to_ned([p["bord_shift_x"], p["bord_shift_y"], 0.0])
    transform = -rotmat_rup * p["bord_radius"]
    npoints = 180 if p["bord_radius"] != 0.0 else 1
    poly = geom.circle_to_polygon(circle_center, transform, npoints)
    poly = geom.trim_polygon_multi(poly, ctx.constraints)
    if poly.shape[0] == 0:
        raise ValueError("Empty rupture area")
    poly_rc = np.array([ned_to_rc(q) for q in poly])
    min_rc, max_rc = geom.polygon_box(poly_rc)

    # 2. fine grid (psm_make_eikonal_grid, :435-517)
    deltagrid = min(100.0 * effective_dt / 2.0, 4000.0)
    first = min_rc[:2]
    last = max_rc[:2]
    dims = last - first
    ndims = np.maximum(np.ceil(dims / deltagrid).astype(int), 1)
    delta = dims / ndims
    delta = np.where(delta == 0.0, 1.0, delta)

    # nucleation point must lie inside (psm_initial_point_intolerant_rc, :402-432)
    nukl = np.array([p["nukl_shift_x"], p["nukl_shift_y"], 0.0])
    if np.hypot(nukl[0], nukl[1]) > p["bord_radius"] or not geom.point_in_constraints(
        rc_to_ned(nukl), ctx.constraints
    ):
        raise ValueError("position of nucleation point is outside of rupture region")

    ix = np.arange(ndims[0])
    iy = np.arange(ndims[1])
    px = first[0] + (ix + 0.5) * delta[0]
    py = first[1] + (iy + 0.5) * delta[1]
    PX, PY = np.meshgrid(px, py, indexing="ij")
    pts_rc = np.stack([PX, PY, np.zeros_like(PX)], axis=-1)  # [nx, ny, 3]
    pts = np.einsum("ij,xyj->xyi", rotmat_rup, pts_rc) + center3

    rvec = pts - circle_center
    inside = np.sqrt((rvec**2).sum(-1)) <= p["bord_radius"]
    for hp, hn in ctx.constraints:
        inside &= np.einsum("j,xyj->xy", np.asarray(hn), np.asarray(hp) - pts) >= 0.0

    vs = _vs_at_depth(ctx, pts[..., 2])
    speed = np.where(inside, vs * p["rel_vrup"], 0.0)
    if not inside.any():
        raise ValueError("Empty rupture area")
    minspeed = speed[inside].min()
    invalid = minspeed * 0.5
    speed_solver = np.where(speed == 0.0, invalid, speed)

    times = eik.fmm_solve(speed_solver, delta, first, nukl[:2])
    times = np.where(speed == 0.0, -1.0, times)
    if solve_dump is not None:
        # expose the per-model solve problem (benchmark/prep_denominator.py
        # ships it to the C++ denominator so the reference replay pays the
        # same per-model FMM + downsample the engine pays)
        solve_dump.update(
            speed=speed_solver, inside=inside, delta=delta, first=first,
            nukl=nukl[:2].copy(),
        )

    # 3. coarse grid size (:617-638) and downsample (:519-601)
    maxd = 0.5 * effective_dt * minspeed
    sizex, sizey = dims
    nx = max(int(np.floor(sizex / maxd)) + 1, 2) if sizex != 0.0 else 1
    ny = max(int(np.floor(sizey / maxd)) + 1, 2) if sizey != 0.0 else 1

    cdelta = np.where(np.array([nx, ny]) > 0, dims / np.array([nx, ny]), 1.0)
    cdelta = np.where(cdelta == 0.0, 1.0, cdelta)
    if solve_dump is not None:
        solve_dump["coarse"] = (nx, ny)
        solve_dump["cdelta"] = cdelta.copy()

    ctimes = np.full((nx, ny), -1.0)
    cspeedinv = np.zeros((nx, ny))
    cpoints = np.zeros((nx, ny, 3))
    counts = np.zeros((nx, ny))

    valid = times >= 0.0
    vx, vy = np.nonzero(valid)
    prc = pts_rc[vx, vy]
    cix = np.clip(np.floor((prc[:, 0] - first[0]) / cdelta[0]).astype(int), 0, nx - 1)
    ciy = np.clip(np.floor((prc[:, 1] - first[1]) / cdelta[1]).astype(int), 0, ny - 1)
    np.add.at(counts, (cix, ciy), 1.0)
    tt = times[vx, vy]
    tmp = np.zeros((nx, ny))
    np.add.at(tmp, (cix, ciy), tt)
    have = counts > 0
    ctimes[have] = tmp[have] / counts[have]
    np.add.at(cspeedinv, (cix, ciy), 1.0 / speed[vx, vy])
    for k in range(3):
        tmp = np.zeros((nx, ny))
        np.add.at(tmp, (cix, ciy), pts[vx, vy, k])
        cpoints[..., k][have] = tmp[have] / counts[have]
    npf = vx.size
    cweights = counts / float(npf)

    cdur = np.zeros((nx, ny))
    np.add.at(cdur, (cix, ciy), np.abs(tt - ctimes[cix, ciy]))
    cdur[have] = 4.0 / counts[have] * cdur[have]

    # 4. centroid table (psm_to_tdsm_table_eikonal, :640-712)
    centertime = float((ctimes[have] * cweights[have]).sum())
    origin_time = p["time"]

    rows = {k: [] for k in ("north", "east", "depth", "time")}
    ms = []
    n_cells = 0
    max_nt = 0
    for iyc in range(ny):
        for ixc in range(nx):
            if ctimes[ixc, iyc] < 0.0:
                continue
            tw, toff = _discretize_subfault_time(cdur[ixc, iyc], 0.0, effective_dt)
            n_cells += 1
            max_nt = max(max_nt, len(tw))
            for w, to in zip(tw, toff):
                rows["north"].append(cpoints[ixc, iyc, 0])
                rows["east"].append(cpoints[ixc, iyc, 1])
                rows["depth"].append(cpoints[ixc, iyc, 2])
                rows["time"].append(ctimes[ixc, iyc] + to + origin_time - centertime)
                ms.append(m6_unit * w * cweights[ixc, iyc])

    n = len(ms)
    return {
        "north": np.asarray(rows["north"], np.float32),
        "east": np.asarray(rows["east"], np.float32),
        "depth": np.asarray(rows["depth"], np.float32),
        "time": np.asarray(rows["time"], np.float32),
        "m": np.asarray(ms, np.float32).reshape(n, 6),
        "active": np.ones(n, bool),
        # table-geometry stats (the device pipeline calibrates its static
        # ncell/nt budgets from these, engine._discretize_batch_host)
        "stats": {"n_cells": n_cells, "max_nt": max_nt},
    }


# -- model: eikonal ---------------------------------------------------------

EIK_NAMES = (
    "time", "north-shift", "east-shift", "depth", "moment", "strike", "dip",
    "slip-rake", "bord-shift-x", "bord-shift-y", "bord-radius",
    "nukl-shift-x", "nukl-shift-y", "rel-rupture-velocity", "rise-time",
)
EIK_UNITS = ("s", "m", "m", "m", "Nm", "degrees", "degrees", "degrees",
             "m", "m", "m", "m", "m", "1", "s")
# source_eikonal.f90:48-67
EIK_NORM = np.array([1, 10000, 10000, 10000, 7e18, 360, 90, 360, 10000, 10000,
                     10000, 360, 10000, 1, 1], np.float32)
EIK_MIN_HARD = np.array([-BIG, -100000, -100000, 0, 1, -BIG, -BIG, -BIG, -1e7,
                         -1e7, 0, -1e7, -1e7, 0.1, 0], np.float32)
EIK_MAX_HARD = np.array([BIG, 100000, 100000, 1000000, 7e25, BIG, BIG, BIG, 1e7,
                         1e7, 1e7, 1e7, 1e7, 10, 10], np.float32)
EIK_MIN_SOFT = np.array([-20, -10000, -10000, 0, 1, -180, 0, -180, -100000,
                         -100000, 0, -100000, -100000, 0.5, 0], np.float32)
EIK_MAX_SOFT = np.array([20, 10000, 10000, 150000, 7e25, 180, 90, 180, 100000,
                         100000, 100000, 100000, 100000, 1.5, 5], np.float32)
EIK_DEFAULTS = np.array([0, 0, 0, 3000, 7e18, 0, 80, 0, 0, 0, 5000, 0, 0, 0.9, 1],
                        np.float32)


def _eik_named(params):
    p = np.asarray(params, np.float64)
    strike = float(p[5]) * float(DEG2RAD_F32)
    dip = float(p[6]) * float(DEG2RAD_F32)
    rake = float(p[7]) * float(DEG2RAD_F32)
    rotmat_rup = init_euler(dip, strike, 0.0)  # source_eikonal.f90:249
    rotmat_slip = init_euler(dip, strike, -rake)
    m_rot = rotmat_slip @ M_UNROT @ rotmat_slip.T
    m6 = np.array([m_rot[0, 0], m_rot[1, 1], m_rot[2, 2],
                   m_rot[0, 1], m_rot[0, 2], m_rot[1, 2]])
    pd = dict(
        time=float(p[0]), north=float(p[1]), east=float(p[2]), depth=float(p[3]),
        bord_shift_x=float(p[8]), bord_shift_y=float(p[9]), bord_radius=float(p[10]),
        nukl_shift_x=float(p[11]), nukl_shift_y=float(p[12]), rel_vrup=float(p[13]),
    )
    return pd, m6, rotmat_rup


def _eik_host(params, effective_dt, ctx: EikonalContext):
    pd, m6, rotmat_rup = _eik_named(params)
    return discretize_eikonal_host(pd, effective_dt, ctx, m6, rotmat_rup)


def _rupture_param_stats(pb, effective_dt, ctx, cols):
    """Conservative host-side centroid bounds from raw eikonal params.

    cols = (north, east, depth, bord_shift_x, bord_shift_y, bord_radius,
    nukl_shift_x, nukl_shift_y, rel_vrup) column indices.  The engine plans
    its static windows from these bounds without reading discretized
    centroids back from the device.

    Geometry: centroids lie on the rupture disc of radius `bord_radius`
    around the shifted center, so positions are within
    reach = |bord_shift| + radius of the source point (any rotation).
    Times: the live region (disc minus constraint half-planes) is convex
    and the fast-sweeping solver floors off-region speed at half the
    minimum rupture speed, so the travel time from the nucleation point
    (within |nukl_shift| of the center) is at most
    2*(radius + |nukl_shift|) / vmin with vmin = min layer vs * rel_vrup;
    per-cell boxcar durations add at most 4*celldiag/vmin/2 with
    celldiag <= 2*sqrt(2)*radius/8 (coarse dims are padded to >= 8)."""
    pb = np.atleast_2d(np.asarray(pb, np.float64))
    n, e, d = (pb[:, cols[0]], pb[:, cols[1]], pb[:, cols[2]])
    bs = np.hypot(pb[:, cols[3]], pb[:, cols[4]])
    radius = np.abs(pb[:, cols[5]])
    ns = np.hypot(pb[:, cols[6]], pb[:, cols[7]])
    relv = np.maximum(np.abs(pb[:, cols[8]]), 0.1)
    reach = bs + radius
    ext = float((np.hypot(n, e) + reach).max())
    depth_range = (
        max(0.0, float((d - reach).min())),
        float((d + reach).max()),
    )
    vmin = max(float(np.min(np.asarray(ctx.layer_vs, np.float64))), 1.0) * relv
    tmax_rupture = 2.0 * (radius + ns) / vmin
    half_dur = 2.0 * np.sqrt(2.0) * radius / 8.0 / vmin * 2.0
    tspan = tmax_rupture + half_dur + effective_dt
    t0 = pb[:, 0]
    return ext, depth_range, (float((t0 - tspan).min()),
                              float((t0 + tspan).max()))


def _eik_param_stats(pb, effective_dt, ctx):
    return _rupture_param_stats(pb, effective_dt, ctx,
                                (1, 2, 3, 8, 9, 10, 11, 12, 13))


MODEL_EIKONAL = register(
    SourceModel(
        name="eikonal",
        names=EIK_NAMES,
        units=EIK_UNITS,
        norm=EIK_NORM,
        min_hard=EIK_MIN_HARD,
        max_hard=EIK_MAX_HARD,
        min_soft=EIK_MIN_SOFT,
        max_soft=EIK_MAX_SOFT,
        defaults=EIK_DEFAULTS,
        grid_shape=lambda params, edt: ("host",),
        discretize=_eik_host,
        shape_param_idx=None,
        post_factors_batch=lambda pb: (pb[:, 4], pb[:, 14]),
        shared_kin_check=lambda pb: False,
        host_discretize=True,
        param_stats=_eik_param_stats,
        param_stats_ctx=True,
    )
)


# -- model: mt_eikonal ------------------------------------------------------

MTE_NAMES = (
    "time", "north-shift", "east-shift", "depth", "moment-factor", "strike",
    "dip", "bord-shift-x", "bord-shift-y", "bord-radius", "nukl-shift-x",
    "nukl-shift-y", "rel-rupture-velocity",
    "mxx", "myy", "mzz", "mxy", "mxz", "myz", "rise-time",
)
MTE_UNITS = ("s", "m", "m", "m", "1", "degrees", "degrees", "m", "m", "m",
             "m", "m", "1", "Nm", "Nm", "Nm", "Nm", "Nm", "Nm", "s")
# source_mt_eikonal.f90:48-72
MTE_NORM = np.array([1, 10000, 10000, 10000, 7e18, 360, 90, 10000, 10000, 10000,
                     360, 10000, 1, 7e18, 7e18, 7e18, 7e18, 7e18, 7e18, 1], np.float32)
MTE_MIN_HARD = np.array([-BIG, -100000, -100000, 0, 1, -BIG, -BIG, -1e7, -1e7, 0,
                         -1e7, -1e7, 0.1, -7e25, -7e25, -7e25, -7e25, -7e25, -7e25, 0], np.float32)
MTE_MAX_HARD = np.array([BIG, 100000, 100000, 1000000, 7e25, BIG, BIG, 1e7, 1e7,
                         1e7, 1e7, 1e7, 10, 7e25, 7e25, 7e25, 7e25, 7e25, 7e25, 10], np.float32)
MTE_MIN_SOFT = np.array([-20, -10000, -10000, 0, 1, -180, 0, -100000, -100000, 0,
                         -100000, -100000, 0.5, -7e25, -7e25, -7e25, -7e25, -7e25, -7e25, 0], np.float32)
MTE_MAX_SOFT = np.array([20, 10000, 10000, 150000, 7e25, 180, 90, 100000, 100000,
                         100000, 100000, 100000, 1.5, 7e25, 7e25, 7e25, 7e25, 7e25, 7e25, 5], np.float32)
MTE_DEFAULTS = np.array([0, 0, 0, 3000, 1, 0, 80, 0, 0, 5000, 0, 0, 0.9,
                         0, 0, 0, 7e18, 0, 0, 1], np.float32)


def _mte_named(params):
    p = np.asarray(params, np.float64)
    strike = float(p[5]) * float(DEG2RAD_F32)
    dip = float(p[6]) * float(DEG2RAD_F32)
    rotmat_rup = init_euler(dip, strike, 0.0)  # source_mt_eikonal.f90:262
    m6 = p[13:19].copy()
    pd = dict(
        time=float(p[0]), north=float(p[1]), east=float(p[2]), depth=float(p[3]),
        bord_shift_x=float(p[7]), bord_shift_y=float(p[8]), bord_radius=float(p[9]),
        nukl_shift_x=float(p[10]), nukl_shift_y=float(p[11]), rel_vrup=float(p[12]),
    )
    return pd, m6, rotmat_rup


def _mte_host(params, effective_dt, ctx: EikonalContext):
    pd, m6, rotmat_rup = _mte_named(params)
    return discretize_eikonal_host(pd, effective_dt, ctx, m6, rotmat_rup)


def _mte_param_stats(pb, effective_dt, ctx):
    return _rupture_param_stats(pb, effective_dt, ctx,
                                (1, 2, 3, 7, 8, 9, 10, 11, 12))


MODEL_MT_EIKONAL = register(
    SourceModel(
        name="mt_eikonal",
        names=MTE_NAMES,
        units=MTE_UNITS,
        norm=MTE_NORM,
        min_hard=MTE_MIN_HARD,
        max_hard=MTE_MAX_HARD,
        min_soft=MTE_MIN_SOFT,
        max_soft=MTE_MAX_SOFT,
        defaults=MTE_DEFAULTS,
        grid_shape=lambda params, edt: ("host",),
        discretize=_mte_host,
        shape_param_idx=None,
        post_factors_batch=lambda pb: (pb[:, 4], pb[:, 19]),
        shared_kin_check=lambda pb: False,
        host_discretize=True,
        param_stats=_mte_param_stats,
        param_stats_ctx=True,
    )
)


# ---------------------------------------------------------------------------
# host preparation of the batched device discretization
# ---------------------------------------------------------------------------


def prepare_batch(pb_named, effective_dt, ctx: EikonalContext):
    """Host-side per-source preparation for the device pipeline.

    pb_named: list of (params dict p, m6_unit, rotmat_rup) as accepted by
    discretize_eikonal_host.  Computes everything whose *shape* matters
    (polygon bboxes, grid dims, coarse dims) plus small per-source arrays;
    the heavy eikonal solve + downsample run batched on device.

    Vectorized across the batch (one Sutherland-Hodgman pass per half-space
    for the whole batch; bit-identical to the per-source loop, see
    geometry.trim_polygon_batch).  Degenerate zero-radius ruptures fall
    back to the per-source loop.

    Returns (static, arrays) or raises ValueError like the host path.
    """
    if isinstance(pb_named, tuple):  # batched (pv, m6s, rotmats)
        pv, m6s, rotmats = pb_named
        if (pv["bord_radius"] != 0.0).all():
            return _prepare_batch_vec(pv, m6s, rotmats, effective_dt, ctx)
        pb_named = [
            ({k: float(v[i]) for k, v in pv.items()}, m6s[i], rotmats[i])
            for i in range(m6s.shape[0])
        ]
        return _prepare_batch_loop(pb_named, effective_dt, ctx)
    if len(pb_named) and all(
        p["bord_radius"] != 0.0 for p, _m, _r in pb_named
    ):
        keys = ("north", "east", "depth", "bord_shift_x", "bord_shift_y",
                "bord_radius", "nukl_shift_x", "nukl_shift_y", "rel_vrup",
                "time")
        pv = {k: np.array([p[k] for p, _m, _r in pb_named]) for k in keys}
        rotmats = np.array([r for _p, _m, r in pb_named])
        m6s = np.array([m for _p, m, _r in pb_named])
        return _prepare_batch_vec(pv, m6s, rotmats, effective_dt, ctx)
    return _prepare_batch_loop(pb_named, effective_dt, ctx)


def _prepare_batch_vec(pv, m6s, rotmats, effective_dt, ctx: EikonalContext):
    """Batched prepare: same quantities as _prepare_batch_loop, computed
    with batch-axis numpy.  Bit-compatible: every per-source float64
    operation runs in the same order as the loop."""
    b = m6s.shape[0]
    centers = np.stack([pv["north"], pv["east"], pv["depth"]], axis=-1)

    # boundary polygons: transformed unit circles (circle_to_polygon),
    # batched; then the constraint clips (Sutherland-Hodgman) in one
    # batched pass per half-space
    shift_rc = np.stack(
        [pv["bord_shift_x"], pv["bord_shift_y"], np.zeros(b)], axis=-1)
    # np.matmul with the scalar loop's per-item shapes: bit-identical to
    # the loop (einsum picks different kernels and drifts by 1 ulp, which
    # could flip a grid-dim ceil against discretize_eikonal_host)
    ccenters = np.matmul(rotmats, shift_rc[..., None])[..., 0] + centers
    transforms = -rotmats * pv["bord_radius"][:, None, None]
    npoints = 180
    i = np.arange(1, npoints + 1)
    ang = i * 2.0 * np.pi / npoints
    unit = np.stack([np.cos(ang), np.sin(ang), np.zeros(npoints)], axis=0)
    polys = (np.matmul(transforms, unit).transpose(0, 2, 1)
             + ccenters[:, None, :])
    counts = np.full(b, npoints, dtype=np.int64)
    for hp, hn in ctx.constraints:
        polys, counts = geom.trim_polygon_batch(polys, counts, hp, hn)
        if (counts == 0).any():
            raise ValueError("Empty rupture area")

    polys_rc = np.matmul(polys - centers[:, None, :], rotmats)
    min_rc = polys_rc.min(axis=1)  # pad rows repeat vertex 0: box-safe
    max_rc = polys_rc.max(axis=1)

    # nucleation point must lie inside (psm_initial_point_intolerant_rc)
    nukls3 = np.stack(
        [pv["nukl_shift_x"], pv["nukl_shift_y"], np.zeros(b)], axis=-1)
    nukl_ned = np.matmul(rotmats, nukls3[..., None])[..., 0] + centers
    bad = np.hypot(nukls3[:, 0], nukls3[:, 1]) > pv["bord_radius"]
    for hp, hn in ctx.constraints:
        bad |= (np.asarray(hn) @ (np.asarray(hp)[None, :] - nukl_ned).T) < 0.0
    if bad.any():
        raise ValueError(
            "position of nucleation point is outside of rupture region")

    deltagrid = min(100.0 * effective_dt / 2.0, 4000.0)
    dims = (max_rc - min_rc)[:, :2]
    ndims = np.maximum(np.ceil(dims / deltagrid).astype(int), 1)
    deltas = np.where(ndims > 0, dims / ndims, 1.0)
    deltas = np.where(deltas == 0.0, 1.0, deltas)

    # min rupture speed over each grid's depth range: vs is a step
    # function of depth, so the min over [zlo, zhi] is the min of the
    # layer intervals the range touches (same candidates the loop probes)
    corners_x = np.stack([min_rc[:, 0], min_rc[:, 0],
                          max_rc[:, 0], max_rc[:, 0]], axis=-1)
    corners_y = np.stack([min_rc[:, 1], max_rc[:, 1],
                          min_rc[:, 1], max_rc[:, 1]], axis=-1)
    zs = (centers[:, 2:3] + rotmats[:, 2, 0:1] * corners_x
          + rotmats[:, 2, 1:2] * corners_y)  # [B, 4]
    zlo, zhi = zs.min(axis=1), zs.max(axis=1)
    depths = np.asarray(ctx.layer_depths, np.float64)
    vs = np.asarray(ctx.layer_vs, np.float64)
    nv = vs.shape[0]
    k0 = np.minimum(np.searchsorted(depths, zlo, side="left"), nv - 1)
    k1 = np.minimum(np.searchsorted(depths, zhi, side="left"), nv - 1)
    kk = np.arange(nv)[None, :]
    sel = (kk >= k0[:, None]) & (kk <= k1[:, None])
    vmins = np.where(sel, vs[None, :], np.inf).min(axis=1)
    minspeeds = vmins * pv["rel_vrup"]

    maxd = 0.5 * effective_dt * minspeeds
    nxy = np.where(
        dims != 0.0,
        np.maximum(np.floor(dims / maxd[:, None]).astype(int) + 1, 2),
        1,
    )
    cdims = nxy
    cdeltas = np.where(nxy > 0, dims / nxy, 1.0)

    def pad8(n):
        return int(-(-max(n, 1) // 8) * 8)

    static = {
        "NF": (pad8(ndims[:, 0].max()), pad8(ndims[:, 1].max())),
        "NC": (int(cdims[:, 0].max()), int(cdims[:, 1].max())),
    }
    arrays = dict(
        first=min_rc[:, :2], delta=deltas, ndims=ndims,
        nukl=nukls3[:, :2], center=centers, rotmat=rotmats, m6=m6s,
        ccenter=ccenters, radius=pv["bord_radius"].copy(), cdims=cdims,
        cdelta=cdeltas, minspeed=minspeeds, time0=pv["time"].copy(),
        relv=pv["rel_vrup"].copy(),
    )
    return static, arrays


def _prepare_batch_loop(pb_named, effective_dt, ctx: EikonalContext):
    """Reference per-source implementation (kept as the zero-radius
    fallback and the equivalence oracle for _prepare_batch_vec)."""
    b = len(pb_named)
    firsts = np.zeros((b, 2))
    deltas = np.zeros((b, 2))
    ndims = np.zeros((b, 2), dtype=int)
    nukls = np.zeros((b, 2))
    centers = np.zeros((b, 3))
    rotmats = np.zeros((b, 3, 3))
    m6s = np.zeros((b, 6))
    ccenters = np.zeros((b, 3))
    radii = np.zeros(b)
    cdims = np.zeros((b, 2), dtype=int)
    cdeltas = np.zeros((b, 2))
    minspeeds = np.zeros(b)
    times0 = np.zeros(b)
    relvs = np.zeros(b)

    deltagrid = min(100.0 * effective_dt / 2.0, 4000.0)
    for i, (p, m6_unit, rotmat) in enumerate(pb_named):
        center3 = np.array([p["north"], p["east"], p["depth"]])

        def rc_to_ned(q):
            return rotmat @ np.asarray(q) + center3

        circle_center = rc_to_ned([p["bord_shift_x"], p["bord_shift_y"], 0.0])
        transform = -rotmat * p["bord_radius"]
        npoints = 180 if p["bord_radius"] != 0.0 else 1
        poly = geom.circle_to_polygon(circle_center, transform, npoints)
        poly = geom.trim_polygon_multi(poly, ctx.constraints)
        if poly.shape[0] == 0:
            raise ValueError("Empty rupture area")
        poly_rc = (poly - center3) @ rotmat
        min_rc, max_rc = geom.polygon_box(poly_rc)

        nukl = np.array([p["nukl_shift_x"], p["nukl_shift_y"], 0.0])
        if np.hypot(nukl[0], nukl[1]) > p["bord_radius"] or not geom.point_in_constraints(
            rc_to_ned(nukl), ctx.constraints
        ):
            raise ValueError("position of nucleation point is outside of rupture region")

        dims = (max_rc - min_rc)[:2]
        nd = np.maximum(np.ceil(dims / deltagrid).astype(int), 1)
        delta = np.where(nd > 0, dims / nd, 1.0)
        delta = np.where(delta == 0.0, 1.0, delta)

        # min rupture speed over the grid's depth range (host, exact):
        # vs is a step function of depth; probe interface depths too
        zs = [center3[2] + rotmat[2, 0] * x + rotmat[2, 1] * y
              for x in (min_rc[0], max_rc[0]) for y in (min_rc[1], max_rc[1])]
        zlo, zhi = min(zs), max(zs)
        cand = [zlo, zhi] + [d for d in ctx.layer_depths if zlo <= d <= zhi]
        cand += [d + 1.0 for d in ctx.layer_depths if zlo <= d + 1.0 <= zhi]
        vmin = min(_vs_at_depth(ctx, np.array([z]))[0] for z in cand)
        minspeed = vmin * p["rel_vrup"]

        maxd = 0.5 * effective_dt * minspeed
        nx = max(int(np.floor(dims[0] / maxd)) + 1, 2) if dims[0] != 0.0 else 1
        ny = max(int(np.floor(dims[1] / maxd)) + 1, 2) if dims[1] != 0.0 else 1

        firsts[i] = min_rc[:2]
        deltas[i] = delta
        ndims[i] = nd
        nukls[i] = nukl[:2]
        centers[i] = center3
        rotmats[i] = rotmat
        m6s[i] = m6_unit
        ccenters[i] = circle_center
        radii[i] = p["bord_radius"]
        cdims[i] = (nx, ny)
        cdeltas[i] = np.where(np.array([nx, ny]) > 0, dims / np.array([nx, ny]), 1.0)
        minspeeds[i] = minspeed
        times0[i] = p["time"]
        relvs[i] = p["rel_vrup"]

    def pad8(n):
        return int(-(-max(n, 1) // 8) * 8)

    static = {
        "NF": (pad8(ndims[:, 0].max()), pad8(ndims[:, 1].max())),
        "NC": (int(cdims[:, 0].max()), int(cdims[:, 1].max())),
    }
    arrays = dict(
        first=firsts, delta=deltas, ndims=ndims, nukl=nukls, center=centers,
        rotmat=rotmats, m6=m6s, ccenter=ccenters, radius=radii, cdims=cdims,
        cdelta=cdeltas, minspeed=minspeeds, time0=times0, relv=relvs,
    )
    return static, arrays


# ---------------------------------------------------------------------------
# batched on-device discretization
# ---------------------------------------------------------------------------


def make_device_discretizer(static, effective_dt, ctx: EikonalContext,
                            nt_cell_max, n_rounds=2, ncell_budget=None,
                            device="cuda"):
    """The batched eikonal discretizer for one static shape: a function of
    the prepared arrays (dict of tensors [B, ...] on `device`) returning the
    centroid tables [B, C] (and m [B, C, 6], overflow i32[B]).

    Same pipeline as discretize_eikonal_host with the batch dimension
    written out; the fine grids are padded to the common static shape NF
    (cells beyond a source's own dims get half the minimum rupture speed in
    the solver and are masked after it).  The solve is the fast-sweeping
    kernel instead of the FMM heap; both converge to the same viscosity
    solution (eikonal.py).

    ncell_budget (optional): keep only that many coarse cells, actives first
    in a stable order (the rupture disc covers ~60% of its bounding box's
    coarse grid, and the synthesis pays for every table row).  The
    "overflow" output counts dropped active cells / clipped time cells per
    source so that the engine can detect a too-tight calibration without a
    sync (engine._discretize_batch_host).
    """
    from ..ops import eik_sweep

    dev = torch.device(device)
    nfx, nfy = static["NF"]
    ncx, ncy = static["NC"]
    layer_depths = torch.as_tensor(np.asarray(ctx.layer_depths), dtype=F32, device=dev)
    layer_vs = torch.as_tensor(np.asarray(ctx.layer_vs), dtype=F32, device=dev)
    cons = [(torch.as_tensor(np.asarray(p), dtype=F32, device=dev),
             torch.as_tensor(np.asarray(n), dtype=F32, device=dev))
            for p, n in ctx.constraints]
    edt = torch.tensor(effective_dt, dtype=F32, device=dev)
    ax = torch.arange(nfx, device=dev)
    ay = torch.arange(nfy, device=dev)

    def _geom(a):
        """Fine-grid points [B, nfx, nfy, 3] + rupture-area mask (recomputed
        on both sides of the solve, as the JAX package does)."""
        first, delta, nd = a["first"], a["delta"], a["ndims"]
        px = first[:, 0, None] + (ax.to(F32) + 0.5) * delta[:, 0, None]  # [B, nfx]
        py = first[:, 1, None] + (ay.to(F32) + 0.5) * delta[:, 1, None]  # [B, nfy]
        bb = px.shape[0]
        PX = px[:, :, None].expand(bb, nfx, nfy)
        PY = py[:, None, :].expand(bb, nfx, nfy)
        inbounds = (ax[None, :, None] < nd[:, 0, None, None]) & (
            ay[None, None, :] < nd[:, 1, None, None])
        # rot @ (PX, PY, 0) + center, the product's terms in order, float32
        rot = a["rotmat"][:, None, None]  # [B, 1, 1, 3, 3]
        pts = (rot[..., 0] * PX[..., None] + rot[..., 1] * PY[..., None]
               + rot[..., 2] * 0.0) + a["center"][:, None, None, :]
        rvec = pts - a["ccenter"][:, None, None, :]
        inside = torch.sqrt((rvec * rvec).sum(-1)) <= a["radius"][:, None, None]
        for cp, cn in cons:
            inside = inside & (((cp - pts) * cn).sum(-1) >= 0.0)
        return px, py, pts, inside & inbounds

    def pre(a):
        _px, _py, pts, inside = _geom(a)
        k = torch.searchsorted(layer_depths, pts[..., 2].contiguous(), side="left")
        vs = layer_vs[torch.clamp(k, max=layer_vs.shape[0] - 1)]
        speed = torch.where(inside, vs * a["relv"][:, None, None], 0.0)
        return torch.where(speed == 0.0, 0.5 * a["minspeed"][:, None, None], speed)

    def post(a, times):
        px, py, pts, inside = _geom(a)
        bb = px.shape[0]
        valid = inside & (times < float(eik.BIG) * 0.5)

        # downsample fine -> coarse (psm_downsample_grid): the coarse cell of
        # a fine point is separable (cix depends on the x index only, ciy on
        # y), so the per-cell sums are two small 0/1 matmuls, float32 with
        # TF32 off (the JAX package pins precision=HIGHEST)
        first, cdelta = a["first"], a["cdelta"]
        cix1 = torch.clamp(torch.floor((px - first[:, 0, None]) / cdelta[:, 0, None]).to(I32),
                           0, ncx - 1)  # [B, nfx]
        ciy1 = torch.clamp(torch.floor((py - first[:, 1, None]) / cdelta[:, 1, None]).to(I32),
                           0, ncy - 1)  # [B, nfy]
        mx = (cix1[:, None, :] == torch.arange(ncx, device=dev)[None, :, None]).to(F32)
        my = (ciy1[:, None, :] == torch.arange(ncy, device=dev)[None, :, None]).to(F32)
        wmask = valid.to(F32)  # [B, nfx, nfy]
        ncell = ncx * ncy

        def seg2(field):
            """sum of field*w per coarse cell, flattened in cix*ncy+ciy order."""
            return torch.einsum("bcx,bxy,bdy->bcd", mx, field * wmask, my).reshape(bb, ncell)

        counts = seg2(torch.ones_like(wmask))
        have = counts > 0
        safe = torch.where(have, counts, 1.0)
        ctimes = seg2(times) / safe
        cn = seg2(pts[..., 0]) / safe
        ce = seg2(pts[..., 1]) / safe
        cd = seg2(pts[..., 2]) / safe
        npf = torch.clamp(wmask.sum(dim=(1, 2)), min=1.0)
        cweights = counts / npf[:, None]
        # broadcast cell means back to the fine grid with the transposes
        mu = torch.einsum("bcx,bcd,bdy->bxy", mx, ctimes.reshape(bb, ncx, ncy), my)
        cdur = 4.0 / safe * seg2(torch.abs(times - mu))

        centertime = torch.where(have, ctimes * cweights, 0.0).sum(dim=1)

        # per-cell boxcar time cells (risetime = 0 here): nt cells of equal
        # weight 1/nt at midpoints of [-dur/2, dur/2]
        nt_full = torch.where(have, torch.floor(cdur / edt).to(I32) + 1, 0)
        overflow = torch.clamp(nt_full - nt_cell_max, min=0).amax(dim=1)

        ncell_out = ncell
        if ncell_budget is not None and ncell_budget < ncell:
            # actives first, stable (cix-major order preserved among them);
            # dropped actives are counted in overflow, not silently lost
            order = torch.argsort(torch.where(have, 0, 1), dim=1, stable=True)[:, :ncell_budget]
            overflow = torch.maximum(overflow, have.sum(dim=1).to(I32) - ncell_budget)
            ctimes, cn, ce, cd, cdur, have, cweights, nt_full = (
                torch.gather(x, 1, order)
                for x in (ctimes, cn, ce, cd, cdur, have, cweights, nt_full))
            ncell_out = ncell_budget

        nt = torch.clamp(nt_full, max=nt_cell_max)
        it = torch.arange(nt_cell_max, dtype=F32, device=dev)
        ntf = torch.clamp(nt, min=1).to(F32)
        toff = -cdur[..., None] / 2.0 + cdur[..., None] / ntf[..., None] * (it + 0.5)
        live = (it < nt[..., None]) & have[..., None]
        wt = torch.where(live, 1.0 / ntf[..., None], 0.0)

        m = a["m6"][:, None, None, :] * (wt * cweights[..., None])[..., None]
        t0 = a["time0"][:, None, None]
        shape = (bb, ncell_out, nt_cell_max)
        return {
            "north": cn[..., None].expand(shape).reshape(bb, -1),
            "east": ce[..., None].expand(shape).reshape(bb, -1),
            "depth": cd[..., None].expand(shape).reshape(bb, -1),
            "time": (ctimes[..., None] + toff + t0 - centertime[:, None, None]).reshape(bb, -1),
            "m": m.reshape(bb, -1, 6),
            "active": live.reshape(bb, -1),
            "overflow": overflow,
        }

    def batched(a):
        speeds = pre(a)
        times = eik_sweep.sweep_solve_batch(speeds, a["delta"], a["first"], a["nukl"],
                                            n_rounds=n_rounds)
        return post(a, times)

    return batched


def discretize_device_batch(static, arrays, effective_dt, ctx, nt_cell_max,
                            n_rounds=2, ncell_budget=None, device="cuda"):
    """prepare_batch's (static, arrays) -> the centroid tables of the whole
    batch on `device` (make_device_discretizer's outputs)."""
    fn = make_device_discretizer(static, effective_dt, ctx, nt_cell_max, n_rounds,
                                 ncell_budget=ncell_budget, device=device)
    adev = {
        k: torch.as_tensor(np.asarray(v), dtype=I32 if v.dtype.kind == "i" else F32,
                           device=device)
        for k, v in arrays.items()
    }
    return fn(adev)


NAMED_PARAMS = {"eikonal": _eik_named, "mt_eikonal": _mte_named}

# (time, north, east, depth, bord_shift_x, bord_shift_y, bord_radius,
#  nukl_shift_x, nukl_shift_y, rel_vrup) column indices per model
_NAMED_COLS = {
    "eikonal": (0, 1, 2, 3, 8, 9, 10, 11, 12, 13),
    "mt_eikonal": (0, 1, 2, 3, 7, 8, 9, 10, 11, 12),
}


def named_params_batch(name, pb):
    """Batched NAMED_PARAMS: (pv dict of f64[B] arrays, m6s f64[B, 6],
    rotmats f64[B, 3, 3]).  Bit-identical to looping NAMED_PARAMS[name]
    over the rows (same f64 operation order; init_euler broadcasts)."""
    pb = np.atleast_2d(np.asarray(pb, np.float64))
    cols = _NAMED_COLS[name]
    keys = ("time", "north", "east", "depth", "bord_shift_x",
            "bord_shift_y", "bord_radius", "nukl_shift_x", "nukl_shift_y",
            "rel_vrup")
    pv = {k: pb[:, c].copy() for k, c in zip(keys, cols)}
    d2r = float(DEG2RAD_F32)
    strike = pb[:, 5] * d2r
    dip = pb[:, 6] * d2r
    rotmats = init_euler(dip, strike, np.zeros(pb.shape[0]))
    if name == "eikonal":
        rake = pb[:, 7] * d2r
        rs = init_euler(dip, strike, -rake)
        m_rot = rs @ M_UNROT @ np.swapaxes(rs, -1, -2)
        m6s = np.stack(
            [m_rot[:, 0, 0], m_rot[:, 1, 1], m_rot[:, 2, 2],
             m_rot[:, 0, 1], m_rot[:, 0, 2], m_rot[:, 1, 2]], axis=-1)
    else:
        m6s = pb[:, 13:19].copy()
    return pv, m6s, rotmats
