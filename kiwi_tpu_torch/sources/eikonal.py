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
* device (`discretize_device_batch`): what fixes shapes is prepared first
  (ops/eik_prepare.py; `prepare_batch` on the host), then the whole batch
  is discretized in torch on the engine's device, the solve through
  ops/eik_sweep.sweep_solve_batch (the CUDA kernel on the card, its plain
  version on the CPU).
`BatchDiscretizer` chooses between them for the engine (the models'
`batch_discretizer`), calibrates the device tables and cross-checks them.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .. import eikonal as eik
from .. import geometry as geom
from ..euler import init_euler
from ..ops import eik_prepare
from ..ops.eik_prepare import _prepare_batch_vec
from ..plf import PLF
from ..profiling import count, span, to_device, to_host
from .base import SourceModel, register

LOG = logging.getLogger("kiwi_tpu_torch")
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


def coarse_index(i, nc, nd):
    """The coarse cell (of nc) that holds the centre of fine cell i (of nd)
    along one axis: floor((i + 1/2) delta / cdelta) with delta = dims / nd
    and cdelta = dims / nc, which is floor((2 i + 1) nc / (2 nd)), in
    integers.  A centre on a coarse boundary -- the middle fine cell of an
    odd nd under an even nc -- goes to the upper cell, as exact arithmetic
    puts it, where a floating-point quotient would decide it by rounding.
    Works on numpy arrays and torch tensors alike."""
    return ((2 * i + 1) * nc) // (2 * nd)


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
    cix = coarse_index(vx, nx, ndims[0])
    ciy = coarse_index(vy, ny, ndims[1])
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
        # ncell/nt budgets from these, BatchDiscretizer)
        "stats": {"n_cells": n_cells, "max_nt": max_nt},
    }


# -- the engine's batch discretization --------------------------------------


def _table_stats(tables, member=None):
    """Moment-weighted centroid statistics of an eikonal table (or of batch
    member `member` of batched ones): mean north, east, depth and time, and
    the total moment weight."""
    north, east, depth, time, m, active = (
        np.asarray(tables[k] if member is None else tables[k][member], np.float64)
        for k in ("north", "east", "depth", "time", "m", "active"))
    w = np.abs(m).sum(axis=-1) * active
    tot = w.sum()
    if tot <= 0:
        return np.zeros(5)
    return np.array([(w * north).sum() / tot, (w * east).sum() / tot,
                     (w * depth).sum() / tot, (w * time).sum() / tot, tot])


def _host_discretize(model, p, effective_dt, ctx):
    """One row through the host pipeline (the FMM oracle), counted as
    `eik.host_solves`."""
    count("eik.host_solves")
    return model.discretize(p, effective_dt, ctx)


def _crosscheck_ok(host, tables, member, effective_dt, rtol=2e-3):
    """First-use validation of the device discretizer against the host
    FMM pipeline: the moment-weighted centroid statistics (mean north,
    east, depth, time and the total moment weight) of batch member
    `member`'s table must agree within rtol of their scales with the host
    table's (the tables cannot be compared cell by cell: the pipelines
    discretize time differently).  tables: the device tables as numpy
    arrays."""
    s_host = _table_stats(host)
    s_dev = _table_stats(tables, member)
    scale = np.array([
        max(abs(s_host[0]), 100.0), max(abs(s_host[1]), 100.0),
        max(abs(s_host[2]), 100.0), max(abs(s_host[3]), effective_dt),
        max(abs(s_host[4]), 1e-30),
    ])
    return bool(np.all(np.abs(s_dev - s_host) <= rtol * scale))


class BatchDiscretizer:
    """The eikonal models' batch discretization and the state it keeps
    across calls (an engine holds one a model).

    With `on_device` and a real batch (B >= 2), the whole batch is
    discretized on the device: the preparation (ops/eik_prepare.py, one
    launch on the card, its plain version on the CPU; the host's
    per-source loop for zero-radius ruptures), then discretize_device_batch
    (the fast-sweeping kernel, the downsample and the time cells), with
    table budgets calibrated from the host FMM tables of the batch's most
    demanding members and a first-use cross-check per table shape: on
    disagreement a CPU engine falls back to the host pipeline with a
    warning (the JAX package's semantics) and a CUDA engine raises, so a
    fault on the card never turns into a slower host search.  Otherwise
    every source runs the host pipeline and the tables are padded to a
    multiple of 16 rows with active = False."""

    def __init__(self):
        self.on_device = True
        # (model, table length, dt) of the device tables cross-checked
        self.checked_keys = set()
        # device-table calibration: (model, NF, NC, dt, ctx) -> (ntmax, ncell
        # budget, hard ntmax bound), from the host tables of the first
        # batch's most demanding members; guarded by the discretizer's
        # overflow counter, read once its copy has landed (no sync)
        self.calib = {}
        self.pending = []  # (calibration key, overflow max, event or None)

    def __call__(self, model, pb, effective_dt, ctx, device):
        """(centroid tables [B, C] on `device`, grid shape, group size: runs
        of that many consecutive centroids share their position) of the
        rows pb f32[B, nparams] under the session's EikonalContext."""
        edt = effective_dt
        if self.on_device and len(pb) >= 2:
            with span("kiwi.synth.eik_prepare"):
                named = named_params_batch(model.name, pb)
                if (named[0]["bord_radius"] != 0.0).all():
                    # one launch on the card (on the CPU the plain version),
                    # then one wait for the numbers that fix the shapes and
                    # the errors; the arrays stay on the device
                    summary, arrays = eik_prepare.eik_prepare(
                        eik_prepare.rows_on(named, device), ctx, edt)
                    summary = to_host(summary)[0]
                else:
                    # a degenerate zero-radius rupture: the host's per-source loop
                    count("eik.host_prepares")
                    _static, arrays = prepare_batch(named, edt, ctx)
                    summary = eik_prepare.summary_of(arrays, edt)
                # ntmax_hard, the rigorous host bound on the time cells per
                # coarse cell: a cell's duration is 4x the mean |t - mean t|
                # over it, at most 4 * celldiag / minspeed (the solution is
                # 1-Lipschitz in the d/speed metric; the solver's dead-zone
                # floor is 0.5 * minspeed)
                static, ntmax_hard = eik_prepare.static_from_summary(summary)

            self.check_overflow()
            ckey = (model.name, static["NF"], static["NC"], float(edt), ctx.content_key())
            calib = self.calib.get(ckey)
            hosts = {}
            if calib is None:
                # calibrate the table budgets from the host oracle on the
                # batch's first, last and widest members: the hard bound pads
                # ~4x in time cells and the bounding box ~1.6x in cells, and
                # the window kernel pays for every padded row.  ntmax is the
                # members' measured need with no margin: a later member that
                # outgrows it is what the overflow counter catches
                members = {0, len(pb) - 1, int(np.argmax(named[0]["bord_radius"]))}
                with span("kiwi.synth.eik_calibrate"):
                    for i in sorted(members):
                        hosts[i] = _host_discretize(model, pb[i], edt, ctx)
                ncell = int(static["NC"][0]) * int(static["NC"][1])
                st = [h["stats"] for h in hosts.values()]
                ntmax = min(max(s["max_nt"] for s in st), ntmax_hard)
                budget = -(-int(np.ceil(max(s["n_cells"] for s in st) * 1.2)) // 8) * 8
                calib = (max(ntmax, 1), budget if budget < ncell else None, ntmax_hard)
                self.calib[ckey] = calib
            ntmax, budget, _hard = calib
            cbatch = dict(discretize_device_batch(
                static, arrays, edt, ctx, ntmax, ncell_budget=budget, device=device))
            self._queue_overflow(ckey, cbatch.pop("overflow"))
            # validate >= 3 members (the calibration members, 0, and random
            # ones) once per (model, table length, dt): a discretizer fault
            # that spares member 0 (a batch-indexing bug) must not pass
            key = (model.name, int(cbatch["north"].shape[1]), float(edt))
            if key not in self.checked_keys:
                self.checked_keys.add(key)
                rng = np.random.default_rng(len(self.checked_keys))
                idxs = set(hosts) | {0} | {
                    int(i) for i in rng.choice(len(pb), size=min(3, len(pb)), replace=False)}
                with span("kiwi.synth.eik_calibrate"):
                    tables = {k: to_host(v)[0] for k, v in cbatch.items()}
                    for i in sorted(idxs - set(hosts)):
                        hosts[i] = _host_discretize(model, pb[i], edt, ctx)
                    bad = [i for i in sorted(idxs)
                           if not _crosscheck_ok(hosts[i], tables, i, edt)]
                if bad and device.type == "cuda":
                    # on the card a disagreement is a fault of the kernel or
                    # the discretizer: raise rather than move the search to
                    # the host pipeline behind a warning
                    raise RuntimeError(
                        "device eikonal discretization disagrees with the host FMM oracle "
                        "(mean north, east, depth, time, total moment weight): " + "; ".join(
                            f"member {i}: device {_table_stats(tables, i)}, host "
                            f"{_table_stats(hosts[i])}" for i in bad))
                if bad:
                    LOG.warning(
                        "device eikonal discretization disagrees with the host FMM oracle "
                        "beyond tolerance for batch member(s) %s; falling back to the host "
                        "pipeline (BatchDiscretizer.on_device = False)", bad)
                    self.on_device = False
                    return self(model, pb, edt, ctx, device)
            # device tables are [ncell, ntmax] row-major: groups of ntmax
            return cbatch, (int(cbatch["north"].shape[1]),), int(ntmax)

        tables = [_host_discretize(model, p, edt, ctx) for p in pb]
        cmax = -(-max(t["north"].shape[0] for t in tables) // 16) * 16
        out = {}
        for k in ("north", "east", "depth", "time", "m", "active"):
            first = tables[0][k]
            arr = np.zeros((len(tables), cmax) + first.shape[1:], dtype=first.dtype)
            for i, t in enumerate(tables):
                arr[i, : t[k].shape[0]] = t[k]
            out[k] = to_device(arr, device)
        # host FMM tables have ragged per-cell time runs: no uniform groups
        return out, (cmax,), 1

    def _queue_overflow(self, ckey, ov):
        """Queue a device batch's overflow counter i32[B] for check_overflow
        without a sync: on the card its max is copied into pinned host
        memory behind an event; on the CPU it is ready."""
        ovmax = ov.amax()
        if ovmax.device.type != "cuda":
            self.pending.append((ckey, ovmax, None))
            return
        host = torch.empty((), dtype=ovmax.dtype, pin_memory=True)
        host.copy_(ovmax, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.pending.append((ckey, host, event))

    def check_overflow(self, force=False):
        """Deferred, sync-free guard on the calibrated device-eikonal table
        budgets.  On overflow the calibration for that shape widens to the
        rigorous hard bound; the overflowed batch itself shipped with
        clipped time cells / dropped cells (a discretization-level
        approximation on a few cells, warned about here).  A counter is read
        only once its copy has landed (event.query()); unresolved ones stay
        queued, the oldest read anyway past 8 pending, all with force."""
        still = []
        for i, (ckey, ov, event) in enumerate(self.pending):
            must = force or len(self.pending) - i > 8
            if event is not None and not event.query():
                if not must:
                    still.append((ckey, ov, event))
                    continue
                event.synchronize()
                count("syncs")
            self._drain_overflow(ckey, ov)
        self.pending = still

    def _drain_overflow(self, ckey, ov):
        ov = int(ov)
        if ov > 0:
            calib = self.calib.get(ckey)
            hard = calib[2] if calib else ov
            self.calib[ckey] = (hard, None, hard)
            LOG.warning(
                "device eikonal table calibration overflowed by %d rows/cells on the "
                "previous batch (its misfits carry a small extra discretization error); "
                "widening the table budget to the rigorous bound for %s", ov, ckey)


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
        batch_discretizer=BatchDiscretizer,
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
        batch_discretizer=BatchDiscretizer,
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

    static = {
        "NF": (eik_prepare.pad8(ndims[:, 0].max()), eik_prepare.pad8(ndims[:, 1].max())),
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
    source so that BatchDiscretizer can detect a too-tight calibration
    without a sync.
    """
    from ..ops import eik_sweep

    dev = torch.device(device)
    nfx, nfy = static["NF"]
    ncx, ncy = static["NC"]
    layer_depths = to_device(np.asarray(ctx.layer_depths), dev, F32)
    layer_vs = to_device(np.asarray(ctx.layer_vs), dev, F32)
    cons = [(to_device(np.asarray(p), dev, F32), to_device(np.asarray(n), dev, F32))
            for p, n in ctx.constraints]
    edt = to_device(effective_dt, dev, F32)
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
        # TF32 off (the JAX package pins precision=HIGHEST); the index in
        # integers (coarse_index), cells past a source's own grid masked
        nd, cdims = a["ndims"].long(), a["cdims"].long()
        cix1 = torch.clamp(coarse_index(ax[None, :], cdims[:, 0, None], nd[:, 0, None]),
                           max=ncx - 1)  # [B, nfx]
        ciy1 = torch.clamp(coarse_index(ay[None, :], cdims[:, 1, None], nd[:, 1, None]),
                           max=ncy - 1)  # [B, nfy]
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
        count("eik.fine_cells", a["first"].shape[0] * nfx * nfy)
        with span("kiwi.synth.eik_solve"):
            speeds = pre(a)
            times = eik_sweep.sweep_solve_batch(speeds, a["delta"], a["first"], a["nukl"],
                                                n_rounds=n_rounds)
        with span("kiwi.synth.eik_tables"):
            return post(a, times)

    return batched


def discretize_device_batch(static, arrays, effective_dt, ctx, nt_cell_max,
                            n_rounds=2, ncell_budget=None, device="cuda"):
    """prepare_batch's (static, arrays) -> the centroid tables of the whole
    batch on `device` (make_device_discretizer's outputs).  Host arrays are
    copied to `device`; tensors (ops/eik_prepare's, already there in the
    discretizer's dtypes) are taken as they are."""
    fn = make_device_discretizer(static, effective_dt, ctx, nt_cell_max, n_rounds,
                                 ncell_budget=ncell_budget, device=device)
    adev = {
        k: v if torch.is_tensor(v) else to_device(np.asarray(v), device,
                                                  I32 if v.dtype.kind == "i" else F32)
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
