"""GF-store distance sharding: model parallelism for giant databases (port
of kiwi_tpu/parallel/gfshard.py).

The reference scales past one machine's memory by giving each minimizer
process a distance-contiguous subset of the receivers, so that every
process reads only the GF chunks covering its receivers' distances
(seismosizer.py:89-124).  Here each rank of the mesh's receiver axis holds
the GF window of its receiver group alone, on its own device: per-device
memory is window(distance span of its receivers) instead of window(all
receivers).

The windows share the unsharded plan's config except the distance origin:
a common width (the widest group's), each origin clamped into the store.
Every rank builds only its own shard (window, receiver geometry, misfit
setup and reference context) from that local config, with the unsharded
plan's probe span, static evaluation window and amplitude normalization
(so each row and its floating shift come out as unsharded), and runs the
formulation the unsharded engine would choose (synth.choose_formulation):
the window kernel, the plain synthesis, or the shared-kinematics
contraction for moment-only batches.  The forward is collective-free; the only
communication is one gather of the per-row misfits (GFShardedPlan.misfits),
after which every rank holds them in the engine's rc and receiver order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import synth
from ..profiling import to_host
from ..sources import get_source_model
from .sharding import check_device, source_block


def partition_receivers(geom, n):
    """Distance-contiguous, count-balanced receiver groups (the reference's
    distance heuristic, seismosizer.py:107-124): n index arrays, some empty
    when n exceeds the receivers."""
    order = np.argsort(geom.dist, kind="stable")
    return [np.sort(chunk) for chunk in np.array_split(order, n)]


@dataclasses.dataclass
class GFShardedPlan:
    """This rank's shard of a distance-sharded forward; build with
    build_plan.  Its forwards are made per batch shape, keyed (ncent,
    group_size, shared, use_window) as in the JAX package, each the
    formulation the unsharded engine would run."""

    engine: object
    mesh: object
    axis: str
    source_axis: object
    cfg: object  # this rank's config: the unsharded one at its own origin
    statics: tuple  # the unsharded plan's Engine._plan_statics
    window: object  # (ext, gfi, gfn) tensors of this rank's window; None: no receivers
    groups: list  # receiver index arrays per shard
    rc_of: list  # global rc rows per shard
    origins: list  # per-shard window origins (store ix)
    built_stats: tuple  # (extent, depth range, time range, rise time) the windows cover
    _fwds: dict = dataclasses.field(default_factory=dict)
    last_formulation: object = None  # synth.Formulation of the last batch

    def _batch_exceeds_built_stats(self, pb, risetime_max):
        """Cheap tier: the batch's conservative param_stats (and rise time)
        against those the windows were built from.  False = covered."""
        eng = self.engine
        model = get_source_model(eng.source_type)
        ext, (d0, d1), (t0, t1) = eng._param_stats(model, pb)
        bext, (bd0, bd1), (bt0, bt1), brt = self.built_stats
        eps = 1e-3
        return (ext > bext + eps or d0 < bd0 - eps or d1 > bd1 + eps
                or t0 < bt0 - eps or t1 > bt1 + eps or risetime_max > brt + eps)

    def _check_coverage_precise(self, cbatch, risetime_max):
        """Exact tier: a centroid outside a shard's window would synthesize
        zeros (the unsharded engine plans anew from the batch instead), and
        a rise time beyond the plan's fold would be cut.  gf_indices'
        validity on the discretized centroids of every shard, and the fold
        length: ValueError naming what leaves the coverage."""
        cfg = self.cfg
        eng = self.engine
        north, east, depth, time = (to_host(cbatch[k].detach())[0]
                                    for k in ("north", "east", "depth", "time"))
        act = (to_host(cbatch["active"].detach())[0].astype(bool) if "active" in cbatch
               else np.ones(north.shape, bool))
        if not act.any():
            return
        off = float(np.hypot(north, east)[act].max())
        cd = depth[act]
        ct = time[act]
        xu = cfg.xunder if cfg.interpolate else 1
        zu = cfg.zunder if cfg.interpolate else 1
        geom = eng._geometry()
        problems = []
        for s, (idx, o) in enumerate(zip(self.groups, self.origins)):
            if len(idx) == 0:
                continue
            dlo = float(geom.dist[idx].min()) - off
            dhi = float(geom.dist[idx].max()) + off
            ix1 = int(np.floor((dlo - cfg.firstx) / (cfg.dx * xu))) * xu
            ix2 = int(np.floor((dhi - cfg.firstx) / (cfg.dx * xu))) * xu + xu
            if ix1 < o or ix2 > o + cfg.nxw - 1:
                problems.append(
                    f"shard {s}: distances [{dlo:.0f}, {dhi:.0f}] m need store "
                    f"ix [{ix1}, {ix2}] outside window [{o}, {o + cfg.nxw - 1}]")
        zlo = float(cd.min()) - float(geom.depth.max())
        zhi = float(cd.max()) - float(geom.depth.min())
        iz1 = int(np.floor((zlo - cfg.firstz) / (cfg.dz * zu))) * zu
        iz2 = int(np.floor((zhi - cfg.firstz) / (cfg.dz * zu))) * zu + zu
        if iz1 < cfg.iz0 or iz2 > cfg.iz0 + cfg.nzw - 1:
            problems.append(
                f"depths [{zlo:.0f}, {zhi:.0f}] m need store iz [{iz1}, {iz2}] "
                f"outside window [{cfg.iz0}, {cfg.iz0 + cfg.nzw - 1}]")
        s1 = int(np.floor(float(ct.min()) / cfg.dt))
        s2 = int(np.floor(float(ct.max()) / cfg.dt)) + 1
        if s1 < cfg.s_base or s2 > cfg.s_base + cfg.s_len - 1:
            problems.append(
                f"centroid times [{ct.min():.2f}, {ct.max():.2f}] s need shifts "
                f"[{s1}, {s2}] outside [{cfg.s_base}, {cfg.s_base + cfg.s_len - 1}]")
        fold_max = self.statics[0]
        fold = int(np.ceil(0.5 * risetime_max / cfg.dt)) + 1 if risetime_max > 0 else 0
        if fold > fold_max:
            problems.append(f"rise time {risetime_max:.3f} s needs a fold of {fold} samples, "
                            f"the plan's is {fold_max}")
        if problems:
            raise ValueError(
                "source batch exceeds the GF window coverage this sharded plan "
                "was built for:\n  " + "\n  ".join(problems) + "\nset the widest "
                "search-space source on the engine and rebuild with "
                "gfshard.build_plan")

    def _forward(self, ncent, gsize, shared):
        """(forward, plan) of this rank's shard for a batch shape: the
        unsharded engine's plan builder on the shard's window and receivers."""
        form = synth.choose_formulation(self.cfg, ncent, gsize)
        self.last_formulation = form
        key = (ncent, form.group_size, bool(shared), bool(form.use_window))
        hit = self._fwds.get(key)
        if hit is None:
            idx = self.groups[self.mesh.coords[self.axis]]
            plan = self.engine._plan_forwards(self.cfg, self.statics, self.window, idx,
                                              (ncent,), gsize)
            hit = (plan["forward_shared_raw"] if shared else plan["forward_batch"], plan)
            self._fwds[key] = hit
        return hit

    def misfits(self, params_batch):
        """(misfit f32[B, RC], norm f32[B, RC], shift i32[B, R]) host arrays
        in the engine's global rc and receiver order, on every rank."""
        eng = self.engine
        model = get_source_model(eng.source_type)
        pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
        b = pb.shape[0]
        # whole-batch decisions first, alike on every rank: a batch one rank
        # refuses is refused by all of them before the gather
        if model.batch_discretizer is None:
            eng._batch_shape(model, pb)
        _m, risetimes = eng._post_factors(model, pb)
        rt_max = float(risetimes.max(initial=0.0))
        if self._batch_exceeds_built_stats(pb, rt_max):
            self._check_coverage_precise(eng.discretize(pb).tables, rt_max)
        shared = b >= 2 and model.shared_kin_check is not None and model.shared_kin_check(pb)

        mesh, sa = self.mesh, self.source_axis
        padded, lo, hi = source_block(mesh, pb, sa)
        block, bl = padded[lo:hi], hi - lo

        rc_max = max(max(len(rc) for rc in self.rc_of), 1)
        r_max = max(max(len(g) for g in self.groups), 1)
        buf = np.zeros((bl, 2 * rc_max + r_max), np.float32)
        mine = mesh.coords[self.axis]
        if len(self.groups[mine]):
            rows, moments, risetimes, shape, gsize, _st = eng._batch_rows(model, block)
            fwd, plan = self._forward(int(np.prod(shape)), gsize, shared)
            m, n, fs = to_host(*eng._run_rows(plan, fwd, rows, moments, risetimes, 0, bl))
            nrc, nr = m.shape[1], fs.shape[1]
            buf[:, :nrc] = m
            buf[:, rc_max:rc_max + nrc] = n
            buf[:, 2 * rc_max:2 * rc_max + nr] = fs.view(np.float32)
        every = mesh.all_gather(buf)  # [ranks, bl, W]

        nrc = sum(len(rc) for rc in self.rc_of)
        nrec = len(eng.receivers)
        mg = np.zeros((padded.shape[0], nrc), np.float32)
        ng = np.zeros_like(mg)
        sg = np.zeros((padded.shape[0], nrec), np.int32)
        other = "s" if self.axis == "r" else "r"
        nr_mesh = mesh.shape["r"]
        for k, part in enumerate(every):
            c = {"s": k // nr_mesh, "r": k % nr_mesh}
            if sa is None and c[other] != 0:
                continue  # a replica of the rows of the rank at c[other] = 0
            sl = slice(c[sa] * bl, (c[sa] + 1) * bl) if sa else slice(0, bl)
            idx, rcrows = self.groups[c[self.axis]], self.rc_of[c[self.axis]]
            mg[sl, rcrows] = part[:, :len(rcrows)]
            ng[sl, rcrows] = part[:, rc_max:rc_max + len(rcrows)]
            sg[sl, idx] = np.ascontiguousarray(
                part[:, 2 * rc_max:2 * rc_max + len(idx)]).view(np.int32)
        return mg[:b], ng[:b], sg[:b]

    def global_misfits(self, params_batch):
        m, n, _ = self.misfits(params_batch)
        return np.sqrt((m.astype(np.float64) ** 2).sum(axis=1)) / np.sqrt(
            (n.astype(np.float64) ** 2).sum(axis=1))

    def shard_window_bytes(self):
        """This rank's GF window bytes (the memory the sharding saves)."""
        return 0 if self.window is None else self.window[0].numel() * 4


def build_plan(engine, mesh, axis="r", source_axis="auto"):
    """This rank's shard of a distance-sharded forward for the engine's
    current source, which sets the search space the windows cover (batches
    beyond it raise).  Each rank of the mesh's `axis` holds only the GF
    window of its receiver group, at the groups' common width.

    source_axis: the mesh axis the source batch is split over ("auto": "s"
    where the mesh has more than one rank along it; None: every rank of an
    `axis` group takes the whole batch).  With both axes the forward is 2-D
    parallel: sources x (receivers + their GF store partition)."""
    if source_axis == "auto":
        source_axis = "s" if axis != "s" and mesh.shape.get("s", 1) > 1 else None
    eng = engine
    eng._require_ready()
    check_device(eng, mesh)
    store = eng.store
    geom = eng._geometry()
    groups = partition_receivers(geom, mesh.shape[axis])

    # the unsharded plan's bounds, config and statics for the current source
    model = get_source_model(eng.source_type)
    pb = eng.source_params[None, :]
    stats = eng._param_stats(model, pb)
    _m, risetimes = eng._post_factors(model, pb)
    rt_max = float(risetimes.max(initial=0.0))
    extent, dr, tr, rt = eng._plan_bounds(rt_max, stats)
    cfg0 = eng._plan_config(extent, dr, tr)
    statics = eng._plan_statics(cfg0, rt)

    # per-group distance windows at a common width
    widths, origins = [], []
    for idx in groups:
        if len(idx) == 0:
            widths.append(2)
            origins.append(0)
            continue
        g = eng._plan_config(extent, dr, tr, geom=geom.subset(idx))
        widths.append(g.nxw)
        origins.append(g.ix0)
    nxw = min(max(widths), store.nx)
    origins = [min(max(o, 0), store.nx - nxw) for o in origins]
    mine = mesh.coords[axis]
    cfg = dataclasses.replace(cfg0, ix0=origins[mine], nxw=nxw)

    window = None
    if len(groups[mine]):  # as Engine._make_plan builds the whole plan's
        gfd, gfi, gfn = synth.window_arrays(store, cfg, mesh.device)
        window = (synth.materialize_window(gfd, gfi, cfg), gfi, gfn)

    layout = eng._rc_layout()
    rc_of = [np.array([i for i, (r, _c) in enumerate(layout) if r in set(idx.tolist())],
                      np.int64) for idx in groups]
    return GFShardedPlan(
        engine=eng, mesh=mesh, axis=axis, source_axis=source_axis, cfg=cfg, statics=statics,
        window=window, groups=groups, rc_of=rc_of, origins=origins,
        built_stats=(*stats, rt_max))
