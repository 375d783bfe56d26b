"""Session engine: source + GF store + receivers -> seismograms -> misfits
(port of the point-sweep subset of kiwi_tpu/engine.py).

One object holds the configured database, receiver set, source and misfit
setup.  Configuration changes invalidate a "plan" (static window/probe
geometry, the device-resident GF window and reference context, and the
forward closures); source parameter changes are new inputs to the same
plan, and a whole sweep of sources is evaluated in one batched forward.

This slice covers the shared-kinematics sweep through the fused synthesis +
floating-scan kernel (ops/float_scan.py) and the synthetic reference.  Plans
outside it raise NotImplementedError naming the ROADMAP.md item that brings
them: there is no unfused fallback, since that path needs the scan_sums
kernel, which is not ported yet.

Units: latitudes/longitudes in degrees, distances/depths in meters, times
in seconds.  Tensors live on `Engine(store, device=...)`'s device.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import check_tf32_off
from . import misfit as mf
from . import synth
from .gf.store import GFStore
from .gf.trace import dataspan, fnint
from .ops.float_scan import MAX_T
from .plf import PLF
from .sources import get_source_model

F32 = torch.float32

# an unported case names the ROADMAP.md (queue 1) item that brings it
_TODO_NONSHARED = ("non-shared (finite-fault) batches and unfused plans need the "
                   "scan_sums kernel and the non-shared forward: ROADMAP.md queue 1, item 9")
_TODO_NORMS = "non-floating misfit norms: ROADMAP.md queue 1, item 11"


@dataclasses.dataclass
class Receiver:
    lat_deg: float
    lon_deg: float
    components: str  # e.g. "ned" (receiver.f90:35-56)
    depth: float = 0.0
    enabled: bool = True


class Engine:
    """A minimizer session on one torch device."""

    def __init__(self, store: GFStore | None = None, device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_tf32_off()
        self.store = store
        self.receivers: list[Receiver] = []
        self.src_lat_deg = None
        self.src_lon_deg = None
        self.source_type = None
        self.source_params = None
        self.effective_dt = 1.0
        self.misfit_method = mf.L2NORM
        self.interpolate = False
        self.floating_shiftrange_s = (0.0, 0.0)
        self._per_rec_shiftrange = {}
        # host-side reference traces / tapers / filters, keyed by rc row
        self._refs: dict = {}  # irc -> (values f32[n], itmin int)
        self._tapers: dict = {}  # irc -> PLF
        self._filters: dict = {}  # irc -> PLF
        self._plan = None
        self._plan_key = None
        self._sweep_memo = {}

    # -- configuration (each invalidates the plan as needed) -----------------

    def set_local_interpolation(self, on: bool):
        self.interpolate = bool(on)
        self._invalidate()

    def set_receivers(self, receivers: list[Receiver]):
        self.receivers = list(receivers)
        self._refs.clear()
        self._tapers.clear()
        self._filters.clear()
        self._invalidate()

    def set_source_location(self, lat_deg, lon_deg):
        self.src_lat_deg = float(lat_deg)
        self.src_lon_deg = float(lon_deg)
        self._invalidate()

    def set_source_params(self, source_type: str, params):
        model = get_source_model(source_type)
        params = np.asarray(params, dtype=np.float32)
        if params.shape != (model.nparams,):
            raise ValueError(
                f"{source_type} needs {model.nparams} params, got {params.shape}"
            )
        self.source_type = source_type
        self.source_params = params

    def set_effective_dt(self, dt):
        self.effective_dt = float(dt)

    def set_misfit_method(self, method):
        self.misfit_method = mf.NORM_NAMES[method] if isinstance(method, str) else int(method)
        self._invalidate()

    def set_misfit_taper(self, irec, x, y):
        plf = PLF(x, y)
        for irc, (r, _c) in enumerate(self._rc_layout()):
            if r == irec:
                self._tapers[irc] = plf
        self._invalidate()

    def set_misfit_filter(self, irec, x, y):
        """irec = None applies to all receivers (minimizer_engine.f90:632-666)."""
        plf = PLF(x, y)
        for irc, (r, _c) in enumerate(self._rc_layout()):
            if irec is None or r == irec:
                self._filters[irc] = plf
        self._invalidate()

    def set_floating_shiftrange(self, tmin, tmax, irec=None):
        """Allowed reference shift range for floating norms; irec=None sets
        all receivers (minimizer_engine.f90:421-451)."""
        if irec is None:
            self.floating_shiftrange_s = (float(tmin), float(tmax))
            self._per_rec_shiftrange = {}
        else:
            self._per_rec_shiftrange[int(irec)] = (float(tmin), float(tmax))
            lo = min(self.floating_shiftrange_s[0], float(tmin))
            hi = max(self.floating_shiftrange_s[1], float(tmax))
            self.floating_shiftrange_s = (lo, hi)
        self._invalidate()

    # -- internals ------------------------------------------------------------

    def _invalidate(self):
        self._plan = None
        self._plan_key = None
        self._sweep_memo = {}

    def _rc_layout(self):
        """[(irec, comp_char)] rows in receiver-major order."""
        return [(irec, c) for irec, r in enumerate(self.receivers) for c in r.components]

    def _require_ready(self):
        if self.store is None:
            raise RuntimeError("no database set")
        if not self.receivers:
            raise RuntimeError("no receivers set")
        if self.src_lat_deg is None:
            raise RuntimeError("no source location set")

    def _geometry(self):
        lats = np.radians([r.lat_deg for r in self.receivers])
        lons = np.radians([r.lon_deg for r in self.receivers])
        depths = np.array([r.depth for r in self.receivers])
        return synth.precompute_receiver_geometry(
            np.radians(self.src_lat_deg), np.radians(self.src_lon_deg), lats, lons, depths
        )

    @staticmethod
    def _bucket(value, step):
        return float(np.ceil(max(value, step) / step) * step)

    def _make_plan(self, extent, depth_range, time_range, risetime_max, nshape,
                   gsize=1):
        self._require_ready()
        store = self.store
        dev = self.device
        geom = self._geometry()
        cfg = synth.plan_config(
            store, geom, extent, depth_range, time_range,
            interpolate=self.interpolate,
        )
        gfd, gfi, gfn = synth.window_arrays(store, cfg, dev)
        ncent = int(np.prod(nshape))
        group_size = synth.choose_group_size(cfg, ncent, gsize)
        ext = synth.materialize_window(gfd, gfi, cfg)

        fold_max = int(np.ceil(0.5 * risetime_max / store.dt)) + 1 if risetime_max > 0 else 0

        # probe span: union of the synthesis window and every reference trace
        lo = cfg.out_it0 - fold_max
        hi = cfg.out_it0 + cfg.nt_out - 1 + fold_max
        maxreflen = 1
        s1 = int(fnint(np.float32(self.floating_shiftrange_s[0]) / np.float32(store.dt)))
        s2 = int(fnint(np.float32(self.floating_shiftrange_s[1]) / np.float32(store.dt)))
        for values, itmin in self._refs.values():
            lo = min(lo, itmin + s1)
            hi = max(hi, itmin + len(values) - 1 + s2)
            maxreflen = max(maxreflen, len(values))
        minlength = 2 * max(cfg.nt_out, maxreflen)
        ps0, ps1 = mf.allowed_span((lo, hi), minlength)
        st = mf.ProbeStatic(ps0=ps0, pl=ps1 - ps0 + 1, dt=store.dt)

        layout = self._rc_layout()
        rc_rec = np.array([r for r, _ in layout], dtype=np.int64)
        rc_chan = np.array(
            [abs(synth.COMPONENT_IDS[c]) - 1 for _, c in layout], dtype=np.int64
        )
        rc_sign = np.array(
            [np.sign(synth.COMPONENT_IDS[c]) for _, c in layout], dtype=np.float32
        )
        span_of_chan = np.array([0, 1, 2, 0, 0], dtype=np.int64)

        setup = mf.MisfitSetup(st, rc_rec)
        for irc, (values, itmin) in self._refs.items():
            setup.set_ref(irc, values, itmin)
        for irc, plf in self._tapers.items():
            setup.set_taper(irc, plf)
        for irc, plf in self._filters.items():
            setup.set_filter(irc, plf)
        for irc, (r, _c) in enumerate(layout):
            setup.enabled[irc] = self.receivers[r].enabled
            tmin, tmax = self._per_rec_shiftrange.get(r, self.floating_shiftrange_s)
            setup.shift_lo[irc] = int(fnint(np.float32(tmin) / np.float32(store.dt)))
            setup.shift_hi[irc] = int(fnint(np.float32(tmax) / np.float32(store.dt)))
        ctx = setup.to(dev)

        # static union window for the misfit sums: every possible norm span
        # (ref spans under all floating shifts, the synthesis window +- fold,
        # GF-data-derived synthetic spans, taper spans) lies inside it
        sl = np.s_[cfg.ix0 : cfg.ix0 + cfg.nxw, cfg.iz0 : cfg.iz0 + cfg.nzw]
        gfi_np = np.asarray(store.itmin[sl])
        gfn_np = np.asarray(store.nsamples[sl])
        w0 = min(lo, int(gfi_np.min()) + cfg.s_base - 1 - fold_max)
        w1 = max(hi, int((gfi_np + gfn_np).max()) + cfg.s_base + cfg.s_len
                 + 1 + fold_max)
        if setup.has_taper.any():
            w0 = min(w0, int(setup.taper_lo[setup.has_taper].min()))
            w1 = max(w1, int(setup.taper_hi[setup.has_taper].max()))
        eval_win = (max(w0, st.ps0), min(w1, st.ps0 + st.pl - 1))

        recs = geom.to(dev)
        nrec = len(self.receivers)
        method = self.misfit_method
        any_taper = bool(setup.has_taper.any())
        any_filter = bool(setup.has_filter.any())
        # the reference context exists for the floating norms only; a plan
        # under another norm still synthesizes (set_synthetic_reference)
        rctx = None
        if method in mf.FLOATING:
            rctx = mf.precompute_ref_context(ctx, method, st, (s1, s2), any_taper, any_filter)

        rc_rec_t = torch.as_tensor(rc_rec, device=dev)
        rc_chan_t = torch.as_tensor(rc_chan, device=dev)
        rc_sign_t = torch.as_tensor(rc_sign, device=dev)
        span_idx_t = torch.as_tensor(span_of_chan[rc_chan], device=dev)

        def synth_rc(cent):
            """One source -> component traces + spans: f32[RC, nt_out]
            (the grouped-direct synthesis of kiwi_tpu, summed over
            centroids and GF components)."""
            kin = synth._centroid_kinematics(cfg, recs, cent)
            v = synth.values_matrix(ext, cfg, kin, group_size=group_size)
            lo_, hi_ = synth.physical_spans(gfi, gfn, cfg, kin)  # [R, 3]
            wv = torch.where(kin["valid"][..., None, None], kin["wg"], 0.0)
            ard = torch.einsum("rcog,rcgt->rot", wv, v)  # [R, 3, nt_out]
            canon = synth.ard_to_components(ard, recs["bazi"], (1, 2, 3, 4, 5))
            syn_rc = canon[rc_rec_t, rc_chan_t] * rc_sign_t[:, None]
            return syn_rc, lo_[rc_rec_t, span_idx_t], hi_[rc_rec_t, span_idx_t]

        def synth_one(cent, moment, risetime):
            syn_rc, lo_rc, hi_rc = synth_rc(cent)
            if fold_max > 0:
                w = mf.fold_stf_weights(risetime, st.dt, fold_max)
                syn_rc = mf.apply_fold(syn_rc, w)
                lo_rc = lo_rc - fold_max
                hi_rc = hi_rc + fold_max
            return syn_rc * moment, lo_rc, hi_rc

        # uniform rc layout (every receiver contributes the same rows,
        # rec-major): the backazimuth rotation folds into the moment
        # weights and the rc rows are a reshape of [R, K]
        rc_k = mf.uniform_rec_major(rc_rec, nrec)
        tprime = ncent * cfg.ng
        use_fused_scan = rctx is not None and rc_k is not None and tprime <= MAX_T

        rot = None
        if rc_k is not None:
            cl = torch.cos(recs["bazi"] + np.pi).to(F32)
            sn = torch.sin(recs["bazi"] + np.pi).to(F32)
            one, zero = torch.ones_like(cl), torch.zeros_like(cl)
            basis = torch.stack([
                torch.stack([one, zero, zero], -1),  # away
                torch.stack([zero, one, zero], -1),  # right
                torch.stack([zero, zero, one], -1),  # down
                torch.stack([cl, -sn, zero], -1),  # north
                torch.stack([sn, cl, zero], -1),  # east
            ], dim=1)  # [R, 5, 3] (ard_to_components semantics)
            chan_rk = rc_chan_t.reshape(nrec, rc_k)
            rot = (torch.gather(basis, 1, chan_rk[..., None].expand(nrec, rc_k, 3))
                   * rc_sign_t.reshape(nrec, rc_k)[..., None])  # [R, K, 3]

        def forward_shared_fused(cbatch, moments, risetime0):
            """Shared-kinematics forward with the synthesis contraction fused
            into the scan kernel.  Callers guarantee batch-uniform
            risetimes and kinematics (row 0 stands for the batch); only
            the moment tensors cbatch["m"] f32[B, C, 6] differ."""
            cent0 = {k: v[0] for k, v in cbatch.items()}
            kin = synth._centroid_kinematics(cfg, recs, cent0)  # [R, C]
            v = synth.values_matrix(ext, cfg, kin, group_size=group_size)
            lo_, hi_ = synth.physical_spans(gfi, gfn, cfg, kin)
            # per-model GF weights in [R, C, B, 3, ng]: angle leaves [R, C, 1]
            # against moment tensors [C, B, 6]
            angles = {k: kin[k][..., None] for k in ("sin_az", "cos_az", "sin_l", "cos_l")}
            wv = synth.weights_from_angles(angles, cbatch["m"].transpose(0, 1), cfg.ng)
            wv = torch.where(kin["valid"][..., None, None, None], wv, 0.0)
            wv = wv.permute(0, 1, 3, 4, 2)  # [R, C, 3, ng, B] (view)
            # rotation + component signs folded into the weights: the
            # synthesis is linear in the (a, r, d) channel axis; exact f32
            # products summed in channel order
            wk = sum(rot[:, :, None, None, o, None] * wv[:, None, :, o] for o in range(3))
            bsz = wk.shape[-1]
            wgt_rtb = wk.reshape(nrec * rc_k, tprime, bsz)  # [RC, T, B]
            v_all = v.reshape(nrec, tprime, cfg.nt_out)  # [R, T, nt]
            if any_taper or any_filter:
                v_rows = v_all.repeat_interleave(rc_k, dim=0)
                kshare = 1
            else:
                v_rows = v_all
                kshare = rc_k
            return mf.evaluate_misfits_floating_fused(
                ctx, v_rows, wgt_rtb, cfg.out_it0, lo_[rc_rec_t, span_idx_t],
                hi_[rc_rec_t, span_idx_t], st, nrec, moments,
                risetime0, rctx, fold_nshift_max=fold_max, any_taper=any_taper,
                any_filter=any_filter, eval_win=eval_win, k_share=kshare, rids=rc_rec,
            )

        return {
            "cfg": cfg,
            "rctx": rctx,
            "use_fused_scan": use_fused_scan,
            "forward_shared_fused": forward_shared_fused,
            "synth_one": synth_one,
        }

    def _batch_shape(self, model, pb):
        """The single discretization grid shape of a batch (shape-relevant
        columns deduplicated first)."""
        cols = pb[:, list(model.shape_param_idx)]
        rows = cols[:1] if (cols == cols[0]).all() else np.unique(cols, axis=0)
        full = np.tile(pb[0], (rows.shape[0], 1))
        full[:, list(model.shape_param_idx)] = rows
        shapes = {model.grid_shape(p, self.effective_dt) for p in full}
        if len(shapes) != 1:
            raise NotImplementedError(
                f"source batch has mixed grid shapes {shapes}; shape bucketing "
                "belongs to the grid-search path: ROADMAP.md queue 1, item 9")
        return shapes.pop()

    def _post_factors(self, model, pb):
        m, r = model.post_factors_batch(torch.as_tensor(pb))
        return m.numpy(), r.numpy()

    def _param_stats(self, model, pb):
        """Host-side conservative centroid bounds from raw params."""
        return model.param_stats(pb, self.effective_dt)

    def _discretize_batch(self, params_batch):
        model = get_source_model(self.source_type)
        pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
        shape = self._batch_shape(model, pb)
        cbatch = model.discretize(torch.as_tensor(pb, device=self.device),
                                  self.effective_dt, shape)
        moments, risetimes = self._post_factors(model, pb)
        return cbatch, moments, risetimes, shape, int(shape[-1])

    def _ensure_plan(self, risetime_max, shape, stats, gsize=1):
        extent, depth_range, time_range = stats
        st = self.store
        xstep = 4.0 * st.dx
        zstep = 4.0 * st.dz
        tstep = 8.0 * st.dt
        extent_b = self._bucket(extent * 1.1 + 0.01, xstep)
        dr = (
            np.floor(depth_range[0] / zstep) * zstep,
            self._bucket(depth_range[1] + 0.01, zstep),
        )
        tr = (
            np.floor(time_range[0] / tstep) * tstep,
            self._bucket(time_range[1] + st.dt, tstep),
        )
        rt = self._bucket(risetime_max, 4.0 * st.dt) if risetime_max > 0 else 0.0
        key = (extent_b, dr, tr, rt, np.prod(shape), gsize)
        if self._plan is None or self._plan_key != key:
            self._plan = self._make_plan(extent_b, dr, tr, rt, shape, gsize=gsize)
            self._plan_key = key
        return self._plan

    def _current_plan(self):
        model = get_source_model(self.source_type)
        pb = self.source_params[None, :]
        stats = self._param_stats(model, pb)
        shape = self._batch_shape(model, pb)
        _m, risetimes = self._post_factors(model, pb)
        return self._ensure_plan(float(risetimes.max(initial=0.0)), shape, stats,
                                 gsize=int(shape[-1]))

    # -- queries --------------------------------------------------------------

    def sweep_global_misfits(self, base_params, col, values):
        """Global misfits g f32[N] (a tensor on the engine's device) for a
        one-column sweep around base_params, values a host array [N].

        The batch never exists on the host: the base row is tiled on the
        device, column `col` set to `values`, then discretized, synthesized,
        evaluated through the fused kernel, and reduced to one global misfit
        per row (minimizer_engine.f90:935-942).  Sweeps outside the
        shared-kinematics fused design raise NotImplementedError.
        """
        if not self._refs:
            raise RuntimeError("no reference seismograms set")
        model = get_source_model(self.source_type)
        base = np.ascontiguousarray(base_params, np.float32).reshape(-1)
        values = np.ascontiguousarray(values, np.float32).reshape(-1)
        col = int(col)
        n = values.shape[0]
        vmin, vmax = float(values.min()), float(values.max())
        # repeat-sweep memo: grid searches dispatch the same (base, col) spec
        # with fresh values; skip the host prep when a previous call planned
        # a covering value range.  effective_dt is in the key because
        # set_effective_dt (alone among the setters) does not invalidate
        # the plan
        mkey = (self.source_type, col, n, self.effective_dt, base.tobytes())
        hit = self._sweep_memo.get(mkey)
        if hit is not None and hit[0] is self._plan and (
                hit[1] <= vmin and vmax <= hit[2]):
            return hit[3](hit[4], torch.as_tensor(values, device=self.device))
        # 3-row probe: host-side shape/stat/sharedness decisions cover the
        # sweep's full range without materializing the batch
        pb3 = np.tile(base, (3, 1))
        pb3[:, col] = (vmin, vmax, float(base[col]))
        shape = self._batch_shape(model, pb3)
        stats = self._param_stats(model, pb3)
        _m3, r3 = self._post_factors(model, pb3)
        plan = self._ensure_plan(float(r3.max(initial=0.0)), shape, stats,
                                 gsize=int(shape[-1]))
        if plan["rctx"] is None:
            raise NotImplementedError(_TODO_NORMS)
        shared = model.shared_kin_check(pb3)
        # the post factors depend on the swept column alone, so equal probe
        # risetimes == batch-uniform risetimes (the STF fold of the shared
        # values rows then commutes with the contraction)
        if not (shared and plan["use_fused_scan"] and (r3 == r3[0]).all() and n <= 65536):
            raise NotImplementedError(_TODO_NONSHARED)
        edt = self.effective_dt
        fwd = plan["forward_shared_fused"]

        def sweep_fn(basej, vals):
            pb = basej[None, :].repeat(n, 1)
            pb[:, col] = vals
            cb = model.discretize(pb, edt, shape)
            moments, risetimes = model.post_factors_batch(pb)
            m, nrm, _fs = fwd(cb, moments, risetimes[0])
            return mf.global_misfit(m, nrm)

        basej = torch.as_tensor(base, device=self.device)
        self._sweep_memo[mkey] = (self._plan, vmin, vmax, sweep_fn, basej)
        return sweep_fn(basej, torch.as_tensor(values, device=self.device))

    def get_synthetic_seismograms(self):
        """[(values f32[n], itmin)] per rc row, scaled (moment + rise time),
        trimmed to the physical data span -- probe_get_plain equivalents."""
        plan = self._current_plan()
        cbatch, moments, risetimes, _shape, _gsize = self._discretize_batch(
            self.source_params[None, :])
        cent = {k: v[0] for k, v in cbatch.items()}
        syn, lo, hi = plan["synth_one"](
            cent, float(np.float32(moments[0])),
            torch.tensor(risetimes[0], dtype=F32, device=self.device))
        syn = syn.cpu().numpy()
        if not np.isfinite(syn).all():  # seismogram.f90:290-295's NaN/huge check
            logging.getLogger("kiwi_tpu_torch").warning(
                "non-finite synthetic seismogram samples "
                "(source outside the GF database's validity range?)")
        lo = lo.cpu().numpy()
        hi = hi.cpu().numpy()
        it0 = plan["cfg"].out_it0
        nt = plan["cfg"].nt_out
        out = []
        for irc in range(syn.shape[0]):
            a = max(int(lo[irc]) - it0, 0)
            b = min(int(hi[irc]) - it0, nt - 1)
            out.append((syn[irc, a : b + 1].copy(), it0 + a))
        return out

    def set_synthetic_reference(self):
        """Synthesize the current source and install it as the reference
        (seismosizer.py:523-527's self-consistency hook)."""
        traces = self.get_synthetic_seismograms()
        for irc, (values, itmin) in enumerate(traces):
            span = dataspan(values, itmin)
            if span is None:
                values = np.zeros(1, np.float32)
            else:
                values = values[span[0] - itmin : span[1] - itmin + 1]
                itmin = span[0]
            self._refs[irc] = (np.asarray(values, np.float32), int(itmin))
        self._invalidate()
