"""Session engine: source + GF store + receivers -> seismograms -> misfits
(port of the batch-evaluation surface of kiwi_tpu/engine.py).

One object holds the configured database, receiver set, source and misfit
setup.  Configuration changes invalidate a "plan" (static window/probe
geometry, the device-resident GF window and reference context, and the
forward closures); source parameter changes are new inputs to the same
plan, and a whole batch of sources is evaluated in one batched forward.

Three forwards, as in the JAX package:
* shared kinematics (all sources of a batch at the same centroid positions
  and times, e.g. a strike sweep of a point source): the synthesis
  contraction fused into the scan kernel (ops/float_scan.fused_scan_sums);
* shared kinematics the fused kernel cannot take (contraction depth
  C*ng > 64, e.g. a slip-rake sweep of a finite fault): a float32 matmul,
  then the scan;
* everything else (finite faults whose strike, dip or size vary): the
  window synthesis kernel (ops/synth_window.py), then the scan kernel
  (ops/float_scan.scan_sums) on unfiltered floating plans or the masked
  plain-torch evaluation (misfit.evaluate_misfits) on filtered floating
  plans and under the time-domain norms.
The eikonal sources discretize a whole batch on the device (prepare_batch
on the host, then sources/eikonal.discretize_device_batch with the
fast-sweeping kernel ops/eik_sweep.py), cross-checked once per table shape
against the host FMM pipeline (a disagreement raises on the card and falls
back to the host pipeline on the CPU), or on the host (eikonal_device =
False, and single sources), and then take the window-kernel forward.
Plans outside them raise NotImplementedError naming the ROADMAP.md item
that brings them; nothing is computed some other way.

Units: latitudes/longitudes in degrees, distances/depths in meters, times
in seconds.  Tensors live on `Engine(store, device=...)`'s device, the card
("cuda") unless the caller names another.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import numpy as np
import torch

from . import check_tf32_off
from . import crust2x2
from . import misfit as mf
from . import synth
from .gf.store import GFStore
from .gf.trace import dataspan, fnint
from .ops import synth_window
from .ops.float_scan import MAX_T
from .plf import PLF
from .sources import eikonal as eiksrc
from .sources import get_source_model

F32 = torch.float32

# an unported case names the ROADMAP.md (queue 1) item that brings it
_TODO_NORMS = "spectral misfit norms (ampspec_l1norm, ampspec_l2norm): ROADMAP.md queue 1, item 4"
LOG = logging.getLogger("kiwi_tpu_torch")
_TODO_WINDOW = ("plans outside the window kernel (extended time axis above "
                f"{synth_window.T_MAX} samples, or a GF store with other than 8 or 10 "
                "components) need the XLA formulations (synthesize_with_spans & co): "
                "ROADMAP.md queue 1, item 8")


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


@dataclasses.dataclass
class Receiver:
    lat_deg: float
    lon_deg: float
    components: str  # e.g. "ned" (receiver.f90:35-56)
    depth: float = 0.0
    enabled: bool = True


class Engine:
    """A minimizer session on one torch device."""

    # device bytes a batch's per-source transients may take; larger batches
    # are evaluated in chunks (misfits_for_source_batch)
    memory_budget = 4 << 30

    def __init__(self, store: GFStore | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_tf32_off()
        self.store = store
        self.receivers: list[Receiver] = []
        self.src_lat_deg = None
        self.src_lon_deg = None
        self.ref_time = 0.0
        self.source_type = None
        self.source_params = None
        self.effective_dt = 1.0
        self.misfit_method = mf.L2NORM
        self.interpolate = False
        self.xunder = 1
        self.zunder = 1
        self.synthetics_factor = 1.0
        self.floating_shiftrange_s = (0.0, 0.0)
        self._per_rec_shiftrange = {}
        self.crustal_thickness_limit = 0.0
        self._user_constraints = None
        # host-side reference traces / tapers / filters, keyed by rc row
        self._refs: dict = {}  # irc -> (values f32[n], itmin int)
        self._tapers: dict = {}  # irc -> PLF
        self._filters: dict = {}  # irc -> PLF
        self._plan = None
        self._plan_key = None
        self._sweep_memo = {}
        # batched eikonal discretization on the device (fast sweeping)
        # instead of the serial host FMM.  The first batch of each table
        # shape cross-checks several members against the host pipeline; if
        # any disagrees, a CPU engine falls back to it with a warning and a
        # CUDA engine raises
        self.eikonal_device = True
        self._eikonal_checked_keys = set()
        # device-table calibration: (model, NF, NC, dt, ctx) -> (ntmax, ncell
        # budget, hard ntmax bound), from the host tables of the first
        # batch's most demanding members; guarded by the discretizer's
        # overflow counter, read once its copy has landed (no sync)
        self._eik_calib = {}
        self._eik_pending = []  # (calibration key, overflow max, event or None)

    # -- configuration (each invalidates the plan as needed) -----------------

    def set_database(self, store: GFStore):
        self.store = store
        self._invalidate()

    def set_local_interpolation(self, on: bool):
        self.interpolate = bool(on)
        self._invalidate()

    def set_spacial_undersampling(self, xunder: int, zunder: int):
        """Use every xunder-th distance and zunder-th depth node of the GF
        store as the bilinear stencil (interpolated sessions only)."""
        if xunder < 1 or zunder < 1:
            raise ValueError("invalid undersampling value")
        self.xunder, self.zunder = int(xunder), int(zunder)
        self._invalidate()

    def set_receivers(self, receivers: list[Receiver]):
        self.receivers = list(receivers)
        self._refs.clear()
        self._tapers.clear()
        self._filters.clear()
        self._invalidate()

    def switch_receiver(self, irec: int, on: bool):
        """Take receiver irec into the misfits or leave it out (its rows
        then weigh nothing in the global misfit)."""
        self.receivers[irec].enabled = bool(on)
        self._invalidate()

    def set_source_location(self, lat_deg, lon_deg, ref_time=0.0):
        self.src_lat_deg = float(lat_deg)
        self.src_lon_deg = float(lon_deg)
        self.ref_time = float(ref_time)
        self._invalidate()

    def set_source_constraints(self, points, normals):
        """Explicit rupture constraints (minimizer_engine.f90:469-477);
        points/normals: [N, 3] arrays in NED meters."""
        self._user_constraints = [
            (np.asarray(p, np.float64), np.asarray(n, np.float64))
            for p, n in zip(points, normals)
        ]

    def set_source_crustal_thickness_limit(self, limit):
        self.crustal_thickness_limit = float(limit)

    def get_source_crustal_thickness(self):
        """The crust2x2 crustal thickness at the source origin, capped by
        the crustal thickness limit when one is set."""
        m = crust2x2.default_model()
        vp, vs, rho, th, _elev = m.profile(self.src_lat_deg, self.src_lon_deg)
        _vvp, _vvs, _vrho, thickness = m.profile_averages(vp, vs, rho, th)
        if self.crustal_thickness_limit > 0:
            thickness = min(self.crustal_thickness_limit, thickness)
        return thickness

    def source_constraints(self):
        """Active constraint half-spaces: user-set, or the defaults from
        crust2x2 (psm_set_default_constraints, parameterized_source.f90:
        127-145): surface at z >= 1500 m and the crust bottom."""
        if self._user_constraints is not None:
            return list(self._user_constraints)
        return [
            (np.array([0.0, 0.0, 1500.0]), np.array([0.0, 0.0, -1.0])),
            (np.array([0.0, 0.0, self.get_source_crustal_thickness()]),
             np.array([0.0, 0.0, 1.0])),
        ]

    def eikonal_context(self):
        depths, _vp, vs, _rho = crust2x2.default_model().layers_at(
            self.src_lat_deg, self.src_lon_deg)
        return eiksrc.EikonalContext(
            constraints=self.source_constraints(), layer_depths=depths, layer_vs=vs)

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

    def set_synthetics_factor(self, factor):
        """Scale every synthetic by `factor` inside the misfits (the misfit
        setup's syn_factor)."""
        self.synthetics_factor = float(factor)
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

    def set_ref_seismogram(self, irec, comp_char, values, itmin):
        """Install a reference trace for (receiver, component); itmin is the
        absolute sample index of the first value (time = itmin*dt)."""
        for irc, (r, c) in enumerate(self._rc_layout()):
            if r == irec and c == comp_char:
                self._refs[irc] = (np.asarray(values, np.float32), int(itmin))
                self._invalidate()
                return
        raise KeyError(f"receiver {irec} has no component {comp_char!r}")

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
            interpolate=self.interpolate, xunder=self.xunder, zunder=self.zunder,
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
        setup.syn_factor[:] = self.synthetics_factor
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
        # the reference context exists for the floating and the time-domain
        # norms; a plan under a spectral norm still synthesizes
        # (set_synthetic_reference)
        rctx = None
        if method in mf.FLOATING or method in mf.TIME_DOMAIN:
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
        use_fused_scan = method in mf.FLOATING and rc_k is not None and tprime <= MAX_T

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

        def shared_parts(cbatch):
            """Shared kinematics (row 0 stands for the batch; only the
            moment tensors cbatch["m"] f32[B, C, 6] differ): the values rows
            v [R, C, ng, nt_out], the per-model GF weights wv
            [R, C, B, 3, ng] and the batch-shared rc spans."""
            cent0 = {k: v[0] for k, v in cbatch.items()}
            kin = synth._centroid_kinematics(cfg, recs, cent0)  # [R, C]
            v = synth.values_matrix(ext, cfg, kin, group_size=group_size)
            lo_, hi_ = synth.physical_spans(gfi, gfn, cfg, kin)
            # angle leaves [R, C, 1] against moment tensors [C, B, 6]
            angles = {k: kin[k][..., None] for k in ("sin_az", "cos_az", "sin_l", "cos_l")}
            wv = synth.weights_from_angles(angles, cbatch["m"].transpose(0, 1), cfg.ng)
            wv = torch.where(kin["valid"][..., None, None, None], wv, 0.0)
            return v, wv, lo_[rc_rec_t, span_idx_t], hi_[rc_rec_t, span_idx_t]

        def forward_shared_fused(cbatch, moments, risetime0):
            """Shared-kinematics forward with the synthesis contraction fused
            into the scan kernel.  Callers guarantee batch-uniform
            risetimes and kinematics."""
            v, wv, lo_rc, hi_rc = shared_parts(cbatch)
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
                ctx, v_rows, wgt_rtb, cfg.out_it0, lo_rc, hi_rc, st, nrec, moments,
                risetime0, rctx, fold_nshift_max=fold_max, any_taper=any_taper,
                any_filter=any_filter, eval_win=eval_win, k_share=kshare, rids=rc_rec,
            )

        def rc_rows(ard):
            """ard f32[B, R, 3, nt_out] -> the signed rc component rows [B, RC, nt_out]."""
            canon = synth.ard_to_components(ard, recs["bazi"], (1, 2, 3, 4, 5))
            return canon[:, rc_rec_t, rc_chan_t] * rc_sign_t[:, None]

        def eval_batch(syn_rc, lo_rc, hi_rc, moments, risetimes):
            """The scan kernel on unfiltered floating plans, the masked
            per-model evaluation (FFT filter chain) on filtered floating
            plans and under the time-domain norms."""
            if method in mf.FLOATING and not any_filter:
                evaluate = mf.evaluate_misfits_floating_batch
            else:
                evaluate = functools.partial(mf.evaluate_misfits, any_filter=any_filter)
            return evaluate(ctx, syn_rc, cfg.out_it0, lo_rc, hi_rc, st, nrec, moments,
                            risetimes, rctx, fold_nshift_max=fold_max, eval_win=eval_win,
                            rids=rc_rec)

        def forward_shared_raw(cbatch, moments, risetimes):
            """Shared-kinematics forward for batches the fused kernel cannot
            take: the moment contraction as one float32 batched matmul per
            receiver (TF32 off; an XLA contraction at HIGHEST precision in
            the JAX package, outside any Pallas kernel), then the scan."""
            v, wv, lo_rc, hi_rc = shared_parts(cbatch)
            bsz = wv.shape[2]
            w2 = wv.permute(0, 2, 3, 1, 4).reshape(nrec, bsz * 3, tprime)
            ard = torch.bmm(w2, v.reshape(nrec, tprime, cfg.nt_out))  # [R, B*3, nt]
            ard = ard.reshape(nrec, bsz, 3, cfg.nt_out).transpose(0, 1)
            return eval_batch(rc_rows(ard), lo_rc, hi_rc, moments, risetimes)

        forward_batch = None
        if synth_window.usable(cfg):
            ext_flat = synth_window.pack_ext(ext, cfg)
            span_tab = synth.span_tables(gfi, gfn, cfg)
            gw = gsize if ncent % gsize == 0 else 1  # centroids sharing one GF node

            def forward_batch(cbatch, moments, risetimes):
                """Per-source kinematics -> window kernel -> spans -> eval."""
                kin = synth._centroid_kinematics(cfg, recs, cbatch)  # [B, R, C]
                ard = synth_window.synthesize_ard_batch(ext_flat, cfg, kin, gw)
                lo, hi = synth.physical_spans_from_tables(span_tab, cfg, kin)  # [B, R, 3]
                return eval_batch(rc_rows(ard), lo[:, rc_rec_t, span_idx_t],
                                  hi[:, rc_rec_t, span_idx_t], moments, risetimes)

        # per-source transient bytes of the batch forwards (kinematics and
        # packed weights, traces, probes, scan or masked-eval blocks)
        nrc = len(layout)
        _i0, wk = mf.eval_window_slice(eval_win, st)
        per_source_bytes = 4 * (nrec * ncent * 48 + nrec * 9 * cfg.nt_out
                                + nrc * st.pl * 8 + (s2 - s1 + 1) * nrc * wk * 3)

        return {
            "cfg": cfg,
            "rctx": rctx,
            "use_fused_scan": use_fused_scan,
            "forward_shared_fused": forward_shared_fused,
            "forward_shared_raw": forward_shared_raw,
            "forward_batch": forward_batch,
            "per_source_bytes": per_source_bytes,
            "synth_one": synth_one,
        }

    def _batch_shape(self, model, pb):
        """The single discretization grid shape of a batch (shape-relevant
        columns deduplicated first); ValueError if the rows need several."""
        cols = pb[:, list(model.shape_param_idx)]
        rows = cols[:1] if (cols == cols[0]).all() else np.unique(cols, axis=0)
        full = np.tile(pb[0], (rows.shape[0], 1))
        full[:, list(model.shape_param_idx)] = rows
        shapes = {model.grid_shape(p, self.effective_dt) for p in full}
        if len(shapes) != 1:
            raise ValueError(f"source batch has mixed grid shapes {shapes}; bucket the batch "
                             "by shape (sweep_global_misfits does)")
        return shapes.pop()

    def _post_factors(self, model, pb):
        m, r = model.post_factors_batch(torch.as_tensor(pb))
        return m.numpy(), r.numpy()

    def _param_stats(self, model, pb):
        """Host-side conservative centroid bounds from raw params."""
        if model.param_stats_ctx:
            return model.param_stats(pb, self.effective_dt, self.eikonal_context())
        return model.param_stats(pb, self.effective_dt)

    def _discretize_batch(self, params_batch):
        """(centroid tables [B, C] on the engine's device, moments [B],
        risetimes [B], grid shape, group size: runs of that many
        consecutive centroids share their position)."""
        model = get_source_model(self.source_type)
        pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
        if model.host_discretize:
            return self._discretize_batch_host(model, pb)
        shape = self._batch_shape(model, pb)
        cbatch = model.discretize(torch.as_tensor(pb, device=self.device),
                                  self.effective_dt, shape)
        moments, risetimes = self._post_factors(model, pb)
        return cbatch, moments, risetimes, shape, int(shape[-1])

    def _discretize_batch_host(self, model, pb):
        """Discretization of the host-discretized (eikonal) models.

        With eikonal_device and a real batch (B >= 2), the whole batch is
        discretized on the device (sources/eikonal.discretize_device_batch:
        the fast-sweeping kernel, the downsample and the time cells), with
        table budgets calibrated from the host FMM tables of the batch's
        most demanding members and a first-use cross-check per table shape:
        on disagreement a CPU engine falls back to the host pipeline with a
        warning (the JAX package's semantics) and a CUDA engine raises, so a
        fault on the card never turns into a slower host search.  Otherwise
        every source runs the host pipeline and the tables are padded to a
        multiple of 16 rows with active = False."""
        ctx = self.eikonal_context()
        dev = self.device
        edt = self.effective_dt
        if self.eikonal_device and len(pb) >= 2 and model.name in eiksrc.NAMED_PARAMS:
            named = eiksrc.named_params_batch(model.name, pb)
            static, arrays = eiksrc.prepare_batch(named, edt, ctx)
            # rigorous host bound on the time cells per coarse cell: a cell's
            # duration is 4x the mean |t - mean t| over it, at most
            # 4 * celldiag / minspeed (the solution is 1-Lipschitz in the
            # d/speed metric; the solver's dead-zone floor is 0.5 * minspeed)
            diag = np.hypot(arrays["cdelta"][:, 0], arrays["cdelta"][:, 1])
            ntmax_hard = int(np.floor(4.0 * diag / np.maximum(arrays["minspeed"], 1.0)
                                      / edt).max()) + 2

            self._check_eik_overflow()
            ckey = (model.name, static["NF"], static["NC"], float(edt), ctx.content_key())
            calib = self._eik_calib.get(ckey)
            hosts = {}
            if calib is None:
                # calibrate the table budgets from the host oracle on the
                # batch's first, last and widest members: the hard bound pads
                # ~4x in time cells and the bounding box ~1.6x in cells, and
                # the window kernel pays for every padded row.  ntmax is the
                # members' measured need with no margin: a later member that
                # outgrows it is what the overflow counter catches
                members = {0, len(pb) - 1, int(np.argmax(named[0]["bord_radius"]))}
                for i in sorted(members):
                    hosts[i] = model.discretize(pb[i], edt, ctx)
                ncell = int(static["NC"][0]) * int(static["NC"][1])
                st = [h["stats"] for h in hosts.values()]
                ntmax = min(max(s["max_nt"] for s in st), ntmax_hard)
                budget = -(-int(np.ceil(max(s["n_cells"] for s in st) * 1.2)) // 8) * 8
                calib = (max(ntmax, 1), budget if budget < ncell else None, ntmax_hard)
                self._eik_calib[ckey] = calib
            ntmax, budget, _hard = calib
            cbatch = dict(eiksrc.discretize_device_batch(
                static, arrays, edt, ctx, ntmax, ncell_budget=budget, device=dev))
            self._queue_overflow(ckey, cbatch.pop("overflow"))
            # validate >= 3 members (the calibration members, 0, and random
            # ones) once per (model, table length, dt): a discretizer fault
            # that spares member 0 (a batch-indexing bug) must not pass
            key = (model.name, int(cbatch["north"].shape[1]), float(edt))
            if key not in self._eikonal_checked_keys:
                self._eikonal_checked_keys.add(key)
                rng = np.random.default_rng(len(self._eikonal_checked_keys))
                idxs = set(hosts) | {0} | {
                    int(i) for i in rng.choice(len(pb), size=min(3, len(pb)), replace=False)}
                tables = {k: v.cpu().numpy() for k, v in cbatch.items()}
                for i in sorted(idxs - set(hosts)):
                    hosts[i] = model.discretize(pb[i], edt, ctx)
                bad = [i for i in sorted(idxs)
                       if not self._eikonal_crosscheck_ok(model, pb[i], tables, ctx, member=i,
                                                          host=hosts[i])]
                if bad and dev.type == "cuda":
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
                        "pipeline (engine.eikonal_device = False)", bad)
                    self.eikonal_device = False
                    return self._discretize_batch_host(model, pb)
            moments, risetimes = self._post_factors(model, pb)
            # device tables are [ncell, ntmax] row-major: groups of ntmax
            return cbatch, moments, risetimes, (int(cbatch["north"].shape[1]),), int(ntmax)

        tables = [model.discretize(p, edt, ctx) for p in pb]
        cmax = -(-max(t["north"].shape[0] for t in tables) // 16) * 16
        out = {}
        for k in ("north", "east", "depth", "time", "m", "active"):
            first = tables[0][k]
            arr = np.zeros((len(tables), cmax) + first.shape[1:], dtype=first.dtype)
            for i, t in enumerate(tables):
                arr[i, : t[k].shape[0]] = t[k]
            out[k] = torch.as_tensor(arr, device=dev)
        moments, risetimes = self._post_factors(model, pb)
        # host FMM tables have ragged per-cell time runs: no uniform groups
        return out, moments, risetimes, (cmax,), 1

    def _queue_overflow(self, ckey, ov):
        """Queue a device batch's overflow counter i32[B] for
        _check_eik_overflow without a sync: on the card its max is copied
        into pinned host memory behind an event; on the CPU it is ready."""
        ovmax = ov.amax()
        if ovmax.device.type != "cuda":
            self._eik_pending.append((ckey, ovmax, None))
            return
        host = torch.empty((), dtype=ovmax.dtype, pin_memory=True)
        host.copy_(ovmax, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._eik_pending.append((ckey, host, event))

    def _check_eik_overflow(self, force=False):
        """Deferred, sync-free guard on the calibrated device-eikonal table
        budgets.  On overflow the calibration for that shape widens to the
        rigorous hard bound; the overflowed batch itself shipped with
        clipped time cells / dropped cells (a discretization-level
        approximation on a few cells, warned about here).  A counter is read
        only once its copy has landed (event.query()); unresolved ones stay
        queued, the oldest read anyway past 8 pending, all with force."""
        still = []
        for i, (ckey, ov, event) in enumerate(self._eik_pending):
            must = force or len(self._eik_pending) - i > 8
            if event is not None and not event.query():
                if not must:
                    still.append((ckey, ov, event))
                    continue
                event.synchronize()
            self._drain_eik_overflow(ckey, ov)
        self._eik_pending = still

    def _drain_eik_overflow(self, ckey, ov):
        ov = int(ov)
        if ov > 0:
            calib = self._eik_calib.get(ckey)
            hard = calib[2] if calib else ov
            self._eik_calib[ckey] = (hard, None, hard)
            LOG.warning(
                "device eikonal table calibration overflowed by %d rows/cells on the "
                "previous batch (its misfits carry a small extra discretization error); "
                "widening the table budget to the rigorous bound for %s", ov, ckey)

    def _eikonal_crosscheck_ok(self, model, p0, tables, ctx, rtol=2e-3, member=0, host=None):
        """First-use validation of the device discretizer against the host
        FMM pipeline: the moment-weighted centroid statistics (mean north,
        east, depth, time and the total moment weight) of batch member
        `member`'s table must agree within rtol of their scales (the tables
        cannot be compared cell by cell: the pipelines discretize time
        differently).  tables: the device tables as numpy arrays."""

        if host is None:
            host = model.discretize(p0, self.effective_dt, ctx)
        s_host = _table_stats(host)
        s_dev = _table_stats(tables, member)
        scale = np.array([
            max(abs(s_host[0]), 100.0), max(abs(s_host[1]), 100.0),
            max(abs(s_host[2]), 100.0), max(abs(s_host[3]), self.effective_dt),
            max(abs(s_host[4]), 1e-30),
        ])
        return bool(np.all(np.abs(s_dev - s_host) <= rtol * scale))

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

    def _current_tables(self):
        """The plan of the current source and its centroid tables (one row),
        discretized first: a host-discretized model's grid shape is its
        table length."""
        model = get_source_model(self.source_type)
        pb = self.source_params[None, :]
        stats = self._param_stats(model, pb)
        cbatch, moments, risetimes, shape, gsize = self._discretize_batch(pb)
        plan = self._ensure_plan(float(risetimes.max(initial=0.0)), shape, stats, gsize=gsize)
        return plan, cbatch, moments, risetimes

    # -- queries --------------------------------------------------------------

    def misfits_for_source_batch(self, params_batch):
        """(misfits f32[B, RC], norms f32[B, RC], floating_shifts i32[B, R])
        for parameter rows [B, nparams], tensors on the engine's device.

        Shared-kinematics batches take the fused kernel when it applies,
        else the matmul forward; all others the window kernel.  Batches
        whose per-source transients exceed `memory_budget` run in balanced
        chunks (the last may be shorter; rows give the same result either
        way).  Host-discretized (eikonal) batches are discretized whole
        first, planned from the host param_stats, and the chunks take row
        slices of their centroid tables."""
        if not self._refs:
            raise RuntimeError("no reference seismograms set")
        model = get_source_model(self.source_type)
        pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
        edt = self.effective_dt
        if model.host_discretize:
            stats = self._param_stats(model, pb)
            tables, moments, risetimes, shape, gsize = self._discretize_batch(pb)
            plan = self._ensure_plan(float(risetimes.max(initial=0.0)), shape, stats,
                                     gsize=gsize)
            if plan["forward_batch"] is None:
                raise NotImplementedError(_TODO_WINDOW)
            if plan["rctx"] is None:
                raise NotImplementedError(_TODO_NORMS)
            fwd = plan["forward_batch"]

            def rows(i, j):
                return {k: v[i:j] for k, v in tables.items()}
        else:
            shape = self._batch_shape(model, pb)
            moments, risetimes = self._post_factors(model, pb)
            plan = self._ensure_plan(float(risetimes.max(initial=0.0)), shape,
                                     self._param_stats(model, pb), gsize=int(shape[-1]))
            if plan["rctx"] is None:
                raise NotImplementedError(_TODO_NORMS)
            fwd = self._batch_forward(model, pb, plan, risetimes)
            pbt = torch.as_tensor(pb, device=self.device)

            def rows(i, j):
                return model.discretize(pbt[i:j], edt, shape)

        dev = self.device
        mts = torch.as_tensor(moments, device=dev)
        rts = torch.as_tensor(risetimes, device=dev)
        b = pb.shape[0]
        chunk = max(1, min(b, self.memory_budget // max(plan["per_source_bytes"], 1)))
        chunk = -(-b // -(-b // chunk))  # balanced chunks
        outs = [fwd(rows(i, i + chunk), mts[i:i + chunk], rts[i:i + chunk])
                for i in range(0, b, chunk)]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    @staticmethod
    def _batch_forward(model, pb, plan, risetimes):
        """The forward of a device-discretized batch: the fused kernel for
        shared kinematics when it applies, else the matmul forward; the
        window kernel for all others."""
        shared = pb.shape[0] >= 2 and model.shared_kin_check(pb)
        if shared and plan["use_fused_scan"] and (risetimes == risetimes[0]).all():
            fused = plan["forward_shared_fused"]

            def fwd(cb, mts, rts):
                return fused(cb, mts, rts[0])
        elif shared:
            fwd = plan["forward_shared_raw"]
        elif plan["forward_batch"] is not None:
            fwd = plan["forward_batch"]
        else:
            raise NotImplementedError(_TODO_WINDOW)
        return fwd

    def global_misfits_for_source_batch(self, params_batch):
        """Global misfits f32[B] (minimizer_engine.f90:935-942) for parameter
        rows [B, nparams]."""
        m, n, _ = self.misfits_for_source_batch(params_batch)
        return mf.global_misfit(m, n)

    def sweep_global_misfits(self, base_params, col, values):
        """Global misfits g f32[N] (a tensor on the engine's device) for a
        one-column sweep around base_params, values a host array [N].

        On the fused shared-kinematics design the batch never exists on the
        host: the base row is tiled on the device, column `col` set to
        `values`, then discretized, synthesized, evaluated through the fused
        kernel, and reduced to one global misfit per row
        (minimizer_engine.f90:935-942).  Other sweeps (finite faults whose
        geometry the column moves, deep contractions) go through
        global_misfits_for_source_batch, one batch per discretization grid
        shape where the column changes it, as the JAX package's fallback does.
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
        if model.host_discretize:  # no device-side tiling for host tables
            return self._sweep_by_batches(model, base, col, values)
        mkey = (self.source_type, col, n, self.effective_dt, base.tobytes())
        hit = self._sweep_memo.get(mkey)
        if hit is not None and hit[0] is self._plan and (
                hit[1] <= vmin and vmax <= hit[2]):
            return hit[3](hit[4], torch.as_tensor(values, device=self.device))
        # 3-row probe: host-side shape/stat/sharedness decisions cover the
        # sweep's full range without materializing the batch
        pb3 = np.tile(base, (3, 1))
        pb3[:, col] = (vmin, vmax, float(base[col]))
        try:
            shape = self._batch_shape(model, pb3)
        except ValueError:
            return self._sweep_by_batches(model, base, col, values)
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
            return self._sweep_by_batches(model, base, col, values)
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

    def _sweep_by_batches(self, model, base, col, values):
        """The sweep's rows through global_misfits_for_source_batch; if they
        span several discretization grid shapes (its ValueError), each
        shape's rows apart, scattered back into one f32[N]
        (kiwi_tpu/engine.py:1222-1240)."""
        pb = np.tile(base, (values.shape[0], 1))
        pb[:, col] = values
        try:
            return self.global_misfits_for_source_batch(pb)
        except ValueError:
            groups = {}
            for i, row in enumerate(pb):
                groups.setdefault(model.grid_shape(row, self.effective_dt), []).append(i)
            out = torch.zeros(len(pb), dtype=F32, device=self.device)
            for idx in groups.values():
                out[torch.as_tensor(idx, device=self.device)] = (
                    self.global_misfits_for_source_batch(pb[idx]).to(F32))
            return out

    def get_synthetic_seismograms(self):
        """[(values f32[n], itmin)] per rc row, scaled (moment + rise time),
        trimmed to the physical data span -- probe_get_plain equivalents."""
        plan, cbatch, moments, risetimes = self._current_tables()
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
