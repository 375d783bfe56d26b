"""Session engine: source + GF store + receivers -> seismograms -> misfits
(port of the batch-evaluation, read-back and diagnostics surface of
kiwi_tpu/engine.py, with the parameter masks and Levenberg-Marquardt entry
point that kiwi_tpu_torch.invert builds on; the minimizer protocol of
kiwi_tpu_torch.cli.minimizer drives it).

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
  plans and under the time-domain and amplitude-spectrum norms.  Plans the
  window kernel cannot take (an extended time axis above
  synth_window.T_MAX samples, a store with other than 8 or 10 components)
  synthesize in plain torch instead (plan["formulation"] = "plain", chosen
  from the plan's config alone, as kiwi_tpu's choose_formulation), then
  evaluate the same way.
Every batch is discretized through `discretize`: on the device by the
source model's discretize, or, for a model with a batch_discretizer (the
eikonal ones), by the engine's instance of it (batch_discretizer(): on the
device with the fast-sweeping kernel, cross-checked once per table shape
against the host FMM pipeline, or on the host; sources/eikonal.
BatchDiscretizer), and then takes the batch forward.

Gradients (global_misfits_and_grad, misfit_jacobian and the descent of
invert.gradient on them) differentiate the plain formulation
(plan["forward_batch_xla"]: per-source kinematics, the grouped-direct
synthesis, spans, the masked evaluation), as the JAX package
differentiates its XLA formulation: no CUDA kernel has a backward, and
each refuses inputs that require grad (ops.refuse_grad).

Units: latitudes/longitudes in degrees, distances/depths in meters, times
in seconds.  Tensors live on `Engine(store, device=...)`'s device, the card
("cuda") unless the caller names another.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import typing

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
from .profiling import span, to_device, to_host
from .sources import eikonal as eiksrc
from .sources import get_source_model

F32 = torch.float32

LOG = logging.getLogger("kiwi_tpu_torch")


class Discretized(typing.NamedTuple):
    """A batch's centroid tables [B, C] on the engine's device, its moments
    and rise times [B] (host numpy), its grid shape, and its group size:
    runs of that many consecutive centroids share their position."""

    tables: dict
    moments: np.ndarray
    risetimes: np.ndarray
    shape: tuple
    group_size: int


@dataclasses.dataclass
class Receiver:
    lat_deg: float
    lon_deg: float
    components: str  # e.g. "ned" (receiver.f90:35-56)
    depth: float = 0.0
    enabled: bool = True
    name: str = ""


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
        # model name -> its batch_discretizer's instance, kept for the session
        self._batch_discretizers = {}
        # optional floor on the pow2 probe length.  Spectral-filter weights
        # are evaluated at k/(pl*dt), so filter parity with another
        # implementation (the C++ oracle) needs a common probe grid.  It is
        # read when a plan is made: set it before the first query (or
        # invalidate the plan after changing it)
        self.min_probe_length = 0
        self.plan_builds = 0  # plans made so far (each stages a GF window)
        # masked subparameters (minimizer_engine.f90:525-610)
        self.params_mask = None
        self.subparam_mins = None
        self.subparam_maxs = None

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
        cfg = self._plan_config(extent, depth_range, time_range)
        gfd, gfi, gfn = synth.window_arrays(self.store, cfg, self.device)
        ext = synth.materialize_window(gfd, gfi, cfg)
        return self._plan_forwards(cfg, self._plan_statics(cfg, risetime_max), (ext, gfi, gfn),
                                   np.arange(len(self.receivers)), nshape, gsize)

    def _plan_config(self, extent, depth_range, time_range, geom=None):
        """The synthesis config of a plan for these centroid bounds and the
        receivers of `geom` (all of them by default)."""
        return synth.plan_config(
            self.store, self._geometry() if geom is None else geom, extent, depth_range,
            time_range, interpolate=self.interpolate, xunder=self.xunder, zunder=self.zunder,
        )

    def _plan_statics(self, cfg, risetime_max):
        """What every receiver of a plan shares, from its config: the STF
        fold length, the floating shift range in samples, the probe span,
        the static union window of the misfit sums and the references'
        amplitude scale.  A plan of a subset of the receivers takes
        them from the whole plan's config, so that its probe, window and
        normalization are the whole plan's."""
        store = self.store
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
        minlength = max(2 * max(cfg.nt_out, maxreflen), self.min_probe_length)
        ps0, ps1 = mf.allowed_span((lo, hi), minlength)
        st = mf.ProbeStatic(ps0=ps0, pl=ps1 - ps0 + 1, dt=store.dt)

        # static union window for the misfit sums: every possible norm span
        # (ref spans under all floating shifts, the synthesis window +- fold,
        # GF-data-derived synthetic spans, taper spans clipped to the probe)
        # lies inside it
        sl = np.s_[cfg.ix0 : cfg.ix0 + cfg.nxw, cfg.iz0 : cfg.iz0 + cfg.nzw]
        gfi_np = np.asarray(store.itmin[sl])
        gfn_np = np.asarray(store.nsamples[sl])
        w0 = min(lo, int(gfi_np.min()) + cfg.s_base - 1 - fold_max)
        w1 = max(hi, int((gfi_np + gfn_np).max()) + cfg.s_base + cfg.s_len
                 + 1 + fold_max)
        for plf in self._tapers.values():
            dlo, dhi = plf.discrete_span(store.dt)
            w0 = min(w0, max(dlo, st.ps0))
            w1 = max(w1, min(dhi, st.ps0 + st.pl - 1))
        eval_win = (max(w0, st.ps0), min(w1, st.ps0 + st.pl - 1))
        refs = [np.asarray(v, np.float32) for v, _ in self._refs.values()]
        amp_scale = float(np.abs(np.concatenate(refs)).max()) if refs else 0.0
        return fold_max, (s1, s2), st, eval_win, amp_scale

    def _plan_forwards(self, cfg, statics, window, rec_idx, nshape, gsize):
        """The plan of the receivers rec_idx (their rc rows in the engine's
        order) on the GF window (ext, gfi, gfn) that cfg selects: misfit
        context, reference context and forwards.  The engine's plans take
        every receiver."""
        store = self.store
        dev = self.device
        ext, gfi, gfn = window
        fold_max, (s1, s2), st, eval_win, amp_scale = statics
        ncent = int(np.prod(nshape))
        form = synth.choose_formulation(cfg, ncent, gsize)
        group_size = synth.choose_group_size(cfg, ncent, gsize)

        rec_idx = np.asarray(rec_idx, dtype=np.int64)
        local = {int(r): i for i, r in enumerate(rec_idx)}
        geom = self._geometry().subset(rec_idx)
        full_layout = self._rc_layout()
        rc_rows = [irc for irc, (r, _c) in enumerate(full_layout) if r in local]
        layout = [full_layout[irc] for irc in rc_rows]
        rc_rec = np.array([local[r] for r, _ in layout], dtype=np.int64)
        rc_chan = np.array(
            [abs(synth.COMPONENT_IDS[c]) - 1 for _, c in layout], dtype=np.int64
        )
        rc_sign = np.array(
            [np.sign(synth.COMPONENT_IDS[c]) for _, c in layout], dtype=np.float32
        )
        span_of_chan = np.array([0, 1, 2, 0, 0], dtype=np.int64)

        setup = mf.MisfitSetup(st, rc_rec)
        for j, irc in enumerate(rc_rows):
            if irc in self._refs:
                setup.set_ref(j, *self._refs[irc])
            if irc in self._tapers:
                setup.set_taper(j, self._tapers[irc])
            if irc in self._filters:
                setup.set_filter(j, self._filters[irc])
        setup.syn_factor[:] = self.synthetics_factor
        for j, (r, _c) in enumerate(layout):
            setup.enabled[j] = self.receivers[r].enabled
            tmin, tmax = self._per_rec_shiftrange.get(r, self.floating_shiftrange_s)
            setup.shift_lo[j] = int(fnint(np.float32(tmin) / np.float32(store.dt)))
            setup.shift_hi[j] = int(fnint(np.float32(tmax) / np.float32(store.dt)))
        ctx = setup.to(dev, self.misfit_method, amp_scale=amp_scale)

        recs = geom.to(dev)
        nrec = len(rec_idx)
        method = self.misfit_method
        # the whole session's, so that every shard of a distance-sharded
        # plan evaluates as the unsharded plan does
        any_taper = bool(self._tapers)
        any_filter = bool(self._filters)
        rctx = mf.precompute_ref_context(ctx, method, st, (s1, s2), any_taper, any_filter)

        rc_rec_t = to_device(rc_rec, dev)
        rc_chan_t = to_device(rc_chan, dev)
        rc_sign_t = to_device(rc_sign, dev)
        span_idx_t = to_device(span_of_chan[rc_chan], dev)

        span_tab = synth.span_tables(gfi, gfn, cfg)

        def plain_synth(cbatch):
            """Per-source kinematics -> the grouped-direct synthesis (the
            values rows, then the moment-weight contraction) -> spans, in
            plain torch (kiwi_tpu's synth_rc under vmap, as
            forward_batch_raw_xla runs it): (syn_rc [B, RC, nt_out], lo_rc,
            hi_rc [B, RC])."""
            kin = synth._centroid_kinematics(cfg, recs, cbatch)  # [B, R, C]
            v = synth.values_matrix(ext, cfg, kin, group_size=group_size)  # [B, R, C, ng, nt]
            wv = torch.where(kin["valid"][..., None, None], kin["wg"], 0.0)
            ard = torch.einsum("brcog,brcgt->brot", wv, v)  # [B, R, 3, nt_out]
            lo, hi = synth.physical_spans_from_tables(span_tab, cfg, kin)  # [B, R, 3]
            return rc_rows(ard), lo[:, rc_rec_t, span_idx_t], hi[:, rc_rec_t, span_idx_t]

        def synth_one(cent, moment, risetime):
            """One source -> its scaled component traces f32[RC, nt_out]
            and spans (plain_synth of a batch of one)."""
            syn_rc, lo_rc, hi_rc = (x[0] for x in plain_synth(
                {k: v[None] for k, v in cent.items()}))
            if fold_max > 0:
                w = mf.fold_stf_weights(risetime, st.dt, fold_max)
                syn_rc = mf.apply_fold(syn_rc, w)
                half = torch.clamp(mf.fold_half(risetime, st.dt), max=fold_max)
                lo_rc = lo_rc - half
                hi_rc = hi_rc + half
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
            with span("kiwi.synth.forward"):
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
            with span("kiwi.misfit.eval"):
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
            plans and under the time-domain norms, the per-pair spectra
            under the amplitude-spectrum norms."""
            if method in mf.FLOATING and not any_filter:
                evaluate = mf.evaluate_misfits_floating_batch
            else:
                evaluate = functools.partial(mf.evaluate_misfits, any_filter=any_filter)
            with span("kiwi.misfit.eval"):
                return evaluate(ctx, syn_rc, cfg.out_it0, lo_rc, hi_rc, st, nrec, moments,
                                risetimes, rctx, fold_nshift_max=fold_max, eval_win=eval_win,
                                rids=rc_rec)

        def forward_shared_raw(cbatch, moments, risetimes):
            """Shared-kinematics forward for batches the fused kernel cannot
            take: the moment contraction as one float32 batched matmul per
            receiver (TF32 off; an XLA contraction at HIGHEST precision in
            the JAX package, outside any Pallas kernel), then the scan."""
            with span("kiwi.synth.forward"):
                v, wv, lo_rc, hi_rc = shared_parts(cbatch)
                bsz = wv.shape[2]
                w2 = wv.permute(0, 2, 3, 1, 4).reshape(nrec, bsz * 3, tprime)
                ard = torch.bmm(w2, v.reshape(nrec, tprime, cfg.nt_out))  # [R, B*3, nt]
                syn_rc = rc_rows(ard.reshape(nrec, bsz, 3, cfg.nt_out).transpose(0, 1))
            return eval_batch(syn_rc, lo_rc, hi_rc, moments, risetimes)

        def forward_batch_xla(cbatch, moments, risetimes):
            """The differentiable batch forward (kiwi_tpu's
            forward_batch_raw_xla): plain_synth, then the masked plain
            evaluation under every norm, floating ones included.  No kernel
            wrapper is called, so gradients reach every parameter."""
            syn_rc, lo_rc, hi_rc = plain_synth(cbatch)
            return mf.evaluate_misfits(ctx, syn_rc, cfg.out_it0, lo_rc, hi_rc, st, nrec,
                                       moments, risetimes, rctx, fold_nshift_max=fold_max,
                                       any_filter=any_filter, eval_win=eval_win, rids=rc_rec)

        # the window kernel where it applies, else the plain synthesis: a
        # static choice from the plan's config
        formulation = "window" if form.use_window else "plain"
        if form.use_window:
            ext_flat = synth_window.pack_ext(ext, cfg)

            def forward_batch(cbatch, moments, risetimes):
                """Per-source kinematics -> window kernel -> spans -> eval."""
                with span("kiwi.synth.forward"):
                    kin = synth._centroid_kinematics(cfg, recs, cbatch)  # [B, R, C]
                    ard = synth_window.synthesize_ard_batch(ext_flat, cfg, kin, form.group_size)
                    lo, hi = synth.physical_spans_from_tables(span_tab, cfg, kin)  # [B, R, 3]
                    syn_rc = rc_rows(ard)
                return eval_batch(syn_rc, lo[:, rc_rec_t, span_idx_t],
                                  hi[:, rc_rec_t, span_idx_t], moments, risetimes)
        else:
            def forward_batch(cbatch, moments, risetimes):
                """Per-source kinematics -> plain synthesis -> spans -> eval."""
                with span("kiwi.synth.forward"):
                    parts = plain_synth(cbatch)
                return eval_batch(*parts, moments, risetimes)

        # per-source transient bytes of the batch forwards (kinematics and
        # packed weights, traces, probes, scan or masked-eval blocks; under
        # an amplitude-spectrum norm the extended-grid rows, pair masks and
        # spectra of ref and synthetic); the plain synthesis adds its
        # blended rows [R, P, ng, nt_ext], shifted slices and values block
        # [R, C, ng, nt_out (+ 1)], which forward_batch_xla always pays
        nrc = len(layout)
        _i0, wk = mf.eval_window_slice(eval_win, st)
        per_source_bytes = 4 * (nrec * ncent * 48 + nrec * 9 * cfg.nt_out
                                + nrc * st.pl * 8 + (s2 - s1 + 1) * nrc * wk * 3)
        if method in mf.AMPSPEC:
            per_source_bytes += 4 * nrc * mf.amp_grid(st.ps0, st.pl)[1] * 12
        plain_bytes = 4 * nrec * cfg.ng * (ncent * (2 * cfg.nt_out + 1)
                                           + ncent // group_size * (cfg.nt_out + cfg.s_len))
        xla_source_bytes = per_source_bytes + plain_bytes
        if formulation == "plain":
            per_source_bytes = xla_source_bytes

        return {
            "cfg": cfg,
            "st": st,
            "setup": setup,
            "ctx": ctx,
            "rctx": rctx,
            "use_fused_scan": use_fused_scan,
            "forward_shared_fused": forward_shared_fused,
            "forward_shared_raw": forward_shared_raw,
            "formulation": formulation,
            "forward_batch": forward_batch,
            "forward_batch_xla": forward_batch_xla,
            "per_source_bytes": per_source_bytes,
            "xla_source_bytes": xla_source_bytes,
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

    def batch_discretizer(self, name=None):
        """The engine's instance of source model `name`'s batch_discretizer
        (the current source type's by default), made at first use; None for
        a model without one."""
        model = get_source_model(self.source_type if name is None else name)
        if model.batch_discretizer is not None and model.name not in self._batch_discretizers:
            self._batch_discretizers[model.name] = model.batch_discretizer()
        return self._batch_discretizers.get(model.name)

    def discretize(self, params_batch):
        """The Discretized batch of the current source type's parameter rows
        [B, nparams]."""
        model = get_source_model(self.source_type)
        pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
        disc = self.batch_discretizer()
        if disc is not None:
            tables, shape, gsize = disc(model, pb, self.effective_dt, self.eikonal_context(),
                                        self.device)
        else:
            shape = self._batch_shape(model, pb)
            tables = model.discretize(to_device(pb, self.device), self.effective_dt, shape)
            gsize = int(shape[-1])
        return Discretized(tables, *self._post_factors(model, pb), shape, gsize)

    def _plan_bounds(self, risetime_max, stats):
        """(extent, depth range, time range, rise time) of a plan covering
        these centroid statistics, bucketed so that nearby batches share
        one plan."""
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
        return extent_b, dr, tr, rt

    def _ensure_plan(self, risetime_max, shape, stats, gsize=1):
        with span("kiwi.engine.plan"):
            bounds = self._plan_bounds(risetime_max, stats)
            key = (*bounds, np.prod(shape), gsize)
            if self._plan is None or self._plan_key != key:
                with span("kiwi.engine.plan_build"):
                    self._plan = self._make_plan(*bounds, shape, gsize=gsize)
                self._plan_key = key
                self.plan_builds += 1
            return self._plan

    def _current_tables(self):
        """The plan of the current source and its centroid tables (one row),
        discretized first: an eikonal model's grid shape is its table
        length."""
        model = get_source_model(self.source_type)
        pb = self.source_params[None, :]
        stats = self._param_stats(model, pb)
        d = self.discretize(pb)
        plan = self._ensure_plan(float(d.risetimes.max(initial=0.0)), d.shape, stats,
                                 gsize=d.group_size)
        return plan, d.tables, d.moments, d.risetimes

    # -- queries --------------------------------------------------------------

    def misfits_for_source_batch(self, params_batch):
        """(misfits f32[B, RC], norms f32[B, RC], floating_shifts i32[B, R])
        for parameter rows [B, nparams], tensors on the engine's device.

        Shared-kinematics batches take the fused kernel when it applies,
        else the matmul forward; all others the window kernel.  Batches
        whose per-source transients exceed `memory_budget` run in balanced
        chunks (the last may be shorter; rows give the same result either
        way).  Eikonal batches (a batch_discretizer's) are discretized whole
        first, planned from the host param_stats, and the chunks take row
        slices of their centroid tables."""
        with span("kiwi.engine.batch"):
            pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
            plan, rows, moments, risetimes, fwd = self._batch_plan(pb)
            return self._run_rows(plan, fwd, rows, moments, risetimes, 0, pb.shape[0])

    def _batch_plan(self, pb, shared=True):
        """(plan, rows, moments, risetimes, forward) of the batch pb,
        planned as a whole (rows as _batch_rows gives them).  shared=False
        takes the plan's batch forward (window kernel or plain synthesis)
        for shared-kinematics batches too."""
        if not self._refs:
            raise RuntimeError("no reference seismograms set")
        model = get_source_model(self.source_type)
        rows, moments, risetimes, shape, gsize, stats = self._batch_rows(model, pb)
        plan = self._ensure_plan(float(risetimes.max(initial=0.0)), shape, stats, gsize=gsize)
        if shared:
            fwd = self._batch_forward(model, pb, plan, risetimes)
        else:
            fwd = plan["forward_batch"]
        return plan, rows, moments, risetimes, fwd

    def _batch_rows(self, model, pb):
        """(rows(i, j): the centroid tables of rows i..j-1 on the device,
        moments, risetimes, grid shape, group size, param_stats) of the
        batch pb.  Eikonal batches (a batch_discretizer's) are discretized
        whole and rows slices their tables; device-discretized rows are
        discretized when asked for."""
        if model.batch_discretizer is not None:
            with span("kiwi.engine.prep"):
                stats = self._param_stats(model, pb)
            with span("kiwi.synth.discretize"):
                d = self.discretize(pb)

            def rows(i, j):
                return {k: v[i:j] for k, v in d.tables.items()}
            return rows, d.moments, d.risetimes, d.shape, d.group_size, stats
        with span("kiwi.engine.prep"):
            shape = self._batch_shape(model, pb)
            moments, risetimes = self._post_factors(model, pb)
            stats = self._param_stats(model, pb)
            pbt = to_device(pb, self.device)
        edt = self.effective_dt

        def rows(i, j):
            with span("kiwi.synth.discretize"):
                return model.discretize(pbt[i:j], edt, shape)
        return rows, moments, risetimes, shape, int(shape[-1]), stats

    def _run_rows(self, plan, fwd, rows, moments, risetimes, i0, i1):
        """fwd over the batch rows i0..i1-1, in balanced chunks of at most
        memory_budget bytes of per-source transients."""
        with span("kiwi.engine.prep"):
            mts = to_device(moments[i0:i1], self.device)
            rts = to_device(risetimes[i0:i1], self.device)
        b = i1 - i0
        chunk = max(1, min(b, self.memory_budget // max(plan["per_source_bytes"], 1)))
        chunk = -(-b // -(-b // chunk))  # balanced chunks
        outs = [fwd(rows(i0 + i, i0 + i + chunk), mts[i:i + chunk], rts[i:i + chunk])
                for i in range(0, b, chunk)]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    @staticmethod
    def _batch_forward(model, pb, plan, risetimes):
        """The forward of a device-discretized batch: the fused kernel for
        shared kinematics when it applies, else the matmul forward; the
        plan's batch forward (window kernel or plain synthesis) for all
        others."""
        shared = pb.shape[0] >= 2 and model.shared_kin_check(pb)
        if shared and plan["use_fused_scan"] and (risetimes == risetimes[0]).all():
            fused = plan["forward_shared_fused"]

            def fwd(cb, mts, rts):
                return fused(cb, mts, rts[0])
        elif shared:
            fwd = plan["forward_shared_raw"]
        else:
            fwd = plan["forward_batch"]
        return fwd

    def global_misfits_for_source_batch(self, params_batch):
        """Global misfits f32[B] (minimizer_engine.f90:935-942) for parameter
        rows [B, nparams]."""
        m, n, _ = self.misfits_for_source_batch(params_batch)
        with span("kiwi.misfit.eval"):
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
        with span("kiwi.engine.sweep"):
            return self._sweep(base_params, col, values)

    def _sweep(self, base_params, col, values):
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
        if model.batch_discretizer is not None:  # no device-side tiling for its tables
            return self._sweep_by_batches(model, base, col, values)
        mkey = (self.source_type, col, n, self.effective_dt, base.tobytes())
        hit = self._sweep_memo.get(mkey)
        if hit is not None and hit[0] is self._plan and (
                hit[1] <= vmin and vmax <= hit[2]):
            with span("kiwi.engine.prep"):
                valsj = to_device(values, self.device)
            return hit[3](hit[4], valsj)
        # 3-row probe: host-side shape/stat/sharedness decisions cover the
        # sweep's full range without materializing the batch
        pb3 = np.tile(base, (3, 1))
        pb3[:, col] = (vmin, vmax, float(base[col]))
        with span("kiwi.engine.prep"):
            try:
                shape = self._batch_shape(model, pb3)
            except ValueError:
                shape = None
            else:
                stats = self._param_stats(model, pb3)
                _m3, r3 = self._post_factors(model, pb3)
        if shape is None:
            return self._sweep_by_batches(model, base, col, values)
        plan = self._ensure_plan(float(r3.max(initial=0.0)), shape, stats,
                                 gsize=int(shape[-1]))
        shared = model.shared_kin_check(pb3)
        # the post factors depend on the swept column alone, so equal probe
        # risetimes == batch-uniform risetimes (the STF fold of the shared
        # values rows then commutes with the contraction)
        if not (shared and plan["use_fused_scan"] and (r3 == r3[0]).all() and n <= 65536):
            return self._sweep_by_batches(model, base, col, values)
        edt = self.effective_dt
        fwd = plan["forward_shared_fused"]

        def sweep_fn(basej, vals):
            with span("kiwi.synth.discretize"):
                pb = basej[None, :].repeat(n, 1)
                pb[:, col] = vals
                cb = model.discretize(pb, edt, shape)
                moments, risetimes = model.post_factors_batch(pb)
            m, nrm, _fs = fwd(cb, moments, risetimes[0])
            with span("kiwi.misfit.eval"):
                return mf.global_misfit(m, nrm)

        with span("kiwi.engine.prep"):
            basej = to_device(base, self.device)
            valsj = to_device(values, self.device)
        self._sweep_memo[mkey] = (self._plan, vmin, vmax, sweep_fn, basej)
        return sweep_fn(basej, valsj)

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
                out[to_device(idx, self.device)] = (
                    self.global_misfits_for_source_batch(pb[idx]).to(F32))
            return out

    def get_synthetic_seismograms(self):
        """[(values f32[n], itmin)] per rc row, scaled (moment + rise time),
        trimmed to the physical data span -- probe_get_plain equivalents."""
        plan, cbatch, moments, risetimes = self._current_tables()
        cent = {k: v[0] for k, v in cbatch.items()}
        syn, lo, hi = to_host(*plan["synth_one"](
            cent, float(np.float32(moments[0])),
            to_device(risetimes[0], self.device, F32)))
        if not np.isfinite(syn).all():  # seismogram.f90:290-295's NaN/huge check
            LOG.warning("non-finite synthetic seismogram samples "
                        "(source outside the GF database's validity range?)")
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

    # -- read-back (minimizer_engine.f90:1150-1258) ---------------------------

    def get_misfits(self):
        """Per-(receiver, component) (misfit, norm) and the per-receiver
        floating shifts (samples) for the current source, host arrays."""
        m, n, fs = to_host(*self.misfits_for_source_batch(self.source_params[None, :]))
        m = m[0]
        if np.isnan(m).any():  # minimizer_engine.f90:1163-1166
            LOG.warning("NaN misfit(s) for rc rows %s", np.flatnonzero(np.isnan(m)))
        return m, n[0], fs[0]

    def get_global_misfit(self):
        m, n, _ = self.misfits_for_source_batch(self.source_params[None, :])
        return float(mf.global_misfit(m[0], n[0]))

    def get_distances(self):
        """(distances m, azimuths rad) of the receivers from the source origin."""
        geom = self._geometry()
        return np.asarray(geom.dist), np.asarray(geom.azi)

    def get_floating_shifts(self):
        """The current source's per-receiver floating shifts in seconds."""
        _m, _n, fs = self.misfits_for_source_batch(self.source_params[None, :])
        return to_host(fs)[0][0] * self.store.dt

    # -- parameter masks / subparameters (minimizer_engine.f90:525-610) -------

    def set_source_params_mask(self, mask):
        model = get_source_model(self.source_type)
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (model.nparams,):
            raise ValueError("wrong number of elements in mask")
        self.params_mask = mask
        self.subparam_mins = None
        self.subparam_maxs = None

    def set_source_subparams(self, subparams, normalized=False):
        if self.source_params is None:
            raise RuntimeError("source parameters must be set prior to subparams")
        mask = self.params_mask
        if mask is None:
            raise RuntimeError("no source params mask set")
        sub = np.asarray(subparams, dtype=np.float32)
        if sub.shape[0] != int(mask.sum()):
            raise ValueError("wrong number of subparams")
        model = get_source_model(self.source_type)
        p = self.source_params.copy()
        p[mask] = sub * model.norm[mask] if normalized else sub
        self.set_source_params(self.source_type, p)

    def get_source_subparams(self, normalized=False):
        mask = self.params_mask
        if mask is None:
            raise RuntimeError("no source params mask set")
        model = get_source_model(self.source_type)
        sub = self.source_params[mask]
        return sub / model.norm[mask] if normalized else sub

    def set_source_subparams_limits(self, mins, maxs):
        mask = self.params_mask
        n = int(mask.sum()) if mask is not None else 0
        mins = np.asarray(mins, np.float64)
        maxs = np.asarray(maxs, np.float64)
        if mins.shape[0] != n or maxs.shape[0] != n:
            raise ValueError("wrong number of subparam limits")
        self.subparam_mins = mins
        self.subparam_maxs = maxs

    def minimize_lm(self):
        """(info, nfev, misfit) -- minimizer_engine.f90:729-805."""
        from .invert import minimize_lm as _lm

        return _lm(self, mask=self.params_mask, subparam_mins=self.subparam_mins,
                   subparam_maxs=self.subparam_maxs)

    # -- gradients (kiwi_tpu/engine.py:1300-1607) -----------------------------

    def _grad_plan(self, model, pb):
        """The plan and grid shape of a device-discretized batch for the
        gradient entry points, planned as the batch entry points plan it;
        the JAX package's errors for the cases it cannot differentiate."""
        if not self._refs:
            raise RuntimeError("no reference seismograms set")
        if model.batch_discretizer is not None or model.post_factors_batch is None:
            raise NotImplementedError(
                f"autodiff gradients need a device discretizer and vectorized post "
                f"factors (source type {self.source_type!r})")
        stats = self._param_stats(model, pb)
        shape = self._batch_shape(model, pb)
        _m, risetimes = self._post_factors(model, pb)
        plan = self._ensure_plan(float(risetimes.max(initial=0.0)), shape, stats,
                                 gsize=int(shape[-1]))
        return plan, shape

    def _xla_misfits(self, model, plan, shape, leaf):
        """(misfits, norms) [B, RC] of the plain formulation for the
        parameter leaf f32[B, nparams]: discretized and post-factored on the
        leaf itself (the moment and the rise time included), so that the
        gradient reaches every parameter."""
        cbatch = model.discretize(leaf, self.effective_dt, shape)
        moments, risetimes = model.post_factors_batch(leaf)
        m, n, _fs = plan["forward_batch_xla"](cbatch, moments, risetimes)
        return m, n

    def _grad_chunk(self, plan, b):
        """Rows per backward pass: the backward roughly triples the
        forward's live transients (kiwi_tpu/engine.py:1393-1410); nothing
        compiles per chunk, so the last one is not padded."""
        return int(max(8, min(b, self.memory_budget // max(3 * plan["xla_source_bytes"], 1))))

    def global_misfits_and_grad(self, params_batch, mesh=None):
        """Global misfits g f32[B] and dg/dparams f32[B, nparams] (host
        arrays) for parameter rows [B, nparams], by reverse-mode autodiff
        through the plain formulation: the global misfit of each row is
        stable_l2(misfits) / stable_l2(norms), and one backward pass of
        their sum gives every row's gradient with respect to every
        parameter.  Exact almost everywhere: the fractional 2-tap shifts
        and the bilinear GF blend are piecewise linear in the parameters
        (the integer grid snaps are the kinks).  Device-discretized models
        only, as in the JAX package.

        mesh: a parallel.make_mesh mesh: the rows are split over its "s"
        axis and gathered, so that every rank returns all of them
        (parallel.sharding.sharded_grad)."""
        if mesh is not None:
            from .parallel.sharding import sharded_grad
            return sharded_grad(self, params_batch, mesh)
        return self._values_and_grads(params_batch)

    def _values_and_grads(self, rows, plan_rows=None):
        """global_misfits_and_grad of the rows on this engine's device, in
        the plan of plan_rows (the rows themselves by default)."""
        model = get_source_model(self.source_type)
        pb = np.atleast_2d(np.asarray(rows, dtype=np.float32))
        plan, shape = self._grad_plan(model, pb if plan_rows is None else plan_rows)
        b = pb.shape[0]
        chunk = self._grad_chunk(plan, b)
        gs, grads = [], []
        for i in range(0, b, chunk):
            leaf = to_device(pb[i:i + chunk], self.device).requires_grad_()
            m, n = self._xla_misfits(model, plan, shape, leaf)
            sn = mf.stable_l2(n)
            g = mf.stable_l2(m) / torch.where(sn == 0.0, 1.0, sn)
            (grad,) = torch.autograd.grad(g.sum(), leaf)
            gs.append(g.detach())
            grads.append(grad)
        return tuple(to_host(torch.cat(gs), torch.cat(grads)))

    def misfit_jacobian(self, params, mask=None):
        """(m f32[RC], J f32[RC, n_free]) at `params` (host arrays): the
        misfit rows minimize_lm minimizes and their Jacobian with respect
        to the free (masked) parameters.  Reverse mode over the RC rows:
        RC copies of the row go through the plain formulation as one batch,
        and one backward pass of the sum of copy k's row k gives row k of J
        (each copy's misfits depend on its own parameters only).  The JAX
        package takes one jvp per free parameter; the Jacobian is the same."""
        model = get_source_model(self.source_type)
        p = np.asarray(params, dtype=np.float32).reshape(-1)
        if mask is None:
            mask = np.ones(model.nparams, dtype=bool)
        idx = to_device(np.flatnonzero(np.asarray(mask, dtype=bool)), self.device)
        plan, shape = self._grad_plan(model, p[None, :])
        nrc = len(self._rc_layout())
        chunk = self._grad_chunk(plan, nrc)
        m0, rows = None, []
        for i in range(0, nrc, chunk):
            k = min(chunk, nrc - i)
            leaf = to_device(np.tile(p, (k, 1)), self.device).requires_grad_()
            m, _n = self._xla_misfits(model, plan, shape, leaf)  # [k, RC]
            own = m[:, i:i + k].diagonal()  # copy j's row i + j
            (grad,) = torch.autograd.grad(own.sum(), leaf)
            rows.append(grad[:, idx])
            if m0 is None:
                m0 = m[0].detach()
        return tuple(to_host(m0, torch.cat(rows)))

    def minimize_gradient(self, steps=150, lr=0.03, nstarts=1):
        """(misfit, steps, starts): multi-start projected Adam on the
        masked subparameters (invert.minimize_gradient), honouring the
        mask and limit setters as minimize_lm does."""
        from .invert import minimize_gradient as _mg

        return _mg(self, mask=self.params_mask, subparam_mins=self.subparam_mins,
                   subparam_maxs=self.subparam_maxs, steps=steps, lr=lr, nstarts=nstarts)

    def get_principal_axes(self):
        """(pax, tax) as (azimuth, colatitude) degrees for sdr-type sources
        (minimizer_engine.f90:1248-1258); zeros for the others."""
        from .euler import pt_axes, rotmats_from_sdr
        from .sources.base import DEG2RAD_F32

        names = get_source_model(self.source_type).names
        if "strike" not in names or "dip" not in names or "slip-rake" not in names:
            return np.zeros(2), np.zeros(2)
        p = self.source_params
        strike = float(p[names.index("strike")]) * float(DEG2RAD_F32)
        dip = float(p[names.index("dip")]) * float(DEG2RAD_F32)
        rake = float(p[names.index("slip-rake")]) * float(DEG2RAD_F32)
        _rr, rs = rotmats_from_sdr(strike, dip, rake, 0.0)
        return pt_axes(rs)

    # -- probe-processed traces (probe_get_*, comparator.f90:333-433) ---------
    # Each diagnostic computes on the engine's device and copies its rows to
    # the host once (to_host).

    def _probe_rows(self, which):
        """(plan, probe rows f32[RC, PL], data spans lo, hi int[RC]), all on
        the engine's device: the current source's synthetics (moment and
        rise time applied) placed on the probe, or the references as
        installed (not amplitude-normalized)."""
        plan, cbatch, moments, risetimes = self._current_tables()
        st, setup, dev = plan["st"], plan["setup"], self.device
        if which == "synthetics":
            cent = {k: v[0] for k, v in cbatch.items()}
            syn, lo, hi = plan["synth_one"](
                cent, float(np.float32(moments[0])),
                to_device(risetimes[0], dev, F32))
            return plan, mf.place_on_probe(syn, plan["cfg"].out_it0, st), lo, hi
        return (plan, to_device(setup.ref, dev), to_device(setup.ref_lo, dev),
                to_device(setup.ref_hi, dev))

    def get_processed_seismograms(self, which="synthetics", processing="plain"):
        """[(values, itmin)] rows for output_seismograms: plain, tapered or
        filtered processing like probe_get (comparator.f90:421-433)."""
        if which == "synthetics" and processing == "plain":
            return self.get_synthetic_seismograms()
        plan, arr, lo, hi = self._probe_rows(which)
        st, setup = plan["st"], plan["setup"]
        tap, filt = mf.processed_arrays(plan["ctx"], arr, st)
        arr, tap, filt, lo, hi = to_host(arr, tap, filt, lo, hi)
        out = []
        for irc in range(setup.nrc):
            if processing == "plain":
                row, a, b = arr[irc], lo[irc], hi[irc]
            elif processing == "tapered":
                if setup.has_taper[irc]:
                    # span = taper span ^ data span, falling back to the data
                    # span when empty (probe_get_tapered, comparator.f90:380-391)
                    row = tap[irc]
                    a = max(setup.taper_lo[irc], int(lo[irc]))
                    b = min(setup.taper_hi[irc], int(hi[irc]))
                    if a > b:
                        a, b = int(lo[irc]), int(hi[irc])
                else:
                    row, a, b = arr[irc], lo[irc], hi[irc]
            elif processing == "filtered":
                if setup.has_filter[irc]:
                    row = filt[irc]
                    a = setup.taper_lo[irc] if setup.has_taper[irc] else lo[irc]
                    b = setup.taper_hi[irc] if setup.has_taper[irc] else hi[irc]
                else:
                    row, a, b = (tap[irc], setup.taper_lo[irc], setup.taper_hi[irc]) \
                        if setup.has_taper[irc] else (arr[irc], lo[irc], hi[irc])
            else:
                raise ValueError(f"unknown processing {processing!r}")
            a = int(np.clip(a, st.ps0, st.ps0 + st.pl - 1))
            b = int(np.clip(b, a, st.ps0 + st.pl - 1))
            out.append((row[a - st.ps0 : b - st.ps0 + 1].copy(), a))
        return out

    def get_amp_spectra(self, which="synthetics", processing="filtered"):
        """[(amplitudes, df)] rows on the probe grid
        (probe_get_amp_spectrum, comparator.f90:333-354)."""
        plan, arr, _lo, _hi = self._probe_rows(which)
        st, setup, ctx = plan["st"], plan["setup"], plan["ctx"]
        tapered, _ = mf.processed_arrays(ctx, arr, st, use_fft=False)
        amp, ampf = to_host(*mf.amp_spectra(ctx, tapered))
        return [((ampf[irc] if processing == "filtered" and setup.has_filter[irc]
                  else amp[irc]).copy(), st.df) for irc in range(setup.nrc)]

    def get_cross_correlations(self, shiftrange_s):
        """f32[S, RC] windowed cross correlations and the shifts in samples
        (output_cross_correlations, minimizer_engine.f90:1283-1307)."""
        plan, arr, _lo, _hi = self._probe_rows("synthetics")
        dt = np.float32(self.store.dt)
        s1 = int(fnint(np.float32(shiftrange_s[0]) / dt))
        s2 = int(fnint(np.float32(shiftrange_s[1]) / dt))
        cc = mf.cross_correlation(plan["ctx"], arr, (s1, s2), plan["st"])
        return to_host(cc)[0], np.arange(s1, s2 + 1)

    def autoshift_ref_seismograms(self, shiftrange_s, ireceiver=None):
        """Shift the references to the cross-correlation power maximum
        (receiver_autoshift_ref_seismogram, receiver.f90:816-832); the
        shifts in seconds of the receivers shifted."""
        cc, shifts = self.get_cross_correlations(shiftrange_s)
        layout = self._rc_layout()
        out = []
        for irec in range(len(self.receivers)):
            rows = [i for i, (r, _c) in enumerate(layout) if r == irec]
            sub = cc[:, rows]  # [S, ncomp]
            denom = max(1.0, float(sub.max()))
            power = (np.maximum(sub / denom, 0.0) ** 2).sum(axis=1)
            ishift = int(shifts[int(np.argmax(power))])
            if ireceiver is None or ireceiver == irec:
                self.shift_ref_seismogram(irec, ishift)
                out.append(ishift * self.store.dt)
        return np.array(out)

    def shift_ref_seismogram(self, irec, ishift):
        """Move receiver irec's references by ishift samples."""
        for irc, (r, _c) in enumerate(self._rc_layout()):
            if r == irec and irc in self._refs:
                values, itmin = self._refs[irc]
                self._refs[irc] = (values, itmin + int(ishift))
        self._invalidate()

    def get_peak_amplitudes(self, differentiate):
        """Per enabled receiver the max |d^k u/dt^k| vector norm over its
        grouped components (get_peak_amplitudes,
        minimizer_engine.f90:1174-1212)."""
        return self._vec_diagnostic(differentiate=differentiate)

    def get_arias_intensities(self):
        """Per enabled receiver (minimizer_engine.f90:1214-1246)."""
        return self._vec_diagnostic(arias=True)

    def _vec_diagnostic(self, differentiate=None, arias=False):
        """Peak amplitudes or Arias intensities of the current synthetics.
        Each receiver groups a vertical and two horizontal rows
        (get_component_ids, receiver.f90:512-542); each row is the filtered,
        else tapered, else plain probe row over the taper span, else its
        data span, from that span's own first sample, and the group is cut
        to its shortest row.  Computed on the device in float64; 0 for a
        receiver with no such row."""
        plan, arr, lo, hi = self._probe_rows("synthetics")
        st, setup, dev = plan["st"], plan["setup"], self.device
        tap, filt = mf.processed_arrays(plan["ctx"], arr, st)
        has_t = to_device(setup.has_taper, dev)
        rows = torch.where(to_device(setup.has_filter, dev)[:, None], filt,
                           torch.where(has_t[:, None], tap, arr))
        a = torch.where(has_t, to_device(setup.taper_lo, dev), lo) - st.ps0
        b = torch.where(has_t, to_device(setup.taper_hi, dev), hi) - st.ps0
        length = torch.clamp(torch.clamp(b + 1, max=st.pl) - a, min=0)  # row[a:b + 1]

        layout = self._rc_layout()
        groups, slots = [], []
        for irec, rec in enumerate(self.receivers):
            if not rec.enabled:
                continue
            rc = {c: i for i, (r, c) in enumerate(layout) if r == irec}
            ver = next((rc[c] for c in "du" if c in rc), None)
            h1 = next((rc[c] for c in "ac" if c in rc), None)
            h2 = next((rc[c] for c in "rl" if c in rc), None)
            if h1 is None or h2 is None:
                h1 = next((rc[c] for c in "ns" if c in rc), None)
                h2 = next((rc[c] for c in "ew" if c in rc), None)
            if h1 is None or h2 is None:
                h1 = h2 = None
            used = [i for i in (ver, h1, h2) if i is not None]
            slots.append(len(groups) if used else None)
            if used:
                groups.append(used + [-1] * (3 - len(used)))
        values = np.zeros(0)
        if groups:
            idx = to_device(groups, dev)  # [NG, 3], -1 = no row
            live = idx >= 0
            idx_c = torch.clamp(idx, min=0)
            n = torch.where(live, length[idx_c], st.pl).amin(dim=1)  # [NG]
            k = torch.arange(st.pl, device=dev)
            src = torch.clamp(a[idx_c][..., None] + k, 0, st.pl - 1)  # [NG, 3, PL]
            vals = torch.gather(rows[idx_c], -1, src)
            vals = torch.where(live[..., None] & (k < n[:, None, None]), vals, 0.0)
            order = 1 if differentiate == 1 and not arias else 2
            mask = (k < (n - order)[:, None]).to(torch.float64)
            if arias:
                res = mf.arias_intensity(vals, mask, st)
            else:
                res = mf.peak_amplitude(vals, mask, differentiate, st)
            values = to_host(res)[0]
        return np.array([0.0 if s is None else float(values[s]) for s in slots])

