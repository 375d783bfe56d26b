"""Inversion pipeline: composable steps with persisted run state.

Re-derivation of tunguska/inversion.py's Step framework: each step has a
work directory with numbered run dirs and a `current` symlink, persists its
inputs/outputs and intermediate grids (pickle), and chains its out-config
into the next step's in-config.  Concrete steps cover the reference's
standard point-source-to-finite-source workflow: receiver weighting
(WeightMaker / gen_dweights), time-shift alignment (Shifter), iterated
per-parameter grid searches (ParamTuner), and an enduring point-source
inversion (EnduringPointSource).

Port of kiwi_tpu/pipeline.py on the port's engine and invert package.
What a step persists (config-in, config-out, results, the tuners' grids)
is host numpy and Python values only, so a run reads back on a machine
with no card; Step.dump refuses a torch.Tensor.  Greeper skips a start
whose search fails, but never a failure of the card or of a kernel.
"""

from __future__ import annotations


import os
import pickle

import numpy as np
import torch

from .invert import MisfitGrid, Source
from .ops.build import KernelError

# failures of the card or of a kernel: a search that skips failing starts
# lets these through (a build, launch or device error is not a bad start)
CARD_ERRORS = tuple(c for c in (
    KernelError,
    getattr(torch.cuda, "CudaError", None),
    getattr(torch.cuda, "OutOfMemoryError", None),
    getattr(torch, "AcceleratorError", None),
) if c is not None)


def is_card_failure(exc):
    """True for a kernel error or an error of the CUDA runtime (torch raises
    some of those as a plain RuntimeError naming CUDA or cuBLAS)."""
    if isinstance(exc, CARD_ERRORS):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and ("CUDA error" in msg or "CUBLAS_STATUS" in msg)


def host_only(obj, _seen=None):
    """Raise TypeError if a torch.Tensor is reachable from obj (through
    dicts, sequences and object attributes): what a step persists must load
    on a machine with no card."""
    if isinstance(obj, torch.Tensor):
        raise TypeError("a torch.Tensor cannot go into a step's persisted state; "
                        "copy it to the host (numpy) first")
    if isinstance(obj, (str, bytes, int, float, bool, type(None), np.ndarray, np.generic)):
        return
    seen = set() if _seen is None else _seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    else:
        items = list(getattr(obj, "__dict__", {}).values())
    for x in items:
        host_only(x, seen)


def gen_dweights(engine, base_source: Source, outer_norm="l2norm"):
    """Per-receiver weights from the mean misfits of a strike/dip/rake grid
    against a moment-zero synthetic reference (gen_dweights,
    inversion.py:195-226): receivers that misfit badly on average get
    downweighted by 1/mean.

    Leaves the engine's reference seismograms replaced by the zero-moment
    synthetic; caller restores references afterwards.
    """
    src = base_source.copy()
    # the reference synthesizes with moment = 0 and sets that as reference
    # (i.e. zero reference traces); install zero references directly
    for irc, _ in enumerate(engine._rc_layout()):
        engine._refs[irc] = (np.zeros(1, np.float32), 0)
    engine._invalidate()
    grid = MisfitGrid(
        src,
        [
            ("strike", np.arange(-180.0, 150.0 + 1, 30.0)),
            ("dip", np.arange(0.0, 90.0 + 1, 30.0)),
            ("slip-rake", np.arange(-180.0, 150.0 + 1, 30.0)),
        ],
    )
    grid.compute(engine)
    # mean misfit per receiver over all sources
    m = grid.misfits_by_src  # [S, R, C]
    means = np.sqrt((m**2).sum(axis=2)).mean(axis=0)  # [R]
    live = means > 0.0
    if live.any():
        means = means / means[live].mean()
    dweights = np.where(means > 0.0, 1.0 / np.where(means > 0, means, 1.0), 0.0)
    return dweights


class Step:
    """A pipeline step with persisted run directories
    (inversion.py:228-557)."""

    def __init__(self, workdir, name):
        self.workdir = workdir
        self.name = name
        self.stepdir = os.path.join(workdir, name)
        self.in_config = {}
        self.out_config = {}
        self.results = {}

    # -- run-dir management (next_available_rundir, inversion.py:244-260) ----

    def make_rundir(self):
        os.makedirs(self.stepdir, exist_ok=True)
        entries = [e for e in os.listdir(self.stepdir) if e.isdigit()]
        irun = max((int(e) for e in entries), default=0) + 1
        rundir = os.path.join(self.stepdir, f"{irun:03d}")
        os.makedirs(rundir)
        current = os.path.join(self.stepdir, "current")
        if os.path.islink(current):
            os.unlink(current)
        os.symlink(f"{irun:03d}", current)
        return rundir

    def rundir(self, run_id="current"):
        return os.path.join(self.stepdir, run_id)

    def dump(self, obj, ident, run_id="current"):
        host_only(obj)
        with open(os.path.join(self.rundir(run_id), ident + ".pickle"), "wb") as f:
            pickle.dump(obj, f)

    def load(self, ident, run_id="current"):
        with open(os.path.join(self.rundir(run_id), ident + ".pickle"), "rb") as f:
            return pickle.load(f)

    def result(self, value, ident):
        self.results[ident] = value

    def pre_work(self):
        self._rundir = self.make_rundir()
        self.dump(self.in_config, "config-in")

    def post_work(self):
        self.dump(self.out_config, "config-out")
        self.dump(self.results, "results")

    def chain(self, previous: "Step"):
        self.in_config = dict(previous.in_config)
        self.in_config.update(previous.out_config)
        return self

    def work(self, engine):
        raise NotImplementedError


class Informer(Step):
    """Log the receiver/station setup (inversion.py's Informer)."""

    def work(self, engine):
        self.pre_work()
        dists, azis = engine.get_distances()
        lines = []
        for i, (r, d, a) in enumerate(zip(engine.receivers, dists, azis)):
            lines.append(
                f"{i + 1:3d} {r.name or '-':8s} dist {d / 1e3:9.1f} km  "
                f"azi {np.degrees(a):6.1f}  comps {r.components}  "
                f"{'on' if r.enabled else 'off'}"
            )
        self.result("\n".join(lines), "receivers")
        self.out_config["nreceivers"] = len(engine.receivers)
        self.post_work()
        return lines


class WeightMaker(Step):
    """Receiver weights from an SDR sweep (inversion.py's WeightMaker)."""

    def __init__(self, workdir, name="weightmaker"):
        super().__init__(workdir, name)

    def work(self, engine, base_source: Source):
        self.pre_work()
        refs_backup = dict(engine._refs)
        weights = gen_dweights(engine, base_source)
        engine._refs = refs_backup
        engine._invalidate()
        self.out_config["receiver_weights"] = weights
        self.result(" ".join(f"{w:.4g}" for w in weights), "receiver_weights")
        self.post_work()
        return weights


class Shifter(Step):
    """Time-shift alignment of references by cross correlation
    (inversion.py's Shifter)."""

    def __init__(self, workdir, name="shifter", shiftrange=(-10.0, 10.0)):
        super().__init__(workdir, name)
        self.shiftrange = shiftrange

    def work(self, engine):
        self.pre_work()
        shifts = engine.autoshift_ref_seismograms(self.shiftrange)
        self.out_config["ref_shifts"] = shifts
        self.result(" ".join(f"{s:.3g}" for s in shifts), "shifts")
        self.post_work()
        return shifts


class ParamTuner(Step):
    """Iterated per-parameter grid search (inversion.py:866-969): search the
    given parameters jointly on their ranges, fix the best values, report
    bootstrap confidence intervals."""

    def __init__(self, workdir, params_ranges, name=None, outer_norm="l2norm",
                 receiver_weights=1.0, bootstrap_iterations=250):
        """params_ranges: [(param_name, values array)]."""
        name = name or "-".join(n for n, _ in params_ranges) + "-tuner"
        super().__init__(workdir, name)
        self.params_ranges = params_ranges
        self.outer_norm = outer_norm
        self.receiver_weights = receiver_weights
        self.bootstrap_iterations = bootstrap_iterations

    def work(self, engine, base_source: Source):
        self.pre_work()
        grid = MisfitGrid(base_source, self.params_ranges)
        grid.compute(engine)
        best, g, stats = grid.postprocess(
            bootstrap_iterations=self.bootstrap_iterations,
            outer_norm=self.outer_norm,
            receiver_weights=self.receiver_weights,
        )
        self.dump(
            {
                "params": grid.params,
                "misfits_by_src": grid.misfits_by_src,
                "norms_by_src": grid.norms_by_src,
            },
            self.name,
        )
        for pname, _vals in self.params_ranges:
            st = stats[pname]
            base_source[pname] = st.best
            self.result(str(st), pname)
            self.out_config[pname] = st.best
            self.out_config[pname + "_stats"] = st
        self.out_config["min_misfit"] = float(np.nanmin(g))
        self.post_work()
        return best, stats


class ExtConfigurator(Step):
    """Derive the finite-extension (eikonal) search configuration from the
    point-source results (inversion.py:823-864): retune the band-pass
    filter to the found rise time, generate bord_radius / nukl_shift
    search ranges scaled by size_factor * rise_time, and bound the
    constraining planes by twice the found depth."""

    def __init__(self, workdir, name="extconfigurator",
                 generate=("filter", "constraining_planes",
                           "bord_radius_range", "nukl_shift_x_range",
                           "nukl_shift_y_range"),
                 frequency_factor=2.0, size_factor=4000.0, steps=5.0):
        super().__init__(workdir, name)
        self.generate = set(generate)
        self.frequency_factor = frequency_factor
        self.size_factor = size_factor
        self.steps = steps

    def work(self, engine=None):
        self.pre_work()
        ic = self.in_config
        oc = self.out_config
        rise_time = float(ic["rise_time"])
        depth = float(ic["depth"])

        if "filter" in self.generate and "filter" in ic:
            # move the filter's upper corner to frequency_factor / rise
            # time (inversion.py:843-847); the filter is a 4-point PLF
            filt = ic["filter"]
            if hasattr(filt, "x"):
                x = np.asarray(filt.x, np.float64).copy()
                x[2] = self.frequency_factor / rise_time
                x[3] = self.frequency_factor * 1.5 / rise_time
                oc["filter"] = type(filt)(x, np.asarray(filt.y))
            else:
                x, y = (np.asarray(filt[0], np.float64).copy(),
                        np.asarray(filt[1], np.float64))
                x[2] = self.frequency_factor / rise_time
                x[3] = self.frequency_factor * 1.5 / rise_time
                oc["filter"] = (x, y)

        maxradius = self.size_factor * rise_time
        step = maxradius / self.steps
        if "bord_radius_range" in self.generate:
            oc["bord_radius_range"] = (0.0, maxradius, step)
        if "nukl_shift_x_range" in self.generate:
            oc["nukl_shift_x_range"] = (-maxradius, maxradius, step)
        if "nukl_shift_y_range" in self.generate:
            oc["nukl_shift_y_range"] = (-maxradius, maxradius, step)
        if "constraining_planes" in self.generate and "constraining_planes" in ic:
            cp = ic["constraining_planes"]
            oc["constraining_planes"] = [
                ((0.0, 0.0, cp[0][0][2]), (0.0, 0.0, -1.0)),
                ((0.0, 0.0, min(depth * 2.0, cp[1][0][2])), (0.0, 0.0, 1.0)),
            ]
        for k, v in oc.items():
            self.result(v, k)
        self.post_work()
        return dict(oc)


class EnduringPointSource(Step):
    """Point-source (moment tensor) inversion sweep: sdr + moment tuning,
    the reference's EnduringPointSource in miniature."""

    def __init__(self, workdir, name="extension", outer_norm="l2norm"):
        super().__init__(workdir, name)
        self.outer_norm = outer_norm

    def work(self, engine, base_source: Source):
        self.pre_work()
        stages = [
            [("strike", np.arange(-180.0, 180.0, 15.0)),
             ("dip", np.arange(0.0, 91.0, 15.0))],
            [("slip-rake", np.arange(-180.0, 180.0, 15.0))],
            [("moment", base_source["moment"] * np.logspace(-0.5, 0.5, 11))],
            [("depth", base_source["depth"] * np.linspace(0.5, 1.5, 11))],
        ]
        src = base_source.copy()
        for ranges in stages:
            grid = MisfitGrid(src, ranges)
            grid.compute(engine)
            best, g, stats = grid.postprocess(
                bootstrap_iterations=100, outer_norm=self.outer_norm
            )
            for pname, _ in ranges:
                src[pname] = stats[pname].best
                self.out_config[pname] = stats[pname].best
        self.out_config["min_misfit"] = float(np.nanmin(g))
        self.post_work()
        return src


class EffectiveDtTester(Step):
    """Find the coarsest source-discretization dt that keeps misfits within
    tolerance of a converged fine discretization (inversion.py:674-...)."""

    def __init__(self, workdir, name="effective_dt_tester", dts=None, tolerance=0.02):
        super().__init__(workdir, name)
        self.dts = dts
        self.tolerance = tolerance

    def work(self, engine, base_source: Source):
        self.pre_work()
        store_dt = engine.store.dt
        dts = self.dts or [store_dt * f for f in (8.0, 4.0, 2.0, 1.0, 0.5)]
        dts = sorted(dts)
        old_dt = engine.effective_dt
        engine.set_source_params(base_source.sourcetype, base_source.params)

        # converged misfit at the finest dt
        engine.set_effective_dt(dts[0])
        m_fine = engine.get_global_misfit()
        chosen = dts[0]
        curve = {}
        for dt in dts:
            engine.set_effective_dt(dt)
            m = engine.get_global_misfit()
            curve[dt] = m
            if abs(m - m_fine) <= self.tolerance * max(m_fine, 1e-30):
                chosen = dt
        engine.set_effective_dt(old_dt)
        self.out_config["effective_dt"] = chosen
        self.result(
            "\n".join(f"dt={dt:g}: misfit={m:g}" for dt, m in curve.items()),
            "effective_dt_curve",
        )
        self.post_work()
        return chosen, curve


class Greeper(Step):
    """Grid of gradient searches (inversion.py:1135+): run LM refinement from
    a coarse grid of starting points and keep the overall best."""

    def __init__(self, workdir, params_starts, name=None):
        """params_starts: [(param_name, starting values array)]."""
        name = name or "-".join(n for n, _v in params_starts) + "-greeper"
        super().__init__(workdir, name)
        self.params_starts = params_starts

    def work(self, engine, base_source: Source):
        self.pre_work()
        from .invert.source import source_grid

        model = base_source.model
        mask = np.zeros(model.nparams, dtype=bool)
        for pname, _v in self.params_starts:
            mask[model.param_index(pname)] = True

        starts, _coords = source_grid(base_source, self.params_starts)
        best = (np.inf, None, None)
        for p0 in starts:
            engine.set_source_params(base_source.sourcetype, p0)
            engine.set_source_params_mask(mask)
            try:
                info, nfev, gm = engine.minimize_lm()
            except Exception as e:
                if is_card_failure(e):
                    raise
                continue
            if gm < best[0]:
                best = (gm, engine.source_params.copy(), (info, nfev))
        if best[1] is None:
            raise RuntimeError("all gradient searches failed")
        engine.set_source_params(base_source.sourcetype, best[1])
        src = base_source.copy()
        src.params = best[1].copy()
        for pname, _v in self.params_starts:
            self.out_config[pname] = src[pname]
        self.out_config["min_misfit"] = best[0]
        self.result(f"misfit {best[0]:g} after {len(starts)} starts", "greeper")
        self.post_work()
        return src, best[0]


class GradientGreeper(Step):
    """Greeper's batched autodiff sibling (no reference counterpart): ALL
    starting points descend together by exact gradients
    (invert.minimize_multistart -- one device program per step instead of
    a serial LM per start), then the winner is LM-polished on the same
    mask.  Same configuration surface as Greeper."""

    def __init__(self, workdir, params_starts, steps=150, lr=0.03,
                 polish=True, name=None):
        name = name or "-".join(n for n, _v in params_starts) + "-gradgreeper"
        super().__init__(workdir, name)
        self.params_starts = params_starts
        self.steps = steps
        self.lr = lr
        self.polish = polish

    def work(self, engine, base_source: Source):
        self.pre_work()
        from .invert.gradient import minimize_multistart
        from .invert.source import source_grid

        model = base_source.model
        mask = np.zeros(model.nparams, dtype=bool)
        for pname, _v in self.params_starts:
            mask[model.param_index(pname)] = True

        starts, _coords = source_grid(base_source, self.params_starts)
        rows, gs, _n = minimize_multistart(
            engine, np.asarray(starts, dtype=np.float32), mask=mask,
            steps=self.steps, lr=self.lr,
        )
        k = int(np.argmin(gs))
        engine.set_source_params(base_source.sourcetype, rows[k])
        gm = float(gs[k])
        if self.polish:
            engine.set_source_params_mask(mask)
            _info, _nfev, gm = engine.minimize_lm()
        src = base_source.copy()
        src.params = engine.source_params.copy()
        for pname, _v in self.params_starts:
            self.out_config[pname] = src[pname]
        self.out_config["min_misfit"] = gm
        self.result(
            f"misfit {gm:g} after {len(starts)} batched starts", "gradgreeper")
        self.post_work()
        return src, gm


class TracePlotter(Step):
    """Waveform comparison + station map figures (inversion.py's
    TracePlotter, via matplotlib instead of GMT)."""

    def __init__(self, workdir, name="traceplotter", processing="plain"):
        super().__init__(workdir, name)
        self.processing = processing

    def work(self, engine):
        self.pre_work()
        from . import plotting

        outdir = self._rundir
        figs = [
            plotting.plot_seismogram_comparison(
                engine, os.path.join(outdir, "seismograms.png"), self.processing
            ),
            plotting.plot_station_map(engine, os.path.join(outdir, "stations.png")),
            plotting.plot_beachball(
                plotting.source_m6(engine),
                os.path.join(outdir, "beachball.png"),
                title=f"{engine.source_type} mechanism",
            ),
            plotting.plot_misfogram(engine, os.path.join(outdir, "misfogram.png")),
            plotting.plot_spectra_comparison(
                engine, os.path.join(outdir, "spectra.png")
            ),
        ]
        report = plotting.html_report(
            os.path.join(outdir, "report.html"), "kiwi-tpu run",
            [("Waveforms", "", [figs[0]]),
             ("Stations", "", [figs[1]]),
             ("Mechanism", "", [figs[2]]),
             ("Misfogram", "", [figs[3]]),
             ("Spectra", "", [figs[4]])],
        )
        self.result(report, "report")
        self.post_work()
        return figs + [report]

    def skip(self, reason):
        """Record the step as skipped (its run dir, config and results with
        the reason) without drawing: for a host without matplotlib."""
        self.pre_work()
        self.result(reason, "skipped")
        self.post_work()
