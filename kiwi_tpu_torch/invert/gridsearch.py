"""Grid search with bootstrap statistics (port of
kiwi_tpu/invert/gridsearch.py).

Counterpart of tunguska/gridsearch.py (MisfitGrid) + the outer-norm
aggregation of tunguska/seismosizer.py:843-922 (make_global_misfits):
compute per-(source, receiver, component) misfits with the batched engine,
combine across components and receivers with l1/l2 outer norms, optional
"anarchy" (per-receiver norm equalization) and receiver weights, pick the
best source, and re-pick under bootstrap-resampled receiver weights to get
parameter confidence distributions.

The inner misfit sweep runs on the engine's device in shape buckets, and
its results reach the host in one copy at the end; the bootstrap
re-aggregation is pure (cheap) float64 numpy over the stored misfit arrays,
exactly like the reference (gridsearch.py:274-291 re-picks without
re-synthesis).
"""

from __future__ import annotations

import numpy as np
import torch

from ..profiling import span, to_host
from .source import Source


def make_global_misfits(misfits_by_src, norms_by_src, receiver_weights=1.0,
                        outer_norm="l2norm", anarchy=False, bweights=None):
    """(misfits_by_s [S], misfits_by_sr [S, R]) from [S, R, C] tensors.

    Port of seismosizer.py:843-922; bweights are bootstrap resampling
    counts (applied as weights; sqrt for the l2 outer norm).
    """
    m = np.asarray(misfits_by_src, dtype=np.float64)
    n = np.asarray(norms_by_src, dtype=np.float64)
    rweights = (
        np.asarray(receiver_weights, dtype=np.float64)[None, :]
        if not np.isscalar(receiver_weights)
        else float(receiver_weights)
    )

    if outer_norm == "l1norm":
        ms_r = m.sum(axis=2)
        ns_r = n.sum(axis=2)
        if anarchy:
            x = np.zeros_like(ns_r)
            x[:, :] = rweights
            x /= np.where(ns_r != 0.0, ns_r, -1.0)
            rweights = np.maximum(x, 0.0)
        if bweights is not None:
            rweights = rweights * bweights
        ms_r = ms_r * rweights
        ns_r = ns_r * rweights
        ms = ms_r.sum(axis=1)
        ns = ns_r.sum(axis=1)
        g = np.where(ns > 0.0, ms / np.where(ns > 0, ns, 1.0), np.nan)
    elif outer_norm == "l2norm":
        ms_r = np.sqrt((m**2).sum(axis=2))
        ns_r = np.sqrt((n**2).sum(axis=2))
        if anarchy:
            x = rweights / np.where(ns_r != 0.0, ns_r, -1.0)
            rweights = np.maximum(x, 0.0)
        if bweights is not None:
            rweights = rweights * np.sqrt(bweights)
        ms_r = ms_r * rweights
        ns_r = ns_r * rweights
        ms = (ms_r**2).sum(axis=1)
        ns = (ns_r**2).sum(axis=1)
        g = np.where(ns > 0.0, np.sqrt(ms / np.where(ns > 0, ns, 1.0)), np.nan)
    else:
        raise ValueError(f"unknown outer norm {outer_norm!r}")
    return g, ms_r


def step_at(values, x):
    """Local grid spacing at x (gridsearch.py's step_at helper)."""
    values = np.sort(np.asarray(values, dtype=np.float64))
    if values.size < 2:
        return 0.0
    i = int(np.clip(np.searchsorted(values, x), 1, values.size - 1))
    return float(values[i] - values[i - 1])


class MisfitGridStats:
    """Best value + bootstrap distribution statistics for one parameter
    (gridsearch.py:45-108)."""

    def __init__(self, paramname, best, distribution, tested_values=None):
        self.paramname = paramname
        self.best = float(best)
        self.distribution = np.asarray(distribution, dtype=np.float64)
        self.tested_values = tested_values
        self.mean = float(self.distribution.mean())
        self.std = float(self.distribution.std())
        self.median = float(np.median(self.distribution))
        self.percentile16 = float(np.percentile(self.distribution, 16.0))
        self.percentile84 = float(np.percentile(self.distribution, 84.0))
        if tested_values is not None:
            self.percentile16 -= step_at(tested_values, self.percentile16) / 2.0
            self.percentile84 += step_at(tested_values, self.percentile84) / 2.0
            self.percentile16_warn = self.percentile16 < float(np.min(tested_values))
            self.percentile84_warn = self.percentile84 > float(np.max(tested_values))
        else:
            self.percentile16_warn = False
            self.percentile84_warn = False

    def __str__(self):
        lw = " (?)" if self.percentile16_warn else ""
        uw = "(?) " if self.percentile84_warn else ""
        return (
            f"{self.paramname} = {self.best:.3g} (68% confidence interval "
            f"[{self.percentile16:.3g}{lw}, {self.percentile84:.3g} {uw}])"
        )

    def as_xml(self):
        """XML report fragment (gridsearch.py:84-98): best value + 68%
        confidence interval with out-of-grid warnings."""
        return (
            "<parameter>\n"
            f"    <name>{self.paramname.title()}</name>\n"
            f"    <value>{self.best:e}</value>\n"
            "    <confidenceinterval>\n"
            "        <interval>68</interval>\n"
            f"        <low>{self.percentile16:e}</low>\n"
            f"        <high>{self.percentile84:e}</high>\n"
            f"        <low_unclear>{int(self.percentile16_warn)}</low_unclear>\n"
            f"        <high_unclear>{int(self.percentile84_warn)}</high_unclear>\n"
            "    </confidenceinterval>\n"
            "</parameter>"
        )

    def converted(self, paramname, function):
        """Re-derive the stats under a unit conversion
        (gridsearch.py:100-108): apply `function` to the best value, the
        bootstrap distribution, and the tested values, then recompute."""
        tested = (None if self.tested_values is None
                  else function(np.asarray(self.tested_values)))
        return MisfitGridStats(paramname, function(self.best),
                               function(self.distribution),
                               tested_values=tested)


class MisfitGrid:
    """Brute-force grid search with builtin bootstrapping
    (gridsearch.py:111-302)."""

    def __init__(self, base_source: Source, param_ranges):
        """param_ranges: [(name, values array)]."""
        self.base_source = base_source
        self.param_ranges = [(n, np.asarray(v)) for n, v in param_ranges]
        from .source import source_grid

        self.params, self.coords = source_grid(base_source, self.param_ranges)
        self.misfits_by_src = None
        self.norms_by_src = None

    @property
    def nsources(self):
        return self.params.shape[0]

    def compute(self, engine, chunk=512):
        """Run all sources through the engine in shape buckets."""
        with span("kiwi.invert.grid"):
            return self._compute(engine, chunk)

    def _compute(self, engine, chunk):
        model = self.base_source.model
        edt = engine.effective_dt
        shapes = [model.grid_shape(p, edt) for p in self.params]
        layout = engine._rc_layout()
        nrec = len(engine.receivers)
        ncomp_max = max((sum(1 for r, _ in layout if r == i) for i in range(nrec)), default=0)
        s = self.nsources
        m_src = np.zeros((s, nrec, ncomp_max), dtype=np.float64)
        n_src = np.zeros_like(m_src)

        # rc -> (rec, comp slot)
        slots = []
        counters = {}
        for r, _c in layout:
            k = counters.get(r, 0)
            slots.append((r, k))
            counters[r] = k + 1

        engine.set_source_params(self.base_source.sourcetype, self.params[0])
        buckets = {}
        for i, sh in enumerate(shapes):
            buckets.setdefault(sh, []).append(i)

        # queue every chunk on the device and copy the results to the host
        # once at the end, so no chunk waits for a round trip of the last
        sels, ms, ns = [], [], []
        for sh, idxs in buckets.items():
            for start in range(0, len(idxs), chunk):
                sel = idxs[start : start + chunk]
                m, n, _fs = engine.misfits_for_source_batch(self.params[sel])
                sels.extend(sel)
                ms.append(m)
                ns.append(n)
        with span("kiwi.invert.to_host"):
            m, n = to_host(torch.cat(ms), torch.cat(ns))
        for irc, (r, k) in enumerate(slots):
            m_src[sels, r, k] = m[:, irc]
            n_src[sels, r, k] = n[:, irc]

        self.misfits_by_src = m_src
        self.norms_by_src = n_src
        return self

    def best_source(self, bootstrap_rng=None, **outer):
        m = self.misfits_by_src
        n = self.norms_by_src
        bweights = None
        if bootstrap_rng is not None:
            nrec = m.shape[1]
            counts = np.bincount(
                bootstrap_rng.integers(0, nrec, nrec), minlength=nrec
            ).astype(np.float64)
            bweights = counts
        g, g_sr = make_global_misfits(m, n, bweights=bweights, **outer)
        ibest = int(np.nanargmin(g))
        src = self.base_source.copy()
        src.params = self.params[ibest].copy()
        return src, g, ibest

    def postprocess(self, bootstrap_iterations=1000, seed=0, **outer):
        """(best_source, global_misfits [S], stats dict per searched param)."""
        if self.misfits_by_src is None:
            raise RuntimeError("call compute() first")
        best, g, _ = self.best_source(**outer)
        rng = np.random.default_rng(seed)
        boot_params = []
        for _ in range(bootstrap_iterations):
            bsrc, _g, _i = self.best_source(bootstrap_rng=rng, **outer)
            boot_params.append(bsrc.params)
        boot_params = np.array(boot_params)
        stats = {}
        model = self.base_source.model
        for name, values in self.param_ranges:
            i = model.param_index(name)
            stats[name] = MisfitGridStats(
                name, best.params[i], boot_params[:, i], tested_values=values
            )
        return best, g, stats
