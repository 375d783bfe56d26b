"""Travel-time phases, timings and distance-dependent tapers.

Re-derivation of tunguska/phase.py: phase travel-time tables from the
bundled aux data (kiwi_tpu_torch/data/phases, a byte-identical copy of
kiwi_tpu/data/phases: P, S, Pn, Sn, PP, SS, LR, LQ, pP_, sP_, begin, end),
distance(+depth) interpolation, "Timing" fallback chains ("S or Sn minus
10 s"), and 4-point tapers expanding to the per-receiver misfit taper
control points the engine consumes (port of kiwi_tpu/phases.py; numpy on
the host).
"""

from __future__ import annotations

import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "phases")


class Phase:
    """Travel-time lookup t(distance[, depth]) from a table file."""

    def __init__(self, name, filename=None):
        self.name = name
        if filename is None:
            filename = name + ".phase" if os.path.isfile(name + ".phase") else os.path.join(
                DATA_DIR, name
            )
        self.filename = filename

        distances, depths, times = [], [], []
        seen = set()
        have_depth = False
        with open(filename) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                dist = float(toks[0])
                if len(toks) == 3:
                    depth = float(toks[1])
                    have_depth = True
                else:
                    depth = 10000.0
                if (dist, depth) not in seen:
                    distances.append(dist)
                    depths.append(depth)
                    times.append(float(toks[-1]))
                    seen.add((dist, depth))

        self.have_depth = have_depth
        if have_depth:
            by_dist = {}
            for di, de, ti in zip(distances, depths, times):
                by_dist.setdefault(di, ([], []))
                by_dist[di][0].append(de)
                by_dist[di][1].append(ti)
            self._dists = np.array(sorted(by_dist))
            self._depth_tables = [
                (np.array(by_dist[d][0]), np.array(by_dist[d][1])) for d in self._dists
            ]
        else:
            self._dists = np.array(distances)
            self._times = np.array(times)

    @staticmethod
    def _interp(x, xs, ys):
        """Linear interpolation; None outside the table (phase.py:24-33)."""
        if x < xs[0] or x > xs[-1]:
            return None
        return float(np.interp(x, xs, ys))

    def __call__(self, distance, depth=10000.0):
        if not self.have_depth:
            return self._interp(float(distance), self._dists, self._times)
        x = float(distance)
        xs = self._dists
        if x < xs[0] or x > xs[-1]:
            return None
        i = int(np.searchsorted(xs, x))
        i = min(max(i, 1), len(xs) - 1)
        frac = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
        y0 = self._interp(float(depth), *self._depth_tables[i - 1])
        y1 = self._interp(float(depth), *self._depth_tables[i])
        if y0 is None or y1 is None:
            return None
        return y0 + frac * (y1 - y0)

    def __repr__(self):
        return f"Phase(name={self.name!r})"


class Timing:
    """First-available phase of a fallback chain plus an offset
    ('S or Sn, whatever is available, minus 10 s')."""

    def __init__(self, phases, offset=0.0):
        if isinstance(phases, str):
            phases = [phases]
        self.phases = [p if isinstance(p, Phase) else Phase(p) for p in phases]
        self.offset = float(offset)

    def __call__(self, distance, depth=10000.0):
        for phase in self.phases:
            t = phase(distance, depth)
            if t is not None:
                return t + self.offset
        return None


class Taper:
    """4-point misfit taper positioned by phase arrivals (phase.py:137-163)."""

    def __init__(self, timings=None, phases=None, offsets=None, amplitude=1.0,
                 amplitudes=None):
        if phases and offsets:
            timings = [Timing(phases, offset) for offset in offsets]
        if timings is None or len(timings) != 4:
            raise ValueError("Taper needs exactly 4 timings")
        self.timings = list(timings)
        if amplitudes is not None:
            if len(amplitudes) != 4:
                raise ValueError("need 4 amplitudes")
            self.amplitudes = list(amplitudes)
        else:
            self.amplitudes = [0.0, amplitude, amplitude, 0.0]

    def __call__(self, distance, depth=10000.0):
        """(x1, y1, x2, y2, x3, y3, x4, y4) control points, or None when a
        timing is unavailable at this distance."""
        xs = [t(distance, depth) for t in self.timings]
        if any(x is None for x in xs):
            return None
        out = []
        for x, y in zip(xs, self.amplitudes):
            out += [x, y]
        return tuple(out)


def apply_taper_to_engine(engine, taper: Taper, disable_unavailable=True):
    """Set per-receiver tapers from phase arrivals, disabling receivers
    outside the tables (Seismosizer.set_taper, seismosizer.py:460-482)."""
    dists, _azis = engine.get_distances()
    depth = 10000.0
    if engine.source_params is not None:
        from .sources import get_source_model

        model = get_source_model(engine.source_type)
        if "depth" in model.names:
            depth = float(engine.source_params[model.param_index("depth")])
    for irec, dist in enumerate(dists):
        points = taper(float(dist), depth)
        if points is None:
            if disable_unavailable:
                engine.switch_receiver(irec, False)
            continue
        engine.set_misfit_taper(irec, points[0::2], points[1::2])
