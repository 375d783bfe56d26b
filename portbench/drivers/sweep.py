"""Strike sweeps of a point source: Engine.sweep_global_misfits.

An SDR grid search by strike sweeps: every call sweeps `strikes.count`
strikes from a seeded origin in steps of `strikes.step` degrees around a
fresh (dip, slip-rake, depth) node drawn uniformly from the mix's ranges,
so no call repeats an earlier call's base row and the engine's
repeat-sweep memo serves none of them.  The call's global misfits reach
the host before the next call."""

from __future__ import annotations

import time

import numpy as np

from portbench.session import Driver as Base

COLUMN = {"dip": 6, "slip-rake": 7, "depth": 3}
STRIKE = 5


class Driver(Base):
    def __init__(self, cfg, mix, store, seed, device):
        super().__init__(cfg, mix, store, seed, device)
        self.count = int(mix["strikes"]["count"])
        self.step = float(mix["strikes"]["step"])

    def _node(self):
        base = self.truth.copy()
        for name, (lo, hi) in self.mix["node"].items():
            base[COLUMN[name]] = np.float32(self.rng.uniform(lo, hi))
        strikes = (self.rng.uniform(0.0, self.step) + self.step * np.arange(self.count))
        return base, strikes.astype(np.float32)

    def warm(self):
        base, strikes = self._node()
        self.engine.sweep_global_misfits(base, STRIKE, strikes).cpu()

    def call(self):
        base, strikes = self._node()
        t0 = time.perf_counter()
        g = self.engine.sweep_global_misfits(base, STRIKE, strikes).cpu().numpy()
        t = time.perf_counter() - t0
        rows = self.keep.choice(self.count, size=int(self.mix["sample"]["rows"]), replace=False)
        kept = []
        for i in sorted(set(rows.tolist()) | {int(np.argmin(g))}):
            row = base.copy()
            row[STRIKE] = strikes[i]
            kept.append((row, float(g[i])))
        self.kept.append(kept)
        return {"t": t, "units": self.count}
