"""Grid searches over a finite fault: invert.MisfitGrid.compute.

Every call builds the mix's grid (strike x dip x slip-rake, each a range
`[start, stop, step]`) around the seeded truth, its strikes moved by a
seeded offset in [0, strike_offset), and computes it through the engine in
the grid's default chunks; the misfits reach the host in one copy at the
end of the compute (the bootstrap stays outside the window)."""

from __future__ import annotations

import time

import numpy as np

from portbench.session import Driver as Base, global_from_parts


class Driver(Base):
    def __init__(self, cfg, mix, store, seed, device):
        from kiwi_tpu_torch.invert import Source

        super().__init__(cfg, mix, store, seed, device)
        self.source = Source(cfg["source_type"], self.truth)
        self.ranges = [(name, np.arange(*r, dtype=np.float64)) for name, r in mix["grid"].items()]
        self.first_rows = None

    def _grid(self):
        from kiwi_tpu_torch.invert import MisfitGrid

        off = self.rng.uniform(0.0, float(self.mix["strike_offset"]))
        ranges = [(n, v + off if n == "strike" else v) for n, v in self.ranges]
        return MisfitGrid(self.source, ranges)

    def probe_rows(self):
        return self.first_rows

    def warm(self):
        grid = self._grid()
        grid.compute(self.engine)
        self.first_rows = grid.params[:512]

    def call(self):
        grid = self._grid()
        t0 = time.perf_counter()
        grid.compute(self.engine)
        t = time.perf_counter() - t0
        g = global_from_parts(grid.misfits_by_src.reshape(grid.nsources, -1),
                              grid.norms_by_src.reshape(grid.nsources, -1))
        rows = self.keep.choice(grid.nsources, size=int(self.mix["sample"]["rows"]), replace=False)
        self.kept.append([(grid.params[i].copy(), float(g[i]))
                          for i in sorted(set(rows.tolist()) | {int(np.argmin(g))})])
        return {"t": t, "units": grid.nsources}
