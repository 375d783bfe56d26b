"""Grid searches over an eikonal rupture: invert.MisfitGrid.compute, as
drivers/grid.py runs them, on any parameter grid of the mix.

Every call builds the mix's grid (`grid`: parameter -> [start, stop,
step]) around the seeded truth, each gridded parameter named in `offsets`
moved by a seeded amount in [0, offset) (a radius grid moves its radii, a
strike grid its strikes), and computes it through the engine.  Around each
call the program's counters (kiwi_tpu_torch.profiling.snapshot) are read,
and the differences of COUNTERS that the snapshot holds go into the call's
record: a program without such a counter records none.  The reference is
reference/eikonal.py's session, at TF32 for the control."""

from __future__ import annotations

import os

from portbench import harness
from portbench.reference import eikonal as eikref

grid = harness.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "grid.py"),
                           "driver_grid")

COUNTERS = ("eik.host_solves", "eik.fine_cells", "launches.eik_sweep")


class Driver(grid.Driver):
    def __init__(self, cfg, mix, store, seed, device):
        super().__init__(cfg, mix, store, seed, device)
        self.sampled = []

    def _grid(self):
        from kiwi_tpu_torch.invert import MisfitGrid

        offs = {n: self.rng.uniform(0.0, float(w)) for n, w in sorted(self.mix["offsets"].items())}
        return MisfitGrid(self.source, [(n, v + offs.get(n, 0.0)) for n, v in self.ranges])

    def call(self):
        from kiwi_tpu_torch import profiling

        before = profiling.snapshot()
        rec = super().call()
        after = profiling.snapshot()
        rec.update({k: after[k] - before.get(k, 0) for k in COUNTERS if k in after})
        return rec

    def answers(self, rng):
        out = super().answers(rng)
        self.sampled = [row for row, _ in out]
        return out

    def reference(self, precision="float64"):
        ses = eikref.Session(self.cfg, self.store, precision=precision)
        ses.prime([self.truth] + self.sampled)  # one solve for all of them
        ses.set_reference(self.truth)
        return ses
