"""Levenberg-Marquardt inversions: Engine.minimize_lm.

Every call starts one inversion from the seeded truth moved in each free
parameter by a seeded amount between half of `offset_max` and all of it,
with a seeded sign (never from the previous call's end), and runs it to its
end.  The starts come in decks of `deck`: each deck a Latin hypercube of
the amounts over every sign pattern in equal numbers, in a seeded order, so
that every seed's window meets the same spread of inversions.  The
program's answers: the misfit of its first evaluation (the start row), and
the final parameters with the misfit it reports for them."""

from __future__ import annotations

import time

import numpy as np

from portbench.session import Driver as Base, global_from_parts


class Driver(Base):
    def __init__(self, cfg, mix, store, seed, device):
        from kiwi_tpu_torch.sources import get_source_model

        super().__init__(cfg, mix, store, seed, device)
        model = get_source_model(cfg["source_type"])
        self.free = [model.param_index(n) for n in mix["free"]]
        self.offset = np.asarray(mix["offset_max"], np.float64)
        mask = np.zeros(model.nparams, bool)
        mask[self.free] = True
        self.engine.set_source_params_mask(mask)
        self._first = None
        self.starts = []
        batch = self.engine.misfits_for_source_batch

        def first_call(pb):
            out = batch(pb)
            if self._first is None:
                self._first = (np.array(pb, np.float32).reshape(-1, len(mask))[0], out)
            return out

        self.engine.misfits_for_source_batch = first_call

    def _start(self):
        if not self.starts:
            n, f = int(self.mix["deck"]), len(self.free)
            u = (np.stack([self.rng.permutation(n) for _ in range(f)], 1)
                 + self.rng.uniform(size=(n, f))) / n
            signs = np.where((np.arange(n)[:, None] >> np.arange(f)) & 1, 1.0, -1.0)
            moves = (0.5 + 0.5 * u) * self.offset * signs
            self.starts = list(moves[self.rng.permutation(n)])
        start = self.truth.copy()
        start[self.free] += self.starts.pop().astype(np.float32)
        return start

    def _solve(self, start):
        self._first = None
        self.engine.set_source_params(self.cfg["source_type"], start)
        builds = self.engine.plan_builds
        info, nfev, gm = self.engine.minimize_lm()
        return nfev, gm, self.engine.plan_builds - builds

    def warm(self):
        self._solve(self._start())

    def call(self):
        start = self._start()
        t0 = time.perf_counter()
        nfev, gm, builds = self._solve(start)
        t = time.perf_counter() - t0
        row0, (m, n, _fs) = self._first
        g0 = float(global_from_parts(m[0].cpu().numpy(), n[0].cpu().numpy()))
        self.kept.append([("start", row0, g0),
                          ("final", self.engine.source_params.copy(), float(gm))])
        return {"t": t, "units": 1, "nfev": nfev, "plan_builds": builds, "misfit": float(gm)}

    def compare(self, ses, answers, control=None):
        """max_gap: the widest gap of the program's start and final misfits
        from the reference's at the same rows; max_final_to_start: the
        largest ratio of the reference's misfit at a solve's final
        parameters to its misfit at the start (1 for a solve that leaves
        its start unchanged)."""
        gaps, ratios, start = [], [], None
        for kind, row, value in answers:
            ref = ses.global_misfit(row)[0]
            if control is not None:
                value = control.global_misfit(row)[0]
            gaps.append(abs(value - ref))
            if kind == "start":
                start = ref
            else:
                ratios.append(ref / start)
        return {"max_gap": max(gaps), "max_final_to_start": max(ratios)}
