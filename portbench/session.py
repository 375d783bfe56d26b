"""What every driver shares: the program's session for a configuration,
the seeded truth that sets its references, and the comparison of sampled
answers with the plain reference."""

from __future__ import annotations

import numpy as np

from portbench.reference import oracle

# a receiver's least summed misfit shared this closely (relative) by
# another trial shift leaves the choice between them to rounding: a float32
# program may take either (oracle.Session.global_misfit)
NEAR_TIE = 2e-5


def truth_row(cfg, mix, rng):
    """The configuration's base row with the mix's seeded jitter: each named
    parameter moved by a uniform amount in [-w, w]."""
    from kiwi_tpu_torch.sources import get_source_model

    model = get_source_model(cfg["source_type"])
    row = np.asarray(cfg["base"], np.float32).copy()
    for name, w in mix.get("truth_jitter", {}).items():
        row[model.param_index(name)] += np.float32(rng.uniform(-w, w))
    return row


def make_engine(cfg, store, device, truth):
    """The program's session: store, receivers, origin, interpolation, the
    truth's synthetics as the references, then the misfit setup."""
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.gf.store import GFStore

    gfs = GFStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                             store.data, store.itmin, store.nsamples)
    eng = Engine(gfs, device=device)
    lat, lon = oracle.receiver_latlon(cfg)
    comps = cfg["receivers"]["components"]
    eng.set_receivers([Receiver(float(np.degrees(a)), float(np.degrees(b)), comps)
                       for a, b in zip(lat, lon)])
    eng.set_source_location(cfg["origin"][0], cfg["origin"][1], 0.0)
    eng.set_effective_dt(cfg["effective_dt"])
    eng.set_local_interpolation(cfg["local_interpolation"])
    if cfg.get("filter"):
        eng.set_misfit_filter(None, *cfg["filter"])
    eng.set_source_params(cfg["source_type"], truth)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(*cfg.get("floating_shiftrange", (0.0, 0.0)))
    eng.set_misfit_method(cfg["misfit_method"])
    return eng


def global_from_parts(m, n):
    """The global misfit of host misfits and norms [..., RC] (float64)."""
    m = np.asarray(m, np.float64)
    n = np.asarray(n, np.float64)
    return np.sqrt((m * m).sum(-1)) / np.sqrt((n * n).sum(-1))


def gap(ses, row, value):
    """The distance of a global misfit from the reference's for `row` (the
    nearest of its tie choices)."""
    return float(np.min(np.abs(ses.global_misfit(row, near=NEAR_TIE) - value)))


def reference_session(cfg, store, truth, rows_for_probe=None, precision="float64"):
    """The plain reference's session with the truth's references; the probe
    span of band-passed norms from the rows the program planned with."""
    ses = oracle.Session(cfg, store, precision=precision)
    ses.set_reference(truth)
    if cfg.get("filter"):
        ses.probe = oracle.probe_span(ses, rows_for_probe)
    return ses


class Driver:
    """A closed-loop client of one entry point.  Subclasses set up their
    traffic in __init__, warm every shape in warm(), run one timed call in
    call() (its answer on the host before it returns), keep a seeded sample
    of answers (`kept`, one list a call), and compare a sample of them with
    the reference in compare()."""

    def __init__(self, cfg, mix, store, seed, device):
        import torch

        from portbench.harness import rng_for

        self.cfg = cfg
        self.mix = mix
        self.store = store
        self.seed = seed
        self.device = torch.device(device)
        self.rng = rng_for(seed, "traffic")
        self.keep = rng_for(seed, "keep")
        self.truth = truth_row(cfg, mix, rng_for(seed, "truth"))
        self.engine = make_engine(cfg, store, device, self.truth)
        self.kept = []

    def close(self):
        """Free the program's state before the reference runs."""
        import torch

        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def probe_rows(self):
        return None

    def reference(self, precision="float64"):
        return reference_session(self.cfg, self.store, self.truth, self.probe_rows(), precision)

    def answers(self, rng):
        """A seeded sample of the kept answers (drawn once the window has closed)."""
        n = int(self.mix["sample"]["calls"])
        pick = sorted(rng.choice(len(self.kept), size=min(n, len(self.kept)), replace=False))
        return [a for i in pick for a in self.kept[i]]

    def compare(self, ses, answers, control=None):
        """{"max_gap": the widest gap of a sampled answer from the
        reference}; `control`, a lower-precision reference session, answers
        in the program's place."""
        gaps = []
        for row, value in answers:
            if control is not None:
                value = control.global_misfit(row, near=None)[0]
            gaps.append(gap(ses, row, value))
        return {"max_gap": max(gaps)}
