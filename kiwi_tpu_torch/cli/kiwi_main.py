"""End-to-end inversion runner: the `kiwi` / `autokiwi` work-report program
on the port's engine (port of kiwi_tpu/cli/kiwi_main.py).

Counterpart of tunguska/main.py (kiwi_main) + the local part of
scripts/autokiwi: given a kiwi data directory and a GF database, run the
standard step sequence (informer -> weights -> shifts -> point-source search
-> finite-source tuning -> report) with persisted run dirs per step, on the
card unless --device cpu is given.

usage:
  python -m kiwi_tpu_torch.cli.kiwi_main [--device cuda|cpu] work <datadir> <gfdb> <workdir> [options]
  python -m kiwi_tpu_torch.cli.kiwi_main report <workdir>

Options (key=value): components=ned effective_dt=0.5 sourcetype=bilateral
misfit=l2norm shiftrange=-10,10 taper=P,S,-10,0,40,50

Where matplotlib does not import, the figures step (traceplotter) is
recorded as skipped, with the reason, in its run dir, on stdout and in
report.html; the misfits, the grids and the best source are the same.
"""

from __future__ import annotations

import os

import numpy as np


def work(datadir, gfdb_path, workdir, device="cuda", **opts):
    from ..dataset import standard_setup
    from ..invert import Source
    from ..pipeline import Informer, ParamTuner, Shifter, TracePlotter, WeightMaker
    from ..plotting import matplotlib_missing

    components = opts.get("components", "ned")
    effective_dt = float(opts.get("effective_dt", 1.0))
    sourcetype = opts.get("sourcetype", "bilateral")
    misfit = opts.get("misfit", "l2norm")

    engine = standard_setup(
        datadir, gfdb_path, components=components, effective_dt=effective_dt,
        device=device,
    )
    engine.set_misfit_method(misfit)

    base = Source(sourcetype)
    # reject typos instead of silently ignoring them (a dropped option
    # means an inversion quietly ran with defaults)
    known = {"components", "effective_dt", "sourcetype", "misfit",
             "shiftrange", "grid_step_deg", "bootstrap_iterations", "taper"}
    unknown = [k for k in opts if k not in known and k not in base.keys()]
    if unknown:
        raise ValueError(
            f"unknown option(s) {unknown}; valid: {sorted(known)} "
            f"or source params {list(base.keys())}")
    # point-source stages: start with zero spatial extent unless configured
    for k in ("length-a", "length-b", "width", "bord-radius", "radius"):
        if k in base.keys():
            base[k] = 0.0
    for k, v in opts.items():
        if k in known:
            continue
        if k in base.keys():
            base[k] = float(v)
    engine.set_source_params(sourcetype, base.params)

    # taper=P,S,-10,0,40,50: phase names then the 4 offsets -- misfit
    # windows positioned by phase arrivals at each receiver's distance
    if "taper" in opts:
        from ..phases import Taper, apply_taper_to_engine

        w = opts["taper"].split(",")
        if len(w) < 5:
            raise ValueError(
                "taper= needs phase name(s) followed by 4 offsets, e.g. "
                "taper=P,S,-10,0,40,50")
        taper = Taper(phases=tuple(w[:-4]), offsets=[float(x) for x in w[-4:]])
        apply_taper_to_engine(engine, taper)

    step_deg = float(opts.get("grid_step_deg", 10.0))
    nboot = int(opts.get("bootstrap_iterations", 100))

    os.makedirs(workdir, exist_ok=True)
    steps = []

    info = Informer(workdir, "informer")
    info.work(engine)
    steps.append(info)

    if "shiftrange" in opts:
        lo, hi = (float(x) for x in opts["shiftrange"].split(","))
        sh = Shifter(workdir, shiftrange=(lo, hi)).chain(info)
        sh.work(engine)
        steps.append(sh)

    wm = WeightMaker(workdir).chain(steps[-1])
    weights = wm.work(engine, base)
    steps.append(wm)

    # point-source orientation search: strike/dip/rake JOINTLY (sequential
    # 1-D scans get trapped; the batched engine makes the joint grid cheap)
    sdr = ParamTuner(
        workdir,
        [("strike", np.arange(0.0, 360.0, step_deg)),
         ("dip", np.arange(step_deg, 91.0, step_deg)),
         ("slip-rake", np.arange(-180.0, 180.0, step_deg))],
        name="sdr-tuner",
        receiver_weights=weights,
        bootstrap_iterations=nboot,
    ).chain(wm)
    sdr.work(engine, base)
    steps.append(sdr)

    momdep = ParamTuner(
        workdir,
        [("moment", base["moment"] * np.logspace(-0.6, 0.6, 13)),
         ("depth", np.linspace(max(base["depth"] * 0.5, 1.0), base["depth"] * 1.5, 11))],
        name="moment-depth-tuner",
        receiver_weights=weights, bootstrap_iterations=nboot,
    ).chain(sdr)
    momdep.work(engine, base)
    steps.append(momdep)

    engine.set_source_params(sourcetype, base.params)
    tp = TracePlotter(workdir).chain(momdep)
    missing = matplotlib_missing()
    if missing is None:
        tp.work(engine)
    else:
        reason = (f"figures not drawn (seismograms, stations, beachball, misfogram, "
                  f"spectra): {missing}")
        tp.skip(reason)
        print(f"traceplotter skipped: {reason}")
    steps.append(tp)

    report(workdir, steps=steps)
    print(f"best source: {base}")
    print(f"min misfit: {momdep.out_config['min_misfit']:g}")
    return base, steps


def report(workdir, steps=None):
    """Collect step results into one HTML report (main.py's report mode)."""
    import pickle

    from .. import plotting

    sections = []
    names = (
        [s.name for s in steps]
        if steps is not None
        else sorted(
            d for d in os.listdir(workdir) if os.path.isdir(os.path.join(workdir, d))
        )
    )
    for name in names:
        stepdir = os.path.join(workdir, name, "current")
        results_fn = os.path.join(stepdir, "results.pickle")
        text = ""
        images = []
        if os.path.exists(results_fn):
            with open(results_fn, "rb") as f:
                results = pickle.load(f)
            text = "\n".join(f"{k}: {v}" for k, v in results.items())
        if os.path.isdir(stepdir):
            for fn in sorted(os.listdir(stepdir)):
                if fn.endswith(".png"):
                    images.append(os.path.join(stepdir, fn))
        sections.append((name, text, images))
    out = os.path.join(workdir, "report.html")
    plotting.html_report(out, f"kiwi-tpu inversion: {os.path.basename(workdir)}", sections)
    print(f"report: {out}")
    return out


def main(argv=None):
    import argparse

    usage = __doc__.split("usage:")[1].split("\n\n")[0]
    ap = argparse.ArgumentParser(prog="kiwi_main", usage=usage)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device (default: the card)")
    ap.add_argument("mode", choices=("work", "report"))
    ap.add_argument("args", nargs="+")
    a = ap.parse_args(argv)
    if a.mode == "report":
        report(a.args[0])
        return
    if len(a.args) < 3:
        ap.error("work needs <datadir> <gfdb> <workdir> [key=value ...]")
    datadir, gfdb_path, workdir = a.args[:3]
    opts = dict(kv.split("=", 1) for kv in a.args[3:])
    if "device" in opts:
        ap.error("give the device as --device, not as an option")
    work(datadir, gfdb_path, workdir, device=a.device, **opts)


if __name__ == "__main__":
    main()
