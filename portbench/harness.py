"""One run of one benchmark cell of kiwi_tpu_torch, found by name.

Everything that belongs to a cell lives in files of its own, found by the
names in BENCHMARK.json:

    configs/<config>.json      the deployment: store, receivers, source, misfit setup
    traffic/<mix>.json         the traffic: its driver, sizes, ranges and samples
    drivers/<driver>.py        the closed loop that drives one entry point
    limits/<cell>.json         the limits of the numbers that decide `correct`
    metrics/<metric>.py        one reader per metric, end-to-end or per layer
    kernels/<kernel>.py        a kernel wrapper to span, and its work per call
    peaks.json                 published peaks per device name

A run: set-up (torch, the card, the store, the session, a warm call of
every shape), a closed-loop window of --seconds, the per-layer trace with
--trace 1, then the plain reference on a sample of the window's answers.
The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "kiwi_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path, name):
    """A module of the benchmark by file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    return load_json(root, "BENCHMARK.json")


def rng_for(seed, stream):
    """A numpy Generator for one named stream of a run's seed (any integer)."""
    import numpy as np

    seed = int(seed)
    words = [abs(seed) & 0xFFFFFFFF, abs(seed) >> 32, int(seed < 0)]
    return np.random.default_rng(words + [sum(stream.encode())] + list(stream.encode()))


class Cell:
    """A cell of `root`/BENCHMARK.json with its configuration, mix, driver,
    limits and metrics resolved by name under `root`/portbench."""

    def __init__(self, name, root=ROOT):
        bench = benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.dir = os.path.join(root, "portbench")
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(root, conf["file"])
        self.mix = load_json(self.dir, "traffic", self.workload["traffic"] + ".json")
        limits = os.path.join(self.dir, "limits", name + ".json")
        self.limits = load_json(limits) if os.path.exists(limits) else {}
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def session(self):
        """The configuration with the mix's session overrides (misfit
        method, shift range, filter)."""
        cfg = dict(self.config)
        cfg.update(self.mix.get("session", {}))
        return cfg

    def driver(self):
        return load_module(os.path.join(self.dir, "drivers", self.mix["driver"] + ".py"),
                           "driver_" + self.mix["driver"])

    def metric(self, name):
        return load_module(os.path.join(self.dir, "metrics", name + ".py"), "metric_" + name)

    def kernels(self):
        kdir = os.path.join(self.dir, "kernels")
        return {f[:-3]: load_module(os.path.join(kdir, f), "kernel_" + f[:-3])
                for f in sorted(os.listdir(kdir)) if f.endswith(".py")}


class Run:
    """What the metric readers read: the window's records, its seconds and
    set-up, the program's counters and the trace summary (or None)."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = None
        self.window_s = None
        self.records = []
        self.trace = None
        self.peaks = None

    def field(self, key):
        return [r[key] for r in self.records if key in r]

    def roofline(self, kernel):
        """The kernel's share of its roofline in %, or None where the trace
        holds no call of it or the card's peaks are unknown."""
        t = self.trace
        if t is None or self.peaks is None or kernel not in t.kernel_work:
            return None
        seconds = t.kernel_seconds.get(kernel, 0.0)
        if seconds <= 0:
            return None
        bound = sum(n * max(b / self.peaks["hbm_bytes_per_s"], f / self.peaks["fp32_flops_per_s"])
                    for n, f, b in t.kernel_work[kernel])
        return 100.0 * bound / seconds


def environment():
    """Caches inside the checkout, at fixed paths; one host thread for the
    numeric libraries (the program's host work is single-threaded); no JAX
    through libraries."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, chips):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def run_window(run, drv, seconds, trace_calls, tracer):
    """The closed loop: calls back to back until `seconds` have passed; the
    first `trace_calls` of them under the tracer when there is one."""
    import torch

    if drv.device.type == "cuda":
        torch.cuda.synchronize(drv.device)
    t0 = time.perf_counter()
    ncall = 0
    while True:
        if tracer is not None and ncall == 0:
            tracer.start()
        rec = drv.call()
        ncall += 1
        if tracer is not None and ncall == trace_calls:
            tracer.stop(ncall)
            tracer = None
        run.records.append(rec)
        if time.perf_counter() - t0 >= seconds:
            break
    if tracer is not None:
        tracer.stop(ncall)
    run.window_s = time.perf_counter() - t0
    return run


def reader_values(run, metrics):
    out = {}
    for m in metrics:
        value = run.cell.metric(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell, seed, seconds, trace, t_start, device="cuda", store_override=None):
    """One run of `cell`: (the result's JSON object, the Run).  `device`
    "cpu" and a small `store_override` serve the tests, which skip the look
    for a card."""
    import numpy as np
    import torch

    from portbench.reference import store as rstore

    chips = cell.chips
    if device == "cuda":
        from portbench import tracing

        torch.cuda.reset_peak_memory_stats()
    cfg = cell.session()
    if store_override is None:
        store, _built = rstore.cached(cfg["store"], CACHE)
    else:
        store = store_override
    drivers = cell.driver()
    drv = drivers.Driver(cfg, cell.mix, store, seed, device)
    drv.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    run = Run(cell)
    run.setup_s = time.perf_counter() - t_start
    tracer = None
    if trace and device == "cuda":
        tracer = tracing.Tracer(cell.kernels(), drv.device)
    run_window(run, drv, seconds, int(cell.mix.get("trace_calls", 1)), tracer)
    if device == "cuda":
        torch.cuda.synchronize()
    if tracer is not None:
        run.trace = tracer.summary()
        peaks = load_json(cell.dir, "peaks.json")
        run.peaks = peaks.get(torch.cuda.get_device_name(0))
    dev = device_info(torch, chips) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    metrics = reader_values(run, cell.per_layer if trace else cell.end_to_end)
    answers = drv.answers(rng_for(seed, "sample"))
    drv.close()
    numbers = drv.compare(drv.reference(), answers)
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])} for k, v in numbers.items()
              if k in cell.limits}
    missing = sorted(set(numbers) - set(cell.limits))
    correct = (not missing and bool(checks)
               and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    # a call that raises ends the run with an error: every call counted returned
    result = {"correct": bool(correct), "attempted": len(run.records), "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    if missing:
        result["unlimited"] = missing
    result["checks"] = checks
    return result, run


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell of kiwi_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    cell = Cell(args.workload)
    try:
        import torch
        import kiwi_tpu_torch  # noqa: F401  the program under test
    except ImportError as exc:
        print(f"portbench: cannot import the program: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, _run = execute(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

