"""The card's idle time by layer of the program, and the program's waits per
call, from the program's own spans and counters (kiwi_tpu_torch.profiling).

    python3 portbench/layers.py --workload <cell> --seed <n> --seconds <s> \
        [--sync-debug 1]

One run of the cell as portbench/run.py --trace 1 runs it, with the
program's spans on in the traced calls: the result's JSON (the accepted
per-layer metrics unchanged), then the six readings of this module's
readers (metrics/idle_under.<layer>.py, syncs_per_call.models.py,
h2d_pageable_per_call.models.py) and the checks behind them: the layers'
idle seconds and `outside` against the window's idle seconds, the entry
spans against each traced call's host time.  With --sync-debug 1, one
more call of the cell under torch.cuda.set_sync_debug_mode("warn"): the
warnings by site against the program's `syncs` counter.  The
benchmark's own runs never run this; their Tracer (portbench/tracing.py)
does not yet turn the spans on (PERF.md, open questions).

LayerTracer is tracing.Tracer with the spans on between start and stop
and a snapshot of the counters at each; its summary is tracing.Summary of
the trace without the program's ranges (so every accepted reader reads
what it reads without them), plus `layer_idle` and `counters`.  Against a
program without `profiling.enable` both are None.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness, tracing  # noqa: E402

PROGRAM = "kiwi."
LAYERS = ("invert", "engine", "synth", "misfit")
ENTRIES = ("kiwi.engine.sweep", "kiwi.invert.grid", "kiwi.invert.lm")
WINDOW = "portbench.window"


def program_profiling():
    """kiwi_tpu_torch.profiling where it has spans, else None."""
    try:
        from kiwi_tpu_torch import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


def innermost(spans):
    """The innermost open span's layer as a step function of time: sorted
    (t, layer) change points (layer None under no span) from one thread's
    properly nested spans [(start, end, layer)]."""
    steps, stack = [], []
    for s, e, layer in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            end = stack.pop()[1]
            steps.append((end, stack[-1][2] if stack else None))
        stack.append((s, e, layer))
        steps.append((s, layer))
    while stack:
        end = stack.pop()[1]
        steps.append((end, stack[-1][2] if stack else None))
    return steps


def layer_idle(busy, spans, w0, w1):
    """Seconds of the window [w0, w1] (microseconds) in which no merged
    device interval of `busy` (sorted, disjoint [a, b]) ran, each split at
    span boundaries and summed by the label of the innermost open span of
    `spans` [(start, end, label)]; time under no span goes to "outside".
    Every layer of LAYERS has a key."""
    steps = innermost(spans)
    times = [t for t, _ in steps]
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, w1)))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    out = {layer: 0.0 for layer in LAYERS + ("outside",)}
    for a, b in gaps:
        i = bisect.bisect_right(times, a) - 1
        while a < b:
            layer = steps[i][1] if i >= 0 else None
            nxt = times[i + 1] if i + 1 < len(times) else b
            end = min(max(nxt, a), b)
            key = layer or "outside"
            out[key] = out.get(key, 0.0) + (end - a) / 1e6
            a = end
            i += 1
    return out


class LayerTracer(tracing.Tracer):
    """tracing.Tracer with the program's spans on over the traced calls."""

    def __init__(self, kernels, device):
        super().__init__(kernels, device)
        self.profiling = program_profiling()
        self.before = self.after = None
        self.window = None

    def start(self):
        from torch.profiler import record_function

        if self.profiling is not None:
            self.before = self.profiling.snapshot()
            self.profiling.enable()
        super().start()
        self.window = record_function(WINDOW)
        self.window.__enter__()

    def stop(self, calls):
        self.torch.cuda.synchronize(self.device)
        self.window.__exit__(None, None, None)
        super().stop(calls)
        if self.profiling is not None:
            self.profiling.disable()
            self.after = self.profiling.snapshot()

    def summary(self):
        return LayerSummary(self)


class _Events:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


class LayerSummary(tracing.Summary):
    """tracing.Summary of the trace without the program's ranges, plus
    layer_idle {layer: s} and counters {name: delta} (None without the
    program's spans), the idle seconds by span name (`step_idle`), the
    entry spans' seconds (`entry_s`, in call order) and the spans' count."""

    def __init__(self, tracer):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = list(tracer.prof.events())
        prof, tracer.prof = tracer.prof, _Events(
            [e for e in events if not e.name.startswith((PROGRAM, WINDOW))])
        try:
            super().__init__(tracer)
        finally:
            tracer.prof = prof
        self.layer_idle = self.counters = None
        self.entry_s = []
        self.spans = self.step_idle = None
        if tracer.profiling is None:
            return
        host = [e for e in events if e.device_type != cuda]
        (window,) = [e for e in host if e.name == WINDOW]
        main = window.thread
        dev = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == cuda and not e.name.startswith(("portbench", PROGRAM)))
        busy = []
        for a, b in dev:
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
                 if e.thread == main and e.name.startswith(PROGRAM)]
        w0, w1 = window.time_range.start, window.time_range.end
        self.spans = len(spans)
        self.layer_idle = layer_idle(busy, [(a, b, n.split(".")[1]) for a, b, n in spans], w0, w1)
        self.step_idle = {k: v for k, v in layer_idle(busy, spans, w0, w1).items() if v}
        # the harness's own seconds between t0 and the window range, and
        # between the range and t1: the card idle, no program span open
        bracket = max(self.window_s - (w1 - w0) / 1e6, 0.0)
        self.layer_idle["outside"] += bracket
        self.step_idle["outside"] = self.step_idle.get("outside", 0.0) + bracket
        self.counters = {k: v - tracer.before.get(k, 0) for k, v in tracer.after.items()}
        self.entry_s = [(e.time_range.end - e.time_range.start) / 1e6
                        for e in sorted(host, key=lambda e: e.time_range.start)
                        if e.thread == main and e.name in ENTRIES]


NEW = ("idle_under.invert", "idle_under.engine", "idle_under.synth", "idle_under.misfit",
       "syncs_per_call.models", "h2d_pageable_per_call.models")


def sync_warnings(fn):
    """{site: count} of the sync warnings that fn raises under
    set_sync_debug_mode("warn"), each at the innermost frame of a file of
    this checkout that led to it."""
    import traceback
    import warnings

    import torch

    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(harness.ROOT)]
        f = ours[-1] if ours else None
        where = (f"{os.path.relpath(f.filename, harness.ROOT)}:{f.lineno}" if f
                 else f"{filename}:{lineno}")
        sites[where] = sites.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def sync_debug(drv, profiling):
    """One more call of the driver under sync debug mode "warn": the
    warnings by site (those of the benchmark's own files apart: the
    driver's copy of its answer, and what switching the mode raises with no
    call), and the program's `syncs` over the call."""
    bare = sync_warnings(lambda: None)
    before = profiling.snapshot() if profiling is not None else {}
    sites = sync_warnings(drv.call)
    after = profiling.snapshot() if profiling is not None else {}
    own = sum(n for k, n in sites.items() if k.startswith("portbench/"))
    return {"sites": sites, "bare": bare, "benchmark_own": own,
            "program_warnings": sum(sites.values()) - own,
            "program_syncs": after.get("syncs", 0) - before.get("syncs", 0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sync-debug", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()
    harness.environment()
    cell = harness.Cell(args.workload)
    tracing.Tracer = LayerTracer  # this process only: execute's tracer
    result, run = harness.execute(cell, args.seed, args.seconds, True, t_start)
    t = run.trace
    out = {"workload": cell.name, "seed": args.seed, "result": result,
           "new": {name: cell.metric(name).read(run) for name in NEW},
           "layer_idle_s": t.layer_idle, "step_idle_s": t.step_idle, "counters": t.counters,
           "window_idle_s": t.window_s - t.busy_s,
           "calls": t.calls, "call_s": [r["t"] for r in run.records[:t.calls]],
           "untraced_call_s": [r["t"] for r in run.records[t.calls:]],
           "entry_s": t.entry_s, "spans": t.spans}
    if args.sync_debug:
        from portbench.reference import store as rstore

        store = rstore.cached(cell.session()["store"], harness.CACHE)[0]
        drv = cell.driver().Driver(cell.session(), cell.mix, store, args.seed, "cuda")
        drv.warm()
        drv.call()
        out["sync_debug"] = sync_debug(drv, program_profiling())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
