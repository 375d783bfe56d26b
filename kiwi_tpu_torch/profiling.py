"""Timing / throughput observability (SURVEY §5 tracing; port of
kiwi_tpu/profiling.py).

The reference has inform() messages, test_begin/test_end cpu_time pairs
(util.f90:170-215) and kiwibench's rolling models-per-second counter
(benchmark/kiwibench.py:135-148).  Here:

* `Timers` -- named accumulating wall-time phases (context manager),
* `MPSCounter` -- the canonical models/sec metric with rolling windows,
* `torch_trace` -- a thin gate around torch.profiler for kernel-level
  traces (a Chrome trace: chrome://tracing or Perfetto).

Work on the card is asynchronous: a torch call returns once its kernels are
queued.  A `Timers` block therefore times what the host did and what had
finished on the card when the block exited, not the card work it queued;
end the block in something that waits for the card (a copy to the host,
torch.cuda.synchronize()) to time that work.  Timers does not synchronize
by itself, as the JAX package's does not block.
"""

from __future__ import annotations

import contextlib
import os
import time


class Timers:
    """Accumulating named wall-time phases."""

    def __init__(self):
        self.acc = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.acc[name] = self.acc.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        total = sum(self.acc.values()) or 1.0
        rows = sorted(self.acc.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{k:24s} {v:9.3f} s  {100 * v / total:5.1f}%  ({self.counts[k]}x)"
            for k, v in rows
        )

    def reset(self):
        self.acc.clear()
        self.counts.clear()


class MPSCounter:
    """Rolling models-per-second (kiwibench.py:135-148's MPS triple:
    total average / last-window average / instantaneous)."""

    def __init__(self, window=10):
        self.window = window
        self.t0 = time.time()
        self.events = []  # (t, nmodels)
        self.total = 0

    def add(self, nmodels):
        now = time.time()
        self.events.append((now, nmodels))
        self.total += nmodels
        if len(self.events) > self.window:
            self.events.pop(0)

    def rates(self):
        """(total_avg, window_avg, last) models/sec."""
        now = time.time()
        total_avg = self.total / max(now - self.t0, 1e-9)
        if len(self.events) >= 2:
            span = self.events[-1][0] - self.events[0][0]
            nwin = sum(n for _, n in self.events[1:])
            window_avg = nwin / max(span, 1e-9)
        else:
            window_avg = total_avg
        if len(self.events) >= 2:
            dt = self.events[-1][0] - self.events[-2][0]
            last = self.events[-1][1] / max(dt, 1e-9)
        else:
            last = total_avg
        return total_avg, window_avg, last


@contextlib.contextmanager
def torch_trace(logdir):
    """torch.profiler trace around a block (host activity, and the card's
    where there is one), written on exit as a Chrome trace
    `trace-<time>-<pid>.json` into logdir.  Yields that file's path.  The
    block's queued card work is waited for before the trace stops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
