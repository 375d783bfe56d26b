"""The per-layer trace of a run: torch.profiler over the window's first
calls, spans of the benchmark's own around each kernel wrapper, and the
reduction of the profile to the numbers the per-layer readers read.

Each file of portbench/kernels names a wrapper of the program (MODULE,
ATTR) and the device kernels it launches (DEVICE_KERNELS).  While a run
traces, the wrapper is replaced by one that runs it inside
record_function("portbench.kernel.<name>") (which names the host's time
in the idle gaps) and counts its calls by the shape key the kernel file
gives; the operands of the last call of each key are kept, and the kernel
file's work() counts that call's operations and bytes once the window has
closed (so that no count adds a device operation or a sync to the trace).
The kernel's time is the device time of its DEVICE_KERNELS in the traced
window.
"""

from __future__ import annotations

import importlib
import time

SPAN = "portbench.kernel."


class Tracer:
    def __init__(self, kernels, device):
        import torch

        self.torch = torch
        self.kernels = kernels
        self.device = device
        self.prof = None
        self.active = False
        self.counts = {k: {} for k in kernels}
        self.last = {k: {} for k in kernels}
        self.calls = 0
        self.t0 = self.t1 = None
        self._patch()

    def _patch(self):
        from torch.profiler import record_function

        for name, kmod in self.kernels.items():
            module = importlib.import_module(kmod.MODULE)
            orig = getattr(module, kmod.ATTR)

            def wrapped(*args, _orig=orig, _name=name, _kmod=kmod, **kwargs):
                with record_function(SPAN + _name):
                    out = _orig(*args, **kwargs)
                if self.active:
                    key = _kmod.key(args, kwargs)
                    self.counts[_name][key] = self.counts[_name].get(key, 0) + 1
                    self.last[_name][key] = (args, kwargs)
                return out

            setattr(module, kmod.ATTR, wrapped)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self, calls):
        self.torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.active = False
        self.calls = calls
        self.prof.__exit__(None, None, None)

    def summary(self):
        return Summary(self)


class Summary:
    """busy_s, window_s, calls, device_ops (count), kernel_seconds,
    kernel_work {kernel: [(calls, flops, bytes)]}, top device ops and the
    idle gaps by what the host was doing."""

    def __init__(self, tracer):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = list(tracer.prof.events())
        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == cuda and not e.name.startswith("portbench"))
        host = [e for e in events if e.device_type != cuda]
        self.calls = tracer.calls
        self.window_s = tracer.t1 - tracer.t0
        self.device_ops = len(dev)
        merged = []
        for a, b, _n in dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        by_op = {}
        for a, b, n in dev:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        self.top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        self.idle = self._idle(merged, host)
        # a kernel's device time: its device kernels' intervals by name (each
        # is launched by its wrapper alone); the profiler links no device time
        # to the spans around the window kernel's launches (PERF.md, PR 18)
        self.kernel_seconds = {
            name: sum(b - a for a, b, n in dev if any(k in n for k in kmod.DEVICE_KERNELS)) / 1e6
            for name, kmod in tracer.kernels.items() if tracer.counts[name]}
        self.kernel_work = {}
        for name, kmod in tracer.kernels.items():
            if tracer.counts[name]:
                self.kernel_work[name] = [(n, *kmod.work(*tracer.last[name][key]))
                                          for key, n in tracer.counts[name].items()]
        tracer.last = None

    @staticmethod
    def _idle(merged, host):
        """Idle gaps between device activity, summed by the innermost host
        operation of the main thread running at the middle of each gap."""
        threads = {}
        for e in host:
            threads[e.thread] = threads.get(e.thread, 0) + 1
        main = max(threads, key=threads.get) if threads else None
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                       if e.thread == main)
        out, stack, i = {}, [], 0
        for (_a, b), (c, _d) in zip(merged, merged[1:]):
            mid = (b + c) / 2.0
            while i < len(spans) and spans[i][0] <= mid:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "python"
            out[name] = out.get(name, 0.0) + (c - b) / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])[:10]

    def breakdown(self):
        return {"device_ops": [[n, s] for n, s in self.top_ops],
                "idle_gaps": [[n, s] for n, s in self.idle]}
