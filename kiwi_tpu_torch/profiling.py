"""The port's spans and counters, and the two copies through which the
host waits for the card.

* `span(name)` -- a named range at a layer boundary, `kiwi.<layer>.<step>`
  (layers `invert`, `engine`, `synth`, `misfit`).  With spans off (the
  default) it returns one shared no-op context, so a site costs one read of
  a module global; with spans on (`enable()`, or inside `torch_trace`) it
  opens a `torch.profiler.record_function` range, which sits in the
  profiler's trace on the same clock as the card's kernels and copies, its
  parent the range that encloses it on the thread.
* `count(name, n=1)` -- plain integer counters, always on (one dict update
  a site); `snapshot()` copies them, with the kernels' launch counters
  (`ops.*.launches`) under `launches.<kernel>`.
* `to_host(*tensors)` and `to_device(x, device)` -- every copy at which the
  host waits for the card goes through one of them and is counted:
  `syncs` counts each wait (a stream synchronization, a blocking copy),
  `h2d_pageable` the host-to-device copies from pageable memory among
  them.  They count by site, whatever the device, so that a CPU session
  counts what a session on the card waits for.
* `torch_trace(logdir)` -- torch.profiler around a block with the spans on,
  written as a Chrome trace (chrome://tracing or Perfetto).

Counters of the port's own objects stay with them: `Engine.plan_builds`.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import record_function

_enabled = False
_NOOP = contextlib.nullcontext()
counters: dict[str, int] = {}


def enable():
    """Turn the spans on."""
    global _enabled
    _enabled = True


def disable():
    """Turn the spans off."""
    global _enabled
    _enabled = False


def span(name):
    """A `record_function(name)` range while spans are on, else a shared no-op."""
    if not _enabled:
        return _NOOP
    return record_function(name)


def count(name, n=1):
    counters[name] = counters.get(name, 0) + n


def snapshot():
    """A copy of the counters, the kernels' launch counters included."""
    from .ops import bilat_tables, eik_prepare, eik_sweep, eik_tables, float_scan, synth_window

    out = dict(counters)
    for mod in (float_scan, synth_window, eik_sweep, bilat_tables, eik_prepare, eik_tables):
        for k, v in mod.launches.items():
            out["launches." + k] = v
    return out


def to_host(*tensors):
    """Host numpy copies of tensors: from the card through pinned buffers
    with one stream synchronization for all of them (one `syncs`)."""
    count("syncs")
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for o, t in zip(out, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in out]


def to_device(x, device, dtype=None):
    """torch.as_tensor(x, dtype, device) of host data (an array, a list, a
    number): on the card a copy from pageable memory, which the host waits
    for (one `syncs`, one `h2d_pageable`)."""
    count("syncs")
    count("h2d_pageable")
    return torch.as_tensor(x, dtype=dtype, device=device)


@contextlib.contextmanager
def torch_trace(logdir):
    """torch.profiler trace around a block (host activity, the port's spans,
    and the card's where there is one), written on exit as a Chrome trace
    `trace-<time>-<pid>.json` into logdir.  Yields that file's path.  The
    block's queued card work is waited for before the trace stops."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json")
    was = _enabled
    enable()
    try:
        with profile(activities=activities) as prof:
            yield path
            if cuda:
                torch.cuda.synchronize()
    finally:
        if not was:
            disable()
    prof.export_chrome_trace(path)
