"""The card's idle time by layer (portbench/layers.py) on hand-built traces:
a gap split between sibling spans, the innermost of nested spans, a gap
under no span, parts that add up to the window's idle seconds; the six
readers against a program without spans (None, nothing raised); the
accepted readers alike on one trace with and without the program's
ranges.  One test, marked cuda, runs the tool on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, layers, tracing

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
ACCEPTED = ("device_ops_per_call.models", "device_idle.models", "scan_sums.roofline")


def test_a_gap_splits_between_sibling_spans():
    spans = [(0, 100, "engine"), (10, 40, "synth"), (40, 70, "misfit")]
    out = layers.layer_idle([[0, 20], [60, 100]], spans, 0, 100)
    assert out["synth"] == pytest.approx(20e-6)
    assert out["misfit"] == pytest.approx(20e-6)
    assert out["engine"] == out["invert"] == out["outside"] == 0.0


def test_the_innermost_span_takes_the_gap():
    spans = [(0, 100, "invert"), (10, 90, "engine"), (20, 50, "misfit")]
    out = layers.layer_idle([[0, 15], [30, 40], [60, 100]], spans, 0, 100)
    assert out == pytest.approx({"invert": 0.0, "engine": 15e-6, "synth": 0.0,
                                 "misfit": 20e-6, "outside": 0.0})


def test_a_gap_under_no_span_is_outside():
    spans = [(10, 30, "engine"), (50, 70, "engine")]
    out = layers.layer_idle([[0, 5], [75, 80]], spans, 0, 100)
    assert out["engine"] == pytest.approx(40e-6)
    assert out["outside"] == pytest.approx(50e-6)  # 5-10, 30-50, 70-75, 80-100


def test_the_parts_add_up_to_the_idle_seconds():
    spans = [(2, 98, "invert"), (5, 45, "engine"), (6, 20, "engine"), (20, 44, "synth"),
             (50, 95, "engine"), (51, 60, "synth"), (60, 94, "misfit")]
    busy = [[0, 3], [8, 12], [19, 21], [43, 55], [70, 71], [96, 99]]
    out = layers.layer_idle(busy, spans, 0, 100)
    idle = 100 - sum(b - a for a, b in busy)
    assert sum(out.values()) == pytest.approx(idle / 1e6)
    assert out == pytest.approx({"invert": 3e-6, "engine": 11e-6, "synth": 27e-6,
                                 "misfit": 33e-6, "outside": 1e-6})


def _event(name, start, end, device=CPU, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, thread=thread)


def _trace(spans):
    """Two calls of a host loop: device kernels, the host ops that issue
    them, and with `spans` the program's ranges (host, and their device
    annotations) and the layer tool's window range, 3 us inside the
    tracer's 100 us."""
    ev = [_event("aten::mul", 10, 12), _event("scan_kernel", 14, 30, CUDA),
          _event("aten::add", 40, 41), _event("other_kernel", 45, 50, CUDA),
          _event("aten::mul", 60, 62), _event("scan_kernel", 64, 80, CUDA),
          _event("cudaStreamSynchronize", 82, 90)]
    if spans:
        ev += [_event("portbench.window", 2, 99), _event("portbench.window", 14, 80, CUDA),
               _event("kiwi.invert.grid", 5, 95), _event("kiwi.engine.batch", 8, 55),
               _event("kiwi.synth.forward", 9, 35), _event("kiwi.misfit.eval", 36, 54),
               _event("kiwi.engine.batch", 58, 81), _event("kiwi.invert.to_host", 81, 92),
               _event("kiwi.synth.forward", 9, 35, CUDA), _event("kiwi.engine.batch", 8, 81, CUDA)]
    return ev


def _tracer(events, profiling):
    kmod = SimpleNamespace(DEVICE_KERNELS=("scan_kernel",), work=lambda *a: (3.0e6, 8.0e6))
    return SimpleNamespace(prof=SimpleNamespace(events=lambda: events), calls=2, t0=0.0,
                           t1=100e-6, kernels={"scan_sums": kmod},
                           counts={"scan_sums": {"k": 2}}, last={"scan_sums": {"k": ((), {})}},
                           profiling=profiling, before={"syncs": 5, "h2d_pageable": 3},
                           after={"syncs": 19, "h2d_pageable": 9})


def _run(summary, root):
    run = harness.Run(harness.Cell("finite.grid", root=root))
    run.trace = summary
    run.peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}
    return run


def test_accepted_readers_read_alike_with_and_without_spans():
    plain = tracing.Summary(_tracer(_trace(False), None))
    spanned = layers.LayerSummary(_tracer(_trace(True), object()))
    cell = harness.Cell("finite.grid")
    for name in ACCEPTED:
        assert (cell.metric(name).read(_run(spanned, harness.ROOT))
                == cell.metric(name).read(_run(plain, harness.ROOT)))
    assert spanned.breakdown() == plain.breakdown()
    assert spanned.layer_idle == pytest.approx({
        "invert": 20e-6, "engine": 10e-6, "synth": 10e-6, "misfit": 13e-6, "outside": 10e-6})
    assert sum(spanned.layer_idle.values()) == pytest.approx(
        plain.window_s - plain.busy_s)
    assert spanned.counters == {"syncs": 14, "h2d_pageable": 6}
    assert spanned.entry_s == pytest.approx([90e-6])
    new = {name: cell.metric(name).read(_run(spanned, harness.ROOT)) for name in layers.NEW}
    assert new["syncs_per_call.models"] == 7 and new["h2d_pageable_per_call.models"] == 3
    assert new["idle_under.misfit"] == pytest.approx(13.0)


@pytest.mark.parametrize("name", layers.NEW)
def test_new_readers_read_none_without_program_spans(name):
    cell = harness.Cell("finite.grid")
    reader = cell.metric(name)
    assert reader.read(_run(None, harness.ROOT)) is None
    assert reader.read(_run(tracing.Summary(_tracer(_trace(False), None)), harness.ROOT)) is None
    summary = layers.LayerSummary(_tracer(_trace(True), None))  # a program without enable()
    assert summary.layer_idle is None and summary.counters is None
    assert reader.read(_run(summary, harness.ROOT)) is None


def test_program_profiling_needs_enable(monkeypatch):
    from kiwi_tpu_torch import profiling

    assert layers.program_profiling() is profiling
    monkeypatch.delattr(profiling, "enable")
    assert layers.program_profiling() is None


@pytest.mark.cuda
def test_the_layer_tool_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "layers.py"), "--workload",
                          "point.sweep", "--seed", "7", "--seconds", "2", "--sync-debug", "1"],
                         capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(v is not None for v in line["new"].values()), line["new"]
    idle = sum(line["layer_idle_s"].values())
    assert abs(idle - line["window_idle_s"]) <= 0.005 * line["result"]["device"]["window_s"]
    sd = line["sync_debug"]
    assert sd["program_warnings"] == sd["program_syncs"], sd
