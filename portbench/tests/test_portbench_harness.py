"""The harness on the CPU at small sizes (no card): every cell of
BENCHMARK.json runs and comes out correct; a cell, configuration, traffic
mix and metric are added by new files and BENCHMARK.json entries alone; a
dry run loads no JAX and no kiwi_tpu; the timed path broken underneath
turns `correct` false, and so does the TF32 control in the program's
place.  One test, marked cuda, runs a cell on the card."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.tests import small

CELLS = sorted({w["name"] for w in harness.benchmark()["workloads"]} | {"finite.lm"})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.make_root(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(root, name):
    result, run = small.run_cell(root, name)
    assert result["correct"], result
    assert result["attempted"] == len(run.records) > 0 and result["failed"] == 0
    cell = harness.Cell(name, root=root)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def digest(top):
    out = {}
    for dirpath, _dirs, files in os.walk(top):
        for f in files:
            if "__pycache__" not in dirpath:
                path = os.path.join(dirpath, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_is_added_by_files_alone(root):
    pb = os.path.join(root, "portbench")
    before = digest(pb)
    cfg = json.load(open(os.path.join(pb, "configs", "kiwibench_finite.json")))
    cfg["receivers"]["north_m"] = [3200.0, 3700.0]
    json.dump(cfg, open(os.path.join(pb, "configs", "throwaway_config.json"), "w"))
    mix = json.load(open(os.path.join(pb, "traffic", "grid.json")))
    mix["grid"] = {"strike": [10.0, 360.0, 120.0], "dip": [60.0, 90.0, 15.0],
                   "slip-rake": [150.0, 180.0, 20.0]}
    json.dump(mix, open(os.path.join(pb, "traffic", "throwaway_mix.json"), "w"))
    with open(os.path.join(pb, "metrics", "throwaway_calls_per_s.py"), "w") as f:
        f.write("def read(run):\n    return len(run.records) / run.window_s\n")
    json.dump({"max_gap": 1e-5}, open(os.path.join(pb, "limits", "throwaway.cell.json"), "w"))
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(bench_path))
    bench["configs"].append({"name": "throwaway_config", "source": "a test",
                             "file": "portbench/configs/throwaway_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway_config",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "throwaway_calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["throwaway.cell"]})
    next(m for m in bench["end_to_end"] if m["name"] == "models_per_s")["workloads"].append(
        "throwaway.cell")
    json.dump(bench, open(bench_path, "w"))
    after = digest(pb)
    assert all(after[k] == v for k, v in before.items())  # no file of portbench/ edited
    result, _run = small.run_cell(root, "throwaway.cell")
    assert result["correct"], result
    assert {"throwaway_calls_per_s", "models_per_s", "setup_s"} == set(result["metrics"])


def test_a_dry_run_loads_no_jax_and_no_kiwi_tpu(root):
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);\n"
        "from portbench import harness; from portbench.tests import small\n"
        "for name in sys.argv[3:]:\n"
        "    small.run_cell(sys.argv[2], name, seconds=0.2)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT, root, *CELLS],
                         capture_output=True, text=True, check=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _scale_output(module, attr, factor):
    orig = getattr(module, attr)

    def broken(*args, **kwargs):
        return orig(*args, **kwargs) * factor
    return broken


def _half_batch(engine_cls):
    orig = engine_cls.misfits_for_source_batch

    def broken(self, pb):
        m, n, fs = orig(self, pb)
        if m.shape[0] < 2:
            return m, n, fs
        h = m.shape[0] // 2
        m = m.clone()
        m[h:] = m[:h].mean(dim=0)  # the rest left out, the mean of the first half in its place
        return m, n, fs
    return broken


def _unchanged_state(_fcn, x0, *args, **kwargs):
    return np.asarray(x0, np.float64), None, 1, 1


FAULTS = {
    "point.sweep": ["answer_altered"],
    "finite.grid": ["answer_altered", "half_batch"],
    "finite.grid_bandpass": ["answer_altered", "half_batch"],
    "finite.lm": ["answer_altered", "unchanged_state"],
}


@pytest.mark.parametrize("name,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    from kiwi_tpu_torch import engine, misfit
    from kiwi_tpu_torch.invert import lmdif
    from kiwi_tpu_torch.ops import synth_window

    if fault == "answer_altered" and name == "point.sweep":
        # the fused kernel's sums 0.1% off where the kernel produces them
        monkeypatch.setattr(misfit, "fused_scan_sums",
                            _scale_output(misfit, "fused_scan_sums", 1.001))
    elif fault == "answer_altered":
        # the window kernel's synthetics 0.1% off where it produces them
        monkeypatch.setattr(synth_window, "window_forward",
                            _scale_output(synth_window, "window_forward", 1.001))
    elif fault == "half_batch":
        monkeypatch.setattr(engine.Engine, "misfits_for_source_batch",
                            _half_batch(engine.Engine))
    elif fault == "unchanged_state":
        monkeypatch.setattr(lmdif, "lmdif", _unchanged_state)
    result, _run = small.run_cell(root, name)
    assert not result["correct"], result


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(root, name):
    from portbench import control

    cell = harness.Cell(name, root=root)
    program, ctl, _calls = control.readings(cell, 2 ** 31 + 9, 0.3, device="cpu",
                                            store=small.store())
    assert all(v <= cell.limits[k] for k, v in program.items())
    assert any(v > cell.limits[k] for k, v in ctl.items()), ctl


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                          "point.sweep", "--seed", "7", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
