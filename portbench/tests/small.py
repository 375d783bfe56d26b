"""A small copy of the benchmark for tests on the CPU: the cells of
BENCHMARK.json with 3 receivers, short sweeps and small grids, over a
40 x 20 analytic store around the sources, in a temporary root.  The copy
also holds finite.lm, whose files portbench/ keeps although BENCHMARK.json
leaves the cell out (its runs spread too widely on the chip's host,
PERF.md): a later benchmark PR adds it by entries alone."""

from __future__ import annotations

import functools
import json
import os
import shutil

import numpy as np

from portbench import harness
from portbench.reference import store as rstore

KIWIBENCH_STF = [0, 0, 0, 0, 0, 0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1, 1, 1, 1, 1]
LM_ENTRIES = {
    "workloads": [{"name": "finite.lm", "config": "kiwibench_finite", "traffic": "lm",
                   "chips": 1, "why": "LM inversions"}],
    "end_to_end": [
        {"name": "lm_solve_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["finite.lm"]},
        {"name": "lm_solve_s_p90", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["finite.lm"]}],
}
SMALL_GRID = {"strike": [1.0, 360.0, 90.0], "dip": [57.0, 90.0, 20.0],
              "slip-rake": [124.0, 205.0, 40.0]}


@functools.lru_cache(maxsize=1)
def store():
    return rstore.build(40, 20, 0.1, 100.0, 100.0, 1800.0, 4000.0, (2300.0, 3200.0, 1600.0),
                        np.asarray(KIWIBENCH_STF, np.float64))


def make_root(tmp):
    """Copy portbench/ and BENCHMARK.json under `tmp`, cut to the small
    sizes; returns the root."""
    root = str(tmp)
    pb = os.path.join(root, "portbench")
    shutil.copytree(os.path.join(harness.ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = harness.benchmark()
    if not any(w["name"] == "finite.lm" for w in bench["workloads"]):
        for key, entries in LM_ENTRIES.items():
            bench[key] += entries
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    for name in os.listdir(os.path.join(pb, "configs")):
        path = os.path.join(pb, "configs", name)
        cfg = json.load(open(path))
        cfg["receivers"]["north_m"] = [3000.0, 3500.0, 4000.0]
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(pb, "traffic")):
        path = os.path.join(pb, "traffic", name)
        mix = json.load(open(path))
        if "strikes" in mix:
            mix["strikes"]["count"] = 64
        if "grid" in mix:
            mix["grid"] = SMALL_GRID
        mix["sample"]["calls"] = 2
        json.dump(mix, open(path, "w"))
    return root


def run_cell(root, name, seed=2 ** 31 + 5, seconds=0.5):
    """One CPU run of the cell `name` of `root`: (result, run)."""
    import time

    cell = harness.Cell(name, root=root)
    return harness.execute(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                           store_override=store())
