"""The readings that set a cell's limits: the program's numbers on many
seeds and the lower-precision control's in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, in one process: the cell's set-up and a closed-loop window
of --seconds (short: it need only finish the mix's calls and keep as many
answers as a run keeps), then the sampled answers against the plain
reference, twice: as the program gave them, and as the reference computed
at TF32 (the contraction's operands rounded to 10 mantissa bits) gives
them in the program's place.  One JSON line per seed.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def readings(cell, seed, seconds, device="cuda", store=None):
    """(the program's numbers, the control's) of one seed."""
    import torch

    from portbench.reference import store as rstore

    cfg = cell.session()
    if store is None:
        store, _ = rstore.cached(cfg["store"], harness.CACHE)
    drv = cell.driver().Driver(cfg, cell.mix, store, seed, device)
    drv.warm()
    run = harness.Run(cell)
    harness.run_window(run, drv, seconds, 0, None)
    answers = drv.answers(harness.rng_for(seed, "sample"))
    drv.close()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = drv.reference()
    program = drv.compare(ref, answers)
    control = drv.compare(ref, answers, control=drv.reference("tf32"))
    return program, control, len(run.records)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    harness.environment()
    cell = harness.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        program, control, calls = readings(cell, seed, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed, "calls": calls,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t0}), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"control: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
