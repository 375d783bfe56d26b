"""Run one cell of the kiwi_tpu_torch benchmark once on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic and metrics are named in
BENCHMARK.json at the root of the checkout (portbench/harness.py).  The
last line of standard output is the run's JSON result; the numbers that
decided `correct`, each with its limit, are the last lines of standard
error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
