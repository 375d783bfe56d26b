"""Seconds from the process's start to the first timed call: torch, the
card, the kernels' libraries, the store, the session and the warm calls
(host clock)."""


def read(run):
    return run.setup_s
