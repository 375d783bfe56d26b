"""Rows the engine discretized through the host pipeline (the FMM oracle:
table calibration, first-use cross-check, host fallback) in the window,
per call: the program's `eik.host_solves` counter, its difference around
each call (drivers/eikonal_grid.py); none where the program lacks it."""


def read(run):
    v = run.field("eik.host_solves")
    return sum(v) / len(v) if v else None
