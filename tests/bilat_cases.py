"""Seeded parameter rows of the bilateral source for the tables kernel's
tests (no JAX: the card tests import this too).

`case(name)` gives (rows f32[B, 14], grid shape at effective_dt EDT); every
row of a case has that shape.  The cases: the benchmark's point sweep
(14,440 strikes around fresh nodes) and finite grid chunks (512 and 440
rows, dip exactly 90 and 90.0008 among them), then the edges of the
discretization: length_a != length_b with a rupture rake, the rise time
below the subfault duration, no length (nx 1), no width (ny 1), nt at its
floor of 2, a source of no duration at all, and LM's calls of 1 and 4 rows.
"""

import numpy as np

EDT = 0.1
POINT = (0.0, 0.0, 0.0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0, 2500.0, 0.2)
FAULT = (0.0, 0.0, 0.0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 900.0, 700.0, 1000.0, 2500.0,
         0.2)

# name -> (base row, B, shape, {column: (low, high)} drawn per row)
CASES = {
    # point.sweep: strikes 0.025 deg apart, each row on its own node
    "sweep": (POINT, 14440, (1, 1, 3), {6: (30.0, 89.0), 7: (-180.0, 180.0),
                                        3: (5000.0, 5180.0)}),
    # finite.grid's chunks over its strikes, dips and slip-rakes
    "grid512": (FAULT, 512, (13, 5, 3), {5: (1.0, 360.0), 6: (57.0, 90.0), 7: (124.0, 205.0)}),
    "grid440": (FAULT, 440, (13, 5, 3), {5: (1.0, 360.0), 6: (57.0, 90.0), 7: (124.0, 205.0)}),
    "rupture_rake": (FAULT, 300, (13, 5, 3), {5: (0.0, 360.0), 6: (0.0, 90.0),
                                              8: (-180.0, 180.0), 0: (-2.0, 2.0)}),
    "risetime_below_dursf": (FAULT[:13] + (0.01,), 300, (13, 5, 2),
                             {5: (0.0, 360.0), 7: (-180.0, 180.0)}),
    "no_length": (FAULT[:9] + (0.0, 0.0) + FAULT[11:], 300, (1, 5, 3),
                  {5: (0.0, 360.0), 6: (0.0, 90.0), 8: (-90.0, 90.0)}),
    "no_width": (FAULT[:11] + (0.0,) + FAULT[12:], 300, (13, 1, 3),
                 {5: (0.0, 360.0), 6: (0.0, 90.0), 8: (-90.0, 90.0)}),
    "nt_floor": (FAULT[:9] + (60.0, 40.0, 100.0, 2500.0, 0.01), 300, (2, 2, 2),
                 {5: (0.0, 360.0), 6: (0.0, 90.0), 1: (-500.0, 500.0), 2: (-500.0, 500.0)}),
    "no_duration": (POINT[:13] + (0.0,), 64, (1, 1, 2), {5: (0.0, 360.0), 6: (0.0, 90.0)}),
    "lm1": (FAULT, 1, (13, 5, 3), {5: (86.0, 96.0), 6: (83.0, 90.0), 7: (158.0, 170.0)}),
    "lm4": (FAULT, 4, (13, 5, 3), {5: (86.0, 96.0), 6: (83.0, 90.0), 7: (158.0, 170.0)}),
}


def case(name, seed=0):
    """(rows f32[B, 14], shape) of case `name`."""
    base, B, shape, ranges = CASES[name]
    rng = np.random.default_rng([seed, sum(name.encode())])
    rows = np.tile(np.asarray(base, np.float32), (B, 1))
    for col, (lo, hi) in ranges.items():
        rows[:, col] = rng.uniform(lo, hi, B)
    if name == "sweep":
        rows[:, 5] = rng.uniform(0.0, 5.0) + 0.025 * np.arange(B)
    if name.startswith("grid"):
        rows[:3, 6] = (90.0, 90.0008, 90.0)  # vertical faults, one just past 90
    return rows.astype(np.float32), shape
