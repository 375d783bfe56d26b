"""2-column ASCII seismogram tables (seismogram_io.f90:123-140, :231-245)."""

from __future__ import annotations

import numpy as np


def write(filename, data, toffset, deltat):
    data = np.asarray(data)
    t = toffset + np.arange(data.shape[0]) * deltat
    with open(filename, "w") as f:
        for ti, vi in zip(t, data):
            f.write(f"  {float(ti):.10G}  {float(vi):.8G}\n")


def read(filename):
    tab = np.loadtxt(filename, dtype=np.float64, ndmin=2)
    if tab.shape[1] < 2 or tab.shape[0] < 2:
        raise ValueError(f"table file {filename} needs >= 2 columns and rows")
    n = tab.shape[0]
    toffset = float(tab[0, 0])
    deltat = float((tab[-1, 0] - tab[0, 0]) / (n - 1))
    return tab[:, 1].astype(np.float32), toffset, deltat
