"""Kiwi data-directory conventions: the receiver table and the reference
seismogram files (port of the parts of kiwi_tpu/dataset.py that the
minimizer protocol reaches; the orchestration around them waits for
ROADMAP.md queue 1, item 9).

    <datadir>/receivers.table       "lat lon [components]" rows
    <datadir>/reference-<i>-<c>.<format>   reference seismograms

(i is the 1-based receiver number, c the component character.)
"""

from __future__ import annotations

import os

import numpy as np

from .engine import Receiver
from .gf.trace import fnint
from .io import readseismogram


def load_receivers_table(path, set_components=None, has_depth=None):
    """receivers.table -> [Receiver] (receiver.py's load_table).

    Accepts both row forms: `lat lon [components [name]]` and the
    depth-bearing form prepare.py writes (`lat lon depth components name`,
    prepare.py:133-135).  has_depth=None auto-detects per row (a component
    string never parses as a float)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            w = line.split()
            depth = 0.0
            name = ""
            comps = set_components or ""
            lat, lon = float(w[0]), float(w[1])
            rest = w[2:]
            hd = has_depth
            if hd is None and rest:
                try:
                    float(rest[0])
                    hd = True
                except ValueError:
                    hd = False
            if hd and rest:
                depth = float(rest[0])
                rest = rest[1:]
            if rest:
                comps = set_components or rest[0]
                rest = rest[1:]
            if rest:
                name = rest[0]
            out.append(Receiver(lat, lon, comps, depth=depth,
                                enabled=bool(comps), name=name))
    return out


def load_ref_seismograms(engine, stem, fmt="mseed", missing_ok=False):
    """Read reference-<i>-<c>.<fmt> into the engine
    (receiver_set_ref_seismogram, receiver.f90:746-801).

    File toffset is the physical time of the FIRST sample (reference
    writers: receiver.f90:647 reftime+(span(1)-1)*dt with 1-based strip
    indices; table format seismogram_io.f90:134).  The engine's itmin is
    0-based (time = itmin*dt, engine.set_ref_seismogram), so the
    conversion is itmin = nint((toffset - ref_time)/dt) -- NO +1 (an
    earlier version copied the Fortran ibeg+1 strip-index idiom here,
    placing externally-timed data one sample late).

    missing_ok=False raises on absent files for enabled receivers (the
    reference errors there too, receiver.f90:768-774): an enabled
    receiver with no reference would otherwise be silently misfit
    against zero.  missing_ok=True returns the missing list instead.
    """
    dt = engine.store.dt
    missing = []
    for irec, rec in enumerate(engine.receivers):
        if not rec.enabled:
            continue
        for c in rec.components:
            fn = f"{stem}-{irec + 1}-{c}.{fmt}"
            if not os.path.exists(fn):
                missing.append(fn)
                continue
            data, toffset, deltat = readseismogram(fn, fmt)
            if abs(deltat - dt) > dt / 10000.0:
                raise ValueError(f"sampling rate {deltat} in {fn}; need {dt}")
            rel = toffset - engine.ref_time
            if abs(rel) > 3600.0 * 24 * 7:
                raise ValueError(f"start time vs origin differ by > 7 days: {fn}")
            itmin = int(fnint(np.float32(rel) / np.float32(dt)))
            engine.set_ref_seismogram(irec, c, data, itmin)
    if missing and not missing_ok:
        raise FileNotFoundError(
            "reference seismograms missing for enabled receivers: "
            + ", ".join(missing))
    return missing
