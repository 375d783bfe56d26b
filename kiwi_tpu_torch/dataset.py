"""Kiwi data-directory conventions and engine setup (port of
kiwi_tpu/dataset.py).

Counterpart of tunguska's standard_setup (inversion.py:118-188) and the
dataset layout produced by its preparation tools (prepare.py):

    <datadir>/source-origin.table   "lat lon time"
    <datadir>/receivers.table       "lat lon [components]" rows
    <datadir>/reference-<i>-<c>.<format>   reference seismograms

(i is the 1-based receiver number, c the component character.)
`standard_setup` configures an Engine on the card unless device="cpu" is
given; `save_dataset` writes such a directory from an engine's state.
"""

from __future__ import annotations

import os

import numpy as np

from .engine import Engine, Receiver
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


def standard_setup(
    datadir,
    store,
    components=None,
    effective_dt=1.0,
    spacial_undersampling=(1, 1),
    crustal_thickness_limit=None,
    constraining_planes=None,
    shifts=None,
    blacklist=None,
    local_interpolation="bilinear",
    source_origin_file="source-origin.table",
    receivers_file="receivers.table",
    ref_seismogram_stem="reference",
    ref_seismogram_format="mseed",
    device="cuda",
):
    """Engine on `device` configured from a kiwi data directory.

    store: a GFStore (or path to one: .npz or reference HDF5 base path).
    """
    if isinstance(store, str):
        if store.endswith(".npz"):
            from .gf.store import GFStore

            store = GFStore.load(store)
        else:
            from .io.gfdb_hdf5 import load_gfdb

            store = load_gfdb(store)

    eng = Engine(store, device=device)
    eng.set_effective_dt(effective_dt)
    eng.set_local_interpolation(local_interpolation == "bilinear")
    eng.set_spacial_undersampling(*spacial_undersampling)

    with open(os.path.join(datadir, source_origin_file)) as f:
        slat, slon, stime = (float(x) for x in f.read().split())
    eng.set_source_location(slat, slon, stime)

    if crustal_thickness_limit is not None:
        eng.set_source_crustal_thickness_limit(crustal_thickness_limit)
    if constraining_planes is not None:
        points = [p for p, _n in constraining_planes]
        normals = [n for _p, n in constraining_planes]
        eng.set_source_constraints(points, normals)

    receivers = load_receivers_table(
        os.path.join(datadir, receivers_file), set_components=components
    )
    if not receivers:
        raise ValueError("no receivers")
    eng.set_receivers(receivers)

    load_ref_seismograms(
        eng, os.path.join(datadir, ref_seismogram_stem), ref_seismogram_format
    )

    if blacklist:
        for irec in blacklist:
            eng.switch_receiver(irec, False)
    if shifts is not None:
        # fnint rounds half away from zero, as the reference's nint does
        # (torch.round would round half to even)
        for irec, s in enumerate(shifts):
            ishift = int(fnint(np.float32(s) / np.float32(store.dt)))
            eng.shift_ref_seismogram(irec, ishift)
    return eng


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


def save_dataset(datadir, engine, which="references", fmt="mseed",
                 stem=None):
    """Write a kiwi data directory from an engine's state (the inverse of
    standard_setup; prepare.py's output conventions)."""
    from .io import writeseismogram

    os.makedirs(datadir, exist_ok=True)
    with open(os.path.join(datadir, "source-origin.table"), "w") as f:
        f.write(f"{engine.src_lat_deg} {engine.src_lon_deg} {engine.ref_time}\n")
    # depth-bearing 5-column form (prepare.py:133-135) whenever any
    # receiver carries a depth or name, so a save/standard_setup round
    # trip preserves the geometry (depth enters the GF lookup)
    rich = any(r.depth or r.name for r in engine.receivers)
    with open(os.path.join(datadir, "receivers.table"), "w") as f:
        for i, r in enumerate(engine.receivers):
            if rich:
                f.write(f"{r.lat_deg:.6f} {r.lon_deg:.6f} {r.depth:.1f} "
                        f"{r.components} {r.name or f'r{i + 1}'}\n")
            else:
                f.write(f"{r.lat_deg:.6f} {r.lon_deg:.6f} {r.components}\n")

    stem = stem or ("reference" if which == "references" else "synthetic")
    dt = engine.store.dt
    layout = engine._rc_layout()
    if which == "references":
        traces = [engine._refs.get(irc) for irc in range(len(layout))]
    else:
        traces = engine.get_synthetic_seismograms()
    for irc, tr in enumerate(traces):
        if tr is None:
            continue
        irec, c = layout[irc]
        values, itmin = tr
        fn = os.path.join(datadir, f"{stem}-{irec + 1}-{c}.{fmt}")
        writeseismogram(fn, fmt, values, engine.ref_time + itmin * dt, dt,
                        station=str(irec + 1), channel=c)
    return datadir
