"""Seismogram and database I/O (port of kiwi_tpu/io; numpy and ctypes, no torch).

Counterpart of seismogram_io.f90 (+ mseed/mseed_simple.c, dummy_sacio) and
gfdb_io_hdf.f90: 2-column ASCII tables, Mini-SEED, SAC binary, and the
reference-compatible HDF5 GF database layout.

Format sniffing by extension mirrors writeseismogram_c
(seismogram_io.f90:83-96): '.sac' -> sac, '.mseed' -> mseed, else table.
"""

from __future__ import annotations

from . import table, mseed, sac  # noqa: F401


def _format_of(filename, fileformat="*"):
    if fileformat != "*":
        return fileformat
    if filename.endswith(".sac"):
        return "sac"
    if filename.endswith(".mseed"):
        return "mseed"
    return "table"


def writeseismogram(filename, fileformat, data, toffset, deltat,
                    network="", station="", location="", channel=""):
    """Write one seismogram component (writeseismogram_c,
    seismogram_io.f90:61-142)."""
    fmt = _format_of(filename, fileformat)
    if fmt == "table":
        table.write(filename, data, toffset, deltat)
    elif fmt == "mseed":
        mseed.write(filename, data, toffset, deltat, network, station, location, channel)
    elif fmt == "sac":
        sac.write(filename, data, toffset, deltat, station=station, channel=channel)
    else:
        raise ValueError(f"unknown seismogram format {fmt!r}")


def readseismogram(filename, fileformat="*"):
    """(data f32[n], toffset, deltat) (readseismogram_c,
    seismogram_io.f90:144-247)."""
    fmt = _format_of(filename, fileformat)
    if fmt == "table":
        return table.read(filename)
    if fmt == "mseed":
        return mseed.read(filename)
    if fmt == "sac":
        return sac.read(filename)
    raise ValueError(f"unknown seismogram format {fmt!r}")
