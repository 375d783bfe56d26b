"""SAC binary waveform files (single component, evenly sampled).

Replaces the reference's libsacio dependency (dummy_sacio/sacio.c is a stub
that aborts; real deployments linked Fortran libsacio).  Implements the
standard SAC binary layout: 70 float words, 40 int words, 192 bytes of
8/16-char strings, then float32 data.  Only the wsac1/rsac1 subset the
reference uses (begin time + delta + data) plus station/channel names.
"""

from __future__ import annotations

import struct

import numpy as np

_UNDEF_F = -12345.0
_UNDEF_I = -12345
_NVHDR = 6
_ITIME = 1  # iftype: time series
_HDR_BYTES = 70 * 4 + 40 * 4 + 192


def write(filename, data, toffset, deltat, station="", channel="", endian="<"):
    """SAC writer: the C++ codec when available (native/sac.cc), else the
    pure-Python one -- both produce identical bytes."""
    if endian == "<":
        from ..native import sac_write

        try:
            if sac_write(filename, np.asarray(data, np.float32), toffset,
                         deltat, station=station, channel=channel):
                return
        except OSError:
            pass  # fall through to the pure-Python writer
    write_py(filename, data, toffset, deltat, station=station,
             channel=channel, endian=endian)


def write_py(filename, data, toffset, deltat, station="", channel="", endian="<"):
    """Pure-Python SAC writer (fallback + cross-check for the C++ codec)."""
    data = np.asarray(data, dtype=np.float32)
    f = np.full(70, _UNDEF_F, dtype=np.float64)
    i = np.full(40, _UNDEF_I, dtype=np.int64)
    f[0] = deltat  # delta
    f[1] = float(data.min()) if data.size else 0.0  # depmin
    f[2] = float(data.max()) if data.size else 0.0  # depmax
    f[5] = toffset  # b
    f[6] = toffset + deltat * (len(data) - 1)  # e
    i[6] = _NVHDR  # nvhdr
    i[9] = len(data)  # npts
    i[15] = _ITIME  # iftype
    i[35] = 1  # leven
    strings = bytearray(b" " * 192)
    strings[0:8] = station[:8].ljust(8).encode()  # kstnm
    strings[160:168] = channel[:8].ljust(8).encode()  # kcmpnm

    with open(filename, "wb") as fh:
        fh.write(np.asarray(f, dtype=f"{endian}f4").tobytes())
        fh.write(np.asarray(i, dtype=f"{endian}i4").tobytes())
        fh.write(bytes(strings))
        fh.write(data.astype(f"{endian}f4").tobytes())


def read(filename):
    """(data f32[n], toffset, deltat); auto-detects byte order via nvhdr."""
    from ..native import sac_read

    try:
        r = sac_read(filename)
        if r is not None:
            return r
    except OSError:
        pass  # fall through to the pure-Python reader
    return read_py(filename)


def read_py(filename):
    """Pure-Python SAC reader (fallback + cross-check for the C++ codec)."""
    with open(filename, "rb") as fh:
        blob = fh.read()
    if len(blob) < _HDR_BYTES:
        raise ValueError(f"{filename}: too short for a SAC file")
    for endian in ("<", ">"):
        nvhdr = struct.unpack(f"{endian}i", blob[70 * 4 + 6 * 4 : 70 * 4 + 7 * 4])[0]
        if 1 <= nvhdr <= 10:
            break
    else:
        raise ValueError(f"{filename}: not a SAC file (bad nvhdr)")
    f = np.frombuffer(blob[: 70 * 4], dtype=f"{endian}f4")
    i = np.frombuffer(blob[70 * 4 : 70 * 4 + 40 * 4], dtype=f"{endian}i4")
    npts = int(i[9])
    deltat = float(f[0])
    toffset = float(f[5])
    data = np.frombuffer(
        blob[_HDR_BYTES : _HDR_BYTES + npts * 4], dtype=f"{endian}f4"
    ).astype(np.float32)
    if data.shape[0] != npts:
        raise ValueError(f"{filename}: truncated SAC data section")
    return data, toffset, deltat
