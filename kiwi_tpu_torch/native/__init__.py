"""Native (C++) seismogram codecs: MiniSEED (mseed.cc, the native twin of
io/mseed.py, replacing the reference's libmseed shim mseed/mseed_simple.c)
and SAC (sac.cc, the twin of io/sac.py).

The library is built with g++ at first use into
`build/kiwi_tpu_torch/libkiwinative-<hash>.so` beside the package (never
into the package directory), keyed by a hash of the sources and the flags,
so an edited source rebuilds; `python -m kiwi_tpu_torch.native` builds it
ahead of time.  When g++ or the sources are missing (the sources ship as
package data) or the build fails, get_lib() returns None and io/ uses its
pure-Python codecs, which write the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "kiwi_tpu_torch"
_SOURCES = ("mseed.cc", "sac.cc")
_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_lib = None
_tried = False


def library_path():
    """Where the build of the current sources and flags lives, or None when
    the sources are not there (an install without them)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    try:
        for src in _SOURCES:
            h.update((_DIR / src).read_bytes())
    except OSError:
        return None
    return BUILD_DIR / f"libkiwinative-{h.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile the native library unless this build exists; returns its path."""
    so = library_path()
    if so is None:
        raise RuntimeError(f"native codec sources {_SOURCES} are missing from {_DIR}")
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed:\n{res.stderr}")
    os.replace(tmp, so)
    if verbose:
        print(f"built {so}", file=sys.stderr)
    return so


def get_lib(auto_build=True):
    """ctypes handle to the native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    so = library_path()
    if so is None or (_tried and not so.exists()):
        return None
    _tried = True
    if not so.exists():
        if not auto_build:
            return None
        try:
            build()
        except (OSError, RuntimeError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.kiwi_mseed_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.kiwi_mseed_write.restype = ctypes.c_int
    lib.kiwi_mseed_nsamples.argtypes = [ctypes.c_char_p]
    lib.kiwi_mseed_nsamples.restype = ctypes.c_int
    lib.kiwi_mseed_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.kiwi_mseed_read.restype = ctypes.c_int
    lib.kiwi_sac_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.kiwi_sac_write.restype = ctypes.c_int
    lib.kiwi_sac_nsamples.argtypes = [ctypes.c_char_p]
    lib.kiwi_sac_nsamples.restype = ctypes.c_int
    lib.kiwi_sac_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.kiwi_sac_read.restype = ctypes.c_int
    _lib = lib
    return _lib


def mseed_write(filename, data, toffset, deltat, network="", station="",
                location="", channel=""):
    """C++ MiniSEED writer; returns False when the native lib is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float32)
    rc = lib.kiwi_mseed_write(
        filename.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0], float(toffset), float(deltat),
        network.encode(), station.encode(), location.encode(), channel.encode(),
    )
    if rc != 0:
        raise IOError(f"kiwi_mseed_write failed ({rc}) for {filename}")
    return True


def mseed_read(filename):
    """C++ MiniSEED reader; returns None when the native lib is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n = lib.kiwi_mseed_nsamples(filename.encode())
    if n < 0:
        raise IOError(f"kiwi_mseed_read failed ({n}) for {filename}")
    out = np.empty(n, dtype=np.float32)
    toffset = ctypes.c_double()
    deltat = ctypes.c_double()
    rc = lib.kiwi_mseed_read(
        filename.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(toffset), ctypes.byref(deltat),
    )
    if rc < 0:
        raise IOError(f"kiwi_mseed_read failed ({rc}) for {filename}")
    return out, toffset.value, deltat.value


def sac_write(filename, data, toffset, deltat, station="", channel=""):
    """C++ SAC writer; returns False when the native lib is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float32)
    rc = lib.kiwi_sac_write(
        filename.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0], float(toffset), float(deltat),
        station.encode(), channel.encode(),
    )
    if rc != 0:
        raise IOError(f"kiwi_sac_write failed ({rc}) for {filename}")
    return True


def sac_read(filename):
    """C++ SAC reader; returns None when the native lib is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n = lib.kiwi_sac_nsamples(filename.encode())
    if n < 0:
        raise IOError(f"kiwi_sac_read failed ({n}) for {filename}")
    out = np.empty(max(n, 1), dtype=np.float32)
    toffset = ctypes.c_double()
    deltat = ctypes.c_double()
    rc = lib.kiwi_sac_read(
        filename.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(toffset), ctypes.byref(deltat),
    )
    if rc < 0:
        raise IOError(f"kiwi_sac_read failed ({rc}) for {filename}")
    return out[:n], toffset.value, deltat.value
