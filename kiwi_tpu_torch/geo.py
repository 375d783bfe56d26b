"""Geodesy constants and host helpers (port of the parts of kiwi_tpu/geo.py
that the point-sweep slice uses).

Everything here is float64 numpy, as in the reference (real*8 geodesy);
the per-centroid differential geodesy on the device lives in synth.py.
"""

from __future__ import annotations

import numpy as np

# orthodrome.f90:21-25 (constants.f90)
EARTHRADIUS = 6371.0 * 1000.0
EARTHRADIUS_EQUATOR = 6378.14 * 1000.0
EARTH_OBLATENESS = 1.0 / 298.257223563  # WGS84


def ne_to_latlon(lat0, lon0, north, east):
    """Move (north, east) meters from (lat0, lon0) [radians]; returns
    (lat, lon) in radians.  Exact spherical formulation, used to place
    receivers (pyrocko.orthodrome.ne_to_latlon in benchmark/kiwibench.py)."""
    a = np.sqrt(north**2 + east**2) / EARTHRADIUS
    gamma = np.arctan2(east, north)

    # spherical triangle from the north pole
    b = np.pi / 2.0 - lat0
    c = np.arccos(
        np.clip(np.cos(a) * np.cos(b) + np.sin(a) * np.sin(b) * np.cos(gamma), -1, 1)
    )
    lat = np.pi / 2.0 - c
    sinc = np.sin(c)
    safe_sinc = np.where(sinc == 0.0, 1.0, sinc)
    dlon = np.arcsin(np.clip(np.sin(a) * np.sin(gamma) / safe_sinc, -1.0, 1.0))
    # quadrant fix when moving past the pole
    dlon = np.where(
        np.cos(a) - np.cos(b) * np.cos(c) < 0,
        np.where(dlon > 0, np.pi - dlon, -np.pi - dlon),
        dlon,
    )
    lon = lon0 + dlon
    return lat, lon
