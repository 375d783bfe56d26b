"""Geodesy on the sphere / WGS84 spheroid (port of kiwi_tpu/geo.py).

Functional equivalents of the reference's orthodrome module
(orthodrome.f90): azimuth/backazimuth/arc distance on a sphere, spheroid
distance accurate to ~50 m, and the differential azimuth/distance formula
used to locate subfault centroids relative to a receiver.  All angles and
coordinates in radians, distances in meters.

Everything here is float64 numpy, as in the reference (real*8 geodesy;
the JAX package runs the same formulas in jnp under x64).  The
per-centroid differential geodesy on the device lives in synth.py.
"""

from __future__ import annotations

import numpy as np

# orthodrome.f90:21-25 (constants.f90)
EARTHRADIUS = 6371.0 * 1000.0
EARTHRADIUS_EQUATOR = 6378.14 * 1000.0
EARTH_OBLATENESS = 1.0 / 298.257223563  # WGS84
PI = np.pi


def _f64(*xs):
    return [np.asarray(x, dtype=np.float64) for x in xs]


def _clip(x, mi, ma):
    return np.minimum(np.maximum(mi, x), ma)


def wrap(x, mi, ma):
    """Wrap x into [mi, ma) (orthodrome.f90:166-170)."""
    (x,) = _f64(x)
    return x - np.floor((x - mi) / (ma - mi)) * (ma - mi)


def cosdelta(alat, alon, blat, blon):
    """Cosine of arc distance between two points (orthodrome.f90:285-294)."""
    alat, alon, blat, blon = _f64(alat, alon, blat, blon)
    return np.sin(alat) * np.sin(blat) + np.cos(alat) * np.cos(blat) * np.cos(
        blon - alon
    )


def azimuth(alat, alon, blat, blon):
    """Azimuth of point b as seen from a, in ]-pi, pi] (orthodrome.f90:231-243)."""
    alat, alon, blat, blon = _f64(alat, alon, blat, blon)
    return np.arctan2(
        np.cos(alat) * np.cos(blat) * np.sin(blon - alon),
        np.sin(blat) - np.sin(alat) * cosdelta(alat, alon, blat, blon),
    )


def azibazi(alat, alon, blat, blon):
    """Azimuth and backazimuth between points a, b (orthodrome.f90:245-265)."""
    alat, alon, blat, blon = _f64(alat, alon, blat, blon)
    t = np.cos(alat) * np.cos(blat) * np.sin(blon - alon)
    sa = np.sin(alat)
    sb = np.sin(blat)
    cd = cosdelta(alat, alon, blat, blon)
    azi = np.arctan2(t, sb - sa * cd)
    bazi = np.arctan2(-t, sa - sb * cd)
    return azi, bazi


def arcdistance(alat, alon, blat, blon):
    """Arc distance in radians (orthodrome.f90:172-182)."""
    return np.arccos(_clip(cosdelta(alat, alon, blat, blon), -1.0, 1.0))


def distance(alat, alon, blat, blon):
    """Spherical distance in meters (orthodrome.f90:184-191)."""
    return arcdistance(alat, alon, blat, blon) * EARTHRADIUS


def distance_accurate50m(alat, alon, blat, blon):
    """Spheroid (WGS84) distance in meters, accurate to ~50 m.

    Meeus' algorithm as in orthodrome.f90:193-229.
    """
    alat, alon, blat, blon = _f64(alat, alon, blat, blon)
    f = (alat + blat) / 2.0
    g = (alat - blat) / 2.0
    ll = (alon - blon) / 2.0

    s = np.sin(g) ** 2 * np.cos(ll) ** 2 + np.cos(f) ** 2 * np.sin(ll) ** 2
    c = np.cos(g) ** 2 * np.cos(ll) ** 2 + np.sin(f) ** 2 * np.sin(ll) ** 2

    w = np.arctan(np.sqrt(s / c))
    r = np.sqrt(s * c) / w
    d = 2.0 * w * EARTHRADIUS_EQUATOR
    h1 = (3.0 * r - 1.0) / (2.0 * c)
    h2 = (3.0 * r + 1.0) / (2.0 * s)

    return d * (
        1.0
        + EARTH_OBLATENESS * h1 * np.sin(f) ** 2 * np.cos(g) ** 2
        - EARTH_OBLATENESS * h2 * np.cos(f) ** 2 * np.sin(g) ** 2
    )


def azidist(alat, alon, blat, blon):
    """Azimuth and arc distance in one shot (orthodrome.f90:267-283)."""
    alat, alon, blat, blon = _f64(alat, alon, blat, blon)
    cd = cosdelta(alat, alon, blat, blon)
    azi = np.arctan2(
        np.cos(alat) * np.cos(blat) * np.sin(blon - alon),
        np.sin(blat) - np.sin(alat) * cd,
    )
    return azi, np.arccos(_clip(cd, -1.0, 1.0))


def approx_differential_azidist(delta_x, delta_y, azi, bazi, dist):
    """Azimuth/backazimuth/distance to a receiver from a point displaced by
    cartesian (delta_x north, delta_y east) meters from the reference point.

    Exact spherical-earth formulas; the reference's flat-geometry and
    constant-azimuth shortcuts are disabled by its own parameters
    (orthodrome.f90:67-72), so only the exact branch
    (orthodrome.f90:121-152) is reproduced.

    All of azi/bazi/dist refer to the *reference* point; returns
    (new_azi, new_bazi, new_dist) as seen from the displaced point.
    """
    delta_x, delta_y, azi, bazi, dist = _f64(delta_x, delta_y, azi, bazi, dist)
    r = np.sqrt(delta_x**2 + delta_y**2)
    a = r / EARTHRADIUS
    b = dist / EARTHRADIUS
    lam = np.arctan2(delta_y, delta_x)
    gamma = azi - lam

    sc = np.sin(a) * np.sin(b)
    c = np.arccos(_clip(np.cos(a) * np.cos(b) + sc * np.cos(gamma), -1.0, 1.0))
    sinc = np.sin(c)
    # Guard r == 0: alpha=0, beta=0, c=b exactly.  sin(c) can be 0 only when
    # the displaced point coincides with the receiver (degenerate).
    safe_sinc = np.where(sinc == 0.0, 1.0, sinc)
    alpha = np.arcsin(_clip(np.sin(a) * np.sin(gamma) / safe_sinc, -1.0, 1.0))
    beta = np.arcsin(_clip(np.sin(b) * np.sin(gamma) / safe_sinc, -1.0, 1.0))

    # put alpha and beta into the correct quadrant (orthodrome.f90:132-146)
    alpha = np.where(
        np.cos(a) - np.cos(b) * np.cos(c) < 0,
        np.where(alpha > 0, PI - alpha, -PI - alpha),
        alpha,
    )
    beta = np.where(
        np.cos(b) - np.cos(a) * np.cos(c) < 0,
        np.where(beta > 0, PI - beta, -PI - beta),
        beta,
    )

    new_dist = c * EARTHRADIUS
    new_bazi = wrap(bazi + alpha, -PI, PI)
    new_azi = wrap(lam - PI - beta, -PI, PI)

    is_zero = r == 0.0
    new_azi = np.where(is_zero, azi, new_azi)
    new_bazi = np.where(is_zero, bazi, new_bazi)
    new_dist = np.where(is_zero, dist, new_dist)
    return new_azi, new_bazi, new_dist


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


def d2r(deg):
    """Degrees to radians as the reference does it (orthodrome.f90:296-341)."""
    return np.asarray(deg, dtype=np.float64) * (2.0 / 360.0) * np.pi


def r2d(rad):
    return np.asarray(rad, dtype=np.float64) * 360.0 / 2.0 / np.pi
