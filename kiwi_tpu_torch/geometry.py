"""Half-spaces, circles, polygons (host numpy).

Counterpart of geometry.f90: used by the eikonal source models to build the
rupture boundary (circle polygon trimmed by constraint half-spaces) and to
project nucleation points.  Host-side: this runs at discretization-planning
time, once per source shape bucket.

A half-space is (point, normal); a point is inside when the normal points
away from it: dot(normal, point_hs - p) >= 0 (geometry.f90:57-71).
Polygons are float32 arrays [N, 3] (the reference works in single
precision).
"""

from __future__ import annotations

import numpy as np


def point_in_halfspace(p, hs_point, hs_normal):
    return float(np.dot(hs_normal, np.asarray(hs_point) - np.asarray(p))) >= 0.0


def point_in_constraints(p, constraints):
    """constraints: iterable of (point, normal)."""
    return all(point_in_halfspace(p, hp, hn) for hp, hn in constraints)


def piercing_point(a, b, hs_point, hs_normal):
    """Piercing point of segment ab with the half-space boundary
    (get_piercingpoint, geometry.f90:73-121).

    Returns (point, between_ab, parallel, a_inside, b_inside).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    hs_point = np.asarray(hs_point, dtype=np.float64)
    hs_normal = np.asarray(hs_normal, dtype=np.float64)
    ab = b - a
    la = float(np.dot(hs_normal, hs_point - a))
    lb = float(np.dot(hs_normal, hs_point - b))
    lab = float(np.dot(hs_normal, ab))

    a_inside = la >= 0.0
    b_inside = lb >= 0.0
    between = a_inside != b_inside
    # single-precision parallelism threshold as in the reference (:102)
    parallel = lab * lab < float(np.dot(ab, ab)) / 2**24

    if parallel and between:
        return (a if abs(la) <= abs(lb) else b), between, parallel, a_inside, b_inside
    if parallel:
        return np.zeros(3), between, parallel, a_inside, b_inside
    return a + ab * la / lab, between, parallel, a_inside, b_inside


def circle_to_polygon(center, transform, npoints):
    """Polygon approximating a transformed unit circle
    (circle_to_polygon, geometry.f90:173-191)."""
    i = np.arange(1, npoints + 1)
    ang = i * 2.0 * np.pi / npoints
    pts = np.stack([np.cos(ang), np.sin(ang), np.zeros(npoints)], axis=0)
    return (np.asarray(transform) @ pts).T + np.asarray(center)


def trim_polygon(points, hs_point, hs_normal):
    """Cut off the polygon parts outside one half-space
    (trim_polygon_one, geometry.f90:193-236).

    Vectorized Sutherland-Hodgman pass: all edges evaluated at once (the
    per-edge piercing_point loop cost ~2.5 ms per 180-gon and dominated
    batched eikonal discretization); semantics identical to the scalar
    piercing_point per edge, including the reference's single-precision
    parallelism threshold."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n == 0:
        return points.reshape(-1, 3)
    hs_point = np.asarray(hs_point, dtype=np.float64)
    hs_normal = np.asarray(hs_normal, dtype=np.float64)
    a = points
    b = points[(np.arange(n) + 1) % n]
    ab = b - a
    la = (hs_point - a) @ hs_normal
    lb = (hs_point - b) @ hs_normal
    lab = ab @ hs_normal
    a_in = la >= 0.0
    pierce = a_in != (lb >= 0.0)
    parallel = lab * lab < (ab * ab).sum(axis=-1) / 2**24
    pp = a + ab * (la / np.where(lab == 0.0, 1.0, lab))[:, None]
    pp_par = np.where((np.abs(la) <= np.abs(lb))[:, None], a, b)
    pp = np.where((parallel & pierce)[:, None], pp_par, pp)

    cnt = a_in.astype(np.int64) + pierce.astype(np.int64)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    out = np.empty((int(cnt.sum()), 3))
    out[off[a_in]] = a[a_in]
    out[(off + a_in)[pierce]] = pp[pierce]
    return out


def trim_polygon_multi(points, constraints):
    """(trim_polygon_more, geometry.f90:238-255)."""
    for hp, hn in constraints:
        points = trim_polygon(points, hp, hn)
        if points.shape[0] == 0:
            break
    return points


def trim_polygon_batch(points, counts, hs_point, hs_normal):
    """One Sutherland-Hodgman pass over a BATCH of polygons.

    points: f64[B, N, 3] with per-row valid-prefix lengths counts[B];
    per-row semantics identical to `trim_polygon` (same edge math in the
    same f64 operation order, vertex order preserved), so the results are
    bit-identical to looping trim_polygon over the batch.  Returns
    (out f64[B, N+2, 3], counts' i64[B]); rows beyond a polygon's count
    repeat its first vertex (harmless to bounding boxes); emptied
    polygons (count 0) stay zero.
    """
    points = np.asarray(points, dtype=np.float64)
    B, N, _ = points.shape
    hs_point = np.asarray(hs_point, dtype=np.float64)
    hs_normal = np.asarray(hs_normal, dtype=np.float64)
    idx = np.arange(N)[None, :]
    valid = idx < counts[:, None]
    nxt = np.where(idx + 1 < counts[:, None], idx + 1, 0)
    a = points
    b = np.take_along_axis(points, nxt[..., None], axis=1)
    ab = b - a
    la = (hs_point[None, None, :] - a) @ hs_normal
    lb = (hs_point[None, None, :] - b) @ hs_normal
    lab = ab @ hs_normal
    a_in = (la >= 0.0) & valid
    pierce = ((la >= 0.0) != (lb >= 0.0)) & valid
    parallel = lab * lab < (ab * ab).sum(axis=-1) / 2**24
    pp = a + ab * (la / np.where(lab == 0.0, 1.0, lab))[..., None]
    pp_par = np.where((np.abs(la) <= np.abs(lb))[..., None], a, b)
    pp = np.where((parallel & pierce)[..., None], pp_par, pp)

    cnt = a_in.astype(np.int64) + pierce.astype(np.int64)
    off = np.cumsum(cnt, axis=1) - cnt
    out = np.zeros((B, N + 2, 3))
    bi, ei = np.nonzero(a_in)
    out[bi, off[bi, ei]] = a[bi, ei]
    bj, ej = np.nonzero(pierce)
    out[bj, off[bj, ej] + a_in[bj, ej]] = pp[bj, ej]
    new_counts = cnt.sum(axis=1)
    pad = (np.arange(N + 2)[None, :] >= new_counts[:, None])[..., None]
    out = np.where(pad & (new_counts[:, None, None] > 0), out[:, 0:1, :], out)
    return out, new_counts


def polygon_box(points):
    return points.min(axis=0), points.max(axis=0)


def polygon_area(points):
    """Area of a planar 3D polygon via projected shoelace sums
    (polygon_area, geometry.f90:278-310)."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n <= 2:
        return 0.0
    j = (np.arange(n) + 1) % n
    p = points
    q = points[j]
    area_xy = np.sum((p[:, 0] - q[:, 0]) * (p[:, 1] + q[:, 1]) * 0.5)
    area_yz = np.sum((p[:, 1] - q[:, 1]) * (p[:, 2] + q[:, 2]) * 0.5)
    area_zx = np.sum((p[:, 2] - q[:, 2]) * (p[:, 0] + q[:, 0]) * 0.5)
    return float(np.sqrt(area_xy**2 + area_yz**2 + area_zx**2))


def nearest_point_on_polygon(points, p):
    """Closest point on the polygon outline to p
    (nearest_point_on_polygon, geometry.f90:123-165)."""
    points = np.asarray(points, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    n = points.shape[0]
    if n == 0:
        return p
    best = points[0]
    bestd = np.inf
    if n == 1:
        return points[0]
    for i in range(n):
        j = (i + 1) % n
        # half-space through p with normal along the edge: its boundary
        # crossing with the edge is the perpendicular foot
        pp, pierce, _par, _a, _b = piercing_point(
            points[i], points[j], p, points[j] - points[i]
        )
        if pierce:
            d = float(np.sum((pp - p) ** 2))
            if d < bestd:
                bestd, best = d, pp
        d = float(np.sum((points[i] - p) ** 2))
        if d < bestd:
            bestd, best = d, points[i]
    return best
