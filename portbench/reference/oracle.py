"""Plain reference of the misfits the benchmark's cells compute (numpy).

What a kiwi minimizer session computes for a source model, written out
straight, per model, in float64, on an unbounded absolute time axis:

1. the bilateral finite-fault discretization (source_bilat.f90:318-459):
   subfault centroids with their moment tensors, times and STF cells;
2. per (receiver, centroid) the differential geodesy (the exact-sphere
   branch of orthodrome.f90 approx_differential_azidist), the
   moment-tensor radiation weights (seismogram.f90:316-336), the bilinear
   GF node stencil (gfdb.f90:781-815, 945-948), the fractional time shift
   (trace_multiply_add, sparse_trace.f90:597-707) and the rotation of
   (away, right, down) into the receiver's components (seismogram.f90:
   195-283);
3. the synthetic's data span per component (span growth of
   trace_multiply_add; away and right share theirs);
4. the misfits (comparator.f90, receiver.f90:439-510): the l2 norm, or the
   floating l1/l2 norm (each trial shift of the reference, the shift with
   the least summed misfit per receiver), each integrated over the union
   of the two data spans; a spectral band-pass on the probe span where the
   configuration sets one; and the global misfit (minimizer_engine.f90:
   935-942).

A trace is (values, itmin): zero before itmin, its last value repeated
after its end.  The only number taken from the program's way of working is
the probe span of the band-passed norms (where the circular filter acts),
which `probe_span` works out again from the configuration and the rows as
the session plans it.

`precision="tf32"` computes the same in float32 with the synthesis
contraction's operands (the GF samples and the weights) rounded to TF32
(10 mantissa bits), as a tensor core's TF32 product takes them: the
benchmark's lower-precision control.

numpy only: no module of the program and no JAX.
"""

from __future__ import annotations

import itertools

import numpy as np

EARTHRADIUS = 6371.0 * 1000.0
EARTHRADIUS_EQUATOR = 6378.14 * 1000.0
EARTH_OBLATENESS = 1.0 / 298.257223563
DEG2RAD_F32 = float(np.float32(2.0 / 360.0 * 3.14159265358979))
COMPONENTS = {"n": 3, "e": 4, "d": 2, "a": 0, "r": 1}  # index into (a, r, d, n, e)
BIG = 1 << 30


def fnint(x):
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


def round_tf32(x):
    """float32 values rounded to TF32 (10 explicit mantissa bits, to nearest even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def ne_to_latlon(lat0, lon0, north, east):
    """(lat, lon) radians of the point (north, east) meters from (lat0, lon0)
    on the sphere (pyrocko.orthodrome.ne_to_latlon)."""
    a = np.sqrt(north ** 2 + east ** 2) / EARTHRADIUS
    gamma = np.arctan2(east, north)
    b = np.pi / 2.0 - lat0
    c = np.arccos(np.clip(np.cos(a) * np.cos(b) + np.sin(a) * np.sin(b) * np.cos(gamma), -1, 1))
    sinc = np.sin(c)
    dlon = np.arcsin(np.clip(np.sin(a) * np.sin(gamma) / np.where(sinc == 0, 1.0, sinc), -1, 1))
    dlon = np.where(np.cos(a) - np.cos(b) * np.cos(c) < 0,
                    np.where(dlon > 0, np.pi - dlon, -np.pi - dlon), dlon)
    return np.pi / 2.0 - c, lon0 + dlon


def receiver_geometry(src_lat, src_lon, rec_lat, rec_lon):
    """Per receiver (radians in, float64): azimuth, backazimuth (orthodrome
    azibazi) and the spheroid distance in m (Meeus, orthodrome.f90:193-229)."""
    rec_lat = np.asarray(rec_lat, np.float64)
    rec_lon = np.asarray(rec_lon, np.float64)
    t = np.cos(src_lat) * np.cos(rec_lat) * np.sin(rec_lon - src_lon)
    cd = (np.sin(src_lat) * np.sin(rec_lat)
          + np.cos(src_lat) * np.cos(rec_lat) * np.cos(rec_lon - src_lon))
    azi = np.arctan2(t, np.sin(rec_lat) - np.sin(src_lat) * cd)
    bazi = np.arctan2(-t, np.sin(src_lat) - np.sin(rec_lat) * cd)
    f = (src_lat + rec_lat) / 2.0
    g = (src_lat - rec_lat) / 2.0
    ll = (src_lon - rec_lon) / 2.0
    s = np.sin(g) ** 2 * np.cos(ll) ** 2 + np.cos(f) ** 2 * np.sin(ll) ** 2
    c = np.cos(g) ** 2 * np.cos(ll) ** 2 + np.sin(f) ** 2 * np.sin(ll) ** 2
    w = np.arctan(np.sqrt(s / c))
    r = np.sqrt(s * c) / w
    d = 2.0 * w * EARTHRADIUS_EQUATOR
    h1 = (3.0 * r - 1.0) / (2.0 * c)
    h2 = (3.0 * r + 1.0) / (2.0 * s)
    dist = d * (1.0 + EARTH_OBLATENESS * h1 * np.sin(f) ** 2 * np.cos(g) ** 2
                - EARTH_OBLATENESS * h2 * np.cos(f) ** 2 * np.sin(g) ** 2)
    return azi, bazi, dist


def centroid_geodesy(dn, de, azi, dist):
    """Differential geodesy of centroids displaced (dn, de) m from the
    source origin towards a receiver at azimuth azi and distance dist
    (approx_differential_azidist's exact-sphere triangle): (azimuth at the
    centroid, rotation angle bazi' - bazi, distance).  Arrays broadcast."""
    r = np.hypot(dn, de)
    a = r / EARTHRADIUS
    b = dist / EARTHRADIUS
    lam = np.arctan2(de, dn)
    sin_a, cos_a = np.sin(a), np.cos(a)
    sin_b, cos_b = np.sin(b), np.cos(b)
    pe, pn, pu = sin_a * np.sin(lam), sin_a * np.cos(lam), cos_a
    be, bn, bu = sin_b * np.sin(azi), sin_b * np.cos(azi), cos_b
    horiz = pe * be + pn * bn
    cos_c = horiz + pu * bu
    sin_c = np.sqrt((pn * bu - pu * bn) ** 2 + (pu * be - pe * bu) ** 2 + (pe * bn - pn * be) ** 2)
    d = np.arctan2(sin_c, cos_c) * EARTHRADIUS
    sin_gamma = np.sin(azi - lam)
    safe_sc = np.where(sin_c == 0, 1.0, sin_c)
    sin_al = sin_a * sin_gamma / safe_sc
    cos_al = (pu * (be * be + bn * bn) - bu * horiz) / (np.where(sin_b == 0, 1.0, sin_b) * safe_sc)
    sin_be = sin_b * sin_gamma / safe_sc
    cos_be = (bu * (pe * pe + pn * pn) - pu * horiz) / (np.where(sin_a == 0, 1.0, sin_a) * safe_sc)
    azi_c = np.arctan2(-(np.sin(lam) * cos_be - np.cos(lam) * sin_be),
                       -(np.cos(lam) * cos_be + np.sin(lam) * sin_be))
    alpha = np.arctan2(sin_al, cos_al)
    at0 = r == 0
    shape = np.broadcast(dn, de, azi, dist).shape
    return (np.broadcast_to(np.where(at0, azi, azi_c), shape),
            np.broadcast_to(np.where(at0, 0.0, alpha), shape),
            np.broadcast_to(np.where(at0, dist, d), shape))


# ---------------------------------------------------------------------------
# bilateral finite fault (source_bilat.f90)
# ---------------------------------------------------------------------------


def _euler(alpha, beta, gamma):
    ca, cb, cg = np.cos(alpha), np.cos(beta), np.cos(gamma)
    sa, sb, sg = np.sin(alpha), np.sin(beta), np.sin(gamma)
    return np.array([[cb * cg - ca * sb * sg, -cb * sg - ca * sb * cg, sa * sb],
                     [sb * cg + ca * cb * sg, -sb * sg + ca * cb * cg, -sa * cb],
                     [sa * sg, sa * cg, ca]])


def bilateral_shape(p, effective_dt):
    """(nx, ny, nt) of the centroid grid (psm_to_tdsm_size_bilat)."""
    length, width = float(p[9]) + float(p[10]), float(p[11])
    rupvel, risetime = float(p[12]), float(p[13])
    nx = 1 if length == 0.0 else max(int(np.floor(length / (0.5 * effective_dt * rupvel))) + 1, 2)
    ny = 1 if width == 0.0 else max(int(np.floor(width / (effective_dt * rupvel))) + 1, 2)
    durfull = risetime + length / nx / rupvel
    nt = max(int(np.floor(durfull / effective_dt)) + 1, 2)
    return nx, ny, nt


def _cell_integrals(xs, ys, ta, tb):
    """Area and centroid of the 4-point STF over cells [ta, tb]."""
    area = np.zeros_like(ta)
    moment = np.zeros_like(ta)
    for i in range(3):
        x0, x1, y0, y1 = xs[i], xs[i + 1], ys[i], ys[i + 1]
        lo, hi = np.maximum(ta, x0), np.minimum(tb, x1)
        slope = (y1 - y0) / (x1 - x0) if x1 != x0 else 0.0
        ylo, yhi = y0 + slope * (lo - x0), y0 + slope * (hi - x0)
        a = np.where(hi > lo, (ylo + yhi) * (hi - lo) / 2.0, 0.0)
        ysum = ylo + yhi
        cx = np.where(ysum != 0, (lo * (2 * ylo + yhi) + hi * (ylo + 2 * yhi))
                      / np.where(ysum != 0, 3 * ysum, 1.0), (lo + hi) / 2.0)
        area, moment = area + a, moment + a * cx
    return area, np.where(area != 0, moment / np.where(area != 0, area, 1.0), (ta + tb) / 2.0)


def bilateral_centroids(p, effective_dt):
    """Centroid table of one bilateral row (14 parameters): north, east,
    depth, time [C] and unit-moment tensors m [C, 6] as (xx, yy, zz, xy,
    xz, yz); the moment p[4] multiplies the synthetics."""
    p = np.asarray(p, np.float64)
    nx, ny, nt = bilateral_shape(p, effective_dt)
    time, north, east, depth = p[0], p[1], p[2], p[3]
    strike, dip, slip_rake, rup_rake = (p[i] * DEG2RAD_F32 for i in (5, 6, 7, 8))
    la, lb, width, v, risetime = p[9], p[10], p[11], p[12], p[13]
    length = la + lb
    rot_rup = _euler(dip, strike, -rup_rake)
    rot = _euler(dip, strike, -slip_rake)
    m = -(np.outer(rot[:, 2], rot[:, 0]) + np.outer(rot[:, 0], rot[:, 2]))
    m6 = np.array([m[0, 0], m[1, 1], m[2, 2], m[0, 1], m[0, 2], m[1, 2]]) / (nx * ny)
    gx = (2.0 * np.arange(nx) - nx + 1.0) / (2.0 * nx) * length
    gy = (2.0 * np.arange(ny) - ny + 1.0) / (2.0 * ny) * width
    gxm, gym = np.meshgrid(gx, gy, indexing="ij")
    tshift = np.abs(length / 2.0 - lb + gxm) / v + time - max(la, lb) / 2.0 / v
    pos = rot_rup[:, 0, None, None] * gxm + rot_rup[:, 1, None, None] * gym
    dursf = length / nx / v
    lo, hi = min(dursf, risetime), max(dursf, risetime)
    xs = np.array([-(hi + lo) / 2.0, -(hi - lo) / 2.0, (hi - lo) / 2.0, (hi + lo) / 2.0])
    ys = np.array([0.0, 1.0 / hi if hi > 0 else 1.0, 1.0 / hi if hi > 0 else 1.0, 0.0])
    cell = (dursf + risetime) / nt
    wt, toff = _cell_integrals(xs, ys, xs[0] + cell * np.arange(nt),
                               xs[0] + cell * np.arange(1, nt + 1))

    def flat(a):
        return np.repeat(a.reshape(-1), nt)

    # the tables hold single-precision positions and times, as kiwi's
    # centroid tables do: a centroid on a GF node or sample boundary in exact
    # arithmetic (depths of a vertical fault fall on nodes) then takes the
    # node and shift that a float32 table gives it
    def f32(a):
        return a.astype(np.float32).astype(np.float64)

    return {"north": f32(flat(pos[0] + north)), "east": f32(flat(pos[1] + east)),
            "depth": f32(flat(pos[2] + depth)), "time": f32(flat(tshift) + np.tile(toff, nx * ny)),
            "m": np.tile(wt, nx * ny)[:, None] * m6[None, :]}


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


def _ext(data, itmin, idx):
    """Samples of stored rows at absolute indices idx (zero before itmin,
    the last value after the end); data [..., NT] edge-padded."""
    rel = idx - itmin[..., None]
    vals = np.take_along_axis(data, np.clip(rel, 0, data.shape[-1] - 1), axis=-1)
    return np.where(rel < 0, 0.0, vals)


class Session:
    """A configuration's session: store, receivers, source origin, norm.

    cfg: the configuration file's dict (see portbench/configs); store:
    reference.store.Store."""

    def __init__(self, cfg, store, precision="float64"):
        if not cfg["local_interpolation"]:
            raise ValueError("the reference synthesizes with the bilinear GF stencil only")
        self.cfg = cfg
        self.store = store
        self.precision = precision
        self.ftype = np.float64 if precision == "float64" else np.float32
        self.edt = float(cfg["effective_dt"])
        lat0, lon0 = np.radians(cfg["origin"][0]), np.radians(cfg["origin"][1])
        self.lat0, self.lon0 = lat0, lon0
        self.rec_lat, self.rec_lon = receiver_latlon(cfg)
        self.azi, self.bazi, self.dist = receiver_geometry(lat0, lon0, self.rec_lat, self.rec_lon)
        self.comps = cfg["receivers"]["components"]
        self.method = cfg["misfit_method"]
        self.shifts = cfg.get("floating_shiftrange", [0.0, 0.0])
        self.band = cfg.get("filter")
        self.refs = None
        self.probe = None

    # -- synthesis --------------------------------------------------------

    def synthesize(self, p):
        """Traces of the row p on the absolute axis: (t0, syn [R, K, W]),
        data spans lo, hi [R, K] (K components per receiver)."""
        st = self.store
        cent = bilateral_centroids(p, self.edt)
        ft = self.ftype
        out, los, his = [], [], []
        for r in range(len(self.dist)):
            azi_c, alpha, dist_c = centroid_geodesy(cent["north"], cent["east"], self.azi[r],
                                                    self.dist[r])
            sa, ca = np.sin(azi_c), np.cos(azi_c)
            m = cent["m"]
            f = np.stack([m[:, 0] * ca ** 2 + m[:, 1] * sa ** 2 + m[:, 3] * 2 * sa * ca,
                          m[:, 4] * ca + m[:, 5] * sa,
                          m[:, 2],
                          0.5 * (m[:, 1] - m[:, 0]) * 2 * sa * ca + m[:, 3] * (ca ** 2 - sa ** 2),
                          m[:, 5] * ca - m[:, 4] * sa,
                          m[:, 0] * sa ** 2 + m[:, 1] * ca ** 2 - m[:, 3] * 2 * sa * ca], -1)
            cl, sl = np.cos(alpha), np.sin(alpha)
            zero = np.zeros_like(cl)
            f1, f2, f3, f4, f5, f6 = f.T
            wg = np.stack([  # [C, 3 (away, right, down), 10]
                np.stack([cl * f1, cl * f2, cl * f3, -sl * f4, -sl * f5, zero, zero, zero,
                          cl * f6, zero], -1),
                np.stack([sl * f1, sl * f2, sl * f3, cl * f4, cl * f5, zero, zero, zero,
                          sl * f6, zero], -1),
                np.stack([zero, zero, zero, zero, zero, f1, f2, f3, zero, f6], -1)], 1)
            x = dist_c - st.firstx
            z = cent["depth"] - st.firstz
            ix = np.floor(x / st.dx).astype(np.int64)
            iz = np.floor(z / st.dz).astype(np.int64)
            if (ix.min() < 0 or iz.min() < 0 or ix.max() + 1 >= st.shape[0]
                    or iz.max() + 1 >= st.shape[1]):
                raise ValueError("a centroid lies outside the GF store")
            dix, diz = x / st.dx - ix, z / st.dz - iz
            wsp = np.stack([(1 - dix) * (1 - diz), (1 - dix) * diz, dix * (1 - diz), dix * diz], -1)
            nix = np.stack([ix, ix, ix + 1, ix + 1], -1)
            niz = np.stack([iz, iz + 1, iz, iz + 1], -1)
            rshift = cent["time"] / st.dt
            ish = np.floor(rshift).astype(np.int64)
            frac = rshift - ish
            itm = st.itmin[nix, niz].astype(np.int64)  # [C, 4, 10]
            nsm = st.nsamples[nix, niz].astype(np.int64)
            lo4 = np.where(nsm > 0, itm, BIG)
            hi4 = np.where(nsm > 0, itm + np.maximum(nsm - 1, 0), -BIG)
            groups = ([0, 1, 2, 3, 4, 8], [5, 6, 7, 9])
            glo = [lo4[..., g].min(axis=(1, 2)) + ish for g in groups]
            ghi = [hi4[..., g].max(axis=(1, 2)) + ish + 1 for g in groups]
            los.append([min(glo[0]), min(glo[1])])
            his.append([max(ghi[0]), max(ghi[1])])
            out.append((itm, nix, niz, wsp, wg, ish, frac))
        t0 = min(min(lo) for lo in los) - 2
        t1 = max(max(hi) for hi in his) + 2
        idx = np.arange(t0, t1 + 1)
        syn = np.zeros((len(out), 3, idx.size), ft)
        for r, (itm, nix, niz, wsp, wg, ish, frac) in enumerate(out):
            rows = st.data[nix, niz]  # [C, 4, 10, NT]
            j = idx[None, None, None, :] - ish[:, None, None, None]
            a = _ext(rows, itm, j)
            b = _ext(rows, itm, j - 1)
            w = wsp[:, :, None, None] * wg[:, None, :, :]  # [C, 4, 3, 10]
            w0 = w * (1.0 - frac)[:, None, None, None]
            w1 = w * frac[:, None, None, None]
            if self.precision == "tf32":
                a, b = round_tf32(a), round_tf32(b)
                w0, w1 = round_tf32(w0), round_tf32(w1)
            syn[r] = (np.einsum("cnkg,cngw->kw", w0.astype(ft), a.astype(ft))
                      + np.einsum("cnkg,cngw->kw", w1.astype(ft), b.astype(ft)))
        # (away, right, down) -> the receivers' components
        cb = np.cos(self.bazi + np.pi)[:, None]
        sb = np.sin(self.bazi + np.pi)[:, None]
        north = cb * syn[:, 0] - sb * syn[:, 1]
        east = cb * syn[:, 1] + sb * syn[:, 0]
        basis = np.stack([syn[:, 0], syn[:, 1], syn[:, 2], north, east], 1)  # [R, 5, W]
        k = [COMPONENTS[c] for c in self.comps]
        traces = basis[:, k] * self.ftype(p[4])
        grp = [1 if c == "d" else 0 for c in self.comps]
        lo = np.array([[l[g] for g in grp] for l in los])
        hi = np.array([[h[g] for g in grp] for h in his])
        return int(t0), traces, lo, hi

    # -- references -------------------------------------------------------

    def set_reference(self, p):
        """The row p's synthetics as the reference traces, trimmed as
        strip_dataspan trims them (leading zeros; trailing repeats of the
        last value kept once)."""
        t0, syn, lo, hi = self.synthesize(p)
        refs = {}
        for r in range(syn.shape[0]):
            for k in range(syn.shape[1]):
                v = syn[r, k, lo[r, k] - t0:hi[r, k] - t0 + 1]
                nz = np.flatnonzero(v != 0)
                if nz.size == 0:
                    refs[r, k] = (np.zeros(1, self.ftype), int(lo[r, k]))
                    continue
                diff = np.flatnonzero(v != v[-1])
                last = max(int(diff[-1]) + 1 if diff.size else 0, int(nz[0]))
                refs[r, k] = (v[nz[0]:last + 1].copy(), int(lo[r, k] + nz[0]))
        self.refs = refs

    # -- misfits ----------------------------------------------------------

    def _shift_range(self):
        s1 = int(fnint(np.float32(self.shifts[0]) / np.float32(self.store.dt)))
        s2 = int(fnint(np.float32(self.shifts[1]) / np.float32(self.store.dt)))
        return s1, s2

    def _filter_weights(self, pl):
        nf = pl // 2 + 1
        return plf_taper_weights(self.band[0], self.band[1], (0, nf - 1),
                                 1.0 / (pl * self.store.dt))

    def misfits(self, p):
        """(m [R, K], n [R, K]) of the row p against the references."""
        t0, syn, slo, shi = self.synthesize(p)
        dt = self.store.dt
        floating = self.method.startswith("floating_")
        l2 = self.method.endswith("l2norm")
        s1, s2 = self._shift_range() if floating else (0, 0)
        R, K = syn.shape[:2]
        shifts = np.arange(s1, s2 + 1)
        if self.band is not None:
            ps0, pl = self.probe
            axis = np.arange(ps0, ps0 + pl)
            fw = self._filter_weights(pl)
        sums = np.zeros((shifts.size, R, K))
        norms = np.zeros((shifts.size, R, K))
        for r in range(R):
            for k in range(K):
                rv, rit = self.refs[r, k]
                rlo, rhi = rit, rit + rv.size - 1
                if self.band is None:
                    axis = np.arange(min(rlo + s1, slo[r, k]) - 1, max(rhi + s2, shi[r, k]) + 2)
                s_ax = _trace_at(syn[r, k], t0, axis)
                if self.band is not None:
                    s_ax = np.fft.irfft(np.fft.rfft(s_ax) * fw, n=pl)
                for i, s in enumerate(shifts):
                    r_ax = _trace_at(rv, rit + s, axis)
                    if self.band is not None:
                        r_ax = np.fft.irfft(np.fft.rfft(r_ax) * fw, n=pl)
                    lo, hi = min(rlo + s, slo[r, k]), max(rhi + s, shi[r, k])
                    mask = (axis >= lo) & (axis <= hi)
                    d = r_ax - s_ax
                    nmask = (axis >= rlo + s) & (axis <= rhi + s)
                    if l2:
                        sums[i, r, k] = dt * np.sum(d * d * mask)
                        norms[i, r, k] = np.sqrt(dt * np.sum(r_ax * r_ax * nmask))
                    else:
                        sums[i, r, k] = dt * np.sum(np.abs(d) * mask)
                        norms[i, r, k] = dt * np.sum(np.abs(r_ax) * nmask)
        ms = np.sqrt(sums) if l2 else sums  # [S, R, K]
        n = norms.mean(axis=0)
        if not floating:
            return ms[0], n
        per_rec = (ms * ms if l2 else ms).sum(axis=2)  # [S, R]
        return ms, n, per_rec

    def global_misfit(self, p, near=None):
        """The global misfit of the row p.  Under a floating norm, a
        receiver whose least summed misfit is shared within `near` (a
        relative width) by other trial shifts may take any of them, as a
        float32 program may: the global misfits of those choices are
        returned, sorted (one value where there is no such tie)."""
        out = self.misfits(p)
        if len(out) == 2:
            m, n = out
            return np.array([_global(m, n)])
        ms, n, per_rec = out
        choices = []
        for r in range(per_rec.shape[1]):
            best = per_rec[:, r].min()
            tol = 0.0 if near is None else near * max(abs(best), 1e-300)
            choices.append(np.flatnonzero(per_rec[:, r] <= best + tol)[:4])
        vals = []
        for sel in itertools.islice(itertools.product(*choices), 256):
            m = ms[np.array(sel), np.arange(len(sel))]
            vals.append(_global(m, n))
        return np.sort(np.array(vals))


def _bucket(value, step):
    return float(np.ceil(max(value, step) / step) * step)


def _round_up(x, m):
    return -(-int(x) // m) * m


def probe_span(session, rows):
    """(ps0, pl): the probe span on which a session's band-passed norms
    filter the traces of a batch of bilateral rows, worked out as the
    session plans it: the rows' centroid bounds (float32 row arithmetic),
    bucketed (4 dx, 4 dz, 8 dt), the GF window and output window they
    select, the references' spans under the shift range, padded to a power
    of two of at least twice the output window (comparator.f90:1092-1109)."""
    st = session.store
    edt = session.edt
    pb = np.atleast_2d(np.asarray(rows, np.float32))
    length = pb[:, 9] + pb[:, 10]
    halfdiag = np.hypot(length / 2.0, pb[:, 11] / 2.0)
    extent = float((np.hypot(pb[:, 1], pb[:, 2]) + halfdiag).max())
    depth = (float((pb[:, 3] - halfdiag).min()), float((pb[:, 3] + halfdiag).max()))
    tspan = (np.maximum(pb[:, 9], pb[:, 10]) / (2.0 * np.maximum(pb[:, 12], 1.0))
             + pb[:, 13] / 2.0 + edt)
    times = (float((pb[:, 0] - tspan).min()), float((pb[:, 0] + tspan).max()))
    xstep, zstep, tstep = 4.0 * st.dx, 4.0 * st.dz, 8.0 * st.dt
    extent = _bucket(extent * 1.1 + 0.01, xstep)
    depth = (np.floor(depth[0] / zstep) * zstep, _bucket(depth[1] + 0.01, zstep))
    times = (np.floor(times[0] / tstep) * tstep, _bucket(times[1] + st.dt, tstep))

    nx, nz = st.shape[:2]
    ix_lo = max(int(np.floor((session.dist.min() - extent - st.firstx) / st.dx)) - 1, 0)
    ix_hi = min(int(np.ceil((session.dist.max() + extent - st.firstx) / st.dx)) + 2, nx - 1)
    iz_lo = max(int(np.floor((depth[0] - st.firstz) / st.dz)) - 1, 0)
    iz_hi = min(int(np.ceil((depth[1] - st.firstz) / st.dz)) + 2, nz - 1)
    nxw = min(_round_up(ix_hi - ix_lo + 1, 2), nx - ix_lo)
    nzw = min(_round_up(iz_hi - iz_lo + 1, 2), nz - iz_lo)
    s_base = int(np.floor(times[0] / st.dt)) - 1
    s_len = _round_up(int(np.ceil(times[1] / st.dt)) + 1 - s_base + 1, 8)
    sub_n = st.nsamples[ix_lo:ix_lo + nxw, iz_lo:iz_lo + nzw]
    sub_i = st.itmin[ix_lo:ix_lo + nxw, iz_lo:iz_lo + nzw]
    used = sub_n > 0
    tr_lo = int(sub_i[used].min())
    tr_hi = int((sub_i.astype(np.int64) + sub_n - 1)[used].max())
    out_it0 = tr_lo + s_base
    nt_out = _round_up(tr_hi - tr_lo + 1 + s_len + 2, 16)

    s1, s2 = session._shift_range()
    lo, hi, maxlen = out_it0, out_it0 + nt_out - 1, 1
    for values, itmin in session.refs.values():
        lo = min(lo, itmin + s1)
        hi = max(hi, itmin + values.size - 1 + s2)
        maxlen = max(maxlen, values.size)
    length = hi - lo + 1
    pl = 1 << max(0, int(np.ceil(np.log2(max(1, max(length, 2 * max(nt_out, maxlen)))))))
    return lo - int(np.floor((pl - length) / 2.0)), pl


def _global(m, n):
    return float(np.sqrt(np.sum(np.square(m, dtype=np.float64)))
                 / np.sqrt(np.sum(np.square(n, dtype=np.float64))))


def _trace_at(values, itmin, axis):
    """The trace (values, itmin) at the absolute indices `axis`."""
    rel = axis - itmin
    v = values[np.clip(rel, 0, values.size - 1)]
    return np.where(rel < 0, 0.0, v)


def receiver_latlon(cfg):
    """Receiver latitudes and longitudes (radians) of a configuration: each
    receiver `north_m` / `east_m` from the source origin."""
    rc = cfg["receivers"]
    lat0, lon0 = np.radians(cfg["origin"][0]), np.radians(cfg["origin"][1])
    north = np.asarray(rc["north_m"], np.float64)
    east = np.broadcast_to(np.asarray(rc["east_m"], np.float64), north.shape)
    return ne_to_latlon(lat0, lon0, north, east)


def plf_taper_weights(x, y, span, dx):
    """Cosine-ramped weights of the piecewise linear function (x, y) at
    samples span[0]..span[1] of coordinate j*dx (plf_taper_array,
    piecewise_linear_function.f90:195-237)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    j0, j1 = int(span[0]), int(span[1])
    w = np.ones(j1 - j0 + 1)
    ibeg0 = int(np.floor(x[0] / dx))
    if j0 <= ibeg0:
        w[:min(ibeg0, j1) - j0 + 1] = 0.0
    atleast = j0
    for i in range(x.size - 1):
        ibeg = max(int(np.floor(x[i] / dx)) + 1, j0, atleast)
        iend = min(int(np.floor(x[i + 1] / dx)), j1)
        if ibeg <= iend:
            xi = np.arange(ibeg, iend + 1) * dx
            if y[i + 1] != y[i]:
                w[ibeg - j0:iend - j0 + 1] = y[i] + (y[i + 1] - y[i]) * (
                    0.5 - 0.5 * np.cos((xi - x[i]) / (x[i + 1] - x[i]) * np.pi))
            else:
                w[ibeg - j0:iend - j0 + 1] = y[i]
        atleast = iend + 1
    tail = int(np.floor(x[-1] / dx)) + 1
    if j1 >= tail:
        w[max(tail, j0) - j0:] = 0.0
    return w
