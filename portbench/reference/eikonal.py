"""Plain reference of the eikonal rupture source (plain torch, float64, CPU).

kiwi's psm_to_tdsm_eikonal (src/source_eikonal.f90:259-316) written out
straight, for a batch of rows of the 15-parameter `eikonal` model (time,
north, east, depth, moment, strike, dip, slip-rake, bord-shift-x/y,
bord-radius, nukl-shift-x/y, rel-rupture-velocity, rise-time):

1. the rupture boundary: the 180-vertex circle of radius bord-radius about
   the shifted centre in the fault plane, trimmed by the constraint
   half-spaces (Sutherland-Hodgman, geometry.f90:193-255);
2. the fine grid over the trimmed boundary's box in fault coordinates,
   cells of at most 100 * effective_dt / 2 m; the speed vs(z) *
   rel-rupture-velocity inside the boundary, half the least of it outside
   (crust profile at the origin: interval k covers depths (d[k-1], d[k]]);
3. the arrival times: the first-order upwind (Godunov) equations of the
   fine grid, from 0 at the nucleation cell, solved by Gauss-Seidel sweeps
   in the four diagonal orders until no cell changes (kiwi's fast marching
   reaches the same times wherever the speed is constant inside the
   rupture, as it is within one crust layer);
4. the coarse grid, cells of at most effective_dt * minspeed / 2 m, each
   fine cell inside the rupture in the coarse cell that holds its centre;
   per coarse cell the mean time, the mean position, the weight (its share
   of the fine cells) and the duration 4 x mean |t - mean t|;
5. per coarse cell floor(duration / effective_dt) + 1 boxcar time cells,
   the times taken about the weight-averaged centre time, single-precision
   tables as kiwi's;
6. the rise time applied after synthesis: the traces folded with a boxcar
   of that width integrated over the sample cells (receiver.f90:866-886),
   1 + 2 nint(rise / 2 dt) taps, the data span grown by the half width.

`Session` is the benchmark's reference session (reference/oracle.py) with
this discretization in place of the bilateral one.  Nothing of the program
and no JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import oracle

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
BIG = 1e300  # a fine cell the solve has not reached
M_UNROT = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])


def profile(cfg):
    """(interface depths, vs per interval) of the configuration's crust."""
    crust = cfg["crust"]
    return (np.asarray(crust["interface_depths_m"], np.float64),
            np.asarray(crust["vs_m_s"], np.float64))


def constraints(cfg):
    """The constraint half-spaces [(point, normal)]: p is inside where
    normal . (point - p) >= 0."""
    c = cfg["constraints"]
    return [(np.asarray(p, np.float64), np.asarray(n, np.float64))
            for p, n in zip(c["points"], c["normals"])]


def trim(poly, point, normal):
    """The polygon's part inside one half-space (trim_polygon_one): each
    edge keeps its start where inside and adds its piercing point where it
    crosses; an edge parallel to the plane by kiwi's single-precision test
    pierces at its end nearer the plane."""
    out = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        la = float(normal @ (point - a))
        lb = float(normal @ (point - b))
        ab = b - a
        lab = float(normal @ ab)
        a_in = la >= 0.0
        if a_in:
            out.append(a)
        if a_in != (lb >= 0.0):
            if lab * lab < float(ab @ ab) / 2 ** 24:
                out.append(a if abs(la) <= abs(lb) else b)
            else:
                out.append(a + ab * (la / lab))
    return np.array(out).reshape(-1, 3)


def prepare(p, edt, depths, vs, cons):
    """The fine grid of one row: a dict of its geometry and speeds."""
    p = np.asarray(p, np.float64)
    strike, dip, rake = (float(p[i]) * oracle.DEG2RAD_F32 for i in (5, 6, 7))
    rot = oracle._euler(dip, strike, 0.0)
    slip = oracle._euler(dip, strike, -rake)
    m = slip @ M_UNROT @ slip.T
    m6 = np.array([m[0, 0], m[1, 1], m[2, 2], m[0, 1], m[0, 2], m[1, 2]])
    center = p[1:4].copy()
    radius = float(p[10])
    ccenter = rot @ np.array([p[8], p[9], 0.0]) + center
    npoints = 180 if radius != 0.0 else 1
    ang = np.arange(1, npoints + 1) * 2.0 * np.pi / npoints
    unit = np.stack([np.cos(ang), np.sin(ang), np.zeros(npoints)])
    poly = ((-rot * radius) @ unit).T + ccenter
    for q, n in cons:
        poly = trim(poly, q, n)
        if len(poly) == 0:
            raise ValueError("Empty rupture area")
    poly_rc = (poly - center) @ rot
    lo, hi = poly_rc.min(axis=0)[:2], poly_rc.max(axis=0)[:2]
    nukl = np.array([p[11], p[12], 0.0])
    nukl_ned = rot @ nukl + center
    if np.hypot(nukl[0], nukl[1]) > radius or any(float(n @ (q - nukl_ned)) < 0.0
                                                  for q, n in cons):
        raise ValueError("position of nucleation point is outside of rupture region")
    dims = hi - lo
    nd = np.maximum(np.ceil(dims / min(100.0 * edt / 2.0, 4000.0)).astype(int), 1)
    delta = np.where(dims / nd == 0.0, 1.0, dims / nd)
    px = lo[0] + (torch.arange(nd[0], dtype=F64) + 0.5) * delta[0]
    py = lo[1] + (torch.arange(nd[1], dtype=F64) + 0.5) * delta[1]
    PX, PY = torch.meshgrid(px, py, indexing="ij")
    rot_t = torch.as_tensor(rot)
    pts = PX[..., None] * rot_t[:, 0] + PY[..., None] * rot_t[:, 1] + torch.as_tensor(center)
    inside = torch.linalg.vector_norm(pts - torch.as_tensor(ccenter), dim=-1) <= radius
    for q, n in cons:
        inside &= ((torch.as_tensor(q) - pts) * torch.as_tensor(n)).sum(-1) >= 0.0
    if not bool(inside.any()):
        raise ValueError("Empty rupture area")
    layer = torch.searchsorted(torch.as_tensor(depths), pts[..., 2].contiguous(), side="left")
    speed = torch.as_tensor(vs)[torch.clamp(layer, max=len(vs) - 1)] * float(p[13])
    minspeed = float(speed[inside].min())
    seed = [min(max(int((nukl[k] - lo[k]) / delta[k]), 0), nd[k] - 1) for k in range(2)]
    return {"nd": nd, "delta": delta, "dims": dims, "pts": pts, "inside": inside,
            "speed": torch.where(inside, speed, 0.5 * minspeed), "minspeed": minspeed,
            "seed": seed, "m6": m6, "time": float(p[0])}


def _diagonals(nx, ny, pitch):
    """Per sweep order, per anti-diagonal of the flipped grid: the flat
    indices of its cells in a grid padded by one cell on each side."""
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    flat = np.broadcast_to((i + 1) * pitch + (j + 1), (nx, ny)).ravel()
    out = []
    for fi in (False, True):
        for fj in (False, True):
            k = np.broadcast_to((nx - 1 - i if fi else i) + (ny - 1 - j if fj else j),
                                (nx, ny)).ravel()
            order = np.argsort(k, kind="stable")
            cut = np.searchsorted(k[order], np.arange(nx + ny))
            cells = flat[order]
            out.append([torch.as_tensor(cells[cut[s]:cut[s + 1]]) for s in range(nx + ny - 1)])
    return out


def solve(grids):
    """Arrival times of a batch of prepared grids (a list), solved together
    on a grid padded to the largest (cells beyond a row's own grid never
    reached); [nx, ny] float64 per grid."""
    nx = max(g["nd"][0] for g in grids)
    ny = max(g["nd"][1] for g in grids)
    b = len(grids)
    pitch = ny + 2
    f = torch.zeros((b, nx + 2, pitch), dtype=F64)
    t = torch.full((b, (nx + 2) * pitch), BIG, dtype=F64)
    for r, g in enumerate(grids):
        f[r, 1:g["nd"][0] + 1, 1:g["nd"][1] + 1] = g["speed"]
        t[r, (g["seed"][0] + 1) * pitch + g["seed"][1] + 1] = 0.0
    f = f.reshape(b, -1)
    rf = torch.where(f > 0.0, 1.0 / torch.where(f > 0.0, f, 1.0), torch.inf)
    d = torch.as_tensor(np.array([g["delta"] for g in grids]), dtype=F64)
    dx, dy = d[:, 0:1], d[:, 1:2]
    dx2, dy2 = dx * dx, dy * dy
    sum2 = dx2 + dy2
    offs = torch.tensor([-pitch, pitch, -1, 1])
    steps = [(idx, (idx[None, :] + offs[:, None]).reshape(-1))
             for order in _diagonals(nx, ny, pitch) for idx in order]
    while True:
        before = t.clone()
        for idx, nb in steps:
            near = t[:, nb].view(b, 4, -1)
            a = torch.minimum(near[:, 0], near[:, 1])
            c = torch.minimum(near[:, 2], near[:, 3])
            ff, rff = f[:, idx], rf[:, idx]
            q = dx2 * dy2 * (sum2 - ((a - c) * ff) ** 2)
            two = ((a * dy2 + c * dx2) + torch.sqrt(torch.clamp(q, min=0.0)) * rff) / sum2
            one = torch.minimum(a + dx * rff, c + dy * rff)
            cand = torch.where((q >= 0.0) & (two >= torch.maximum(a, c)), two, one)
            t[:, idx] = torch.minimum(t[:, idx], cand)
        if torch.equal(before, t):
            break
    t = t.view(b, nx + 2, pitch)
    return [t[r, 1:g["nd"][0] + 1, 1:g["nd"][1] + 1] for r, g in enumerate(grids)]


def boxcar_cells(dur, edt):
    """(weights, offsets) of a cell's boxcar time cells
    (discretize_subfault_time with zero rise time)."""
    nt = int(np.floor(dur / edt)) + 1
    if nt == 1:
        return np.ones(1), np.zeros(1)
    xs = np.array([-dur / 2.0, -dur / 2.0, dur / 2.0, dur / 2.0])
    ys = np.array([0.0, 1.0 / dur, 1.0 / dur, 0.0])
    cell = dur / nt
    return oracle._cell_integrals(xs, ys, xs[0] + cell * np.arange(nt),
                                  xs[0] + cell * np.arange(1, nt + 1))


def table(g, times, edt):
    """The centroid table of one solved grid (psm_downsample_grid and
    psm_to_tdsm_table_eikonal): north, east, depth, time [C], m [C, 6]."""
    maxd = 0.5 * edt * g["minspeed"]
    nc = [1 if g["dims"][k] == 0.0 else max(int(np.floor(g["dims"][k] / maxd)) + 1, 2)
          for k in range(2)]
    # the coarse cell holding a fine cell's centre: floor((i + 1/2) delta /
    # cdelta) with delta = dims / nd and cdelta = dims / nc, which is
    # floor((2 i + 1) nc / (2 nd)) in exact arithmetic
    cix = (2 * torch.arange(g["nd"][0]) + 1) * nc[0] // (2 * g["nd"][0])
    ciy = (2 * torch.arange(g["nd"][1]) + 1) * nc[1] // (2 * g["nd"][1])
    cell = (cix[:, None] * nc[1] + ciy[None, :])[g["inside"]]
    tt = times[g["inside"]]
    pts = g["pts"][g["inside"]]
    ncell = nc[0] * nc[1]
    counts = torch.zeros(ncell, dtype=F64).index_add_(0, cell, torch.ones_like(tt))
    have = counts > 0
    safe = torch.where(have, counts, 1.0)

    def mean(v):
        return torch.zeros(ncell, dtype=F64).index_add_(0, cell, v) / safe

    ctime = mean(tt)
    cpos = torch.stack([mean(pts[:, k]) for k in range(3)], -1)
    cdur = 4.0 * mean(torch.abs(tt - ctime[cell]))
    cweight = counts / tt.numel()
    centertime = float((ctime * cweight)[have].sum())
    rows = {"north": [], "east": [], "depth": [], "time": [], "w": []}
    for k in torch.nonzero(have)[:, 0].tolist():
        w, toff = boxcar_cells(float(cdur[k]), edt)
        for wi, ti in zip(w, toff):
            rows["north"].append(float(cpos[k, 0]))
            rows["east"].append(float(cpos[k, 1]))
            rows["depth"].append(float(cpos[k, 2]))
            rows["time"].append(float(ctime[k]) + ti + g["time"] - centertime)
            rows["w"].append(wi * float(cweight[k]))
    out = {k: np.asarray(v, np.float32).astype(np.float64) for k, v in rows.items()}
    out["m"] = (out.pop("w")[:, None] * g["m6"][None, :]).astype(np.float32).astype(np.float64)
    return out


def centroid_tables(rows, edt, depths, vs, cons):
    """The centroid tables of a batch of rows (one solve for all)."""
    grids = [prepare(p, edt, depths, vs, cons) for p in rows]
    return [table(g, t, edt) for g, t in zip(grids, solve(grids))]


def fold_weights(risetime, dt):
    """Taps k = -h..h of the post-synthesis boxcar (h = nint(rise / 2 dt)):
    its overlap with each sample cell [k dt - dt/2, k dt + dt/2], summed to 1."""
    h = int(oracle.fnint(0.5 * risetime / dt))
    k = np.arange(-h, h + 1)
    w = np.clip(np.minimum(risetime / 2.0, k * dt + dt / 2.0)
                - np.maximum(-risetime / 2.0, k * dt - dt / 2.0), 0.0, None)
    return (w / w.sum(), h) if w.sum() > 0 else (np.ones(1), 0)


class Session(oracle.Session):
    """oracle.Session with the eikonal discretization and the post-synthesis
    rise time.  Tables are made once a row and kept: `prime(rows)` solves a
    batch of rows together ahead of their misfits."""

    _tables: dict = {}

    def __init__(self, cfg, store, precision="float64"):
        super().__init__(cfg, store, precision)
        self.depths, self.vs = profile(cfg)
        self.cons = constraints(cfg)

    def _key(self, p):
        return (self.edt, self.depths.tobytes(), self.vs.tobytes(),
                tuple((q.tobytes(), n.tobytes()) for q, n in self.cons),
                np.asarray(p, np.float32).tobytes())

    def prime(self, rows):
        todo = {self._key(p): p for p in rows if self._key(p) not in self._tables}
        if todo:
            tables = centroid_tables(list(todo.values()), self.edt, self.depths, self.vs,
                                     self.cons)
            self._tables.update(zip(todo, tables))

    def centroids(self, p):
        self.prime([p])
        return self._tables[self._key(p)]

    def synthesize(self, p):
        """oracle.Session.synthesize on the eikonal table, then the rise
        time's fold (edge-extended, as the trace's last value repeats)."""
        st = self.store
        cent = self.centroids(p)
        ft = self.ftype
        out, los, his = [], [], []
        for r in range(len(self.dist)):
            azi_c, alpha, dist_c = oracle.centroid_geodesy(cent["north"], cent["east"],
                                                           self.azi[r], self.dist[r])
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
            wg = np.stack([
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
            itm = st.itmin[nix, niz].astype(np.int64)
            nsm = st.nsamples[nix, niz].astype(np.int64)
            lo4 = np.where(nsm > 0, itm, oracle.BIG)
            hi4 = np.where(nsm > 0, itm + np.maximum(nsm - 1, 0), -oracle.BIG)
            groups = ([0, 1, 2, 3, 4, 8], [5, 6, 7, 9])
            glo = [lo4[..., g].min(axis=(1, 2)) + ish for g in groups]
            ghi = [hi4[..., g].max(axis=(1, 2)) + ish + 1 for g in groups]
            los.append([min(glo[0]), min(glo[1])])
            his.append([max(ghi[0]), max(ghi[1])])
            out.append((itm, nix, niz, wsp, wg, ish, frac))
        wfold, h = fold_weights(float(p[14]), st.dt)
        t0 = min(min(lo) for lo in los) - 2 - h
        t1 = max(max(hi) for hi in his) + 2 + h
        idx = np.arange(t0, t1 + 1)
        syn = np.zeros((len(out), 3, idx.size), ft)
        for r, (itm, nix, niz, wsp, wg, ish, frac) in enumerate(out):
            rows = st.data[nix, niz]
            j = idx[None, None, None, :] - ish[:, None, None, None]
            a = oracle._ext(rows, itm, j)
            b = oracle._ext(rows, itm, j - 1)
            w = wsp[:, :, None, None] * wg[:, None, :, :]
            w0 = w * (1.0 - frac)[:, None, None, None]
            w1 = w * frac[:, None, None, None]
            if self.precision == "tf32":
                a, b = oracle.round_tf32(a), oracle.round_tf32(b)
                w0, w1 = oracle.round_tf32(w0), oracle.round_tf32(w1)
            syn[r] = (np.einsum("cnkg,cngw->kw", w0.astype(ft), a.astype(ft))
                      + np.einsum("cnkg,cngw->kw", w1.astype(ft), b.astype(ft)))
        if h > 0:
            # out[j] = sum_k w[k] x(j - k): zero before the axis, the last
            # value repeated after it
            pad = np.concatenate([np.zeros(syn.shape[:2] + (h,), ft), syn,
                                  np.repeat(syn[..., -1:], h, axis=-1)], -1)
            n = syn.shape[-1]
            syn = sum(ft(wfold[k + h]) * pad[..., h - k:h - k + n] for k in range(-h, h + 1))
        cb = np.cos(self.bazi + np.pi)[:, None]
        sb = np.sin(self.bazi + np.pi)[:, None]
        north = cb * syn[:, 0] - sb * syn[:, 1]
        east = cb * syn[:, 1] + sb * syn[:, 0]
        basis = np.stack([syn[:, 0], syn[:, 1], syn[:, 2], north, east], 1)
        k = [oracle.COMPONENTS[c] for c in self.comps]
        traces = basis[:, k] * self.ftype(p[4])
        grp = [1 if c == "d" else 0 for c in self.comps]
        lo = np.array([[l[g] - h for g in grp] for l in los])
        hi = np.array([[x[g] + h for g in grp] for x in his])
        return int(t0), traces, lo, hi
