"""The benchmark's analytic fullspace Green's-function store (frozen numpy).

A copy of the analytic homogeneous-fullspace builder of the upstream
benchmark (emolch/kiwi benchmark/kiwibench.py `makedb`, gfdb_build_ahfull.f90
and elseis.f90): elementary seismograms of the four kiwi basis sources,
near-field terms included, on a grid of distances x = firstx + ix*dx and
depths z = firstz + iz*dz.  The store is the benchmark's input: the harness
builds it here once, keeps it in a cache file inside the checkout, and hands
the same arrays to the program under test and to the plain reference.

Layout (the program's .npz layout):
    data     f32[nx, nz, ng, nt]   samples, edge-padded to nt with the last value
    itmin    i32[nx, nz, ng]       absolute index of the first sample (t = i*dt)
    nsamples i32[nx, nz, ng]       stored samples before the padding

numpy only: no module of the program and no JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_DELTA = np.eye(3)

# the four basis sources of the kiwi elementary set (gfdb_build_ahfull.f90:34-37)
SOURCE_A = np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0]], dtype=np.float64)
SOURCE_B = np.array([[0, 0, 1], [0, 0, 1], [1, 1, 0]], dtype=np.float64)
SOURCE_C = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 1]], dtype=np.float64)
SOURCE_D = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float64)
# rows [A_n A_e A_d | B_n B_e B_d | C_n C_e C_d | D_n D_e D_d] -> ig 1..10
ROW_FOR_IG = (0, 3, 6, 1, 4, 2, 5, 8, 9, 11)


def fnint(x):
    """Fortran NINT: round half away from zero."""
    x = np.asarray(x)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


@dataclasses.dataclass
class Store:
    dt: float
    dx: float
    dz: float
    firstx: float
    firstz: float
    data: np.ndarray
    itmin: np.ndarray
    nsamples: np.ndarray

    @property
    def shape(self):
        return self.data.shape

    def save(self, path):
        """Write to `path` atomically (a temporary name beside it, then a
        rename), so that a reader never sees half a file."""
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, dt=self.dt, dx=self.dx, dz=self.dz, firstx=self.firstx,
                 firstz=self.firstz, data=self.data, itmin=self.itmin, nsamples=self.nsamples)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path):
        with np.load(path) as f:
            return cls(dt=float(f["dt"]), dx=float(f["dx"]), dz=float(f["dz"]),
                       firstx=float(f["firstx"]), firstz=float(f["firstz"]),
                       data=f["data"], itmin=f["itmin"], nsamples=f["nsamples"])


def _istfs(dt, stf):
    """Trapezoid antiderivatives of stf and t*stf (elseis.f90:434-452)."""
    tau = stf * (np.arange(stf.size) * dt)

    def anti(f):
        out = np.zeros_like(f)
        out[1:] = np.cumsum((f[1:] + f[:-1]) / 2.0 * dt)
        return out

    return anti(stf), anti(tau)


def _differentiate(dt, f):
    df = np.empty_like(f)
    df[1:-1] = (f[2:] - f[:-2]) / (2.0 * dt)
    df[0] = (f[1] - f[0]) / dt
    df[-1] = (f[-1] - f[-2]) / dt
    return df


def _radpat(g):
    """Radiation pattern coefficients rpc[5, n, p, q] (elseis.f90:321-357)."""
    n_, p_, q_ = np.ix_(np.arange(3), np.arange(3), np.arange(3))
    gn, gp, gq = g[n_], g[p_], g[q_]
    dpq, dnq, dnp = _DELTA[p_, q_], _DELTA[n_, q_], _DELTA[n_, p_]
    rpc = np.empty((5, 3, 3, 3))
    rpc[0] = 15 * gn * gp * gq - 3 * gn * dpq - 3 * gp * dnq - 3 * gq * dnp
    rpc[1] = 6 * gn * gp * gq - gn * dpq - gp * dnq - gq * dnp
    rpc[2] = -(6 * gn * gp * gq - gn * dpq - gp * dnq - 2 * gq * dnp)
    rpc[3] = gn * gp * gq
    rpc[4] = -(gn * gp - dnp) * gq
    return rpc


def _seismograms(material, stf, istf, istftau, dstf, dt, coord, weights, toffset, npt):
    """u[n, npt] of a weighted moment-tensor source at `coord` (N, E, D)
    relative to it (elseis.f90:133-209, near and far field)."""
    rho, alpha, beta = material
    r = np.sqrt((coord ** 2).sum())
    c = 1.0 / (4.0 * np.pi * rho)
    matfac = np.array([c, c / alpha ** 2, c / beta ** 2, c / alpha ** 3, c / beta ** 3])
    rpow = np.array([4.0, 2.0, 2.0, 1.0, 1.0])
    factors = matfac[:, None, None, None] * _radpat(coord / r) / r ** rpow[:, None, None, None]
    coeff = np.einsum("knpq,pq->nk", factors, weights)

    lstf = stf.shape[0]
    it = np.arange(npt)
    t = toffset + it * dt
    ta, tb = t - r / alpha, t - r / beta
    ita = np.clip(fnint(toffset / dt - r / alpha / dt) + it, 0, lstf - 1)
    itb = np.clip(fnint(toffset / dt - r / beta / dt) + it, 0, lstf - 1)
    ta_d, tb_d = ta - ita * dt, tb - itb * dt
    basis = np.zeros((5, npt))
    basis[0] = t * (istf[ita] - istf[itb] + ta_d * stf[ita] - tb_d * stf[itb]) - (
        istftau[ita] + ta_d * stf[ita] * ita * dt + 0.5 * stf[ita] * ta_d ** 2
        - istftau[itb] - tb_d * stf[itb] * itb * dt - 0.5 * stf[itb] * tb_d ** 2)
    basis[1], basis[2] = stf[ita], stf[itb]
    basis[3], basis[4] = dstf[ita], dstf[itb]
    return coeff @ basis


def _pack(values, tbegin, dt):
    """(trimmed values f32, itmin): leading zeros cut, trailing repeats of
    the last value collapsed to one (trace_pack, sparse_trace.f90)."""
    v = np.asarray(values, dtype=np.float32)
    it0 = int(fnint(np.float32(tbegin) / np.float32(dt)))
    nz = np.flatnonzero(v != 0.0)
    if nz.size == 0:
        return np.zeros(1, np.float32), it0
    first = int(nz[0])
    diff = np.flatnonzero(v != v[-1])
    last = max(int(diff[-1]) + 1 if diff.size else 0, first)
    return v[first:last + 1].copy(), it0 + first


def node_traces(material, stf, dt, x, z):
    """The ten elementary traces of the node at distance x and depth z:
    [(values f32, itmin)] in kiwi's ig order (gfdb_build_ahfull.f90:70-191)."""
    stf = np.asarray(stf, np.float64)
    istf, istftau = _istfs(dt, stf)
    dstf = _differentiate(dt, stf)
    alpha, beta = material[1], material[2]
    rel = np.array([x, 0.0, -z])
    d = np.sqrt((rel ** 2).sum())
    tstf = (stf.shape[0] - 1) * dt
    fa_p = np.floor(d / alpha / dt) * dt
    la_s = np.ceil((d / beta + tstf) / dt) * dt + dt * 2
    nsamples = int(fnint((la_s - fa_p) / dt)) + 1
    seis = np.zeros((12, nsamples))
    for ibase, w in enumerate((SOURCE_A, SOURCE_B, SOURCE_C, SOURCE_D)):
        seis[ibase * 3:ibase * 3 + 3] = _seismograms(
            material, stf, istf, istftau, dstf, dt, rel, w, fa_p, nsamples)
    return [_pack(seis[row], fa_p, dt) for row in ROW_FOR_IG]


def _column(args):
    material, stf, dt, x, zs = args
    return [node_traces(material, stf, dt, x, z) for z in zs]


def build(nx, nz, dt, dx, dz, firstx, firstz, material, stf, workers=1):
    """The whole store: every node's ten traces, edge-padded to the longest;
    the distance columns in `workers` spawned processes (numpy only)."""
    jobs = [(tuple(material), np.asarray(stf, np.float64), dt, firstx + ix * dx,
             [firstz + iz * dz for iz in range(nz)]) for ix in range(nx)]
    if workers > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            columns = pool.map(_column, jobs)
            pool.close()
            pool.join()
    else:
        columns = [_column(job) for job in jobs]
    nt = max(v.shape[0] for col in columns for node in col for v, _ in node)
    data = np.zeros((nx, nz, 10, nt), np.float32)
    itmin = np.zeros((nx, nz, 10), np.int32)
    nsamples = np.zeros((nx, nz, 10), np.int32)
    for ix, col in enumerate(columns):
        for iz, node in enumerate(col):
            for ig, (v, it0) in enumerate(node):
                n = v.shape[0]
                data[ix, iz, ig, :n] = v
                data[ix, iz, ig, n:] = v[-1]
                itmin[ix, iz, ig] = it0
                nsamples[ix, iz, ig] = n
    return Store(float(dt), float(dx), float(dz), float(firstx), float(firstz),
                 data, itmin, nsamples)


def cached(spec, cache_dir):
    """The store of a configuration's `store` spec, built once and kept in
    `cache_dir` under a name made from the spec; (store, seconds built, 0
    when it was loaded)."""
    import hashlib
    import json
    import time

    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"store-{key}.npz")
    if os.path.exists(path):
        return Store.load(path), 0.0
    t0 = time.perf_counter()
    store = build(spec["nx"], spec["nz"], spec["dt"], spec["dx"], spec["dz"], spec["firstx"],
                  spec["firstz"], tuple(spec["material"]), np.asarray(spec["stf"], np.float64),
                  workers=min(8, os.cpu_count() or 1))
    seconds = time.perf_counter() - t0
    os.makedirs(cache_dir, exist_ok=True)
    store.save(path)
    return store, seconds
