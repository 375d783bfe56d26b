"""Analytic homogeneous-fullspace Green's functions (Aki & Richards).

Vectorized re-derivation of the reference's elseis.f90 / elseis_oo.f90 /
gfdb_build_ahfull.f90: elementary seismograms for moment-tensor sources in an
isotropic fullspace including near-field terms, and the builder that fills a
GF store with the kiwi 10-component elementary set.

The per-sample structure of elseis_mt (elseis.f90:133-209) is

    u_npq(t) =  F1(n,p,q) * I(t)            (near field)
              + F2(n,p,q) * stf(t_a)        (intermediate, P)
              + F3(n,p,q) * stf(t_b)        (intermediate, S)
              + F4(n,p,q) * dstf(t_a)       (far field, P)
              + F5(n,p,q) * dstf(t_b)       (far field, S)

where the five time series depend only on (r, material, stf) -- so a weighted
combination over (p, q) [a basis source] collapses to a 5-vector of
coefficients per component n times the shared basis.  This makes DB building
O(npt) instead of O(27 * npt).
"""

from __future__ import annotations

import numpy as np

from .store import GFStoreBuilder
from .trace import fnint

PI = np.pi
_DELTA = np.eye(3)

# The four basis sources of the kiwi elementary GF set
# (gfdb_build_ahfull.f90:34-37; Fortran reshape is column-major).
SOURCE_A = np.array([[1, 1, 0], [1, 0, 0], [0, 0, 0]], dtype=np.float64)
SOURCE_B = np.array([[0, 0, 1], [0, 0, 1], [1, 1, 0]], dtype=np.float64)
SOURCE_C = np.array([[0, 0, 0], [0, 0, 0], [0, 0, 1]], dtype=np.float64)
SOURCE_D = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float64)


def make_istfs(dt, stf):
    """(istf, istftau): trapezoid antiderivatives of stf and t*stf
    (elseis.f90:434-452, integration.f90)."""
    stf = np.asarray(stf, dtype=np.float64)
    tau = stf * (np.arange(stf.size) * dt)

    def anti(f):
        ff = np.zeros_like(f)
        ff[1:] = np.cumsum((f[1:] + f[:-1]) / 2.0 * dt)
        return ff

    return anti(stf), anti(tau)


def differentiate(dt, f):
    """Central differences, forward/backward at ends (differentiation.f90)."""
    f = np.asarray(f, dtype=np.float64)
    df = np.empty_like(f)
    df[1:-1] = (f[2:] - f[:-2]) / (2.0 * dt)
    df[0] = (f[1] - f[0]) / dt
    df[-1] = (f[-1] - f[-2]) / dt
    return df


def radpat_mt(gamma):
    """Radiation pattern coefficients for all (n, p, q): rpc[5, 3, 3, 3]
    (elseis.f90:321-357)."""
    g = np.asarray(gamma, dtype=np.float64)
    n_, p_, q_ = np.ix_(np.arange(3), np.arange(3), np.arange(3))
    gn, gp, gq = g[n_], g[p_], g[q_]
    dpq = _DELTA[p_, q_]
    dnq = _DELTA[n_, q_]
    dnp = _DELTA[n_, p_]
    rpc = np.empty((5, 3, 3, 3))
    rpc[0] = 15 * gn * gp * gq - 3 * gn * dpq - 3 * gp * dnq - 3 * gq * dnp
    rpc[1] = 6 * gn * gp * gq - gn * dpq - gp * dnq - gq * dnp
    rpc[2] = -(6 * gn * gp * gq - gn * dpq - gp * dnq - 2 * gq * dnp)
    rpc[3] = gn * gp * gq
    rpc[4] = -(gn * gp - dnp) * gq
    return rpc


def material_factors_mt(rho, alpha, beta):
    """(elseis.f90:382-396)."""
    c = 1.0 / (4.0 * PI * rho)
    return np.array([c, c / alpha**2, c / beta**2, c / alpha**3, c / beta**3])


def mt_factors(rho, alpha, beta, coord):
    """Full 5-factor table F[5, n, p, q] for a station at `coord` (N, E, D)
    relative to the source (factors_mt, elseis.f90:293-305)."""
    coord = np.asarray(coord, dtype=np.float64)
    r = np.sqrt((coord**2).sum())
    gamma = coord / r
    matfac = material_factors_mt(rho, alpha, beta)
    rpc = radpat_mt(gamma)
    rpow = np.array([4.0, 2.0, 2.0, 1.0, 1.0])
    return matfac[:, None, None, None] * rpc / r ** rpow[:, None, None, None], r


def elseis_basis(r, alpha, beta, toffset, dt, npt, stf, istf, istftau, dstf,
                 nfflag=True, ffflag=True):
    """The five shared time series [I, stf_a, stf_b, dstf_a, dstf_b][npt]
    (the per-sample body of elseis_mt, elseis.f90:155-207)."""
    lstf = stf.shape[0]
    it = np.arange(npt)
    t = toffset + it * dt
    ta = t - r / alpha
    tb = t - r / beta
    ita = np.clip(fnint(toffset / dt - r / alpha / dt) + it, 0, lstf - 1)
    itb = np.clip(fnint(toffset / dt - r / beta / dt) + it, 0, lstf - 1)
    basis = np.zeros((5, npt))
    if nfflag:
        ta_d = ta - ita * dt
        tb_d = tb - itb * dt
        integral = t * (istf[ita] - istf[itb] + ta_d * stf[ita] - tb_d * stf[itb]) - (
            istftau[ita] + ta_d * stf[ita] * ita * dt + 0.5 * stf[ita] * ta_d**2
            - istftau[itb] - tb_d * stf[itb] * itb * dt - 0.5 * stf[itb] * tb_d**2
        )
        basis[0] = integral
        basis[1] = stf[ita]
        basis[2] = stf[itb]
    if ffflag:
        basis[3] = dstf[ita]
        basis[4] = dstf[itb]
    return basis


class FullspaceGF:
    """Elementary fullspace seismograms for one material + STF."""

    def __init__(self, rho, alpha, beta, stf, dt):
        self.rho = float(rho)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.dt = float(dt)
        self.stf = np.asarray(stf, dtype=np.float64)
        self.istf, self.istftau = make_istfs(self.dt, self.stf)
        self.dstf = differentiate(self.dt, self.stf)

    def seismograms_mt(self, coord, weights_pq, toffset, npt, nfflag=True, ffflag=True):
        """Displacement components u[n, npt] for a weighted MT source.

        weights_pq: (3, 3) weight matrix over moment tensor couples.
        """
        factors, r = mt_factors(self.rho, self.alpha, self.beta, coord)
        coeff = np.einsum("knpq,pq->nk", factors, np.asarray(weights_pq, dtype=np.float64))
        basis = elseis_basis(
            r, self.alpha, self.beta, toffset, self.dt, npt,
            self.stf, self.istf, self.istftau, self.dstf, nfflag, ffflag,
        )
        return coeff @ basis

    def stf_duration(self):
        return (self.stf.shape[0] - 1) * self.dt


def _snapdown(t, dt):
    return np.floor(t / dt) * dt


def _snapup(t, dt):
    return np.ceil(t / dt) * dt


def add_ahfull_traces(builder: GFStoreBuilder, fs: FullspaceGF, x, z,
                      nfflag=True, ffflag=True):
    """Compute and insert the ng=10 elementary traces for one (x, z) node.

    Mirrors gfdb_build_ahfull.f90:70-191: source at (0, 0, z), receiver at
    (x, 0, 0); time window from the P arrival to the S arrival + STF length
    + 2 samples; P/S windows split when separated and far-field only; then
    the component/basis mapping to ig 1..10 (:164-175):

        ig 1..3  = A,B,C north     (away,  f1..f3)
        ig 4..5  = A,B east        (right, f4..f5)
        ig 6..8  = A,B,C down      (down,  f1..f3)
        ig 9     = D north         (away near-field, f6)
        ig 10    = D down          (down near-field, f6)
    """
    dt = fs.dt
    alpha, beta = fs.alpha, fs.beta
    rel = np.array([x, 0.0, -z])  # receiver minus source, NED
    d = np.sqrt((rel**2).sum())
    tstf = fs.stf_duration()

    fa_p = _snapdown(d / alpha, dt)
    la_p = _snapup(d / alpha + tstf, dt)
    fa_s = _snapdown(d / beta, dt)
    la_s = _snapup(d / beta + tstf, dt) + dt * 2

    tbegin_total = fa_p
    tend_total = la_s
    if la_p >= fa_s or nfflag:
        windows = [(fa_p, la_s)]
    else:
        windows = [(fa_p, la_p), (fa_s, la_s)]

    nsamples = int(fnint((tend_total - tbegin_total) / dt)) + 1
    seis = np.zeros((12, nsamples))

    for (tb, te) in windows:
        i0 = int(fnint((tb - tbegin_total) / dt))
        i1 = int(fnint((te - tbegin_total) / dt))
        npt = i1 - i0 + 1
        for ibase, w in enumerate([SOURCE_A, SOURCE_B, SOURCE_C, SOURCE_D]):
            u = fs.seismograms_mt(rel, w, tb, npt, nfflag, ffflag)
            seis[ibase * 3 : ibase * 3 + 3, i0 : i1 + 1] += u

    # rows here are [A_n A_e A_d | B_n B_e B_d | C_n C_e C_d | D_n D_e D_d]
    row_for_ig = [0, 3, 6, 1, 4, 2, 5, 8, 9, 11]
    for ig, row in enumerate(row_for_ig):
        builder.put_trace_at_time(x, z, ig, seis[row].astype(np.float32), tbegin_total)


def build_ahfull_store(nx, nz, dt, dx, dz, firstx, firstz, material, stf,
                       nfflag=True, ffflag=True, progress=None):
    """Build a complete analytic-fullspace GF store (the 'benchdb' recipe,
    benchmark/kiwibench.py:45-92).

    material: (rho, alpha, beta); stf: sampled source time function at dt.
    """
    rho, alpha, beta = material
    fs = FullspaceGF(rho, alpha, beta, stf, dt)
    builder = GFStoreBuilder(nx, nz, 10, dt, dx, dz, firstx, firstz)
    for ix in range(nx):
        x = firstx + ix * dx
        for iz in range(nz):
            z = firstz + iz * dz
            add_ahfull_traces(builder, fs, x, z, nfflag, ffflag)
        if progress:
            progress(ix + 1, nx)
    return builder.build()
