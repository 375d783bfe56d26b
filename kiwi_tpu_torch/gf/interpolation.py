"""Gulunay (2003) generalized f-k trace interpolation (port of
kiwi_tpu/gf/interpolation.py; numpy).

Port of interpolation.f90 (gulunay2d/3d) plus the blockwise GF-store
oversampling routine of gfdb.f90:1109-1310 (gfdb_interpolate_block /
interpolate3d).  The reference interpolates lazily per accessed block at
runtime; here the whole store is oversampled offline into a new dense store
(the engine wants the finished array resident anyway).

Arrays are time-first [nt, ...traces] like the Fortran.  numpy FFTs;
the spectral whitening/clipping thresholds follow interpolation.f90:119-145
exactly (including the quirk of replacing only the real part with the noise
floor when the spectrum is very small).
"""

from __future__ import annotations

import numpy as np

from .store import GFStore, GFStoreBuilder

# gfdb.f90:31-37
NBLOCKX = 128
NBLOCKX_OVERLAP = 32
NBLOCKX_PAYLOAD = NBLOCKX - NBLOCKX_OVERLAP
NBLOCKZ = 32
NBLOCKZ_OVERLAP = 8
NBLOCKZ_PAYLOAD = NBLOCKZ - NBLOCKZ_OVERLAP


def _taper_margin(a, axis, margin):
    """Cosine edge taper over `margin` samples (interpolation.f90:66-82)."""
    if margin <= 0:
        return
    n = a.shape[axis]
    m = min(margin, n)
    idx = [slice(None)] * a.ndim
    for x in range(m):
        w = (1.0 - np.cos(2.0 * np.pi * (x / (2.0 * margin)))) / 2.0
        idx[axis] = x
        a[tuple(idx)] *= w
        idx[axis] = n - 1 - x
        a[tuple(idx)] *= w


def gulunay2d(a, l, ntmargin, nxmargin):
    """Interpolate [t, s] -> [t, s*l] traces (gulunay2d,
    interpolation.f90:29-160).  Mutates a (tapers), like the Fortran."""
    a = np.array(a, dtype=np.float64)
    t, s = a.shape
    kk = s * l
    ff = t * l

    _taper_margin(a, 1, nxmargin // l)
    _taper_margin(a, 0, ntmargin // l)

    b = np.zeros((t, kk))
    b[:, ::l] = a
    fb = np.fft.fft(np.fft.rfft(b, axis=0), axis=1)  # [t//2+1, kk]

    c = np.zeros((ff, kk))
    c[:t, :s] = a
    fc = np.fft.fft(np.fft.rfft(c, axis=0), axis=1)  # [ff//2+1, kk]

    d = np.zeros((ff, kk))
    d[:, 0:s:l] = c[:, 0:s:l]
    fd = np.fft.fft(np.fft.rfft(d, axis=0), axis=1)

    fny = t // 2 + 1
    fd = fd[:fny].copy()
    fc = fc[:fny]

    m = 0.01 * np.abs(fd[fny - 1, :]).max()
    tiny = np.abs(fd) < m / 1000.0
    fd[tiny] = m + 1j * fd[tiny].imag
    small = np.abs(fd) < m
    fd[small] *= m / np.abs(fd[small])

    op = fc / fd
    big = np.abs(op) > l
    op[big] *= l / np.abs(op[big])
    op[np.abs(op) < l * 0.5] = 0.0

    finter = fb * op
    return np.fft.irfft(np.fft.ifft(finter, axis=1), n=t, axis=0).astype(np.float64)


def gulunay3d(a, l, ntmargin, nxmargin, nzmargin):
    """Interpolate [t, sz, sx] -> [t, sz*l, sx*l] (gulunay3d,
    interpolation.f90:162-311)."""
    a = np.array(a, dtype=np.float64)
    t, sz, sx = a.shape
    kkz, kkx = sz * l, sx * l
    ff = t * l

    _taper_margin(a, 2, nxmargin // l)
    _taper_margin(a, 1, nzmargin // l)
    _taper_margin(a, 0, ntmargin // l)

    def fft3(x):
        return np.fft.fftn(np.fft.rfft(x, axis=0), axes=(1, 2))

    b = np.zeros((t, kkz, kkx))
    b[:, ::l, ::l] = a
    fb = fft3(b)

    c = np.zeros((ff, kkz, kkx))
    c[:t, :sz, :sx] = a
    fc = fft3(c)

    d = np.zeros((ff, kkz, kkx))
    d[:, 0:sz:l, 0:sx:l] = c[:, 0:sz:l, 0:sx:l]
    fd = fft3(d)

    fny = t // 2 + 1
    fd = fd[:fny].copy()
    fc = fc[:fny]

    m = 0.01 * np.abs(fd[fny - 1]).max()
    tiny = np.abs(fd) < m / 1000.0
    fd[tiny] = m + 1j * fd[tiny].imag
    small = np.abs(fd) < m
    fd[small] *= m / np.abs(fd[small])

    op = fc / fd
    ls = float(l) ** 2
    big = np.abs(op) > ls
    op[big] *= ls / np.abs(op[big])
    op[np.abs(op) < 0.5 * ls] = 0.0

    finter = fb * op
    return np.fft.irfft(np.fft.ifftn(finter, axes=(1, 2)), n=t, axis=0)


def interpolate3d(fin, nipz, nipx, ntmargin, nxmargin, nzmargin):
    """Dispatch like gfdb.f90:1236-1310: 2D when one factor is 1, 3D when
    equal (two passes for 4x4), sequential x-then-z otherwise."""
    t, nz_in, nx_in = fin.shape
    if nipz == 1 and nipx == 1:
        return fin.copy()
    if nipz == 1:
        out = np.zeros((t, 1, nx_in * nipx))
        out[:, 0, :] = gulunay2d(fin[:, 0, :], nipx, ntmargin, nxmargin)
        return out
    if nipx == 1:
        out = np.zeros((t, nz_in * nipz, 1))
        out[:, :, 0] = gulunay2d(fin[:, :, 0], nipz, ntmargin, nzmargin)
        return out
    if nipx == 4 and nipz == 4:
        mid = gulunay3d(fin, 2, ntmargin, nxmargin // 2, nzmargin // 2)
        return gulunay3d(mid, 2, ntmargin, nxmargin, nzmargin)
    if nipx == nipz:
        return gulunay3d(fin, nipx, ntmargin, nxmargin, nzmargin)
    # pseudo-3D: horizontal, then vertical (gfdb.f90:1289-1308)
    out = np.zeros((t, nz_in * nipz, nx_in * nipx))
    for iz in range(nz_in):
        out[:, iz * nipz, :] = gulunay2d(fin[:, iz, :], nipx, ntmargin, nxmargin)
    for ixo in range(nx_in * nipx):
        ixi = ixo // nipx
        if ixo % nipx == 0:
            ins = fin[:, :, ixi]
        else:
            ins = out[:, ::nipz, ixo]
        out[:, :, ixo] = gulunay2d(ins, nipz, ntmargin, nxmargin)
    return out


def _allowed_span(lo, hi, minlength):
    length = hi - lo + 1
    lengthp = 1 << max(0, int(np.ceil(np.log2(max(1, max(length, minlength))))))
    lo2 = lo - int(np.floor((lengthp - length) / 2.0))
    return lo2, lo2 + lengthp - 1


def oversample_store(store: GFStore, nipx, nipz) -> GFStore:
    """Oversample a GF store by (nipx, nipz) with blockwise Gulunay
    interpolation (the offline equivalent of set_database's nipx/nipz,
    gfdb.f90:222-245 + gfdb_interpolate_block).

    The oversampled grid keeps the real traces at strides (nipx, nipz) and
    fills the rest with interpolated traces; dx/dz shrink accordingly.
    """
    if nipx == 1 and nipz == 1:
        return store
    nx_o = store.nx * nipx
    nz_o = store.nz * nipz
    builder = GFStoreBuilder(
        nx_o, nz_o, store.ng, store.dt, store.dx / nipx, store.dz / nipz,
        store.firstx, store.firstz,
    )
    # copy real traces
    for ix in range(store.nx):
        for iz in range(store.nz):
            for ig in range(store.ng):
                tr = store.get_trace(ix, iz, ig)
                if tr is not None:
                    builder.put_trace(ix * nipx, iz * nipz, ig, tr[0], tr[1])

    nblockx = NBLOCKX if nipx != 1 else 1
    nblockz = NBLOCKZ if nipz != 1 else 1
    xov = NBLOCKX_OVERLAP if nipx != 1 else 0
    zov = NBLOCKZ_OVERLAP if nipz != 1 else 0
    xpay = nblockx - xov
    zpay = nblockz - zov

    nblocks_x = -(-nx_o // xpay) if nipx != 1 else 1
    nblocks_z = -(-nz_o // zpay) if nipz != 1 else 1

    for ibx in range(nblocks_x):
        ixfirst = ibx * xpay - xov // 2  # 0-based fine index of block start
        for ibz in range(nblocks_z):
            izfirst = ibz * zpay - zov // 2
            _interpolate_block(
                store, builder, nipx, nipz, ixfirst, izfirst,
                nblockx, nblockz, xov, zov,
            )
    return builder.build()


def _interpolate_block(store, builder, nipx, nipz, ixfirst, izfirst,
                       nblockx, nblockz, xov, zov):
    """One block (gfdb_interpolate_block, gfdb.f90:1109-1234)."""
    nx_o = store.nx * nipx
    nz_o = store.nz * nipz

    def clamp_real(ix_f, iz_f):
        """Edge-repeating real-trace index for a fine index."""
        ix = min(max(ix_f, 0), nx_o - 1) // nipx
        iz = min(max(iz_f, 0), nz_o - 1) // nipz
        return ix, iz

    # spans of real traces in the block
    lo, hi = 1 << 30, -(1 << 30)
    spans = {}
    for bx in range(0, nblockx, nipx):
        for bz in range(0, nblockz, nipz):
            ix, iz = clamp_real(ixfirst + bx, izfirst + bz)
            for ig in range(store.ng):
                tr = store.get_trace(ix, iz, ig)
                if tr is None:
                    spans[(bz, bx)] = (0, 0)
                    continue
                v, it0 = tr
                lo = min(lo, it0)
                hi = max(hi, it0 + v.shape[0] - 1)
                spans[(bz, bx)] = (it0, it0 + v.shape[0] - 1)
    if hi <= lo:
        return
    lo, hi = _allowed_span(lo, hi, min(64, int((hi - lo) * 1.2)))
    nt = hi - lo + 1

    for ig in range(store.ng):
        field = np.zeros((nt, nblockz // nipz, nblockx // nipx))
        for bz in range(0, nblockz, nipz):
            for bx in range(0, nblockx, nipx):
                ix, iz = clamp_real(ixfirst + bx, izfirst + bz)
                tr = store.get_trace(ix, iz, ig)
                if tr is None:
                    continue
                v, it0 = tr
                a = it0 - lo
                col = field[:, bz // nipz, bx // nipx]
                col[max(a, 0) : max(a, 0) + v.shape[0]] = v[: nt - max(a, 0)]
                if a + v.shape[0] < nt:
                    col[a + v.shape[0] :] = v[-1]  # end-point repeat
        out = interpolate3d(field, nipz, nipx, int(0.1 * (hi - lo)), xov // 2, zov // 2)

        for bz in range(zov // 2, nblockz - zov // 2):
            iz_o = izfirst + bz
            for bx in range(xov // 2, nblockx - xov // 2):
                ix_o = ixfirst + bx
                if ix_o % nipx == 0 and iz_o % nipz == 0:
                    continue  # real traces stay untouched
                if not (0 <= ix_o < nx_o and 0 <= iz_o < nz_o):
                    continue
                # data span = union of the 4 neighboring real-trace spans
                bxl = (bx // nipx) * nipx
                bzl = (bz // nipz) * nipz
                cand = []
                for dz in (0, nipz):
                    for dx in (0, nipx):
                        sp = spans.get((bzl + dz, bxl + dx))
                        if sp and sp != (0, 0):
                            cand.append(sp)
                if not cand:
                    continue
                dlo = min(s[0] for s in cand)
                dhi = max(s[1] for s in cand)
                dlo = max(dlo, lo)
                dhi = min(dhi, hi)
                vals = out[dlo - lo : dhi - lo + 1, bz, bx].astype(np.float32)
                builder.put_trace(ix_o, iz_o, ig, vals, dlo)
