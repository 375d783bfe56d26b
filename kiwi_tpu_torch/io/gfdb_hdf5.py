"""Reference-compatible HDF5 GF database layout.

Reads and writes the exact on-disk layout of the Fortran kiwi tools
(gfdb_io_hdf.f90), so databases built with either stack interchange:

* `<base>.index`: scalar datasets dt, dx, dz, firstx, firstz, nchunks, nx,
  nxc, nz, ng (gfdb_io_hdf.f90:182-234),
* `<base>.<i>.chunk` (1-based i): dataset "index" of HDF5 object references
  with Fortran dims (ng, nz, nxc) (h5py sees the C-transpose (nxc, nz, ng)),
  plus per-trace 1-D float32 datasets at /gf/<ixc>/<iz>/<ig> with integer
  attributes pofs, ofs (packed strip offset tables, 1-based)
  (gfdb_io_hdf.f90:236-427).
"""

from __future__ import annotations

import numpy as np

from ..gf.store import GFStore, GFStoreBuilder
from ..gf.trace import pack_strips


def _require_h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("h5py is required for reference-layout HDF5 GFDBs") from e
    return h5py


def save_gfdb(store: GFStore, basepath, nchunks=1):
    """Write a GFStore in the reference HDF5 layout."""
    h5py = _require_h5py()

    nx = store.nx
    nchunks = min(nchunks, nx)
    # chunk sizing (gfdb_init, gfdb.f90:190-199)
    nxc = nx // nchunks + 1
    if nxc > nx:
        nxc = nx
    while nx - nxc * (nchunks - 1) <= 0:
        nxc -= 1

    with h5py.File(f"{basepath}.index", "w") as f:
        for name, val in [("dt", store.dt), ("dx", store.dx), ("dz", store.dz),
                          ("firstx", store.firstx), ("firstz", store.firstz)]:
            f.create_dataset(name, data=np.float32(val))
        for name, val in [("nchunks", nchunks), ("nx", nx), ("nxc", nxc),
                          ("nz", store.nz), ("ng", store.ng)]:
            f.create_dataset(name, data=np.int32(val))

    for ichunk in range(nchunks):
        nxcthis = nxc if ichunk < nchunks - 1 else nx - nxc * (nchunks - 1)
        fn = f"{basepath}.{ichunk + 1}.chunk"
        with h5py.File(fn, "w") as f:
            ref_dtype = h5py.ref_dtype
            index = f.create_dataset("index", shape=(nxcthis, store.nz, store.ng),
                                     dtype=ref_dtype)
            gf = f.create_group("gf")
            for ixc in range(nxcthis):
                ix = ichunk * nxc + ixc
                gx = None
                for iz in range(store.nz):
                    gz = None
                    for ig in range(store.ng):
                        tr = store.get_trace(ix, iz, ig)
                        if tr is None:
                            continue
                        values, itmin = tr
                        strips = pack_strips(values, itmin)
                        packed = np.concatenate([d for _s, d in strips]).astype("<f4")
                        pofs = np.empty(len(strips), dtype=np.int32)
                        ofs = np.empty(len(strips), dtype=np.int32)
                        pos = 1
                        for k, (s, d) in enumerate(strips):
                            pofs[k] = pos
                            ofs[k] = s
                            pos += d.shape[0]
                        if gx is None:
                            gx = gf.require_group(str(ixc + 1))
                        if gz is None:
                            gz = gx.require_group(str(iz + 1))
                        ds = gz.create_dataset(str(ig + 1), data=packed)
                        ds.attrs.create("pofs", pofs)
                        ds.attrs.create("ofs", ofs)
                        index[ixc, iz, ig] = ds.ref
    return nchunks


def load_gfdb(basepath) -> GFStore:
    """Read a reference-layout HDF5 GFDB into a dense GFStore."""
    h5py = _require_h5py()

    with h5py.File(f"{basepath}.index", "r") as f:
        dt = float(f["dt"][()])
        dx = float(f["dx"][()])
        dz = float(f["dz"][()])
        firstx = float(f["firstx"][()]) if "firstx" in f else 0.0
        firstz = float(f["firstz"][()]) if "firstz" in f else 0.0
        nchunks = int(f["nchunks"][()])
        nx = int(f["nx"][()])
        nxc = int(f["nxc"][()])
        nz = int(f["nz"][()])
        ng = int(f["ng"][()])

    builder = GFStoreBuilder(nx, nz, ng, dt, dx, dz, firstx, firstz)
    for ichunk in range(nchunks):
        fn = f"{basepath}.{ichunk + 1}.chunk"
        with h5py.File(fn, "r") as f:
            index = f["index"]
            nxcthis = index.shape[0]
            refs = index[...]
            for ixc in range(nxcthis):
                for iz in range(nz):
                    for ig in range(ng):
                        ref = refs[ixc, iz, ig]
                        if not ref:
                            continue
                        ds = f[ref]
                        packed = np.asarray(ds[...], dtype=np.float32)
                        pofs = np.atleast_1d(ds.attrs["pofs"]).astype(int)
                        ofs = np.atleast_1d(ds.attrs["ofs"]).astype(int)
                        # unpack strips into a dense trace (trace_unpack,
                        # sparse_trace.f90:557-580)
                        itmin = int(ofs[0])
                        ends = []
                        for k in range(len(pofs)):
                            nk = (pofs[k + 1] - pofs[k]) if k + 1 < len(pofs) else (
                                packed.shape[0] - pofs[k] + 1
                            )
                            ends.append(int(ofs[k]) + nk - 1)
                        itmax = max(ends)
                        dense = np.zeros(itmax - itmin + 1, dtype=np.float32)
                        for k in range(len(pofs)):
                            nk = (pofs[k + 1] - pofs[k]) if k + 1 < len(pofs) else (
                                packed.shape[0] - pofs[k] + 1
                            )
                            a = int(ofs[k]) - itmin
                            dense[a : a + nk] = packed[pofs[k] - 1 : pofs[k] - 1 + nk]
                        ix = ichunk * nxc + ixc
                        builder.put_trace(ix, iz, ig, dense, itmin)
    return builder.build()
