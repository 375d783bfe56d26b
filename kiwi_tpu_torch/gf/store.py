"""Dense Green's-function store (port of kiwi_tpu/gf/store.py).

    data     f32[nx, nz, ng, nt]   trace samples, edge-padded to nt
    itmin    i32[nx, nz, ng]       absolute index of first sample (time = i*dt)
    nsamples i32[nx, nz, ng]       true sample count (before edge padding)

Distances x = firstx + ix*dx, depths z = firstz + iz*dz (0-based), ng = 8
or 10 elementary components ordered as in seismogram.f90:171-251.  The
arrays stay host numpy; `to(device)` gives the tensors.  `save`/`load` use
the same .npz layout as kiwi_tpu.gf.store.GFStore, so a store written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..profiling import to_device
from .trace import fnint, pack_trace


@dataclasses.dataclass
class GFStore:
    """Immutable dense GF store (host numpy; .to(device) for tensors)."""

    dt: float
    dx: float
    dz: float
    firstx: float
    firstz: float
    data: np.ndarray  # f32[nx, nz, ng, nt]
    itmin: np.ndarray  # i32[nx, nz, ng]
    nsamples: np.ndarray  # i32[nx, nz, ng]

    @classmethod
    def from_numpy(cls, dt, dx, dz, firstx, firstz, data, itmin, nsamples):
        """A store from host arrays (e.g. another package's store fields)."""
        return cls(
            dt=float(dt), dx=float(dx), dz=float(dz),
            firstx=float(firstx), firstz=float(firstz),
            data=np.ascontiguousarray(data, dtype=np.float32),
            itmin=np.ascontiguousarray(itmin, dtype=np.int32),
            nsamples=np.ascontiguousarray(nsamples, dtype=np.int32),
        )

    @property
    def nx(self):
        return self.data.shape[0]

    @property
    def nz(self):
        return self.data.shape[1]

    @property
    def ng(self):
        return self.data.shape[2]

    @property
    def nt(self):
        return self.data.shape[3]

    def get_indices(self, x, z):
        """Nearest-node indices (gfdb_get_indices, gfdb.f90:781-792), 0-based."""
        ix = fnint((np.float32(x) - np.float32(self.firstx)) / np.float32(self.dx))
        iz = fnint((np.float32(z) - np.float32(self.firstz)) / np.float32(self.dz))
        return int(ix), int(iz)

    def span(self):
        """(itmin_all, itmax_all) over stored traces; (0, 0) if empty."""
        used = self.nsamples > 0
        if not used.any():
            return 0, 0
        lo = int(self.itmin[used].min())
        hi = int((self.itmin + self.nsamples - 1)[used].max())
        return lo, hi

    def get_trace(self, ix, iz, ig):
        """(values, itmin) of the stored (unpadded) trace, or None if empty."""
        n = int(self.nsamples[ix, iz, ig])
        if n == 0:
            return None
        return self.data[ix, iz, ig, :n].copy(), int(self.itmin[ix, iz, ig])

    def to(self, device):
        """(data f32, itmin i32) tensors on `device`."""
        return to_device(self.data, device), to_device(self.itmin, device)

    def save(self, path):
        np.savez_compressed(
            path,
            dt=self.dt,
            dx=self.dx,
            dz=self.dz,
            firstx=self.firstx,
            firstz=self.firstz,
            data=self.data,
            itmin=self.itmin,
            nsamples=self.nsamples,
        )

    @classmethod
    def load(cls, path):
        with np.load(path) as f:
            return cls(
                dt=float(f["dt"]),
                dx=float(f["dx"]),
                dz=float(f["dz"]),
                firstx=float(f["firstx"]),
                firstz=float(f["firstz"]),
                data=f["data"],
                itmin=f["itmin"],
                nsamples=f["nsamples"],
            )


class GFStoreBuilder:
    """Incrementally build a GFStore (replaces gfdb_build / gfdb_save_trace)."""

    def __init__(self, nx, nz, ng, dt, dx, dz, firstx=0.0, firstz=0.0):
        self.dt = float(dt)
        self.dx = float(dx)
        self.dz = float(dz)
        self.firstx = float(firstx)
        self.firstz = float(firstz)
        self.nx, self.nz, self.ng = int(nx), int(nz), int(ng)
        self._traces = {}

    def put_trace(self, ix, iz, ig, values, itmin):
        """Store dense samples `values` starting at absolute index itmin
        (0-based ix, iz, ig; leading zeros trimmed)."""
        if not (0 <= ix < self.nx and 0 <= iz < self.nz and 0 <= ig < self.ng):
            raise IndexError(f"GF index out of bounds: ({ix}, {iz}, {ig})")
        v, it0 = pack_trace(values, itmin)
        self._traces[(ix, iz, ig)] = (v.astype(np.float32), it0)

    def put_trace_at_time(self, x, z, ig, values, tbegin):
        """Place a trace by physical coordinates (gfdb_build_ahfull.f90:193-216)."""
        ix = int(fnint(np.float32(x - self.firstx) / np.float32(self.dx)))
        iz = int(fnint(np.float32(z - self.firstz) / np.float32(self.dz)))
        itmin = int(fnint(np.float32(tbegin) / np.float32(self.dt)))
        self.put_trace(ix, iz, ig, values, itmin)

    def build(self) -> GFStore:
        nt = max((v.shape[0] for v, _ in self._traces.values()), default=1)
        data = np.zeros((self.nx, self.nz, self.ng, nt), dtype=np.float32)
        itmin = np.zeros((self.nx, self.nz, self.ng), dtype=np.int32)
        nsamples = np.zeros((self.nx, self.nz, self.ng), dtype=np.int32)
        for (ix, iz, ig), (v, it0) in self._traces.items():
            n = v.shape[0]
            data[ix, iz, ig, :n] = v
            data[ix, iz, ig, n:] = v[-1]  # edge padding: "repeat last value"
            itmin[ix, iz, ig] = it0
            nsamples[ix, iz, ig] = n
        return GFStore(
            dt=self.dt,
            dx=self.dx,
            dz=self.dz,
            firstx=self.firstx,
            firstz=self.firstz,
            data=data,
            itmin=itmin,
            nsamples=nsamples,
        )
