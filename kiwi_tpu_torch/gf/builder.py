"""GF store builder framework for external modeling codes (port of
kiwi_tpu/gf/builder.py; numpy).

Counterpart of tunguska's qseis.py/poel.py GFDBBuilder machinery: partition
the (distance x depth) grid into blocks of distance columns, run a
user-supplied modeling backend per block, in parallel worker processes when
asked, and insert the resulting elementary traces into a store.  The
reference farms external Fortran codes (QSEIS for layered-earth GFs, POEL
for poroelasticity) this way (qseis.py:500-713); any picklable callable
with the same contract plugs in here -- including the built-in analytic
fullspace backend (`ahfull_backend`).

The workers run numpy only and never touch torch.cuda, so a parent that
holds a CUDA context (an Engine on the card) can build stores.
"""

from __future__ import annotations

import concurrent.futures as _fut
import multiprocessing

import numpy as np

from .elseis import FullspaceGF, add_ahfull_traces
from .store import GFStore, GFStoreBuilder


def _block(backend, config, firstx, dx, firstz, dz, nz, ixs):
    """The traces [(ix, iz, ig, f32 values, itmin)] of the columns ixs."""
    out = []
    for ix in ixs:
        x = firstx + ix * dx
        for iz in range(nz):
            z = firstz + iz * dz
            for (ig, values, itmin) in backend(x, z, config):
                out.append((ix, iz, ig, np.asarray(values, np.float32), int(itmin)))
    return out


class GFDBBuilder:
    """Parallel block-wise GF store construction.

    backend(x, z, config) -> [(ig, values f32[n], itmin int)] produces the
    elementary traces for one (distance, depth) node.  With nworkers > 1 the
    backend and config are pickled to the workers, so the backend must be a
    module-level callable or an instance of a module-level class (as
    ahfull_backend's is), not a closure.  The workers are spawned, so a
    script that builds with them keeps its top-level code under
    `if __name__ == "__main__":`.
    """

    def __init__(self, backend, nx, nz, ng, dt, dx, dz, firstx=0.0, firstz=0.0,
                 config=None, nworkers=None, block_nx=32):
        self.backend = backend
        self.builder = GFStoreBuilder(nx, nz, ng, dt, dx, dz, firstx, firstz)
        self.config = config
        self.nworkers = nworkers
        self.block_nx = block_nx

    def build(self, progress=None) -> GFStore:
        b = self.builder
        blocks = [
            (self.backend, self.config, b.firstx, b.dx, b.firstz, b.dz, b.nz,
             list(range(i, min(i + self.block_nx, b.nx))))
            for i in range(0, b.nx, self.block_nx)
        ]
        if self.nworkers in (None, 0, 1):
            self._insert((_block(*args) for args in blocks), len(blocks), progress)
        else:
            # the forkmap/nworkers equivalent (qseis.py:17-18).  Workers are
            # spawned, not forked: the parent may hold a CUDA context and
            # torch's threads, which a forked child would inherit in an
            # undefined state; a spawned one starts from a fresh import and
            # receives everything it needs (backend, config, grid) as
            # arguments, never the builder and its growing trace table
            ctx = multiprocessing.get_context("spawn")
            with _fut.ProcessPoolExecutor(max_workers=self.nworkers, mp_context=ctx) as ex:
                futures = [ex.submit(_block, *args) for args in blocks]
                self._insert((f.result() for f in futures), len(blocks), progress)
        return b.build()

    def _insert(self, results, nblocks, progress):
        for i, traces in enumerate(results):
            for (ix, iz, ig, v, it0) in traces:
                self.builder.put_trace(ix, iz, ig, v, it0)
            if progress:
                progress(i + 1, nblocks)


class _AhfullBackend:
    """The gfdb_build_ahfull recipe for one node: the traces a one-node
    store builder receives from elseis.add_ahfull_traces.  A module-level
    class, so that its instances pickle to worker processes."""

    def __init__(self, material, stf, dt, nfflag, ffflag):
        self.fs = FullspaceGF(material[0], material[1], material[2], stf, dt)
        self.dt = dt
        self.nfflag = nfflag
        self.ffflag = ffflag

    def __call__(self, x, z, _config):
        tmp = GFStoreBuilder(1, 1, 10, self.dt, 1.0, 1.0, x, z)
        add_ahfull_traces(tmp, self.fs, x, z, self.nfflag, self.ffflag)
        out = []
        for ig in range(10):
            tr = tmp._traces.get((0, 0, ig))
            if tr is not None:
                out.append((ig, tr[0], tr[1]))
        return out


def ahfull_backend(material, stf, dt, nfflag=True, ffflag=True):
    """Analytic fullspace backend (the gfdb_build_ahfull recipe) for
    GFDBBuilder: material (rho, alpha, beta), stf sampled at dt.  The
    returned callable pickles, so it also runs with nworkers > 1."""
    return _AhfullBackend(material, stf, dt, nfflag, ffflag)
