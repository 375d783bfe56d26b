"""GF database command-line tools (port of kiwi_tpu/cli/gfdb_tools.py; numpy,
the same argv, stdin and stdout).

Drop-in workflow equivalents of the reference's gfdb_* programs
(gfdb_build.f90, gfdb_extract.f90, gfdb_info.f90, gfdb_redeploy.f90,
gfdb_build_ahfull.f90): same argument conventions and stdin line protocols,
operating on either the reference HDF5 layout (default, extension-less base
paths, which need h5py) or .npz dense stores.
"""

from __future__ import annotations

import shlex
import sys

import numpy as np

from ..gf.store import GFStore, GFStoreBuilder
from ..gf.trace import fnint


def _load_store(path) -> GFStore:
    if path.endswith(".npz"):
        return GFStore.load(path)
    from ..io.gfdb_hdf5 import load_gfdb

    return load_gfdb(path)


def _save_store(store, path, nchunks=1):
    if path.endswith(".npz"):
        store.save(path)
    else:
        from ..io.gfdb_hdf5 import save_gfdb

        save_gfdb(store, path, nchunks=nchunks)


def gfdb_build(argv=None):
    """gfdb_build database [nchunks nx nz ng dt dx dz [firstx firstz]] << 'x z ig file ...'"""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 8, 10):
        sys.exit("usage: gfdb_build database [ nchunks nx nz ng dt dx dz [ firstx firstz ] ]")
    base = argv[0]
    if len(argv) >= 8:
        nchunks = int(argv[1])
        nx, nz, ng = int(argv[2]), int(argv[3]), int(argv[4])
        dt, dx, dz = float(argv[5]), float(argv[6]), float(argv[7])
        firstx = float(argv[8]) if len(argv) == 10 else 0.0
        firstz = float(argv[9]) if len(argv) == 10 else 0.0
        builder = GFStoreBuilder(nx, nz, ng, dt, dx, dz, firstx, firstz)
    else:
        store = _load_store(base)
        builder = GFStoreBuilder(store.nx, store.nz, store.ng, store.dt,
                                 store.dx, store.dz, store.firstx, store.firstz)
        for ix in range(store.nx):
            for iz in range(store.nz):
                for ig in range(store.ng):
                    tr = store.get_trace(ix, iz, ig)
                    if tr is not None:
                        builder.put_trace(ix, iz, ig, tr[0], tr[1])
        nchunks = 1

    from ..io import readseismogram

    for line in sys.stdin:
        w = shlex.split(line)
        if not w:
            continue
        x, z, ig = float(w[0]), float(w[1]), int(w[2])
        # multiple files are joined end to end (gfdb_build.f90:58-124)
        parts = []
        it0 = None
        for fn in w[3:]:
            data, toffset, deltat = readseismogram(fn)
            itmin = int(fnint(np.float32(toffset) / np.float32(builder.dt)))
            if it0 is None:
                it0 = itmin
                parts.append((itmin, data))
            else:
                parts.append((itmin, data))
        if it0 is None:
            continue
        lo = min(p[0] for p in parts)
        hi = max(p[0] + len(p[1]) for p in parts)
        dense = np.zeros(hi - lo, dtype=np.float32)
        for itmin, data in parts:
            dense[itmin - lo : itmin - lo + len(data)] = data
        ix = int(fnint(np.float32(x - builder.firstx) / np.float32(builder.dx)))
        iz = int(fnint(np.float32(z - builder.firstz) / np.float32(builder.dz)))
        builder.put_trace(ix, iz, ig - 1, dense, lo)

    _save_store(builder.build(), base, nchunks=nchunks)


def gfdb_extract(argv=None):
    """gfdb_extract database << \"x z ig 'outfile'\" (gfdb_extract.f90)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: gfdb_extract database")
    store = _load_store(argv[0])
    from ..io import writeseismogram

    for line in sys.stdin:
        w = shlex.split(line)
        if not w:
            continue
        x, z, ig = float(w[0]), float(w[1]), int(w[2])
        fn = w[3]
        ix, iz = store.get_indices(x, z)
        tr = store.get_trace(ix, iz, ig - 1)
        if tr is None:
            print(f"nok", flush=True)
            continue
        values, itmin = tr
        writeseismogram(fn, "*", values, itmin * store.dt, store.dt)
        print("ok", flush=True)


def gfdb_info(argv=None):
    """key=value metadata (gfdb_info.f90; parsed by tunguska/gfdb.py:24-40)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.exit("usage: gfdb_info database")
    store = _load_store(argv[0])
    used = int((store.nsamples > 0).sum())
    total = store.nx * store.nz * store.ng
    print(f"dt={store.dt:g}")
    print(f"dx={store.dx:g}")
    print(f"dz={store.dz:g}")
    print(f"firstx={store.firstx:g}")
    print(f"firstz={store.firstz:g}")
    print(f"nchunks=1")
    print(f"nx={store.nx}")
    print(f"nz={store.nz}")
    print(f"ng={store.ng}")
    print(f"total_traces={used}/{total}")


def gfdb_redeploy(argv=None, stdin=None):
    """Copy selected traces between databases (gfdb_redeploy.f90:243-322).

    usage: gfdb_redeploy input-db [nipx nipz [g1 g2 ... gNg]] output-db <<EOF
           x z [factor | tbeg tend]
           ...
           EOF

    Each stdin entry copies the input trace nearest (x, z) to the output
    node nearest (x, z): a bare `x z` copies verbatim, `x z factor` scales
    the trace (gfdb_redeploy.f90:122-124), `x z tbeg tend` clips to the
    sample window [floor(tbeg/dt), ceil(tend/dt)] (:132-151; entries with
    tbeg > tend are skipped like :113).  nipx/nipz oversample the input
    with Gulunay interpolation first (:218-231); the optional g-mapping
    redirects input component igs -> its value (1-based, 0 drops, :54-62).

    Deviation: the reference copies samples verbatim even when in/out dt
    differ (no resampling); here differing dt is an error to avoid silently
    mislabeled rates.
    """
    argv = sys.argv[1:] if argv is None else argv
    stdin = sys.stdin if stdin is None else stdin
    if len(argv) < 2:
        sys.exit("usage: gfdb_redeploy input-db [nipx nipz [g-mapping...]] "
                 "output-db <<EOF\nx z [factor | tbeg tend]\n...\nEOF")
    src = _load_store(argv[0])
    dst_name = argv[-1]
    dst = _load_store(dst_name)
    mapping = list(range(1, src.ng + 1))  # 1-based identity
    if len(argv) >= 4:
        nipx, nipz = int(argv[1]), int(argv[2])
        if nipx != 1 or nipz != 1:
            from ..gf.interpolation import oversample_store

            src = oversample_store(src, nipx, nipz)
        gargs = argv[3:-1]
        if gargs:
            if len(gargs) != src.ng:
                sys.exit(f"gfdb_redeploy: need {src.ng} g-mapping values")
            mapping = [int(g) for g in gargs]
    if abs(src.dt - dst.dt) > 1e-7:
        sys.exit("gfdb_redeploy: differing sampling rates (the reference "
                 "copies samples verbatim; refusing to mislabel rates)")

    builder = GFStoreBuilder(dst.nx, dst.nz, dst.ng, dst.dt, dst.dx, dst.dz,
                             dst.firstx, dst.firstz)
    for ix in range(dst.nx):
        for iz in range(dst.nz):
            for ig in range(dst.ng):
                tr = dst.get_trace(ix, iz, ig)
                if tr is not None:
                    builder.put_trace(ix, iz, ig, tr[0], tr[1])

    for line in stdin:
        w = line.split()
        if not w:
            continue
        x, z = float(w[0]), float(w[1])
        factor = 1.0
        window = None
        if len(w) == 3:
            factor = float(w[2])
        elif len(w) >= 4:
            tbeg, tend = float(w[2]), float(w[3])
            if tbeg > tend:
                continue
            window = (tbeg, tend)
        ix = int(fnint(np.float32(x - src.firstx) / np.float32(src.dx)))
        iz = int(fnint(np.float32(z - src.firstz) / np.float32(src.dz)))
        jx = int(fnint(np.float32(x - dst.firstx) / np.float32(dst.dx)))
        jz = int(fnint(np.float32(z - dst.firstz) / np.float32(dst.dz)))
        if not (0 <= ix < src.nx and 0 <= iz < src.nz):
            continue
        if not (0 <= jx < dst.nx and 0 <= jz < dst.nz):
            continue
        for ig in range(src.ng):
            igt = mapping[ig]
            if igt < 1 or igt > dst.ng:
                continue
            tr = src.get_trace(ix, iz, ig)
            if tr is None:
                continue
            vals, it0 = tr
            if factor != 1.0:
                vals = vals * np.float32(factor)
            if window is not None:
                s1 = max(int(np.floor(window[0] / dst.dt)), it0)
                s2 = min(int(np.ceil(window[1] / dst.dt)), it0 + len(vals) - 1)
                if s2 < s1:
                    continue
                vals = vals[s1 - it0 : s2 - it0 + 1]
                it0 = s1
            builder.put_trace(jx, jz, igt - 1, vals, it0)
    _save_store(builder.build(), dst_name)


def gfdb_build_ahfull(argv=None):
    """gfdb_build_ahfull database material stf << 'x z nfflag ffflag'
    (gfdb_build_ahfull.f90)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        sys.exit("usage: gfdb_build_ahfull database material stf")
    base, material_fn, stf_fn = argv
    store = _load_store(base)
    material = np.loadtxt(material_fn, ndmin=2)[0]
    stf_tab = np.loadtxt(stf_fn, ndmin=2)

    from ..gf.elseis import FullspaceGF, add_ahfull_traces

    builder = GFStoreBuilder(store.nx, store.nz, store.ng, store.dt,
                             store.dx, store.dz, store.firstx, store.firstz)
    fs = FullspaceGF(material[0], material[1], material[2], stf_tab[:, 1], store.dt)
    for line in sys.stdin:
        w = line.split()
        if not w:
            continue
        x, z = float(w[0]), float(w[1])
        nf = w[2] in ("T", "t", "1", "true", "True")
        ff = w[3] in ("T", "t", "1", "true", "True")
        add_ahfull_traces(builder, fs, x, z, nf, ff)
    _save_store(builder.build(), base)


def gfdb_downsample(argv=None):
    """Temporal decimation of a database (scripts/gfdb_downsample): an
    order-8 Chebyshev type I lowpass followed by subsampling."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        sys.exit("usage: gfdb_downsample in_db out_db tratio")
    from scipy import signal

    src = _load_store(argv[0])
    q = int(argv[2])
    b, a = signal.cheby1(8, 0.05, 0.8 / q)
    builder = GFStoreBuilder(src.nx, src.nz, src.ng, src.dt * q, src.dx, src.dz,
                             src.firstx, src.firstz)
    for ix in range(src.nx):
        for iz in range(src.nz):
            for ig in range(src.ng):
                tr = src.get_trace(ix, iz, ig)
                if tr is None:
                    continue
                v, it0 = tr
                # align to the coarse grid: pad to a multiple-of-q start
                pre = it0 % q
                vv = np.concatenate([np.zeros(pre, np.float32), v])
                # keep-phase: the smallest multiple of q >= the filter
                # half-order 4 (the reference keeps [4::q] and lets the
                # store round the resulting off-grid start time,
                # scripts/gfdb_downsample:96-97; starting ON the coarse
                # grid keeps the label exact for every q -- the old
                # fixed [4::q] start mislabeled any q != 4 by q-4 fine
                # samples)
                j0 = q * (-(-4 // q))
                y = signal.lfilter(b, a, vv)[j0::q]
                builder.put_trace(ix, iz, ig, y.astype(np.float32),
                                  (it0 - pre + j0) // q)
    _save_store(builder.build(), argv[1])


def gfdb_phaser(argv=None):
    """Phase-windowed redeploy (scripts/gfdb_phaser): keep only samples
    inside a taper positioned by phase arrivals."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 6:
        sys.exit("usage: gfdb_phaser in_db out_db phase1[,phase2...] "
                 "toff1 toff2 toff3 toff4")
    from ..phases import Taper
    from ..plf import PLF

    src = _load_store(argv[0])
    phases = tuple(argv[2].split(","))
    offs = [float(x) for x in argv[3:7]]
    taper = Taper(phases=phases, offsets=offs)
    builder = GFStoreBuilder(src.nx, src.nz, src.ng, src.dt, src.dx, src.dz,
                             src.firstx, src.firstz)
    for ix in range(src.nx):
        x = src.firstx + ix * src.dx
        pts = taper(x)
        for iz in range(src.nz):
            for ig in range(src.ng):
                tr = src.get_trace(ix, iz, ig)
                if tr is None:
                    continue
                v, it0 = tr
                if pts is None:
                    continue
                w = PLF(pts[0::2], pts[1::2]).taper_weights(
                    (it0, it0 + len(v) - 1), src.dt
                )
                builder.put_trace(ix, iz, ig, (v * w).astype(np.float32), it0)
    _save_store(builder.build(), argv[1])


def gfdb_specialextract(argv=None):
    """Batch extraction of whole distance-range arrays
    (gfdb_specialextract.f90): stdin lines 'z ig outfile' write one table
    with all distances as columns."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit("usage: gfdb_specialextract database")
    store = _load_store(argv[0])
    lo, hi = store.span()
    for line in sys.stdin:
        w = shlex.split(line)
        if not w:
            continue
        z, ig = float(w[0]), int(w[1])
        fn = w[2]
        iz = int(fnint(np.float32(z - store.firstz) / np.float32(store.dz)))
        field = np.zeros((hi - lo + 1, store.nx), dtype=np.float32)
        for ix in range(store.nx):
            tr = store.get_trace(ix, iz, ig - 1)
            if tr is None:
                continue
            v, it0 = tr
            a = it0 - lo
            field[a : a + len(v), ix] = v
            field[a + len(v) :, ix] = v[-1]
        np.savetxt(fn, field, fmt="%.7G")
        print("ok", flush=True)


def gfdb_meta(argv=None):
    """JSON metadata dump (scripts/gfdb_meta's guts schema, as JSON)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.exit("usage: gfdb_meta database")
    import json

    store = _load_store(argv[0])
    lo, hi = store.span()
    meta = {
        "type": "kiwi-tpu GF store",
        "dt": store.dt, "dx": store.dx, "dz": store.dz,
        "firstx": store.firstx, "firstz": store.firstz,
        "nx": store.nx, "nz": store.nz, "ng": store.ng,
        "distance_min": store.firstx,
        "distance_max": store.firstx + (store.nx - 1) * store.dx,
        "depth_min": store.firstz,
        "depth_max": store.firstz + (store.nz - 1) * store.dz,
        "sample_span": [int(lo), int(hi)],
        "traces_used": int((store.nsamples > 0).sum()),
        "traces_total": store.nx * store.nz * store.ng,
        "nbytes_dense": int(store.data.nbytes),
    }
    print(json.dumps(meta, indent=2))


def main():
    tool = sys.argv[1] if len(sys.argv) > 1 else ""
    fns = {
        "build": gfdb_build,
        "extract": gfdb_extract,
        "info": gfdb_info,
        "redeploy": gfdb_redeploy,
        "build_ahfull": gfdb_build_ahfull,
        "downsample": gfdb_downsample,
        "phaser": gfdb_phaser,
        "specialextract": gfdb_specialextract,
        "meta": gfdb_meta,
    }
    if tool not in fns:
        sys.exit(f"usage: python -m kiwi_tpu_torch.cli.gfdb_tools ({'|'.join(fns)}) args...")
    fns[tool](sys.argv[2:])


def _entry(tool):
    """Console-script entry: `gfdb_<tool> args...` (reference binary names)."""
    def run():
        sys.argv = [sys.argv[0], tool] + sys.argv[1:]
        main()
    run.__name__ = f"main_{tool}"
    return run


main_build = _entry("build")
main_extract = _entry("extract")
main_info = _entry("info")
main_redeploy = _entry("redeploy")
main_build_ahfull = _entry("build_ahfull")
main_downsample = _entry("downsample")
main_phaser = _entry("phaser")
main_specialextract = _entry("specialextract")
main_meta = _entry("meta")


if __name__ == "__main__":
    main()
