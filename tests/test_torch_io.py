"""Seismogram and GF-database I/O of the port (kiwi_tpu_torch.io, .native,
.gf.interpolation, .dataset) against kiwi_tpu's on the same seeded data.

Every seismogram format is written by both packages from the same samples:
the files must be byte-identical (MiniSEED and SAC once through both native
libraries, once through both pure-Python codecs), and each package reads
back what the other wrote, samples exactly.  Also: the port's native
library builds beside the package, not in it; oversample_store (2-D and
3-D Gulunay interpolation) gives the same store; an HDF5 database written
by either package loads in the other; receiver tables parse alike.
"""

import sys

import numpy as np
import pytest

import kiwi_tpu.native as jnative
import kiwi_tpu_torch.native as tnative
from kiwi_tpu import dataset as jdataset
from kiwi_tpu import io as jio
from kiwi_tpu.gf import elseis
from kiwi_tpu.gf.interpolation import oversample_store as joversample
from kiwi_tpu.gf.store import GFStoreBuilder as JBuilder
from kiwi_tpu.io import gfdb_hdf5 as jh5, mseed as jms, sac as jsac
from kiwi_tpu_torch import dataset as tdataset
from kiwi_tpu_torch import io as tio
from kiwi_tpu_torch.gf.interpolation import oversample_store as toversample
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.io import gfdb_hdf5 as th5, mseed as tms, sac as tsac

FORMATS = ["table", "sac", "mseed"]


def _samples(n=2500, seed=0):
    return (3e-7 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tstore(store):
    return TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                             store.data, store.itmin, store.nsamples)


def _same_store(a, b):
    for k in ("dt", "dx", "dz", "firstx", "firstz"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("data", "itmin", "nsamples"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_native_library_builds_beside_the_package():
    lib = tnative.get_lib()
    assert lib is not None
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "kiwi_tpu_torch")
    assert not list(tnative._DIR.glob("*.so"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_seismogram_files_identical_and_cross_read(tmp_path, fmt):
    assert jnative.get_lib() is not None and tnative.get_lib() is not None
    data = _samples()
    t0, dt = 1060000000.12345 if fmt == "mseed" else 12.25, 0.1
    names = dict(network="KW", station="STA1", location="", channel="ns")
    paths = {}
    for name, io in (("jax", jio), ("port", tio)):
        paths[name] = str(tmp_path / f"{name}.{fmt}")
        io.writeseismogram(paths[name], fmt, data, t0, dt, **names)
    assert _bytes(paths["jax"]) == _bytes(paths["port"])
    for reader, writer in ((tio, "jax"), (jio, "port")):
        got, gt0, gdt = reader.readseismogram(paths[writer], fmt)
        want, wt0, wdt = jio.readseismogram(paths["jax"], fmt)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert (gt0, gdt) == (wt0, wdt)
    if fmt != "table":
        np.testing.assert_array_equal(tio.readseismogram(paths["jax"], fmt)[0], data)


@pytest.mark.parametrize("fmt", ["sac", "mseed"])
def test_pure_python_codecs_identical(tmp_path, fmt):
    data = _samples(1500, seed=3)
    a, b = str(tmp_path / f"jax.{fmt}"), str(tmp_path / f"port.{fmt}")
    if fmt == "sac":
        jsac.write_py(a, data, -2.0, 0.25, station="STA", channel="BHE", endian=">")
        tsac.write_py(b, data, -2.0, 0.25, station="STA", channel="BHE", endian=">")
        read_py, native_read = tsac.read_py, tnative.sac_read
    else:
        jms.write_py(a, data, 123456.789, 0.25, "KW", "STA", "", "n")
        tms.write_py(b, data, 123456.789, 0.25, "KW", "STA", "", "n")
        read_py, native_read = tms.read_py, tnative.mseed_read
    assert _bytes(a) == _bytes(b)
    for read in (read_py, native_read):
        np.testing.assert_array_equal(read(a)[0], data)


@pytest.mark.parametrize("nipx, nipz", [(2, 1), (1, 2), (2, 2)])
def test_oversample_store_matches(nipx, nipz):
    stf = np.array([0, 0, 0.2, 0.5, 0.8, 1, 1, 1], dtype=np.float64)
    coarse = elseis.build_ahfull_store(
        nx=12, nz=3, dt=0.1, dx=200.0, dz=100.0, firstx=2000.0, firstz=400.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    want = joversample(coarse, nipx=nipx, nipz=nipz)
    got = toversample(_tstore(coarse), nipx=nipx, nipz=nipz)
    assert isinstance(got, TStore) and got.nx == 12 * nipx and got.nz == 3 * nipz
    _same_store(got, want)
    live = 0
    for ix, iz in ((1, 1), (3, 2), (2 * nipx, nipz), (5, 0)):
        assert got.get_indices(got.firstx + ix * got.dx, got.firstz + iz * got.dz) == (ix, iz)
        for ig in range(got.ng):
            g, w = got.get_trace(ix, iz, ig), want.get_trace(ix, iz, ig)
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g[0], w[0])
                assert g[1] == w[1]
                live += 1
    assert live > 0
    assert got.span() == want.span()


def _builder_store(builder_cls):
    b = builder_cls(nx=7, nz=3, ng=10, dt=0.1, dx=50.0, dz=50.0, firstx=50.0)
    rng = np.random.default_rng(1)
    for ix in range(7):
        for iz in range(3):
            for ig in range(10):
                if (ix + iz + ig) % 3 == 0:
                    continue  # some traces missing
                v = rng.normal(size=int(rng.integers(4, 40))).astype(np.float32)
                if ig % 2 == 0:
                    v[-3:] = 0.0  # zero tail
                if ig == 3:
                    v[5:20] = 0.0  # a gap: two strips on disk
                b.put_trace(ix, iz, ig, v, int(rng.integers(-5, 40)))
    return b.build()


def test_gfdb_hdf5_across_packages(tmp_path):
    pytest.importorskip("h5py")
    from kiwi_tpu_torch.gf.store import GFStoreBuilder as TBuilder

    jstore, tstore = _builder_store(JBuilder), _builder_store(TBuilder)
    _same_store(tstore, jstore)
    assert jh5.save_gfdb(jstore, str(tmp_path / "j"), nchunks=3) == 3
    assert th5.save_gfdb(tstore, str(tmp_path / "t"), nchunks=3) == 3
    want = jh5.load_gfdb(str(tmp_path / "j"))  # dt read back as float32
    np.testing.assert_array_equal(want.data, jstore.data)
    for load in (jh5.load_gfdb, th5.load_gfdb):
        for base in ("j", "t"):
            _same_store(load(str(tmp_path / base)), want)
    assert isinstance(th5.load_gfdb(str(tmp_path / "j")), TStore)


def test_gfdb_hdf5_without_h5py_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py is required"):
        th5.load_gfdb(str(tmp_path / "missing"))


def test_receivers_table_parses_alike(tmp_path):
    fn = tmp_path / "receivers.table"
    fn.write_text("# comment\n30.1 70.2 ned\n30.3 70.4\n30.5 70.6 120.0 ne st2\n"
                  "30.7 70.8 dr st3\n")
    for kw in ({}, {"set_components": "d"}):
        got = tdataset.load_receivers_table(str(fn), **kw)
        want = jdataset.load_receivers_table(str(fn), **kw)
        assert [vars(r) for r in got] == [vars(r) for r in want]
