"""The GF store tooling of the port against kiwi_tpu on the CPU: every
gfdb command (kiwi_tpu_torch.cli.gfdb_tools), the block-wise builder
(kiwi_tpu_torch.gf.builder) and gf.trace.multiply_add_ref.

Both packages run the same numpy code on the same inputs (the stores of
tests/test_gfdb_tools.py and tests/test_tools_dataset.py), so the bar is
exact: identical stdout, byte-identical output files, and output stores
whose data, itmin and nsamples are exactly equal, as .npz and as the
reference's HDF5 layout (.h5base, which needs h5py).
"""

import io
import sys

import numpy as np
import pytest

from kiwi_tpu.cli import gfdb_tools as jtools
from kiwi_tpu.gf import builder as jbuilder, elseis as jelseis
from kiwi_tpu.gf.store import GFStoreBuilder as JBuilder
from kiwi_tpu.gf.trace import multiply_add_ref as j_multiply_add_ref
from kiwi_tpu_torch.cli import gfdb_tools as ttools
from kiwi_tpu_torch.gf import builder as tbuilder
from kiwi_tpu_torch.gf.store import GFStore
from kiwi_tpu_torch.gf.trace import multiply_add_ref as t_multiply_add_ref

PACKAGES = {"jax": jtools, "torch": ttools}
STF = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
MATERIAL = (2300.0, 3200.0, 1600.0)


def _small(path):
    """tests/test_gfdb_tools.py's 6 x 3 x 10 store of seeded noise."""
    b = JBuilder(6, 3, 10, 0.5, 100.0, 100.0, 100.0, 0.0)
    rng = np.random.default_rng(0)
    for ix in range(6):
        for iz in range(3):
            for ig in range(10):
                v = rng.normal(size=24).astype(np.float32)
                v[-1] = 0.0
                b.put_trace(ix, iz, ig, v, 4 + ix)
    b.build().save(path)
    return path


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The small noise store and tests/test_tools_dataset.py's 45 x 8
    analytic store, each as .npz and .h5base."""
    d = tmp_path_factory.mktemp("gfdb")
    small = GFStore.load(_small(str(d / "small.npz")))
    ahfull = jelseis.build_ahfull_store(nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0,
                                        firstz=0.0, material=MATERIAL, stf=STF)
    ahfull.save(str(d / "ahfull.npz"))
    from kiwi_tpu.io.gfdb_hdf5 import save_gfdb

    for name, st in (("small", small), ("ahfull", ahfull)):
        save_gfdb(st, str(d / f"{name}.h5base"))
    return d


def _same_store(a, b):
    a, b = (ttools._load_store(p) for p in (a, b))
    assert (a.dt, a.dx, a.dz, a.firstx, a.firstz) == (b.dt, b.dx, b.dz, b.firstx, b.firstz)
    for k in ("data", "itmin", "nsamples"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def _run(capsys, monkeypatch, fn, argv, stdin=""):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    fn(argv)
    return capsys.readouterr().out


def _both(capsys, monkeypatch, tool, argv_of, stdin_of=lambda pkg: ""):
    """Run tool in both packages; argv_of(pkg) and stdin_of(pkg) name each
    package's own output paths.  Returns the two stdouts."""
    return {pkg: _run(capsys, monkeypatch, getattr(mod, tool), argv_of(pkg), stdin_of(pkg))
            for pkg, mod in PACKAGES.items()}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", ["npz", "h5base"])
@pytest.mark.parametrize("tool", ["gfdb_info", "gfdb_meta"])
@pytest.mark.parametrize("name", ["small", "ahfull"])
def test_info_and_meta_stdout(stores, capsys, monkeypatch, tool, name, ext):
    out = _both(capsys, monkeypatch, tool, lambda pkg: [str(stores / f"{name}.{ext}")])
    assert out["torch"] == out["jax"] and "nx" in out["torch"]


@pytest.mark.parametrize("ext", ["npz", "h5base"])
def test_extract_then_build(stores, tmp_path, capsys, monkeypatch, ext):
    """gfdb_extract's files and answers (one node is missing: nok), then
    gfdb_build of a new store from them and into a copy of an existing
    one (the one-argument form)."""
    src = str(stores / f"small.{ext}")
    lines = {pkg: "".join(f"{x} {z} {ig} '{tmp_path / f'{pkg}-{i}.table'}'\n"
                          for i, (x, z, ig) in enumerate([(300, 100, 3), (100, 0, 1),
                                                          (600, 200, 10), (250, 150, 7)]))
             for pkg in PACKAGES}
    out = _both(capsys, monkeypatch, "gfdb_extract", lambda pkg: [src], lines.get)
    assert out["torch"] == out["jax"] == "ok\n" * 4
    for i in range(4):
        assert _bytes(tmp_path / f"torch-{i}.table") == _bytes(tmp_path / f"jax-{i}.table")

    # two files joined end to end on one node, and one file per node
    build_in = {pkg: (f"300 100 3 '{tmp_path / f'{pkg}-0.table'}'\n"
                      f"100 0 2 '{tmp_path / f'{pkg}-1.table'}' '{tmp_path / f'{pkg}-3.table'}'\n"
                      f"600 200 10 '{tmp_path / f'{pkg}-2.table'}'\n") for pkg in PACKAGES}
    grid = ["1", "6", "3", "10", "0.5", "100", "100", "100", "0"]
    _both(capsys, monkeypatch, "gfdb_build",
          lambda pkg: [str(tmp_path / f"{pkg}-new.{ext}"), *grid], build_in.get)
    _same_store(str(tmp_path / f"torch-new.{ext}"), str(tmp_path / f"jax-new.{ext}"))
    assert ttools._load_store(str(tmp_path / f"torch-new.{ext}")).get_trace(2, 1, 2) is not None

    for pkg in PACKAGES:  # the one-argument form adds to an existing store
        ttools._save_store(ttools._load_store(src), str(tmp_path / f"{pkg}-add.{ext}"))
    _both(capsys, monkeypatch, "gfdb_build", lambda pkg: [str(tmp_path / f"{pkg}-add.{ext}")],
          build_in.get)
    _same_store(str(tmp_path / f"torch-add.{ext}"), str(tmp_path / f"jax-add.{ext}"))


def _empty_like(store, path):
    from kiwi_tpu_torch.gf.store import GFStoreBuilder

    ttools._save_store(GFStoreBuilder(store.nx, store.nz, store.ng, store.dt, store.dx,
                                      store.dz, store.firstx, store.firstz).build(), path)


@pytest.mark.parametrize("ext", ["npz", "h5base"])
@pytest.mark.parametrize("extra", [[], ["1", "1", "2"] + ["0"] * 9, ["2", "2"]],
                         ids=["verbatim", "g-mapping", "oversampled"])
def test_redeploy(stores, tmp_path, extra, ext):
    """tests/test_tools_dataset.py::test_gfdb_redeploy_entries' entries
    (verbatim, scaled, window-clipped, skipped), with a g-mapping and with
    the input oversampled 2 x 2 first."""
    src_fn = str(stores / f"ahfull.{ext}")
    src = ttools._load_store(src_fn)
    x1, z1 = src.firstx + 3 * src.dx, src.firstz + 2 * src.dz
    x2 = src.firstx + 5 * src.dx
    entries = (f"{x1} {z1}\n{x2} {z1} 2.5\n{x2} {src.firstz} 0.5 0.9\n"
               f"{x1} {src.firstz} 9.0 1.0\n")
    outs = {}
    for pkg, mod in PACKAGES.items():
        outs[pkg] = str(tmp_path / f"{pkg}-dst.{ext}")
        _empty_like(src, outs[pkg])
        mod.gfdb_redeploy([src_fn, *extra, outs[pkg]], stdin=io.StringIO(entries))
    _same_store(outs["torch"], outs["jax"])
    assert int((ttools._load_store(outs["torch"]).nsamples > 0).sum()) > 0


def test_build_ahfull(stores, tmp_path, capsys, monkeypatch):
    src = ttools._load_store(str(stores / "ahfull.npz"))
    mat, stf = str(tmp_path / "material"), str(tmp_path / "stf")
    np.savetxt(mat, [MATERIAL])
    np.savetxt(stf, np.column_stack([np.arange(STF.size) * 0.1, STF]))
    nodes = "".join(f"{src.firstx + ix * src.dx} {src.firstz + iz * src.dz} {nf} {ff}\n"
                    for ix, iz, nf, ff in [(0, 0, "T", "T"), (7, 3, "T", "F"),
                                           (20, 5, "F", "T"), (44, 7, "T", "T")])
    dbs = {}
    for pkg in PACKAGES:
        dbs[pkg] = str(tmp_path / f"{pkg}.npz")
        _empty_like(src, dbs[pkg])
    _both(capsys, monkeypatch, "gfdb_build_ahfull", lambda pkg: [dbs[pkg], mat, stf],
          lambda pkg: nodes)
    _same_store(dbs["torch"], dbs["jax"])
    # both flags on: the node equals the analytic store's
    got = ttools._load_store(dbs["torch"])
    for ig in range(10):
        a, b = got.get_trace(44, 7, ig), src.get_trace(44, 7, ig)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[1] == b[1]
            np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("q", ["2", "3"])
def test_downsample(stores, tmp_path, capsys, monkeypatch, q):
    _both(capsys, monkeypatch, "gfdb_downsample",
          lambda pkg: [str(stores / "small.npz"), str(tmp_path / f"{pkg}.npz"), q])
    _same_store(str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz"))


@pytest.mark.parametrize("phases", ["begin", "P,begin"])
def test_phaser(stores, tmp_path, capsys, monkeypatch, phases):
    _both(capsys, monkeypatch, "gfdb_phaser",
          lambda pkg: [str(stores / "ahfull.npz"), str(tmp_path / f"{pkg}.npz"), phases,
                       "0", "0.3", "1.0", "1.5"])
    _same_store(str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz"))
    assert int((ttools._load_store(str(tmp_path / "torch.npz")).nsamples > 0).sum()) > 0


def test_specialextract(stores, tmp_path, capsys, monkeypatch):
    out = _both(capsys, monkeypatch, "gfdb_specialextract",
                lambda pkg: [str(stores / "small.npz")],
                lambda pkg: f"100 3 '{tmp_path / f'{pkg}-a.table'}'\n"
                            f"200 10 '{tmp_path / f'{pkg}-b.table'}'\n")
    assert out["torch"] == out["jax"] == "ok\nok\n"
    for name in ("a", "b"):
        assert _bytes(tmp_path / f"torch-{name}.table") == _bytes(tmp_path / f"jax-{name}.table")


@pytest.mark.parametrize("tool", ["info", "meta", "bogus"])
def test_main_and_console_entries(stores, capsys, monkeypatch, tool):
    """`python -m ... gfdb_tools <tool>` and the gfdb_<tool> console
    entries; an unknown tool exits with the usage, naming the package."""
    db = str(stores / "ahfull.npz")
    outs = {}
    for pkg, mod in PACKAGES.items():
        monkeypatch.setattr(sys, "argv", ["gfdb_tools", tool, db])
        if tool == "bogus":
            with pytest.raises(SystemExit) as e:
                mod.main()
            outs[pkg] = str(e.value).replace(mod.__name__, "<module>")
            continue
        mod.main()
        monkeypatch.setattr(sys, "argv", [f"gfdb_{tool}", db])
        getattr(mod, f"main_{tool}")()
        outs[pkg] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("nworkers", [None, 2])
def test_builder_matches_direct_build(nworkers):
    """The port's GFDBBuilder with its ahfull backend, in the parent and in
    two spawned workers, equals the direct analytic build exactly (the
    reference's builder and build_ahfull_store as well)."""
    kw = dict(nx=6, nz=2, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0)
    built = tbuilder.GFDBBuilder(tbuilder.ahfull_backend(MATERIAL, STF, 0.1), ng=10, **kw,
                                 nworkers=nworkers, block_nx=2).build()
    direct = jelseis.build_ahfull_store(material=MATERIAL, stf=STF, **kw)
    ref = jbuilder.GFDBBuilder(jbuilder.ahfull_backend(MATERIAL, STF, 0.1), ng=10, **kw,
                               block_nx=2).build()
    for want in (direct, ref):
        for k in ("data", "itmin", "nsamples"):
            np.testing.assert_array_equal(getattr(built, k), getattr(want, k), err_msg=k)


def test_reference_builder_cannot_use_workers():
    """The reference's ahfull_backend is a closure, which a process pool
    cannot pickle: nworkers > 1 raises there.  The port's pickles (the test
    above builds with two workers)."""
    import pickle

    kw = dict(nx=4, nz=1, ng=10, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0)
    with pytest.raises(AttributeError, match="local object"):
        jbuilder.GFDBBuilder(jbuilder.ahfull_backend(MATERIAL, STF, 0.1), **kw, nworkers=2,
                             block_nx=2).build()
    backend = pickle.loads(pickle.dumps(tbuilder.ahfull_backend(MATERIAL, STF, 0.1)))
    assert backend(300.0, 0.0, None)


@pytest.mark.parametrize("acc0,data,itmin,factor,rshift", [
    (np.zeros(12), [1.0, 2.0, 4.0], 2, 2.0, 3.0),  # tests/test_trace_store.py's cases
    (np.zeros(10), [0.0, 1.0, 0.0], 3, 1.0, 1.5),
    (np.zeros(10), [2.0, 4.0], 0, 1.0, 2.25),
    (np.arange(9, dtype=np.float32), [0.5, -1.0, 3.0, 3.0], 5, -0.7, -2.6),  # acc_it0 4
])
def test_multiply_add_ref(acc0, data, itmin, factor, rshift):
    it0 = 4 if acc0.dtype == np.float32 else 0
    want = j_multiply_add_ref(acc0.copy(), it0, np.array(data), itmin, factor, rshift)
    got = t_multiply_add_ref(acc0.copy(), it0, np.array(data), itmin, factor, rshift)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
