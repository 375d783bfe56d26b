"""The port's install story: its package data covers every native codec and
CUDA source on disk (an installed port builds both from the sources it
ships) and every data table (crust2x2, the phase tables), its runners have
console scripts of their own beside the reference's, and the native codec
loader answers None, not an exception, where
the sources are missing (io/ then takes its pure-Python codecs)."""

import fnmatch
import os

import pytest

from kiwi_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "kiwi_tpu_torch")


def test_package_data_covers_the_sources():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["kiwi_tpu_torch"]
    files = [f"native/{n}" for n in os.listdir(os.path.join(PACKAGE, "native"))
             if n.endswith(".cc")]
    files += [f"csrc/{n}" for n in os.listdir(os.path.join(PACKAGE, "csrc"))]
    assert {"native/mseed.cc", "native/sac.cc"} <= set(files)
    assert any(f.endswith(".cu") for f in files)
    missing = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, missing


def test_package_data_covers_the_tables():
    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["kiwi_tpu_torch"]
    files = [f"data/{d}/{n}" for d in ("crust2x2", "phases")
             for n in os.listdir(os.path.join(PACKAGE, "data", d))]
    assert len([f for f in files if f.startswith("data/phases/")]) == 12
    missing = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, missing


def test_console_scripts():
    """The port's runners under names of their own; the reference's names
    still point at kiwi_tpu, and every entry point resolves to a callable."""
    import importlib

    tomllib = pytest.importorskip("tomllib")
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["kiwi"] == "kiwi_tpu.cli.kiwi_main:main"
    assert scripts["autokiwi"] == "kiwi_tpu.cli.autokiwi:main"
    port = {k: v for k, v in scripts.items() if v.startswith("kiwi_tpu_torch.")}
    assert port == {"kiwi-torch": "kiwi_tpu_torch.cli.kiwi_main:main",
                    "autokiwi-torch": "kiwi_tpu_torch.cli.autokiwi:main"}
    for target in port.values():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn))


def test_get_lib_without_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.library_path() is None
    assert native.get_lib() is None
    assert native.get_lib(auto_build=False) is None
    with pytest.raises(RuntimeError, match="missing"):
        native.build()
