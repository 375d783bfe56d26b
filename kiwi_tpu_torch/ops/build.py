"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/*.cu` file has a plain C interface and is compiled by nvcc for
Hopper (sm_90a) into `build/kiwi_tpu_torch/<stem>-<hash>.so` beside the
package, at first use, then loaded with ctypes; `build_all` compiles
several sources at once, one nvcc process each.  The hash covers the source
and the flags, so an edited source rebuilds.  The flags keep IEEE float32
semantics: no fast math, denormals kept (moment-1.0 sessions put misfit
samples near 1e-19), correctly rounded division and square root.

A kernel that fails to build, load or launch raises KernelError, one class
for all of them, so that callers which skip a failing start of a search
(pipeline.Greeper) can let the card's failures through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kiwi_tpu_torch"

class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build, load or launch."""


NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)
# flags one source adds: the eikonal preparation contracts no product into
# an FMA but those it writes out, so that it rounds as the host's numpy
SOURCE_FLAGS = {"eik_prepare.cu": ("-fmad=false",)}


def find_nvcc():
    """nvcc from PATH, $CUDA_HOME, or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built at first use")


def build_all(*source_names):
    """Compile each csrc/<source_name> unless a build of the same source
    and flags exists, one nvcc process per source, all started together;
    returns the library paths in order.  The compiler's resource report
    (-Xptxas -v) is kept beside each library as <lib>.log."""
    libs, jobs = [], []
    for name in source_names:
        src = CSRC_DIR / name
        flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
        digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"{src.stem}-{digest}.so"
        libs.append(lib)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, cmd, proc))
    failed = []
    for src, lib, tmp, cmd, proc in jobs:
        report, _ = proc.communicate()  # waits for every job, failed or not
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                          f"{' '.join(cmd)}\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)
    if failed:
        raise KernelError("\n".join(failed))
    return libs


def build(source_name):
    """build_all for one source; returns its library path."""
    return build_all(source_name)[0]


def load(source_name):
    """ctypes handle of the built library for csrc/<source_name>."""
    path = build(source_name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelError(f"cannot load {path}: {e}") from e
