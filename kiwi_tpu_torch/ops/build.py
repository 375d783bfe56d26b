"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/*.cu` file has a plain C interface and is compiled by nvcc for
Hopper (sm_90a) into `build/kiwi_tpu_torch/<stem>-<hash>.so` beside the
package, at first use, then loaded with ctypes.  The hash covers the source
and the flags, so an edited source rebuilds.  The flags keep IEEE float32
semantics: no fast math, denormals kept (moment-1.0 sessions put misfit
samples near 1e-19), correctly rounded division and square root.
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

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)


def find_nvcc():
    """nvcc from PATH, $CUDA_HOME, or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built at first use")


def build(source_name):
    """Compile csrc/<source_name> unless a build of the same source and
    flags exists; returns the library path.  The compiler's resource report
    (-Xptxas -v) is kept beside it as <lib>.log."""
    src = CSRC_DIR / source_name
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(source_name):
    """ctypes handle of the built library for csrc/<source_name>."""
    return ctypes.CDLL(str(build(source_name)))
