"""kiwi_tpu_torch: the PyTorch + CUDA port of kiwi-tpu.

A second package beside the JAX reference `kiwi_tpu`; module names mirror
it so every counterpart is easy to find.  It imports torch and numpy and
never jax or kiwi_tpu (the host with the GPU has no JAX), so the numpy-only
modules it needs (plf, euler, gf/elseis, geometry, crust2x2 with its data
tables) are carried into it.

Dtype policy (the reference's, kiwi_tpu/__init__.py):
* waveform data and the misfit path are float32;
* host geodesy is float64 numpy;
* TF32 is off: the misfit parity bar is 1e-5 relative, and one TF32 pass
  keeps ~3 decimal digits (the JAX package pins precision=HIGHEST for the
  same reason).  These two flags are the package's only import-time side
  effect; Engine re-asserts them on CUDA.

Ported so far: the shared-kinematics point sweep
(Engine.sweep_global_misfits through the fused synthesis + floating-scan
kernel, ops/float_scan.py), the finite-source batches
(Engine.misfits_for_source_batch through the window synthesis kernel,
ops/synth_window.py, and the scan kernel) and the eikonal ruptures (their
device discretizer through the fast-sweeping kernel, ops/eik_sweep.py)
under the time-domain and amplitude-spectrum norms, the engine's
read-back getters and diagnostics, grid search and Levenberg-Marquardt
inversions on them (invert/), and the minimizer text protocol
(cli/minimizer.py) with its seismogram I/O (io/, native/); see README.md.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def check_tf32_off():
    """Raise if anything re-enabled TF32 since import."""
    if _torch.backends.cuda.matmul.allow_tf32 or _torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.backends.cudnn.allow_tf32); the port's float32 misfit "
            "parity needs full float32 contractions")
