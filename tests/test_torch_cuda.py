"""The port's CUDA kernel on the card: kernel vs plain version.

Marked `cuda`: these skip without a CUDA device.  The host with the card
has no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernel sums in another order than the plain version (FMA contraction,
four-sample partial sums), so the comparison is relative to the output's
max at 1e-5, the repo's on-card bar.
"""

import numpy as np
import pytest
import torch

from kiwi_tpu_torch.ops import float_scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(rng, RC, S, T, W, B, k_share, dev, masked):
    ref = rng.standard_normal((RC, S, W)).astype(np.float32)
    v = rng.standard_normal((RC // k_share, T, W)).astype(np.float32)
    wgt = (rng.standard_normal((RC, T, B)) / T).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (ref, v, wgt)]
    kw = {"k_share": k_share}
    if masked:
        basei = 37
        lo = rng.integers(basei - 5, basei + W // 2, size=(S, RC)).astype(np.int32)
        hi = lo + rng.integers(0, W, size=(S, RC)).astype(np.int32)
        kw.update(lo=torch.as_tensor(lo, device=dev), hi=torch.as_tensor(hi, device=dev),
                  basei=basei)
    return args, kw


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("RC,S,T,W,B,k_share", [
    (30, 21, 30, 128, 1000, 3),   # the point sweep's shapes, ragged B
    (6, 5, 8, 16, 256, 1),        # the CPU parity tests' shapes
    (4, 37, 64, 200, 129, 2),     # S over two chunks, T at its bound, W not a 64 multiple
    (3, 11, 40, 72, 1, 1),        # one model
])
def test_kernel_matches_plain(cuda_dev, masked, l2, RC, S, T, W, B, k_share):
    rng = np.random.default_rng(RC * 1000 + S * 10 + T)
    args, kw = _operands(rng, RC, S, T, W, B, k_share, cuda_dev, masked)
    before = dict(float_scan.launches)
    got = float_scan.fused_scan_sums(*args, l2=l2, **kw)
    torch.cuda.synchronize()
    name = "fused_scan_masked" if masked else "fused_scan"
    assert float_scan.launches[name] == before[name] + 1
    want = float_scan.fused_scan_sums_reference(*args, l2=l2, **kw)
    assert got.shape == (RC, S, B) and torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err


def test_kernel_rejects_deep_contraction(cuda_dev):
    rng = np.random.default_rng(0)
    args, kw = _operands(rng, 2, 3, 65, 16, 8, 1, cuda_dev, False)
    with pytest.raises(ValueError, match="T <= 64"):
        float_scan.fused_scan_sums(*args, **kw)
