"""The port's CUDA kernels on the card: each kernel vs its plain version.

Marked `cuda`: these skip without a CUDA device.  The host with the card
has no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernels sum in another order than the plain versions (FMA contraction,
partial sums), so the comparison is relative to the output's max at 1e-5,
the repo's on-card bar.
"""

import numpy as np
import pytest
import torch

from kiwi_tpu_torch.ops import float_scan, synth_window

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


def _window_operands(rng, ng, G, nt_ext, nt_out, B, zu, dev, nxw=20, nzw=8, R=3, P=4):
    s = (zu, zu * nzw, zu * nzw + zu)  # xunder = zunder = zu
    N = nxw * nzw
    ext = rng.standard_normal((N, ng, nt_ext)).astype(np.float32)
    node_rows = rng.integers(0, N - s[2], size=(B, R, P)).astype(np.int32)
    kk = rng.integers(0, nt_ext - nt_out, size=(B, P, G)).astype(np.int32)
    wrows = rng.standard_normal((B, R, P, G, synth_window.NW)).astype(np.float32)
    wsp = rng.uniform(0.0, 1.0, (B, R, P, 4)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (ext, node_rows)]
    args.append(s)
    args += [torch.as_tensor(a, device=dev) for a in (kk, wrows, wsp)]
    return args


@pytest.mark.parametrize("ng,G,nt_ext,nt_out,B,zu", [
    (10, 3, 104, 80, 257, 1),    # the finite benchmark's group shape, ragged B
    (8, 1, 600, 560, 1, 2),      # a long window (finite_long), one model
    (10, 8, 600, 500, 3, 2),
    (8, 64, 104, 80, 5, 1),      # a deep group: G is a runtime loop
    (10, 1, 2048, 2000, 2, 1),   # the longest window: 80 KB of shared memory
])
def test_window_kernel_matches_plain(cuda_dev, ng, G, nt_ext, nt_out, B, zu):
    rng = np.random.default_rng(ng * 1000 + G * 10 + zu)
    args = _window_operands(rng, ng, G, nt_ext, nt_out, B, zu, cuda_dev)
    before = synth_window.launches["window_synth"]
    got = synth_window.window_forward(*args, nt_out)
    torch.cuda.synchronize()
    assert synth_window.launches["window_synth"] == before + 1
    want = synth_window.window_forward_reference(*args, nt_out)
    assert got.shape == (B, 3, 3, nt_out) and torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("S,RC,B,W", [
    (21, 30, 256, 128),   # the finite benchmark's scan
    (1, 6, 7, 50),        # one shift, ragged B, W not a multiple of 32
    (5, 4, 33, 200),      # W over several staged chunks
    (70, 3, 65, 130),     # S over two shift chunks
])
def test_scan_kernel_matches_plain(cuda_dev, l2, S, RC, B, W):
    rng = np.random.default_rng(S * 100 + RC)
    ref = torch.as_tensor(rng.standard_normal((S * RC, W)).astype(np.float32), device=cuda_dev)
    syn = torch.as_tensor(rng.standard_normal((RC, B, W)).astype(np.float32), device=cuda_dev)
    before = float_scan.launches["scan_sums"]
    got = float_scan.scan_sums(ref, syn, l2=l2)
    torch.cuda.synchronize()
    assert float_scan.launches["scan_sums"] == before + 1
    want = float_scan.scan_sums_reference(ref, syn, l2=l2)
    assert got.shape == (S, B, RC) and torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err
