"""Parity of the port's fused scan (kiwi_tpu_torch.ops.float_scan) with the
JAX package's Pallas kernel (kiwi_tpu.ops.float_scan.fused_scan_sums, in
interpret mode on the CPU, fed the lane-broadcast tiles it takes).

On a CPU tensor the port's wrapper runs its plain version, which is what
these tests exercise; the CUDA kernel itself is held against the same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).  Tolerance:
2e-5 of the output's max, the two summing in different orders.
"""

import numpy as np
import pytest
import torch

from kiwi_tpu.ops import float_scan as jfs
from kiwi_tpu_torch.ops import float_scan as tfs

BL = jfs.BL


def _operands(seed, RC=6, S=5, T=8, W=16, B=256, k_share=1):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((RC, S, W)).astype(np.float32)
    v = rng.standard_normal((RC // k_share, T, W)).astype(np.float32)
    wgt = (rng.standard_normal((RC, T, B)) / T).astype(np.float32)
    basei = 100
    lo = rng.integers(basei - 3, basei + W // 2, size=(S, RC)).astype(np.int32)
    hi = (lo + rng.integers(0, W, size=(S, RC))).astype(np.int32)
    return ref, v, wgt, lo, hi, basei


def _jax_sums(ref, v, wgt, lo, hi, basei, k_share, l2, masked):
    import jax.numpy as jnp

    RC, S, W = ref.shape
    ref_tiles = jnp.broadcast_to(jnp.asarray(ref)[..., None], (RC, S, W, BL))
    v_tiles = jnp.broadcast_to(jnp.asarray(v)[..., None], v.shape + (BL,))
    mask_tiles = None
    if masked:
        j = basei + np.arange(W)
        mask = ((j >= lo.T[..., None]) & (j <= hi.T[..., None])).astype(np.float32)
        mask_tiles = jnp.broadcast_to(jnp.asarray(mask)[..., None], (RC, S, W, BL))
    out = jfs.fused_scan_sums(ref_tiles, v_tiles, jnp.asarray(wgt), mask_tiles=mask_tiles,
                              k_share=k_share, l2=l2, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("k_share", [1, 3])
def test_plain_matches_pallas_interpret(masked, l2, k_share):
    ref, v, wgt, lo, hi, basei = _operands(10 * k_share + 2 * l2 + masked, k_share=k_share)
    want = _jax_sums(ref, v, wgt, lo, hi, basei, k_share, l2, masked)
    kw = {"k_share": k_share, "l2": l2}
    if masked:
        kw.update(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi), basei=basei)
    before = dict(tfs.launches)
    got = tfs.fused_scan_sums(torch.as_tensor(ref), torch.as_tensor(v),
                              torch.as_tensor(wgt), **kw)
    assert tfs.launches == before, "a CPU call must not count as a kernel launch"
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_plain_chunking_is_invisible():
    """Chunking over B (bounded CPU memory) changes the sums only by the
    reduction order of torch's vectorized sum (1e-6 of the max)."""
    ref, v, wgt, lo, hi, basei = _operands(7, B=300)
    args = [torch.as_tensor(a) for a in (ref, v, wgt)]
    kw = {"lo": torch.as_tensor(lo), "hi": torch.as_tensor(hi), "basei": basei}
    whole = tfs.fused_scan_sums_reference(*args, **kw)
    chunked = tfs.fused_scan_sums_reference(*args, chunk_elems=ref.size * 7, **kw)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6 * float(whole.abs().max()))


def test_wrapper_rejects_bad_operands():
    ref, v, wgt, lo, hi, basei = _operands(3)
    r, vv, w = (torch.as_tensor(a) for a in (ref, v, wgt))
    with pytest.raises(ValueError, match="float32"):
        tfs.fused_scan_sums(r.double(), vv, w)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfs.fused_scan_sums(r, vv, w, k_share=2)
    with pytest.raises(ValueError, match="go together"):
        tfs.fused_scan_sums(r, vv, w, lo=torch.as_tensor(lo))
    with pytest.raises(ValueError, match="int32"):
        tfs.fused_scan_sums(r, vv, w, lo=torch.as_tensor(lo).long(), hi=torch.as_tensor(hi))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfs.fused_scan_sums(r.to("meta"), vv.to("meta"), w.to("meta"))


@pytest.mark.parametrize("l2", [False, True])
def test_scan_sums_matches_pallas_interpret(l2):
    """scan_sums over precomputed synthetics against the JAX package's
    scan_sums (resident variant, interpret mode).  The JAX kernel takes B in
    whole 32-model blocks, so it runs the padded batch; the port takes the
    ragged B = 50 directly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(20 + l2)
    S, RC, W, B = 5, 6, 128, 50
    ref = rng.standard_normal((S * RC, W)).astype(np.float32)
    syn = rng.standard_normal((RC, B, W)).astype(np.float32)
    syn_pad = np.concatenate([syn, np.repeat(syn[:, -1:], 64 - B, axis=1)], axis=1)
    want = np.asarray(jfs.scan_sums(jnp.asarray(ref), jnp.asarray(syn_pad), l2=l2,
                                    interpret=True))[:, :B]
    before = dict(tfs.launches)
    got = tfs.scan_sums(torch.as_tensor(ref), torch.as_tensor(syn), l2=l2)
    assert tfs.launches == before, "a CPU call must not count as a kernel launch"
    assert got.dtype == torch.float32 and got.shape == (S, B, RC)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    # chunking over B (bounded CPU memory) leaves every sum as it was
    chunked = tfs.scan_sums_reference(torch.as_tensor(ref), torch.as_tensor(syn), l2=l2,
                                      chunk_elems=S * RC * W * 7)
    torch.testing.assert_close(chunked, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfs.scan_sums(torch.as_tensor(ref[:-1]), torch.as_tensor(syn))
