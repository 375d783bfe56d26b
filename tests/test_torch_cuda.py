"""The port's CUDA kernels on the card: each kernel vs its plain version.

Marked `cuda`: these skip without a CUDA device.  The host with the card
has no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernels sum in another order than the plain versions (FMA contraction,
partial sums), so the comparison is relative to the output's max at 1e-5,
the repo's on-card bar.  The eikonal sweep kernel and the bilateral tables
kernel round as their plain versions do on the card (no contraction, the
same operations in the same order), so they must equal them bit for bit.
The eikonal preparation kernel rounds as the host's numpy does on x86-64
(its BLAS's FMAs written out): its sizes must equal the plain version's,
its float32 arrays lie within one ulp of them (a host whose BLAS rounds a
product otherwise moves a float64 by an ulp).  The eikonal speeds kernel
rounds as its plain version does on the card (bit for bit); the eikonal
tables kernel sums in float64, its plain version in float32 einsums (1e-6
of each field's largest magnitude).
"""

import numpy as np
import pytest
import torch

import bilat_cases
import eik_prepare_cases
import span_cases
from kiwi_tpu_torch.ops import (bilat_tables, eik_prepare, eik_sweep, eik_tables, float_scan,
                                synth_window)
from kiwi_tpu_torch.sources import bilat
from kiwi_tpu_torch.sources import eikonal as eiksrc

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
    got = _check_fused(args, kw, l2)
    assert got.shape == (RC, S, B)


def _check_fused(args, kw, l2):
    """One launch of the fused kernel against its plain version at 1e-5 of
    the max; returns the kernel's output."""
    masked = "lo" in kw
    name = "fused_scan_masked" if masked else "fused_scan"
    before = dict(float_scan.launches)
    got = float_scan.fused_scan_sums(*args, l2=l2, **kw)
    torch.cuda.synchronize()
    assert float_scan.launches[name] == before[name] + 1
    want = float_scan.fused_scan_sums_reference(*args, l2=l2, **kw)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err
    return got


@pytest.mark.parametrize("spans", [None, *span_cases.KINDS])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("RC,S,T,W,B,k_share", [
    (30, 21, 30, 72, 1000, 3),    # the point sweep's shapes (unfiltered: shared rows)
    (30, 21, 30, 72, 1000, 1),    # the filtered point sweep's (rows per rc)
    (4, 21, 30, 71, 200, 1),      # W not a multiple of 4
    (4, 21, 30, 73, 200, 2),
    (6, 1, 30, 72, 130, 3),       # one shift
    (6, 33, 30, 72, 130, 3),      # shifts over two blocks of 17 and 16
    (6, 21, 1, 72, 130, 1),       # one values row
    (6, 21, 64, 72, 130, 1),      # T at its bound
])
def test_kernel_main_path_shapes(cuda_dev, spans, l2, RC, S, T, W, B, k_share):
    """The sweep's own shapes and the edges of every size, unmasked and
    under span tables (band: the filtered sweep's pattern; edges: hi < lo,
    spans wholly outside the window, lo < basei, hi >= basei + W)."""
    rng = np.random.default_rng(RC * 1000 + S * 10 + T + W)
    args, kw = _operands(rng, RC, S, T, W, B, k_share, cuda_dev, False)
    if spans:
        basei = 37
        lo, hi = span_cases.span_table(rng, S, RC, W, basei, spans)
        kw.update(lo=torch.as_tensor(lo, device=cuda_dev), hi=torch.as_tensor(hi, device=cuda_dev),
                  basei=basei)
    got = _check_fused(args, kw, l2)
    assert got.shape == (RC, S, B)


@pytest.mark.parametrize("l2", [False, True])
def test_masked_kernel_skips_dead_samples(cuda_dev, l2):
    """The masked kernel reads no sample outside every span: NaN and Inf
    there leave its output finite and equal to the plain version's on the
    same data with those samples set to 0.  The plain version (and the JAX
    package's kernel) multiplies them by 0 and returns NaN: a divergence
    kept on purpose (ROADMAP.md §3)."""
    RC, S, T, W, B, basei = 30, 21, 30, 72, 300, 37
    rng = np.random.default_rng(5)
    args, kw = _operands(rng, RC, S, T, W, B, 1, cuda_dev, False)
    lo, hi = span_cases.span_table(rng, S, RC, W, basei, "band")
    j = basei + np.arange(W)
    live = (j >= lo.T[..., None]) & (j <= hi.T[..., None])  # [RC, S, W]
    ref, v, wgt = (a.cpu().numpy() for a in args)
    ref[~live] = np.nan  # dead for this shift
    v[np.broadcast_to(~live.any(1)[:, None], v.shape)] = np.inf  # dead for every shift
    kw.update(lo=torch.as_tensor(lo, device=cuda_dev), hi=torch.as_tensor(hi, device=cuda_dev),
              basei=basei)
    dirty = [torch.as_tensor(a, device=cuda_dev) for a in (ref, v, wgt)]
    got = float_scan.fused_scan_sums(*dirty, l2=l2, **kw)
    clean = [torch.nan_to_num(a, nan=0.0, posinf=0.0) for a in dirty]
    want = float_scan.fused_scan_sums_reference(*clean, l2=l2, **kw)
    assert torch.isfinite(got).all()
    assert not torch.isfinite(float_scan.fused_scan_sums_reference(*dirty, l2=l2, **kw)).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err


def test_kernel_rejects_deep_contraction(cuda_dev):
    rng = np.random.default_rng(0)
    args, kw = _operands(rng, 2, 3, 65, 16, 8, 1, cuda_dev, False)
    with pytest.raises(ValueError, match="T <= 64"):
        float_scan.fused_scan_sums(*args, **kw)


def _window_operands(rng, ng, G, nt_ext, nt_out, B, zu, dev, layout="random", nxw=20, nzw=8,
                     R=3, P=4):
    """Seeded window operands.  layout "random": every (b, r, p) at its own
    node; "shared": one origin per (r, p), moved by up to two nodes for a
    random quarter of the sources (what a strike sweep gives neighbouring
    sources); "empty": as "random" with f1..f6 = 0 for ~40% of the groups
    and for every group of (b, r) = (0, 1)."""
    s = (zu, zu * nzw, zu * nzw + zu)  # xunder = zunder = zu
    N = nxw * nzw
    ext = rng.standard_normal((N, ng, nt_ext)).astype(np.float32)
    node_rows = rng.integers(0, N - s[2], size=(B, R, P)).astype(np.int32)
    if layout == "shared":
        moved = rng.uniform(size=(B, R, P)) < 0.25
        node_rows = np.broadcast_to(node_rows[:1], (B, R, P)) + moved * rng.integers(
            -2, 3, size=(B, R, P))
        node_rows = np.clip(node_rows, 0, N - 1 - s[2]).astype(np.int32)
    kk = rng.integers(0, nt_ext - nt_out, size=(B, P, G)).astype(np.int32)
    wrows = rng.standard_normal((B, R, P, G, synth_window.NW)).astype(np.float32)
    if layout == "empty":
        wrows[rng.uniform(size=(B, R, P)) < 0.4, :, :6] = 0.0
        wrows[0, 1, :, :, :6] = 0.0
    wsp = rng.uniform(0.0, 1.0, (B, R, P, 4)).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (ext, node_rows)]
    args.append(s)
    args += [torch.as_tensor(a, device=dev) for a in (kk, wrows, wsp)]
    return args


@pytest.mark.parametrize("ng,G,nt_ext,nt_out,B,zu,layout,instance", [
    (10, 3, 104, 80, 257, 1, "random", "tile"),   # the finite benchmark's group shape, ragged B
    (10, 3, 104, 80, 64, 1, "shared", "tile"),    # neighbouring sources share node rows
    (10, 1, 136, 96, 61, 1, "shared", "tile"),    # the eikonal benchmark's group shape
    (10, 3, 104, 80, 13, 1, "empty", "tile"),     # empty groups; B not a multiple of the tile
    (8, 1, 136, 96, 16, 2, "empty", "tile"),
    (10, 3, 105, 80, 20, 1, "shared", "tile"),    # nt_ext % 4 != 0: one float per load
    (8, 3, 300, 200, 9, 1, "shared", "tile"),     # 7 shifted samples per lane
    (10, 1, 2048, 200, 8, 1, "shared", "tile"),   # a tile of 2: 160 KB of shared memory
    (8, 1, 600, 560, 1, 2, "random", "direct"),   # a long window (finite_long), one model
    (10, 8, 600, 500, 3, 2, "random", "direct"),  # too many samples for a lane's registers
    (8, 64, 104, 80, 5, 1, "random", "tile"),     # a deep group: G is a runtime loop
    (8, 64, 104, 80, 37, 1, "shared", "tile"),
    (10, 1, 2048, 2000, 2, 1, "random", "direct"),  # the longest window: the direct instance
    (10, 3, 2048, 2000, 3, 1, "empty", "direct"),
])
def test_window_kernel_matches_plain(cuda_dev, ng, G, nt_ext, nt_out, B, zu, layout, instance):
    rng = np.random.default_rng(ng * 1000 + G * 10 + zu + B)
    args = _window_operands(rng, ng, G, nt_ext, nt_out, B, zu, cuda_dev, layout)
    assert (synth_window.launch_plan(ng, nt_ext, nt_out, B) > 1) == (instance == "tile")
    before = synth_window.launches["window_synth"]
    got = synth_window.window_forward(*args, nt_out)
    torch.cuda.synchronize()
    assert synth_window.launches["window_synth"] == before + 1
    want = synth_window.window_forward_reference(*args, nt_out)
    assert got.shape == (B, 3, 3, nt_out) and torch.isfinite(got).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err
    if layout == "empty":  # a (b, r) whose groups are all empty gives exact zeros
        assert not got[0, 1].any()


@pytest.mark.parametrize("B,bt", [(1, 1), (2, 2), (3, 4), (45, 4)])
@pytest.mark.parametrize("layout", ["shared", "empty"])
def test_window_kernel_tiles_match_plain(cuda_dev, B, bt, layout):
    """Every source tile the chooser picks at the finite benchmark's group
    shape, reached through the batch size (1: the direct instance; 3 and
    45: a ragged last tile)."""
    rng = np.random.default_rng(B)
    args = _window_operands(rng, 10, 3, 104, 80, B, 1, cuda_dev, layout)
    assert synth_window.launch_plan(10, 104, 80, B) == bt
    before = synth_window.launches["window_synth"]
    got = synth_window.window_forward(*args, 80)
    torch.cuda.synchronize()
    assert synth_window.launches["window_synth"] == before + 1
    want = synth_window.window_forward_reference(*args, 80)
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err


def test_window_kernel_nearest_neighbour_strides(cuda_dev):
    """Strides (0, 0, 0) (nearest-neighbour plans, synth_window.strides):
    the kernel reads the node alone; NaN rows at every other node do not
    reach the output, which matches the plain version."""
    rng = np.random.default_rng(11)
    args = _window_operands(rng, 10, 3, 104, 80, 37, 1, cuda_dev)
    ext, node_rows = args[0].clone(), args[1]
    unused = torch.ones(ext.shape[0], dtype=torch.bool, device=cuda_dev)
    unused[node_rows.flatten().long()] = False
    ext[unused] = float("nan")
    wsp = torch.zeros_like(args[5])
    wsp[..., 0] = 1.0
    ops = (ext, node_rows, (0, 0, 0), args[3], args[4], wsp, 80)
    got = synth_window.window_forward(*ops)
    want = synth_window.window_forward_reference(*ops)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err


def test_window_kernel_dead_groups_read_nan(cuda_dev):
    """Bilinear strides: NaN rows at every node that no live centroid's
    stencil reads (what an invalid centroid at the window's last depth
    reads in the next column) reach neither the kernel's output nor the
    plain version's, and the two agree."""
    rng = np.random.default_rng(12)
    args = _window_operands(rng, 10, 3, 104, 80, 37, 1, cuda_dev, "empty")
    ext, node_rows, s, wrows = args[0].clone(), args[1], args[2], args[4]
    live = (wrows[..., :6] != 0).any(-1)  # [B, R, P, G]
    unused = torch.ones(ext.shape[0], dtype=torch.bool, device=cuda_dev)
    for o in (0,) + tuple(s):
        unused[node_rows[live.any(-1)].long() + o] = False
    assert unused[node_rows[~live.any(-1)].long()].any()
    ext[unused] = float("nan")
    ops = (ext, node_rows, s, args[3], wrows, args[5], 80)
    got = synth_window.window_forward(*ops)
    want = synth_window.window_forward_reference(*ops)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= 1e-5, err


def _scan_operands(rng, S, RC, B, W, layout, dev, scale):
    """ref [S*RC, W] and syn [RC, B, W]: contiguous, or the finite caller's
    views of [S, RC, PL] and [B, RC, PL] probes, sliced at i0 (`any_offset`:
    PL odd, rows at every offset from a 16-byte boundary, the kernel's
    4-byte copies; `one_offset`: PL a multiple of 4 and i0 = 3, every row 3
    samples past a boundary, as on the finite path: its 16-byte copies)."""
    if layout == "contiguous":
        PL, i0 = W, 0
    elif layout == "any_offset":
        PL, i0 = W + 13, 5
    else:
        PL, i0 = -(-W // 4) * 4 + 8, 3
    ref_proc = rng.standard_normal((S, RC, PL)).astype(np.float32) * np.float32(scale)
    syn_s = rng.standard_normal((B, RC, PL)).astype(np.float32) * np.float32(scale)
    ref_proc, syn_s = (torch.as_tensor(a, device=dev) for a in (ref_proc, syn_s))
    ref = ref_proc[..., i0:i0 + W].reshape(S * RC, W)
    syn = syn_s[..., i0:i0 + W].transpose(0, 1)
    if layout == "contiguous":
        syn = syn.contiguous()
    return ref, syn


@pytest.mark.parametrize("layout", ["contiguous", "any_offset", "one_offset"])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("S,RC,B,W,scale", [
    (21, 30, 256, 88, 1.0),     # the finite path's scan
    (21, 30, 256, 128, 1.0),    # the finite benchmark's scan at a longer probe
    (1, 6, 7, 50, 1.0),         # one shift, ragged B, W not a multiple of 4
    (5, 4, 33, 200, 1.0),       # B over one 32-model block, W over 3 passes of 24 quads
    (33, 4, 40, 96, 1.0),       # S over one shift tile: two tiles of 17 and 16
    (70, 3, 65, 130, 1.0),      # S over two shift tiles: three of 24, 24, 22
    (5, 4, 33, 1000, 1.0),      # a long window: 11 passes
    (33, 3, 40, 601, 1.0),      # 7 passes with two shift tiles, W odd
    (21, 30, 256, 88, 1e-19),   # moment-1.0 amplitudes: squares near and below FLT_MIN
])
def test_scan_kernel_matches_plain(cuda_dev, l2, S, RC, B, W, scale, layout):
    rng = np.random.default_rng(S * 100 + RC + W)
    ref, syn = _scan_operands(rng, S, RC, B, W, layout, cuda_dev, scale)
    before = float_scan.launches["scan_sums"]
    got = float_scan.scan_sums(ref, syn, l2=l2)
    torch.cuda.synchronize()
    assert float_scan.launches["scan_sums"] == before + 1
    want = float_scan.scan_sums_reference(ref, syn, l2=l2)
    assert got.shape == (S, B, RC) and torch.isfinite(got).all()
    assert want.abs().max().item() > 0.0
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-5, err


def _eik_operands(rng, B, nx, ny, dev, frac=None, scale=1.0):
    """Seeded solve operands, cells of 50-300 m times `scale`; frac in
    [0, 1] per axis puts every source's seed at that fraction of the grid
    (1: the last row or column), else a random cell."""
    speed = rng.uniform(1000.0, 4000.0, (B, nx, ny)).astype(np.float32)
    delta = (rng.uniform(50.0, 300.0, (B, 2)) * scale).astype(np.float32)
    first = (rng.uniform(-1000.0, 0.0, (B, 2)) * scale).astype(np.float32)
    f = rng.uniform(0.0, 1.0, (B, 2)) * [nx - 1, ny - 1] if frac is None else (
        np.array(frac, np.float64) * [nx - 0.5, ny - 0.5])
    ip = (first + f * delta).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (speed, delta, first, ip)]


def _eik_check(args, n_rounds):
    """The kernel against its plain version: the same cells reached, and
    every reached cell bit for bit (no contraction, the same roundings)."""
    before = eik_sweep.launches["eik_sweep"]
    got = eik_sweep.sweep_solve_batch(*args, n_rounds=n_rounds)
    torch.cuda.synchronize()
    assert eik_sweep.launches["eik_sweep"] == before + 1
    want = eik_sweep.sweep_solve_batch_reference(*args, n_rounds=n_rounds)
    assert got.shape == want.shape
    reached = want < 1e29
    assert torch.equal(got < 1e29, reached)
    assert torch.equal(got[reached], want[reached]), int((got != want)[reached].sum())
    return got


@pytest.mark.parametrize("B,nx,ny,n_rounds", [
    (37, 48, 40, 2),     # B not a multiple of 32, nx != ny
    (5, 144, 136, 2),    # the eikonal benchmark's fine grid
    (3, 31, 97, 1),      # odd ny (padded pitch), nx < one warp
    (2, 1, 7, 3),        # one row
    (2, 600, 80, 1),     # nx > 512: the first design (a barrier per diagonal), shared grid
    (2, 250, 240, 1),    # above the shared-memory limit: the grid in device memory
    (2, 1100, 24, 1),    # nx > 1024: a thread takes two rows, grid in shared memory
    (1, 1500, 60, 1),    # nx > 1024 above the shared-memory limit
])
def test_eik_sweep_kernel_matches_plain(cuda_dev, B, nx, ny, n_rounds):
    rng = np.random.default_rng(B * 100 + nx)
    _eik_check(_eik_operands(rng, B, nx, ny, cuda_dev), n_rounds)


@pytest.mark.parametrize("n_rounds", [1, 2])
@pytest.mark.parametrize("corner", [(0, 0), (1, 1), (0, 1), (1, 0)])
@pytest.mark.parametrize("ny", [1, 2, 136])
@pytest.mark.parametrize("nx", [32, 33, 64, 65, 160])
def test_eik_sweep_warp_edges(cuda_dev, nx, ny, corner, n_rounds):
    """Rows at and just past a warp's 32 (a partial last warp of one row),
    one and two columns, the seed in the first or last row and column."""
    rng = np.random.default_rng(nx * 1000 + ny * 10 + 2 * corner[0] + corner[1])
    _eik_check(_eik_operands(rng, 2, nx, ny, cuda_dev, frac=corner), n_rounds)


@pytest.mark.parametrize("scale", [2e-8, 1e-14])
def test_eik_sweep_tiny_cells(cuda_dev, scale):
    """Cells so small that the square root's argument da^2 dc^2 (da^2 + dc^2
    - diff^2) falls below 2^-101 (scale 2e-8: cells of 1-6 um), where the
    kernel's branch-free root scales it, or to exactly 0 (1e-14: da^2 dc^2
    underflows); the 2-D candidate is then as small as the 1-D terms, so
    its root decides the result."""
    rng = np.random.default_rng(int(1 / scale) % 1000)
    args = _eik_operands(rng, 3, 70, 50, cuda_dev, scale=scale)
    da2dc2 = (args[1][:, 0] ** 2 * args[1][:, 1] ** 2).cpu().numpy()
    assert (da2dc2 < 2.0 ** -60).all() if scale > 1e-10 else (da2dc2 == 0).all()
    for n_rounds in (1, 2):
        _eik_check(args, n_rounds)


def _boundary_operands(dev, nx=160, ny=136):
    """One source whose every direction's first sweep lowers cells on both
    sides of every warp boundary (flipped rows 31 | 32, 63 | 64, ...): the
    seed in the first row and a speed field of slow and fast bands at an
    angle, so that the fastest paths turn in all four directions."""
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    speed = 2500.0 + 2000.0 * np.sin(i / 9.0 + j / 13.0) * np.cos(i / 17.0 - j / 7.0)
    ops = (speed[None].astype(np.float32), np.array([[100.0, 120.0]], np.float32),
           np.zeros((1, 2), np.float32), np.array([[50.0, 120.0 * 70.5]], np.float32))
    return [torch.as_tensor(a, device=dev) for a in ops]


def test_eik_sweep_warp_boundaries_change(cuda_dev, monkeypatch):
    args = _boundary_operands(cuda_dev)
    nx = args[0].shape[1]
    # the plain version sweep by sweep: the first 1, 2, 3, 4 directions of round 1
    real = eik_sweep._diagonals
    states = []
    for ndir in range(5):
        monkeypatch.setattr(eik_sweep, "_diagonals", lambda a, b, n=ndir: real(a, b)[:n])
        states.append(eik_sweep.sweep_solve_batch_reference(*args, n_rounds=1)[0])
    monkeypatch.setattr(eik_sweep, "_diagonals", real)
    for d, (flip0, _flip1) in enumerate(eik_sweep.DIRS):
        lowered = (states[d + 1] < states[d]).any(dim=1)  # per row
        if flip0:
            lowered = lowered.flip(0)  # flipped rows
        for edge in range(32, nx, 32):
            assert lowered[edge - 1] and lowered[edge], (d, edge)
    for n_rounds in (1, 2):
        _eik_check(args, n_rounds)


def test_eik_sweep_kernel_rejects(cuda_dev):
    rng = np.random.default_rng(0)
    speed, delta, first, ip = _eik_operands(rng, 2, 8, 8, cuda_dev)
    with pytest.raises(ValueError, match="f32"):
        eik_sweep.sweep_solve_batch(speed.double(), delta, first, ip)
    with pytest.raises(ValueError, match="one device"):
        eik_sweep.sweep_solve_batch(speed, delta.cpu(), first, ip)


@pytest.mark.parametrize("name", sorted(bilat_cases.CASES))
def test_bilat_tables_equal_the_plain_chain(cuda_dev, name):
    """The bilateral discretization on the card: one launch whose six tables
    equal the plain chain's on the card bit for bit (bilat_cases.py)."""
    rows, shape = bilat_cases.case(name)
    p = torch.as_tensor(rows, device=cuda_dev)
    before = bilat_tables.launches["bilat_tables"]
    got = bilat.discretize(p, bilat_cases.EDT, shape)
    torch.cuda.synchronize()
    assert bilat_tables.launches["bilat_tables"] == before + 1
    want = bilat.discretize_reference(p, shape)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), k
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (k, int((g != w).sum()))


def test_bilat_gradient_takes_the_plain_chain(cuda_dev):
    """Rows that require grad (the gradient paths' leaves) take the plain
    chain: no launch, and the gradient reaches the parameters."""
    rows, shape = bilat_cases.case("lm4")
    leaf = torch.as_tensor(rows, device=cuda_dev).requires_grad_()
    before = bilat_tables.launches["bilat_tables"]
    tables = bilat.discretize(leaf, bilat_cases.EDT, shape)
    (tables["time"].sum() + tables["depth"].sum() + tables["m"].sum()).backward()
    assert bilat_tables.launches["bilat_tables"] == before
    assert torch.isfinite(leaf.grad).all()
    assert (leaf.grad[:, [0, 3, 5, 6, 7, 9, 10, 12]] != 0).all()


def _f32_ulps_apart(got, want):
    """Per element, whether two float32 tensors differ by more than one ulp
    of the plain version's value."""
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"))) - want.abs()
    return (got - want).abs() > ulp


@pytest.mark.parametrize("name", sorted(eik_prepare_cases.CASES))
def test_eik_prepare_matches_the_plain_version(cuda_dev, name):
    """The eikonal batch preparation on the card: one launch whose arrays are
    the plain version's (sources/eikonal._prepare_batch_vec, cast as the
    discretizer casts them): sizes, the static shape and the hard bound on
    time cells equal, floats at most one float32 ulp apart; a refused batch
    raises the host's ValueError with its message, its bad rows flagged
    (eik_prepare_cases.py)."""
    model, rows, ctx, error = eik_prepare_cases.case(name)
    named = eiksrc.named_params_batch(model, rows)
    before = eik_prepare.launches["eik_prepare"]
    summary, got = eik_prepare.eik_prepare(eik_prepare.rows_on(named, cuda_dev), ctx,
                                           eik_prepare_cases.EDT)
    torch.cuda.synchronize()
    assert eik_prepare.launches["eik_prepare"] == before + 1
    summary = summary.cpu().numpy()
    status = got.pop("status").cpu().numpy()
    if error is not None:
        with pytest.raises(ValueError, match=error):
            eik_prepare.static_from_summary(summary)
        with pytest.raises(ValueError, match=error):
            eiksrc.prepare_batch(named, eik_prepare_cases.EDT, ctx)
        both = eik_prepare.EMPTY | eik_prepare.NUKL_OUTSIDE  # at 600 m, nucleation too
        want_status = {"empty": {5: both, 9: eik_prepare.NUKL_OUTSIDE},
                       "nukl_outside": {7: eik_prepare.NUKL_OUTSIDE}}[name]
        assert {i: int(v) for i, v in enumerate(status) if v} == want_status
        return
    plain_summary, plain = eik_prepare.eik_prepare(eik_prepare.rows_on(named, "cpu"), ctx,
                                                   eik_prepare_cases.EDT)
    static, _arrays = eik_prepare_cases.host_prepare(name)
    assert eik_prepare.static_from_summary(summary) == eik_prepare.static_from_summary(
        plain_summary.numpy())
    assert eik_prepare.static_from_summary(summary)[0] == static
    assert not status.any()
    plain.pop("status")
    assert set(got) == set(plain)
    for k, w in plain.items():
        g = got[k].cpu()
        assert g.shape == w.shape and g.dtype == w.dtype and got[k].is_contiguous(), k
        if w.dtype == torch.int32:
            assert torch.equal(g, w), (k, int((g != w).sum()))
        else:
            assert not _f32_ulps_apart(g, w).any(), (k, int(_f32_ulps_apart(g, w).sum()))


def test_eik_prepare_on_the_engine_path(cuda_dev):
    """On a CUDA engine a device discretization at a calibrated shape makes
    one launch, waits once for the summary and copies none of the prepared
    arrays: the CPU session's counts (tests/test_torch_eik_prepare.py); its
    global misfits are the CPU engine's at 1e-5 of the largest."""
    eng = eik_prepare_cases.session(cuda_dev)
    batch = eik_prepare_cases.session_batch()
    eng.global_misfits_for_source_batch(batch)  # calibrates and cross-checks
    before = eik_prepare.launches["eik_prepare"]
    waits = eik_prepare_cases.waits(lambda: eng.discretize(batch))
    assert eik_prepare.launches["eik_prepare"] == before + 1
    assert waits == eik_prepare_cases.SESSION_WAITS
    got = eng.global_misfits_for_source_batch(batch).cpu().numpy()
    want = eik_prepare_cases.session("cpu").global_misfits_for_source_batch(batch).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


EIK_TABLE_CASES = ("radius_sweep", "dips", "radii_on_the_grid", "shallow", "oblique",
                   "mt_eikonal")


def _eik_prepared(name, dev, constraints=None):
    """(static, arrays, context tensor, sizes) of case `name` prepared on the
    card (under other constraints where given)."""
    model, rows, ctx, _error = eik_prepare_cases.case(name)
    if constraints is not None:
        ctx = eik_prepare_cases.context(constraints)
    named = eiksrc.named_params_batch(model, rows)
    summary, arrays = eik_prepare.eik_prepare(eik_prepare.rows_on(named, dev), ctx,
                                              eik_prepare_cases.EDT)
    static, _hard = eik_prepare.static_from_summary(summary.cpu().numpy())
    return (static, arrays, *eik_tables.context_on(dev, ctx))


def _eik_solved(name, dev, constraints=None):
    """_eik_prepared and the times the kernels solve for it."""
    static, arrays, ctx_arr, sizes = _eik_prepared(name, dev, constraints)
    speeds = eik_tables.eik_speeds(arrays, ctx_arr, sizes, static["NF"])
    times = eik_sweep.sweep_solve_batch(speeds, arrays["delta"], arrays["first"], arrays["nukl"],
                                        n_rounds=2)
    return static, arrays, ctx_arr, sizes, times


@pytest.mark.parametrize("name", EIK_TABLE_CASES)
def test_eik_speeds_matches_the_plain_version(cuda_dev, name):
    """The speeds kernel equals the plain torch chain on the card bit for bit
    (the solve reads every speed), in one launch; two launches give the same
    bits."""
    static, arrays, ctx_arr, sizes = _eik_prepared(name, cuda_dev)
    before = eik_tables.launches["eik_speeds"]
    got = eik_tables.eik_speeds(arrays, ctx_arr, sizes, static["NF"])
    again = eik_tables.eik_speeds(arrays, ctx_arr, sizes, static["NF"])
    torch.cuda.synchronize()
    assert eik_tables.launches["eik_speeds"] == before + 2
    want = eik_tables.speeds_reference(arrays, ctx_arr, sizes, static["NF"])
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous()
    g, w = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(g, w), int((g != w).sum())
    assert torch.equal(g, again.view(torch.int32))


@pytest.mark.parametrize("budget", [None, 64])
@pytest.mark.parametrize("name", EIK_TABLE_CASES)
def test_eik_tables_matches_the_plain_version(cuda_dev, name, budget):
    """The tables kernels against the plain torch chain on the card, on the
    solve's own times.  The kernel sums in float64, the chain's einsums in
    float32 in another order: north, east, depth, time and m agree at 1e-6
    of each field's largest magnitude.  The time cells (nt, active, and the
    overflow count) are equal, except where a coarse cell's duration over
    the time step lies within 1e-5 of an integer, where that sum order can
    move the floor: such cells are counted and reported.  Two launches give
    the same bits."""
    static, arrays, ctx_arr, sizes, times = _eik_solved(name, cuda_dev)
    nt_cell_max, edt = 2, eik_prepare_cases.EDT
    args = (arrays, times, ctx_arr, sizes, static["NC"], nt_cell_max, budget, edt)
    before = eik_tables.launches["eik_tables"]
    got = eik_tables.eik_tables(*args)
    again = eik_tables.eik_tables(*args)
    torch.cuda.synchronize()
    assert eik_tables.launches["eik_tables"] == before + 2
    want = eik_tables.tables_reference(*args)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), k
        bits = (lambda x: x.view(torch.int32)) if w.dtype == torch.float32 else (lambda x: x)
        assert torch.equal(bits(g), bits(again[k])), k

    # the plain version's coarse cells that sit within 1e-5 of a time-cell
    # boundary, in the tables' order
    near = eik_tables.boundary_cells(arrays, times, ctx_arr, sizes, static["NC"], budget, edt)
    B = near.shape[0]
    nt_got = got["active"].view(B, -1, nt_cell_max).sum(-1)
    nt_want = want["active"].view(B, -1, nt_cell_max).sum(-1)
    apart = nt_got != nt_want
    print(f"{name}, budget {budget}: {int(near.sum())} cells within 1e-5 of a time-cell "
          f"boundary, {int(apart.sum())} with another nt")
    assert not (apart & ~near).any(), int((apart & ~near).sum())
    same = ~apart[:, :, None].expand(-1, -1, nt_cell_max).reshape(B, -1)
    assert torch.equal(got["active"][same], want["active"][same])
    sources_near = near.any(dim=1)
    assert torch.equal(got["overflow"][~sources_near], want["overflow"][~sources_near])
    for k in ("north", "east", "depth", "time", "m"):
        g, w = got[k][same], want[k][same]
        err = float((g - w).abs().max())
        assert err <= 1e-6 * float(w.abs().max()), (k, err, float(w.abs().max()))
    if budget is not None:
        assert (got["overflow"] > 0).any() == (want["overflow"] > 0).any()


@pytest.mark.parametrize("ncons", [0, 1, 4])
def test_eik_fine_grid_kernels_at_any_constraint_count(cuda_dev, ncons):
    """The kernels read any number of constraints from shared memory: at 0,
    1 and 4 constraints the speeds equal the plain version's bits and the
    tables agree at 1e-6 of each field's largest magnitude, with the same
    time cells."""
    far = (np.array([0.0, 0.0, 100000.0]), np.array([0.0, 0.0, 1.0]))  # clips nothing
    constraints = {0: [], 1: eik_prepare_cases.DEFAULT[:1],
                   4: eik_prepare_cases.OBLIQUE + [far]}[ncons]
    static, arrays, ctx_arr, sizes, times = _eik_solved("dips", cuda_dev, constraints)
    assert sizes[0] == ncons
    speeds = eik_tables.eik_speeds(arrays, ctx_arr, sizes, static["NF"])
    want = eik_tables.speeds_reference(arrays, ctx_arr, sizes, static["NF"])
    assert torch.equal(speeds.view(torch.int32), want.view(torch.int32))
    args = (arrays, times, ctx_arr, sizes, static["NC"], 2, None, eik_prepare_cases.EDT)
    got, want = eik_tables.eik_tables(*args), eik_tables.tables_reference(*args)
    assert torch.equal(got["active"], want["active"])
    assert torch.equal(got["overflow"], want["overflow"])
    for k in ("north", "east", "depth", "time", "m"):
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-6 * float(want[k].abs().max()), (k, err)


def test_eik_tables_on_the_engine_path(cuda_dev):
    """A device discretization on a CUDA engine launches each of the two
    fine-grid kernels once (eik_speeds, eik_tables) and the solve once."""
    eng = eik_prepare_cases.session(cuda_dev)
    batch = eik_prepare_cases.session_batch()
    eng.global_misfits_for_source_batch(batch)  # calibrates and cross-checks
    before = {**eik_tables.launches, **eik_sweep.launches}
    eng.discretize(batch)
    torch.cuda.synchronize()
    after = {**eik_tables.launches, **eik_sweep.launches}
    assert {k: after[k] - before[k] for k in after} == {"eik_speeds": 1, "eik_tables": 1,
                                                        "eik_sweep": 1}


def test_eikonal_crosscheck_raises_on_the_card(cuda_dev, monkeypatch):
    """A device discretization that disagrees with the host FMM oracle on
    members i > 0 raises on a CUDA engine (the CPU engine falls back to the
    host pipeline instead, tests/test_torch_eikonal.py), naming the member."""
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.gf import elseis

    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1.0]))
    eng = Engine(store, device=cuda_dev)
    olat, olon = 30.0, 70.0
    recs = []
    for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0), (2700.0, 2.6)]:
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d * np.cos(az),
                                  d * np.sin(az))
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_misfit_method("l2norm")
    eng.set_source_constraints([[0, 0, 50.0], [0, 0, 700.0]], [[0, 0, -1.0], [0, 0, 1.0]])
    p = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0, 0.0, 0.0, 250.0, 50.0, -50.0,
                  0.9, 0.3], dtype=np.float32)
    eng.set_source_params("eikonal", p)
    eng.set_synthetic_reference()
    batch = np.tile(p, (4, 1))
    batch[:, 10] = [200.0, 250.0, 300.0, 350.0]
    assert np.argmin(eng.global_misfits_for_source_batch(batch).cpu().numpy()) == 1

    real = eiksrc.discretize_device_batch

    def corrupt(*args, **kw):
        out = dict(real(*args, **kw))
        north = out["north"].clone()
        north[1:] += 3000.0
        out["north"] = north
        return out

    monkeypatch.setattr(eiksrc, "discretize_device_batch", corrupt)
    eng.batch_discretizer().checked_keys.clear()
    eng._invalidate()
    with pytest.raises(RuntimeError, match="disagrees with the host FMM oracle.*member 1"):
        eng.global_misfits_for_source_batch(batch)
    assert eng.batch_discretizer().on_device is True


def _card_and_cpu_engines(dev, dt, method, shiftrange):
    """tests/test_torch_gradient.py's session (3 `ned` receivers, the
    bilateral fault's own synthetic as the reference) on the card and on the
    CPU, over one analytic store sampled at dt."""
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.gf import elseis

    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=dt, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1.0]))
    out = []
    for device in (dev, "cpu"):
        eng = Engine(store, device=device)
        recs = []
        for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0)]:
            la, lo = geo.ne_to_latlon(np.radians(30.0), np.radians(70.0), d * np.cos(az),
                                      d * np.sin(az))
            recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
        eng.set_receivers(recs)
        eng.set_source_location(30.0, 70.0, 0.0)
        eng.set_effective_dt(0.1)
        eng.set_local_interpolation(True)
        eng.set_source_params("bilateral", BILAT)
        eng.set_misfit_method(method)
        eng.set_synthetic_reference()
        eng.set_floating_shiftrange(*shiftrange)
        out.append(eng)
    return out


BILAT = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                  2500.0, 0.2], np.float32)


def _launch_counts():
    return {**float_scan.launches, **synth_window.launches, **eik_sweep.launches}


@pytest.mark.parametrize("method,shiftrange", [("l2norm", (0.0, 0.0)),
                                               ("floating_l1norm", (-0.5, 0.5))])
def test_gradient_on_the_card_matches_cpu(cuda_dev, method, shiftrange):
    """global_misfits_and_grad and misfit_jacobian on the card against the
    CPU port: g at 1e-5 relative, every gradient and Jacobian component at
    1e-4 of its row's largest (minimize_multistart's scale); no kernel runs."""
    from kiwi_tpu_torch.sources import get_source_model

    card, cpu = _card_and_cpu_engines(cuda_dev, 0.1, method, shiftrange)
    rows = np.tile(BILAT, (3, 1))
    rows[:, 5] += (13.0, -6.5, 4.2)
    rows[:, 6] -= (7.0, 2.5, 1.1)
    rows[:, 0] += (0.03, -0.02, 0.01)
    before = _launch_counts()
    g, grad = card.global_misfits_and_grad(rows)
    m, J = card.misfit_jacobian(rows[0], mask=np.isin(np.arange(14), (5, 6, 7)))
    assert _launch_counts() == before
    g_cpu, grad_cpu = cpu.global_misfits_and_grad(rows)
    m_cpu, J_cpu = cpu.misfit_jacobian(rows[0], mask=np.isin(np.arange(14), (5, 6, 7)))
    np.testing.assert_allclose(g, g_cpu, rtol=1e-5, atol=1e-5 * np.abs(g_cpu).max())
    np.testing.assert_allclose(m, m_cpu, rtol=1e-5, atol=1e-5 * np.abs(m_cpu).max())
    norm = get_source_model("bilateral").norm.astype(np.float64)
    scale = np.where(rows != 0, np.abs(rows), 0.01 * norm)
    for got, want, sc in ((grad, grad_cpu, scale), (J, J_cpu, scale[0, 5:8])):
        d = np.abs(got - want) * sc
        assert (d <= 1e-4 * (np.abs(want) * sc).max(axis=-1, keepdims=True)).all()


def test_long_window_plan_on_the_card(cuda_dev):
    """An extended time axis above T_MAX: the plain synthesis on the card,
    then the scan kernel (one launch, no window kernel), against the CPU
    port at 1e-5 relative."""
    card, cpu = _card_and_cpu_engines(cuda_dev, 0.001, "floating_l1norm", (-0.02, 0.02))
    rows = np.tile(BILAT, (4, 1))
    rows[:, 5] = (20.0, 91.0, 150.0, 260.0)
    before = _launch_counts()
    m, n, fs = (x.cpu().numpy() for x in card.misfits_for_source_batch(rows))
    after = _launch_counts()
    assert card._plan["formulation"] == "plain"
    assert after["scan_sums"] - before["scan_sums"] == 1
    assert after["window_synth"] == before["window_synth"]
    mc, nc, fsc = (x.numpy() for x in cpu.misfits_for_source_batch(rows))
    np.testing.assert_allclose(m, mc, rtol=1e-5, atol=1e-5 * np.abs(mc).max())
    np.testing.assert_allclose(n, nc, rtol=1e-5, atol=1e-5 * np.abs(nc).max())
    np.testing.assert_array_equal(fs, fsc)


def test_kiwi_main_work_on_the_card(cuda_dev, tmp_path, monkeypatch):
    """kiwi_main work on the card at a coarse grid (tests/test_kiwi_main.py's
    scenario, the data directory written by the port): the plan in the window
    formulation, window_synth launched, and the same best source and min
    misfit (1e-5 relative) as the same run on the CPU port.  The SDR grid
    holds both planes of a double couple (strike 90, dip 90, slip-rake -180
    is strike 180, dip 90, slip-rake 0), whose misfits tie to float
    rounding, so the best mechanisms compare by their moment tensors."""
    from kiwi_tpu_torch.euler import mt_from_sdr

    from kiwi_tpu_torch import dataset, geo
    from kiwi_tpu_torch.cli import kiwi_main
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.gf import elseis

    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1.0]))
    dbfile = str(tmp_path / "db.npz")
    store.save(dbfile)
    eng = Engine(store, device="cpu")
    recs = []
    for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0), (2700.0, 2.6)]:
        la, lo = geo.ne_to_latlon(np.radians(30.0), np.radians(70.0), d * np.cos(az),
                                  d * np.sin(az))
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(30.0, 70.0, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    truth = BILAT.copy()
    truth[9:12] = 0.0  # a point source
    eng.set_source_params("bilateral", truth)
    eng.set_synthetic_reference()
    datadir = str(tmp_path / "event")
    dataset.save_dataset(datadir, eng, fmt="mseed")

    engines = []
    real = dataset.standard_setup

    def setup(*a, **kw):
        engines.append(real(*a, **kw))
        return engines[-1]

    monkeypatch.setattr(dataset, "standard_setup", setup)
    opts = dict(components="ned", effective_dt="0.1", depth="600", moment="5e11",
                grid_step_deg="30", bootstrap_iterations="10", shiftrange="-0.5,0.5",
                **{"rupture-velocity": "2500", "rise-time": "0.2"})
    before = _launch_counts()
    best, steps = kiwi_main.work(datadir, dbfile, str(tmp_path / "card"), **opts)
    after = _launch_counts()
    assert engines[0].device.type == "cuda"
    assert engines[0]._plan["formulation"] == "window"
    assert after["window_synth"] > before["window_synth"]
    best_cpu, steps_cpu = kiwi_main.work(datadir, dbfile, str(tmp_path / "cpu"), device="cpu",
                                         **opts)
    sdr = [5, 6, 7]
    np.testing.assert_array_equal(np.delete(best.params, sdr), np.delete(best_cpu.params, sdr))
    mt, mt_cpu = (mt_from_sdr(*np.radians(b.params[sdr].astype(np.float64)))
                  for b in (best, best_cpu))
    np.testing.assert_allclose(mt, mt_cpu, atol=1e-6)
    assert steps[-2].out_config["min_misfit"] == pytest.approx(
        steps_cpu[-2].out_config["min_misfit"], rel=1e-5)


def test_eikonal_benchmark_on_the_card(cuda_dev, monkeypatch, capsys):
    """cli.tools.eikonal_benchmark at its default 300 x 300 grid, 8 rounds
    (above the shared-memory limit: the kernel's first design): the kernel
    launched, and equal bit for bit to its plain version on the operands of
    the tool's own calls."""
    from kiwi_tpu_torch import eikonal
    from kiwi_tpu_torch.cli import tools

    seen = []
    real = eikonal.sweep_solve_batch

    def recorder(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(eikonal, "sweep_solve_batch", recorder)
    before = eik_sweep.launches["eik_sweep"]
    tools.eikonal_benchmark(["300"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[1].startswith("device sweep  300x300: ")
    assert eik_sweep.launches["eik_sweep"] == before + len(seen) == before + 2
    (speed, delta, first, ip), kw = seen[-1]
    assert speed.is_cuda and tuple(speed.shape) == (1, 300, 300) and kw["n_rounds"] == 8
    _eik_check((speed, delta, first, ip), 8)


def test_web_calculate_on_the_card(cuda_dev, tmp_path):
    """One web calculate of a finite bilateral fault on the card equals the
    same calculate of a CPU app within 1e-5 of each row's largest value,
    with the same rows and itmin; the source view's tables come to the
    host."""
    import json

    from kiwi_tpu_torch.gf import elseis
    from kiwi_tpu_torch.web import SeismogramApp

    store = elseis.build_ahfull_store(
        nx=40, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1.0]))
    form = {"sourcetype": "bilateral", "source_latitude": "30.0", "source_longitude": "70.0",
            "effective_dt": "0.1", "interpolation": "bilinear",
            "receivers": "30.02 70.0 ned\n30.025 70.01 ne",
            **{f"param.{k}": v for k, v in (("depth", "400"), ("moment", "1e12"),
                                            ("strike", "91"), ("dip", "87"),
                                            ("slip-rake", "164"), ("length-a", "300"),
                                            ("length-b", "200"), ("width", "250"),
                                            ("rupture-velocity", "2500"),
                                            ("rise-time", "0.2"))}}
    rows, cents = {}, {}
    for device in ("cuda", "cpu"):
        app = SeismogramApp(store, str(tmp_path / device), device=device)
        assert app.engine.device.type == device
        gen = app.calculate(1, dict(form))
        rows[device] = app._load(1, gen)["traces"]
        cents[device] = app.source_centroids(1, gen)
    assert [(r["receiver"], r["component"], r["itmin"]) for r in rows["cuda"]] == [
        (r["receiver"], r["component"], r["itmin"]) for r in rows["cpu"]]
    for g, w in zip(rows["cuda"], rows["cpu"]):
        g, w = np.asarray(g["values"]), np.asarray(w["values"])
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    for k in ("north", "east", "depth", "time", "weight"):
        g, w = np.asarray(cents["cuda"][k]), np.asarray(cents["cpu"][k])
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
    json.dumps(cents["cuda"])


def test_gfshard_ranks_on_the_card(cuda_dev):
    """Two ranks of a gloo group share cuda:0, each holding the GF window of
    its receiver group: both launch window_synth and scan_sums, every rank
    returns the same misfits, and they match the CPU port's unsharded
    engine at 1e-5 of the largest value, shifts exactly."""
    import torch_parallel_ranks as R
    from kiwi_tpu_torch.gf import elseis
    from kiwi_tpu_torch.parallel import spawn_ranks

    store = elseis.build_ahfull_store(**R.STORE, stf=R.STF)
    args = (store.dt, store.dx, store.dz, store.firstx, store.firstz, store.data, store.itmin,
            store.nsamples)
    pb = R.sweep(16, 5, 0.0, 350.0)
    ranks = spawn_ranks(R.card_gfshard_rank, 2, (args, pb), timeout=600.0)
    cpu = R.make_engine(args)
    R.floating(cpu, True)
    want = [x.numpy() for x in cpu.misfits_for_source_batch(pb)]
    for m, n, fs, (windows, scans), nbytes in ranks:
        assert windows > 0 and scans > 0 and nbytes > 0
        for got, ref in ((m, want[0]), (n, want[1])):
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        np.testing.assert_array_equal(fs, want[2])
