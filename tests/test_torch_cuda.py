"""The port's CUDA kernels on the card: each kernel vs its plain version.

Marked `cuda`: these skip without a CUDA device.  The host with the card
has no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The kernels sum in another order than the plain versions (FMA contraction,
partial sums), so the comparison is relative to the output's max at 1e-5,
the repo's on-card bar.  The eikonal sweep kernel rounds as its plain
version does (no contraction, the same update order), so it must equal it
bit for bit.
"""

import numpy as np
import pytest
import torch

from kiwi_tpu_torch.ops import eik_sweep, float_scan, synth_window

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


def test_eikonal_crosscheck_raises_on_the_card(cuda_dev, monkeypatch):
    """A device discretization that disagrees with the host FMM oracle on
    members i > 0 raises on a CUDA engine (the CPU engine falls back to the
    host pipeline instead, tests/test_torch_eikonal.py), naming the member."""
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.gf import elseis
    from kiwi_tpu_torch.sources import eikonal as eiksrc

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
    eng._eikonal_checked_keys.clear()
    eng._invalidate()
    with pytest.raises(RuntimeError, match="disagrees with the host FMM oracle.*member 1"):
        eng.global_misfits_for_source_batch(batch)
    assert eng.eikonal_device is True
