"""Parity of the port's finite-source synthesis pieces with the JAX package:
batched kinematics (kiwi_tpu_torch.synth._centroid_kinematics with a batch
axis), span tables, and the window synthesis
(kiwi_tpu_torch.ops.synth_window), on the 40x8 fullspace store and 4
receivers of tests/test_synth_window.py.

The window synthesis is held against the JAX Pallas kernel in interpret
mode and against the JAX package's XLA formulation (_grouped_accumulate)
at 1e-5 of the output's max (tests/test_synth_window.py's bar): the 2-tap
shift applies after the contraction in the kernel and before it in the
XLA path, exact up to float32 reassociation.  Integer leaves and spans
match exactly; float kinematics meet tests/test_torch_synth.py's bound.
On a CPU tensor the port's wrapper runs its plain version; the CUDA kernel
is held against that plain version on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiwi_tpu import geo as jgeo
from kiwi_tpu import synth as js
from kiwi_tpu.gf import elseis as jelseis
from kiwi_tpu.ops import synth_window as jsw
from kiwi_tpu.sources import bilat as jbilat
from kiwi_tpu_torch import synth as ts
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.ops import synth_window as tsw

STF = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
EDT = 0.1
FAULT = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                  2500.0, 0.2], np.float32)


def _close(got, want, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    floor = max(1e-6 * max(float(np.abs(want).max()), 1e-30), atol)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=floor)


def _exact(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def world():
    jstore = jelseis.build_ahfull_store(
        nx=40, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=STF,
    )
    tstore = TStore.from_numpy(jstore.dt, jstore.dx, jstore.dz, jstore.firstx,
                               jstore.firstz, jstore.data, jstore.itmin, jstore.nsamples)
    olat, olon = np.radians(30.0), np.radians(70.0)
    lats, lons = [], []
    for i in range(4):
        la, lo = jgeo.ne_to_latlon(olat, olon, 1200.0 + 400.0 * i, 0.3 * i)
        lats.append(float(la))
        lons.append(float(lo))
    jgeom = js.precompute_receiver_geometry(olat, olon, lats, lons)
    tgeom = ts.precompute_receiver_geometry(olat, olon, lats, lons)
    # three faults with the strike (hence the centroid positions) varying
    pb = np.tile(FAULT, (3, 1))
    pb[:, 5] = (20.0, 91.0, 200.0)
    shape = jbilat.grid_shape(FAULT, EDT)
    cb = jax.jit(jax.vmap(lambda q: jbilat.discretize(q, EDT, shape)))(jnp.asarray(pb))
    return jstore, tstore, jgeom, tgeom, pb, shape, {k: np.asarray(v) for k, v in cb.items()}


def _cfgs(jstore, tstore, jgeom, tgeom, pb, under):
    ext, d, t = jbilat.param_stats(pb, EDT)
    args = (ext * 1.1 + 400.0, (d[0] - 200.0, d[1] + 200.0), (t[0] - 0.8, t[1] + 0.8))
    cfg_j = js.plan_config(jstore, jgeom, *args, interpolate=True, xunder=under, zunder=under)
    cfg = ts.plan_config(tstore, tgeom, *args, interpolate=True, xunder=under, zunder=under)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(cfg_j)
    return cfg_j, cfg


def _kinematics(world, under):
    jstore, tstore, jgeom, tgeom, pb, _shape, cb = world
    cfg_j, cfg = _cfgs(jstore, tstore, jgeom, tgeom, pb, under)
    recs_j = jgeom.device()
    kin_j = jax.jit(jax.vmap(lambda cent: jax.vmap(
        lambda rec: js._centroid_kinematics(cfg_j, rec, cent))(recs_j)))(
        {k: jnp.asarray(v) for k, v in cb.items()})
    # the same centroids on both sides, so that only the kinematics differ
    kin = ts._centroid_kinematics(cfg, tgeom.to("cpu"), {k: torch.tensor(v) for k, v in cb.items()})
    return cfg_j, cfg, kin_j, kin


@pytest.mark.parametrize("under", [1, 2])
def test_batched_kinematics_match(world, under):
    cfg_j, cfg, kin_j, kin = _kinematics(world, under)
    tgeom = world[3]
    assert kin["ish"].shape == (3, 4, int(np.prod(world[5])))
    for k in ("ixs", "izs", "ish", "valid"):
        _exact(kin[k], kin_j[k])
    for k in ("wg", "f", "frac", "sin_az", "cos_az", "sin_l", "cos_l"):
        assert kin[k].dtype == torch.float32
        _close(kin[k], kin_j[k])
    dist_tol = 2 * float(np.spacing(np.float32(tgeom.dist.max() + 1000.0))) / (cfg.dx * under)
    _close(kin["wsp"], kin_j["wsp"], atol=dist_tol)
    # the one-source call still gives [R, C] leaves
    one = ts._centroid_kinematics(cfg, tgeom.to("cpu"),
                                  {k: torch.tensor(v[1]) for k, v in world[6].items()})
    for k in ("ixs", "ish", "valid", "f"):
        torch.testing.assert_close(one[k], kin[k][1], rtol=0, atol=0)


@pytest.mark.parametrize("under", [1, 2])
def test_span_tables_match(world, under):
    jstore, tstore, *_ = world
    cfg_j, cfg, kin_j, kin = _kinematics(world, under)
    sl = np.s_[cfg.ix0:cfg.ix0 + cfg.nxw, cfg.iz0:cfg.iz0 + cfg.nzw]
    gfi_j = jnp.asarray(jstore.itmin[sl])
    gfn_j = jnp.asarray(jstore.nsamples[sl])
    _gfd, gfi, gfn = ts.window_arrays(tstore, cfg, "cpu")
    tab_j = js.span_tables(gfi_j, gfn_j, cfg_j)
    tab = ts.span_tables(gfi, gfn, cfg)
    assert tab.dtype == torch.int32
    _exact(tab, tab_j)
    lo_j, hi_j = jax.vmap(jax.vmap(lambda k: js.physical_spans_from_tables(tab_j, cfg_j, k)))(
        {k: kin_j[k] for k in ("ixs", "izs", "valid", "ish")})
    lo, hi = ts.physical_spans_from_tables(tab, cfg, kin)  # [B, R, 3]
    _exact(lo, lo_j)
    _exact(hi, hi_j)
    for b in range(lo.shape[0]):  # the same spans as the per-element gathers
        lo1, hi1 = ts.physical_spans(gfi, gfn, cfg, {k: v[b] for k, v in kin.items()})
        _exact(lo[b], lo1)
        _exact(hi[b], hi1)


def _synthetic_kin(rng, cfg, B, R, G, P):
    """Seeded kinematics leaves [B, R, P*G] with groups of G centroids at
    one GF node, some centroids invalid and some shifts out of the plan's
    range (both packs clip them)."""
    xu, zu = cfg.xunder, cfg.zunder
    C = P * G
    ix1 = rng.integers(0, cfg.nxw - xu, size=(B, R, P))
    iz1 = rng.integers(0, cfg.nzw - zu, size=(B, R, P))
    rep = lambda a: np.repeat(a, G, axis=2)  # noqa: E731
    ixs = np.stack([rep(ix1), rep(ix1) + xu], -1)
    izs = np.stack([rep(iz1), rep(iz1) + zu], -1)
    wsp = rep(rng.uniform(0.0, 1.0, (B, R, P, 4))).astype(np.float32)
    ish_b = rng.integers(cfg.s_base - 2, cfg.s_base + cfg.s_len + 1, size=(B, 1, C))
    ang = rng.uniform(0.0, 2 * np.pi, (B, R, C))
    kin = {
        "ixs": ixs, "izs": izs, "wsp": wsp,
        "ish": np.broadcast_to(ish_b, (B, R, C)).astype(np.int32),
        "frac": np.broadcast_to(rng.uniform(0.0, 1.0, (B, 1, C)), (B, R, C)).astype(np.float32),
        "valid": rng.uniform(size=(B, R, C)) > 0.15,
        "f": rng.standard_normal((B, R, C, 6)).astype(np.float32),
        "cos_l": np.cos(ang).astype(np.float32),
        "sin_l": np.sin(ang).astype(np.float32),
    }
    return {k: np.ascontiguousarray(v) for k, v in kin.items()}


@pytest.mark.parametrize("ng,G,under,nt_out", [
    (10, 3, 1, 64),    # the finite benchmark's group size
    (8, 1, 2, 64),     # point-like groups, undersampled stencil
    (10, 8, 2, 160),   # nt_ext > 128: the JAX kernel's multi-tile layout
    (8, 12, 1, 64),    # G > 8: the JAX kernel splits the group, the port does not
])
def test_window_synthesis_matches(ng, G, under, nt_out):
    rng = np.random.default_rng(100 * ng + 10 * G + under)
    nxw, nzw, s_len = 12, 8, 24
    base = dict(dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0, ng=ng, nt=200,
                ix0=3, nxw=nxw, iz0=0, nzw=nzw, out_it0=20, nt_out=nt_out, s_base=-6,
                s_len=s_len, interpolate=True, xunder=under, zunder=under)
    cfg_j, cfg = js.SynthConfig(**base), ts.SynthConfig(**base)
    ext = rng.standard_normal((nxw, nzw, ng, nt_out + s_len)).astype(np.float32)
    B, R, P = 2, 3, 4
    kin = _synthetic_kin(rng, cfg, B, R, G, P)

    kin_t = {k: torch.as_tensor(v) for k, v in kin.items()}
    before = dict(tsw.launches)
    got = tsw.synthesize_ard_batch(tsw.pack_ext(torch.as_tensor(ext), cfg), cfg, kin_t, G)
    assert tsw.launches == before, "a CPU call must not count as a kernel launch"
    assert got.shape == (B, R, 3, nt_out) and got.dtype == torch.float32

    kin_j = {k: jnp.asarray(v) for k, v in kin.items()}
    want = np.asarray(jsw.synthesize_ard_batch(jsw.pack_ext(jnp.asarray(ext), cfg_j), cfg_j,
                                               kin_j, G, interpret=True))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)

    # and the XLA formulation of the same math, per (source, receiver), on
    # shifts inside the plan's range (what the engine's plans guarantee;
    # the vmapped XLA slices treat out-of-range starts differently)
    kin["ish"] = np.clip(kin["ish"], cfg.s_base, cfg.s_base + s_len - 1)
    kin_t["ish"] = torch.as_tensor(kin["ish"])
    got = tsw.synthesize_ard_batch(tsw.pack_ext(torch.as_tensor(ext), cfg), cfg, kin_t, G)

    def grouped(k):
        k = dict(k, wg=js._group_weights(k["f"], k["cos_l"], k["sin_l"], ng))
        return js._grouped_accumulate(jnp.asarray(ext), cfg_j, k, G)

    want_x = np.asarray(jax.vmap(jax.vmap(grouped))({k: jnp.asarray(v) for k, v in kin.items()}))
    np.testing.assert_allclose(got.numpy(), want_x, rtol=0, atol=1e-5 * np.abs(want_x).max())


@pytest.mark.parametrize("ng", [8, 10])
@pytest.mark.parametrize("nt_ext,nt_out", [
    (104, 80),     # the finite benchmark
    (136, 96),     # the eikonal benchmark
    (24, 1),       # one output sample
    (600, 560),    # finite_long
    (1024, 900),
    (2048, 200),   # a long window with few output samples: a narrower tile
    (2048, 2000),  # the longest window
])
@pytest.mark.parametrize("B", [1, 3, 256, 384])
def test_launch_plan_fits_the_card(ng, nt_ext, nt_out, B):
    """The wrapper's tile and shared-memory chooser (G, up to 64, does not
    enter it): a source tile of at least one source, shared memory within
    the H100's 227 KB per block, at most TILE_SLOTS shifted samples per
    lane, and the direct instance where a tile cannot run."""
    bt = tsw.launch_plan(ng, nt_ext, nt_out, B)
    row = 4 * ng * nt_ext  # bytes of one source's blend buffer
    assert 1 <= bt <= tsw.BT and bt * row <= tsw.SMEM_MAX
    if bt > 1:  # the source tile
        assert bt < 2 * B  # no tile wider than the batch needs
        assert nt_out + 1 <= 32 * tsw.TILE_SLOTS
        assert 2 * bt * row > tsw.SMEM_MAX or 2 * bt > min(tsw.BT, 2 * B - 1)  # the widest that fits
    if B == 1 or nt_out >= 32 * tsw.TILE_SLOTS:  # nothing to share, or too many samples a lane
        assert bt == 1
    elif nt_ext == 2048:  # an 80 KB (ng 10) or 64 KB (ng 8) buffer per source
        assert bt == 2
    else:
        assert bt == min(tsw.BT, 1 << (B - 1).bit_length())
    if B >= 256 and nt_ext <= 136:  # the benchmark shapes take the full tile
        assert bt == tsw.BT


@pytest.mark.parametrize("ng,G,under", [(10, 3, 1), (8, 1, 2), (10, 8, 1), (8, 64, 1)])
def test_empty_groups_contribute_exact_zeros(ng, G, under):
    """What the kernel's skip relies on: a (source, receiver, group) whose
    centroids all carry f1..f6 = 0 adds exact zeros, so the plain version
    gives the same output bit for bit whatever rows and bilinear weights
    such a group points at.  (Removing the groups instead would reorder
    torch's sum and change its rounding.)"""
    rng = np.random.default_rng(7 * ng + G)
    nxw, nzw, s_len, nt_out = 12, 8, 24, 64
    cfg = ts.SynthConfig(dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0, ng=ng, nt=200,
                         ix0=3, nxw=nxw, iz0=0, nzw=nzw, out_it0=20, nt_out=nt_out, s_base=-6,
                         s_len=s_len, interpolate=True, xunder=under, zunder=under)
    B, R, P = 3, 4, 5
    kin = _synthetic_kin(rng, cfg, B, R, G, P)
    dead = rng.uniform(size=(B, R, P)) < 0.4
    dead[1, 2] = True  # one (source, receiver) with every group empty
    kin["valid"] &= ~np.repeat(dead, G, axis=2)
    ext = tsw.pack_ext(torch.as_tensor(
        rng.standard_normal((nxw, nzw, ng, nt_out + s_len)).astype(np.float32)), cfg)
    node_rows, kk, wrows, wsp = tsw.pack_kinematics(
        cfg, {k: torch.as_tensor(v) for k, v in kin.items()}, G)
    empty = (wrows[..., :6] == 0).all(-1).all(-1)
    assert empty[torch.as_tensor(dead)].all()  # and groups of invalid centroids
    want = tsw.window_forward_reference(ext, node_rows, tsw.strides(cfg), kk, wrows, wsp, nt_out)
    moved = node_rows.clone()
    moved[empty] = torch.as_tensor(
        rng.integers(0, node_rows.max().item() + 1, int(empty.sum())).astype(np.int32))
    other_wsp = wsp.clone()
    other_wsp[empty] = torch.as_tensor(
        rng.uniform(0.0, 1.0, (int(empty.sum()), 4)).astype(np.float32))
    got = tsw.window_forward(ext, moved, tsw.strides(cfg), kk, wrows, other_wsp, nt_out)
    assert torch.equal(got, want)
    assert not got[1, 2].any()


@pytest.mark.parametrize("ng,G", [(10, 3), (8, 1)])
def test_dead_centroids_read_no_nonfinite_rows(ng, G):
    """Bilinear plans: an invalid centroid at the window's last depth
    points its stencil's +zu nodes at the next column's first row.  Its
    moment weights are 0, and the plain version drops its terms as the
    kernel skips them, so NaN rows wherever no live centroid reads (such
    rows included) leave the output finite and equal to the one without
    them (the CUDA side: tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(5 * ng + G)
    nxw, nzw, s_len, nt_out = 6, 4, 24, 64
    cfg = ts.SynthConfig(dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0, ng=ng, nt=200,
                         ix0=0, nxw=nxw, iz0=0, nzw=nzw, out_it0=20, nt_out=nt_out, s_base=-6,
                         s_len=s_len, interpolate=True, xunder=1, zunder=1)
    s = tsw.strides(cfg)
    B, R, P = 2, 3, 6
    kin = _synthetic_kin(rng, cfg, B, R, G, P)
    dead = rng.uniform(size=(B, R, P)) < 0.5
    dead[0, 0, 0] = True
    kin["izs"][..., 0] = np.where(np.repeat(dead, G, axis=2), nzw - 1, kin["izs"][..., 0])
    kin["ixs"][..., 0] %= 2  # live centroids read columns 0-2 only
    kin["ixs"][0, 0, :G, 0] = 3  # the +zu node is column 4's first row
    kin["valid"] &= ~np.repeat(dead, G, axis=2)
    data = rng.standard_normal((nxw * nzw, ng, nt_out + s_len)).astype(np.float32)
    node_rows, kk, wrows, wsp = tsw.pack_kinematics(
        cfg, {k: torch.as_tensor(v) for k, v in kin.items()}, G)
    live = (wrows[..., :6] != 0).any(-1).any(-1)  # [B, R, P]
    reads = lambda sel: {int(n) + o for n in node_rows[sel].tolist() for o in (0,) + s}  # noqa: E731
    used = reads(live)
    assert 4 * nzw in reads(~live) - used  # a dead centroid reads a NaN row
    poisoned = data.copy()
    poisoned[[n for n in range(nxw * nzw) if n not in used]] = np.nan
    want = tsw.window_forward(torch.as_tensor(data), node_rows, s, kk, wrows, wsp, nt_out)
    got = tsw.window_forward(torch.as_tensor(poisoned), node_rows, s, kk, wrows, wsp, nt_out)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("ng", [8, 10])
def test_nearest_neighbour_reads_one_node(ng):
    """A nearest-neighbour plan weighs the stencil's other three nodes 0:
    they point at the node itself, so NaN rows in the neighbouring nodes
    (here the next depth, the next column, and the next column's first row
    seen from the window's last depth) leave the output finite and equal
    to the one without them, as one node read alone gives it."""
    rng = np.random.default_rng(ng)
    nxw, nzw, s_len, nt_out = 6, 4, 24, 64
    cfg = ts.SynthConfig(dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0, ng=ng, nt=200,
                         ix0=0, nxw=nxw, iz0=0, nzw=nzw, out_it0=20, nt_out=nt_out, s_base=-6,
                         s_len=s_len, interpolate=False)
    assert tsw.strides(cfg) == (0, 0, 0)
    assert tsw.strides(dataclasses.replace(cfg, interpolate=True)) == (1, nzw, nzw + 1)
    B, R, P, G = 2, 3, 4, 1
    kin = _synthetic_kin(rng, dataclasses.replace(cfg, xunder=1, zunder=1), B, R, G, P)
    kin["ixs"][..., 0] = rng.integers(0, nxw - 1, size=(B, R, P))
    kin["izs"][..., 0] = np.where(rng.uniform(size=(B, R, P)) < 0.5, nzw - 1, 1)
    kin["wsp"][:] = (1.0, 0.0, 0.0, 0.0)
    kin["valid"][:] = True
    data = rng.standard_normal((nxw, nzw, ng, nt_out + s_len)).astype(np.float32)
    node_rows, kk, wrows, wsp = tsw.pack_kinematics(
        cfg, {k: torch.as_tensor(v) for k, v in kin.items()}, G)
    used = set(node_rows.flatten().tolist())
    poisoned = data.reshape(nxw * nzw, ng, -1).copy()
    poisoned[[n for n in range(nxw * nzw) if n not in used]] = np.nan
    want = tsw.window_forward(tsw.pack_ext(torch.as_tensor(data), cfg), node_rows,
                              tsw.strides(cfg), kk, wrows, wsp, nt_out)
    got = tsw.window_forward(torch.as_tensor(poisoned), node_rows, tsw.strides(cfg), kk,
                             wrows, wsp, nt_out)
    assert torch.isfinite(got).all() and torch.equal(got, want)
