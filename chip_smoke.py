#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives kiwi_tpu_torch's main paths at full size on the card -- the
kiwibench point sweep (bench.py's bench_point / bench_point_filtered
configuration), the finite-source batches (bench.py's bench_finite, and
the same with a band-pass) and the eikonal-rupture grid search (bench.py's
bench_eikonal) -- and fails on the first phase that goes wrong:

1. build the CUDA kernels from kiwi_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc process per source, all started together;
2. build the 200x200x10 analytic fullspace GF store with the port's
   elseis (cached under build/kiwi_tpu_torch/);
3. point sweeps: set up the unfiltered and the band-pass-filtered sweeps
   (10 `ned` receivers at 3-4 km, point bilateral source, floating_l1norm
   over +-1 s, 3610 strikes x 4 = 14,440 rows per call), capture the fused
   kernel's operands from one call of each, and hold the kernel against its
   plain PyTorch version on them (l1 and l2, k_share 3 and 1) at 1e-5 of
   the max, with both timed by CUDA events;
4. finite batches: the same receivers with a 195-centroid bilateral fault,
   256 strikes per global_misfits_for_source_batch call; capture the window
   kernel's and the scan kernel's operands from one call and hold each
   kernel against its plain version (scan: l1 and l2), timed by CUDA
   events, with the window kernel's launch plan, its share of empty
   groups and its reckoned L2 reads; then the window kernel on seeded
   long-window operands (ng 8 and 10, nt_ext ~600, G 1, 3 and 8);
5. eikonal: bench_eikonal's session (the same store and receivers, l2norm,
   no floating shift, constraints z in [50, 700] m, an eikonal rupture of
   radius 250 m as the synthetic reference through the host FMM path);
   capture the fast-sweeping kernel's operands from one 384-radius batch
   (speed [384, 144, 136]) and hold it against its plain version (1e-4
   relative per reached cell, and bit for bit: 0 cells may differ), timed,
   per step at one, two and three sources per SM, beside its chain floor
   (EIK_CHAIN_CYCLES per step at the maximum SM clock); then time it on seeded 1100 x 300
   grids (more rows than threads, the time grid in device memory); and the
   window kernel on the same batch's operands, as in 4;
6. the main paths, each with the launch counters set to 0 just before it
   and read just after: both point sweeps (8 calls each), both finite
   configurations (8 and 4 batches of 256 strikes, linspace(0, 359) plus
   N(0, 0.01) noise as bench.py draws them) and the eikonal search (4
   batches of 384 radii, linspace(200, 350)); steady-state models/s (host
   clock around work that ends in torch.cuda.synchronize()), the best
   strike (91 +- 1 for the sweeps, +- 1.5 for the finite batches) or
   radius (250 +- 10 m), each path's kernels launched, and the eikonal
   device discretizer still in use (no fallback to the host pipeline);
7. run the first 16 strikes of each sweep, the first 32 models of each
   finite configuration and the first 8 radii on a CPU Engine and require
   1e-5 relative agreement with the card (global misfits; for the finite
   batches also misfits and norms);
8. trace 5 eikonal calls with torch.profiler: the device time by kernel,
   the device's busy time, the host syncs, and the host-side batch
   preparation alone.

Prints one line per phase, then the
card's name and power limit, the kernels' JSON line (each kernel's
launches on the main paths, its error against its plain version, its
time, the plain version's, one PyTorch call's where one computes the same
function, and its roofline bound from this run's shapes and data; the
window kernel's numbers are those of the finite batch), and last
{"ok": true, "device": {...}}.  There is no CPU path: without a CUDA
device it exits nonzero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STORE_CACHE = os.path.join(HERE, "build", "kiwi_tpu_torch", "benchdb.npz")
KIWIBENCH_STF = np.array(
    [0, 0, 0, 0, 0, 0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1, 1, 1, 1, 1],
    dtype=np.float64,
)  # benchmark/kiwibench.py:50-70
BASE = np.array([0, 0, 0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0, 2500.0, 0.2],
                dtype=np.float32)
# bench.py:270-273: 900 + 700 m long, 1000 m wide -> (13, 5, 3) = 195 centroids
FINITE_BASE = np.array([0, 0, 0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 900.0, 700.0, 1000.0,
                        2500.0, 0.2], dtype=np.float32)
NSTRIKES = 3610
PACK = 4  # sweeps per call: 14,440 rows
FINITE_B = 256  # models per finite batch (bench.py:284)
# bench.py:456-466: a test-scale eikonal rupture (radius 250 m) under l2norm
EIK_BASE = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0, 0.0, 0.0, 250.0, 50.0,
                     -50.0, 0.9, 0.3], dtype=np.float32)
EIK_B = 384  # radii per batch (bench.py:476)
TOL = 1e-5  # the repo's on-card relative bar (bench.py:194)
EIK_TOL = 1e-4  # kernel vs plain arrival times (tests/test_eikonal.py:208-209)
# SM cycles of the dependent instructions of one step of the eikonal sweep
# kernel: the shuffle, the ~18 float operations and the reciprocal square
# root that each step waits on (PERF.md, PR 6: that chain alone, one warp,
# timed with clock64 on an H100)
EIK_CHAIN_CYCLES = 145
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, FP32 flop/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])
SOURCES = {
    "fused_scan": "kiwi_tpu_torch/csrc/float_scan.cu",
    "fused_scan_masked": "kiwi_tpu_torch/csrc/float_scan.cu",
    "window_synth": "kiwi_tpu_torch/csrc/synth_window.cu",
    "scan_sums": "kiwi_tpu_torch/csrc/scan_sums.cu",
    "eik_sweep": "kiwi_tpu_torch/csrc/eik_sweep.cu",
}
REPLACES = {
    "fused_scan": "kiwi_tpu/ops/float_scan.py:193",
    "fused_scan_masked": "kiwi_tpu/ops/float_scan.py:203",
    # _kernel; also _kernel_dma (:387) and _kernel_compact (:325)
    "window_synth": "kiwi_tpu/ops/synth_window.py:238",
    # _scan_kernel; also _scan_kernel_blocked (:78)
    "scan_sums": "kiwi_tpu/ops/float_scan.py:61",
    "eik_sweep": "kiwi_tpu/ops/eik_sweep.py:44",
}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def get_store():
    from kiwi_tpu_torch.gf import elseis
    from kiwi_tpu_torch.gf.store import GFStore

    if os.path.exists(STORE_CACHE):
        return GFStore.load(STORE_CACHE), 0.0
    t0 = time.perf_counter()
    store = elseis.build_ahfull_store(
        nx=200, nz=200, dt=0.1, dx=50.0, dz=50.0, firstx=50.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=KIWIBENCH_STF,
    )
    os.makedirs(os.path.dirname(STORE_CACHE), exist_ok=True)
    store.save(STORE_CACHE)
    return store, time.perf_counter() - t0


def make_session(store, device):
    """bench.py:94-108's session: 10 `ned` receivers at 3-4 km, dt 0.1 s."""
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Engine, Receiver

    olat, olon = 30.0, 70.0
    eng = Engine(store, device=device)
    recs = []
    for d in np.linspace(3000.0, 4000.0, 10):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), float(d), 0.0)
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    return eng


def make_engine(store, device, filtered, base=BASE):
    eng = make_session(store, device)
    if filtered:
        eng.set_misfit_filter(None, *BAND)
    eng.set_source_params("bilateral", base)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(-1.0, 1.0)
    eng.set_misfit_method("floating_l1norm")
    return eng


def make_eikonal_engine(store, device):
    """bench.py:461-467: l2norm, no floating shift, the rupture confined to
    z in [50, 700] m, its own synthetic as the reference (host FMM path)."""
    eng = make_session(store, device)
    eng.set_misfit_method("l2norm")
    eng.set_floating_shiftrange(0.0, 0.0)
    eng.set_source_constraints([[0, 0, 50.0], [0, 0, 700.0]], [[0, 0, -1.0], [0, 0, 1.0]])
    eng.set_source_params("eikonal", EIK_BASE)
    eng.set_synthetic_reference()
    return eng


def eik_rows(radii):
    pb = np.tile(EIK_BASE, (radii.size, 1))
    pb[:, 10] = radii
    return pb


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_, flops):
    """Roofline bound of one call: (ms, "bytes" or "operations"), the larger
    of its bytes (each input read once, each output written once) over the
    HBM rate and its float32 operations over the FP32 peak."""
    t_bytes = nbytes_ / HBM_BPS * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture(module, name, run):
    """The operands of every call of module.<name> made by run()."""
    import torch

    seen = []
    real = getattr(module, name)

    def recorder(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, recorder)
    try:
        run()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return seen


def capture_operands(eng, strikes):
    """The fused kernel's operands of one sweep call (the engine's own)."""
    from kiwi_tpu_torch import misfit as mf

    seen = capture(mf, "fused_scan_sums", lambda: eng.sweep_global_misfits(BASE, 5, strikes))
    if len(seen) != 1:
        fail(f"expected one fused-scan call per sweep, saw {len(seen)}")
    return seen[0]


def record_err(results, name, got, want, label):
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    log(f"  {name}: {label}: max abs err {err:.3e}, rel {rel:.3e}")
    if not np.isfinite(rel) or rel > TOL:
        fail(f"{name} disagrees with its plain version ({label}): rel err {rel:.3e} > {TOL}")
    rec = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    return rec


def check_kernel(name, args, kw, results):
    """Kernel vs plain on the captured operands, for l1 and l2 and with the
    values rows shared (k_share 3) and per row (k_share 1)."""
    from kiwi_tpu_torch.ops import float_scan as fs

    ref, v, wgt = args
    k0 = kw.get("k_share", 1)
    if k0 > 1:  # rows shared per receiver: also run them expanded per rc row
        variants = [(v, k0), (v.repeat_interleave(k0, dim=0).contiguous(), 1)]
    else:  # rows per rc: also run every third row shared by three rc rows
        variants = [(v, 1), (v[::3].contiguous(), 3)]
    for vv, k in variants:
        for l2 in (False, True):
            kk = dict(kw, k_share=k, l2=l2)
            got = fs.fused_scan_sums(ref, vv, wgt, **kk)
            want = fs.fused_scan_sums_reference(ref, vv, wgt, **kk)
            rec = record_err(results, name, got, want,
                             f"RC={ref.shape[0]} S={ref.shape[1]} T={vv.shape[1]} "
                             f"W={ref.shape[2]} B={wgt.shape[2]} k_share={k} l2={l2}")
    # time the main path's own call (first variant, l1)
    vv, k = variants[0]
    kk = dict(kw, k_share=k)
    rec["ms"] = cuda_ms(lambda: fs.fused_scan_sums(ref, vv, wgt, **kk), 20)
    rec["plain_ms"] = cuda_ms(lambda: fs.fused_scan_sums_reference(ref, vv, wgt, **kk), 3)
    # synthesis: 2 T flop per (rc, b, w); scan: 3 per (rc, s, b, w)
    RC, S, W = ref.shape
    T, B = vv.shape[1], wgt.shape[2]
    spans = [kw[k] for k in ("lo", "hi") if k in kw]
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(ref, vv, wgt, *spans) + 4 * RC * S * B,
                                             2 * RC * B * W * T + 3 * RC * S * B * W)
    rec["library_ms"] = None  # no one PyTorch call synthesizes and scans
    log(f"  {name}: kernel {rec['ms']:.4f} ms, plain torch {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def window_reads(args):
    """Reckoned L2 reads of the window kernel's blends on these operands:
    the share of (b, r, group) triples whose centroids all carry f = 0, and
    the bytes of window rows read in full for every triple, only over the
    samples a live group's shifts reach, and once per distinct live node of
    a tile of bt = 4, 8 or 16 consecutive sources over the tile's sample
    range."""
    import torch

    ext, node_rows, strides3, kk, wrows, _wsp, nt_out = args
    _N, ng, nt_ext = ext.shape
    B, R, P = node_rows.shape
    sample = 4 * ng  # bytes of one sample of one node's rows
    live_c = (wrows[..., :6] != 0).any(-1)  # [B, R, P, G]
    live = live_c.any(-1)
    k = kk.clamp(0, nt_ext - nt_out - 1).long()
    lo = k.amin(-1)[:, None].expand(B, R, P)
    hi = k.amax(-1)[:, None].expand(B, R, P) + nt_out + 1
    spans = int(((hi - lo) * live).sum())
    reads = {"empty_share": 1.0 - float(live.float().mean()),
             "live_centroids": int(live_c.sum()), "live_spans": spans,
             "full": 4 * B * R * P * nt_ext * sample, "trimmed": 4 * spans * sample}
    offs = torch.tensor((0,) + tuple(int(s) for s in strides3), device=node_rows.device)
    nodes = node_rows.long()[..., None] + offs  # [B, R, P, 4]
    for bt in (4, 8, 16):
        def tiles(x, fill):  # [B, ...] -> [B / bt, bt, ...], the ragged tile padded
            pad = -B % bt
            if pad:
                x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
            return x.reshape(-1, bt, *x.shape[1:])

        lv = tiles(live, False)  # [T, bt, R, P]
        nd = tiles(nodes, -1).masked_fill(~lv[..., None], -1)
        nd = nd.permute(0, 2, 3, 1, 4).reshape(lv.shape[0], R, P, 4 * bt).sort(-1).values
        distinct = (nd[..., 0] >= 0).long() + ((nd[..., 1:] != nd[..., :-1])
                                               & (nd[..., 1:] >= 0)).sum(-1)
        tlo = tiles(lo, 0).masked_fill(~lv, nt_ext).amin(1)  # [T, R, P]
        thi = tiles(hi, 0).masked_fill(~lv, 0).amax(1)
        reads[f"tile{bt}"] = int((distinct * (thi - tlo).clamp(min=0)).sum()) * sample
    return reads


def check_window(args, kw, label, results):
    """The window kernel against its plain version on one batch's captured
    operands, timed beside its bound; the reckoned L2 reads logged."""
    from kiwi_tpu_torch.ops import synth_window as sw

    ext, node_rows, strides3, kk, wrows, wsp, nt_out = args
    N, ng, nt_ext = ext.shape
    B, R, P = node_rows.shape
    G = kk.shape[2]
    log(f"  window_synth shapes ({label}): B={B} R={R} P={P} G={G} ng={ng} nt_ext={nt_ext} "
        f"nt_out={nt_out} N={N} strides={tuple(strides3)}; sources per block "
        f"{sw.launch_plan(ng, nt_ext, nt_out, B)} (1: the direct instance)")
    reads = window_reads(args)
    log(f"  window_synth reads ({label}): {reads['empty_share']:.2%} of (b, r, group) empty; "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in reads.items()
                    if k in ("full", "trimmed") or k.startswith("tile")))
    got = sw.window_forward(*args, **kw)
    want = sw.window_forward_reference(*args, **kw)
    rec = record_err(results, "window_synth", got, want, f"{label} batch operands")
    ms = cuda_ms(lambda: sw.window_forward(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: sw.window_forward_reference(*args, **kw), 3)
    # the work these operands need: per live (b, r, group) the 4-node blend
    # over the samples its shifts reach, 7 flop per (component, sample); per
    # live centroid and output sample the moment contraction (2 ng), the
    # rotation (6), the 2-tap shift of 3 channels (9), the accumulation (3)
    io = nbytes(ext, node_rows, kk, wrows, wsp) + 4 * B * R * 3 * nt_out
    bound_ms, bound_by = bound(io, 7 * ng * reads["live_spans"]
                               + reads["live_centroids"] * nt_out * (2 * ng + 18))
    full_ms, full_by = bound(io, B * R * P * (7 * ng * nt_ext + G * nt_out * (2 * ng + 18)))
    log(f"  window_synth ({label}): kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}; every group over nt_ext: {full_ms:.4f} ms, "
        f"{full_by})")
    if "ms" not in rec:  # the JSON line carries the first (finite) batch's times
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None)  # no one PyTorch call does blend + contraction + shift


def check_finite_kernels(eng, strikes, results):
    """The window and scan kernels against their plain versions on the
    operands of one 256-model finite batch (the engine's own), timed."""
    import torch

    from kiwi_tpu_torch import misfit as mf
    from kiwi_tpu_torch.ops import float_scan as fs, synth_window as sw

    pb = np.tile(FINITE_BASE, (strikes.size, 1))
    pb[:, 5] = strikes
    scans = []
    windows = capture(sw, "window_forward", lambda: scans.extend(
        capture(mf, "scan_sums", lambda: eng.global_misfits_for_source_batch(pb))))
    if len(windows) != 1 or len(scans) != 1:
        fail(f"expected one window and one scan call per batch, saw {len(windows)}, {len(scans)}")
    args, kw = windows[0]
    check_window(args, kw, "finite", results)

    (ref, syn), skw = scans[0]
    RC, Bs, W = syn.shape
    log(f"  scan_sums shapes: S={ref.shape[0] // RC} RC={RC} W={W} B={Bs}")
    for l2 in (False, True):
        got = fs.scan_sums(ref, syn, l2=l2)
        want = fs.scan_sums_reference(ref, syn, l2=l2)
        rec = record_err(results, "scan_sums", got, want, f"finite batch operands, l2={l2}")
    l2 = skw.get("l2", False)  # time the main path's own call
    rec["ms"] = cuda_ms(lambda: fs.scan_sums(ref, syn, l2=l2), 20)
    rec["plain_ms"] = cuda_ms(lambda: fs.scan_sums_reference(ref, syn, l2=l2), 3)
    S = ref.shape[0] // RC
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(ref, syn) + 4 * S * Bs * RC,
                                             3 * S * RC * Bs * W)
    rec["library_ms"] = None
    if not l2:  # the l1 sums are one cdist: [RC, S, W] x [RC, B, W] -> [RC, S, B]
        def library():
            return torch.cdist(ref.view(S, RC, W).transpose(0, 1), syn, p=1)

        lib_rel = float((library().permute(1, 2, 0) - fs.scan_sums(ref, syn)).abs().max()
                        / fs.scan_sums(ref, syn).abs().max())
        rec["library_ms"] = cuda_ms(library, 20)
        log(f"  scan_sums: torch.cdist(p=1) {rec['library_ms']:.4f} ms "
            f"(max rel diff to the kernel {lib_rel:.2e})")
    log(f"  scan_sums: kernel {rec['ms']:.4f} ms, plain torch {rec['plain_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def check_long_windows(dev, results):
    """The window kernel on seeded long-window operands (the finite_long
    regime without a second store build)."""
    import torch

    from kiwi_tpu_torch.ops import synth_window as sw

    rng = np.random.default_rng(0)
    nxw, nzw, R, P, B, nt_ext, nt_out = 60, 40, 10, 20, 16, 600, 560
    N = nxw * nzw
    for ng in (8, 10):
        for G in (1, 3, 8):
            s3 = (1, nzw, nzw + 1)
            ops = [rng.standard_normal((N, ng, nt_ext)).astype(np.float32),
                   rng.integers(0, N - s3[2], (B, R, P)).astype(np.int32),
                   rng.integers(0, nt_ext - nt_out, (B, P, G)).astype(np.int32),
                   rng.standard_normal((B, R, P, G, sw.NW)).astype(np.float32),
                   rng.uniform(0.0, 1.0, (B, R, P, 4)).astype(np.float32)]
            ext, nodes, kk, wrows, wsp = (torch.as_tensor(a, device=dev) for a in ops)
            got = sw.window_forward(ext, nodes, s3, kk, wrows, wsp, nt_out)
            want = sw.window_forward_reference(ext, nodes, s3, kk, wrows, wsp, nt_out)
            record_err(results, "window_synth", got, want,
                       f"long window ng={ng} G={G} nt_ext={nt_ext} B={B} R={R} P={P}")


def check_eikonal_kernel(eng, radii, results):
    """The fast-sweeping kernel against its plain version on the operands of
    one 384-radius batch (the engine's own; also the path's first call:
    plan, table calibration and the host cross-check), timed."""
    import torch

    from kiwi_tpu_torch.ops import eik_sweep as es, synth_window as sw

    windows = []
    seen = capture(es, "sweep_solve_batch", lambda: windows.extend(capture(
        sw, "window_forward", lambda: eng.global_misfits_for_source_batch(eik_rows(radii)))))
    if len(seen) != 1:
        fail(f"expected one eikonal solve per batch, saw {len(seen)}")
    windows = [w for w in windows if w[0][1].shape[0] == radii.size]
    if len(windows) != 1:
        fail(f"expected one {radii.size}-model window synthesis per batch, saw {len(windows)}")
    (speed, delta, first, ip), kw = seen[0]
    n_rounds = kw["n_rounds"]
    B, nx, ny = speed.shape
    steps = (nx + ny - 1) * 4 * n_rounds
    log(f"  eik_sweep shapes: B={B} nx={nx} ny={ny} n_rounds={n_rounds} "
        f"({steps} dependent diagonal steps per solve)")
    for key, (ntmax, budget, hard) in eng._eik_calib.items():
        log(f"  eikonal tables: fine grid {key[1]}, coarse grid {key[2]}, time cells per "
            f"coarse cell {ntmax} (bound {hard}), cell budget {budget}")
    got = es.sweep_solve_batch(speed, delta, first, ip, n_rounds=n_rounds)
    want = es.sweep_solve_batch_reference(speed, delta, first, ip, n_rounds=n_rounds)
    reached = want < 1e29
    if not torch.equal(got < 1e29, reached):
        fail("eik_sweep reaches other cells than its plain version")
    err = (got - want).abs()[reached]
    rel = float((err / want.abs()[reached].clamp(min=1e-30)).max())
    ndiff = int((got != want).sum())
    log(f"  eik_sweep: {int(reached.sum())} reached cells of {want.numel()}: max abs err "
        f"{float(err.max()):.3e}, max rel err {rel:.3e}; cells that differ from the plain "
        f"version: {ndiff}")
    if not rel <= EIK_TOL:
        fail(f"eik_sweep disagrees with its plain version: rel err {rel:.3e} > {EIK_TOL}")
    if ndiff:  # the kernel rounds as the plain version does, step for step
        fail(f"eik_sweep differs from its plain version in {ndiff} cells (it must equal it)")
    rec = results["eik_sweep"] = {"max_abs_err": float(err.max()), "max_rel_err": rel}
    rec["ms"] = cuda_ms(lambda: es.sweep_solve_batch(speed, delta, first, ip, n_rounds=n_rounds),
                        20)
    rec["plain_ms"] = cuda_ms(
        lambda: es.sweep_solve_batch_reference(speed, delta, first, ip, n_rounds=n_rounds), 1)
    # 26 flop per cell update (division and square root counted as one
    # each), every cell once per directional sweep
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(speed, delta, first, ip) + 4 * B * nx * ny,
                                             26 * B * nx * ny * 4 * n_rounds)
    rec["library_ms"] = None  # no PyTorch call solves an eikonal equation
    # the dependency chain: one block per source, as many resident per SM as
    # their shared memory allows (228 KB per SM, 1 KB reserved per block; the
    # time grid and a boundary row of ny + 64 words per pair of warps), so
    # the call runs `waves` chains of `steps` dependent steps
    warps = -(-nx // 32)
    shared = nx * (ny + (ny & 1)) * 4 + max(warps - 1, 1) * (ny + 64) * 4
    sms = torch.cuda.get_device_properties(speed.device).multi_processor_count
    per_sm = max(1, min(228 * 1024 // (shared + 1024), 64 // warps))
    waves = -(-B // (per_sm * sms))
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    floor_ms = waves * steps * EIK_CHAIN_CYCLES / (mhz * 1e3)
    log(f"  eik_sweep: kernel {rec['ms']:.4f} ms = {waves} waves x {steps} steps x "
        f"{rec['ms'] / (waves * steps) * 1e3:.4f} us per step ({per_sm} blocks per SM), "
        f"plain torch {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}); chain floor {floor_ms:.4f} ms ({waves} waves x {steps} steps x "
        f"{EIK_CHAIN_CYCLES} cycles at the {mhz:.0f} MHz maximum SM clock)")
    # per step at one, two and three sources per SM: the batch's sources
    # taken in turn to fill one wave of each
    for k in (1, 2, 3):
        idx = torch.arange(k * sms, device=speed.device) % B
        ops = [a[idx].contiguous() for a in (speed, delta, first, ip)]
        ms = cuda_ms(lambda: es.sweep_solve_batch(*ops, n_rounds=n_rounds), 10)
        log(f"  eik_sweep: {k * sms} sources ({k} per SM): {ms:.4f} ms, "
            f"{ms / (-(-k // per_sm) * steps) * 1e3:.4f} us per step")
    # a rupture wider than the benchmark's: nx > 1024 rows (a thread takes
    # two) and a time grid above the shared-memory limit (in device memory)
    gen = torch.Generator(device=speed.device).manual_seed(7)
    wb, wnx, wny = 8, 1100, 300
    wide = (torch.rand((wb, wnx, wny), generator=gen, device=speed.device) * 3000.0 + 1000.0,
            torch.full((wb, 2), 5.0, device=speed.device),
            torch.zeros((wb, 2), device=speed.device),
            torch.full((wb, 2), 700.0, device=speed.device))
    wsteps = (wnx + wny - 1) * 4 * n_rounds
    ms = cuda_ms(lambda: es.sweep_solve_batch(*wide, n_rounds=n_rounds), 5)
    log(f"  eik_sweep: {wb} sources of {wnx} x {wny} (time grid in device memory): {ms:.4f} ms, "
        f"{ms / wsteps * 1e3:.4f} us per step")

    log(f"phase kernel-vs-plain window_synth ({radii.size}-radius batch operands):")
    check_window(*windows[0], "eikonal", results)


def run_main_path(label, launch_names, run):
    """run() with every launch counter set to 0 just before and read just
    after; fails unless each of the path's kernels was launched."""
    from kiwi_tpu_torch.ops import eik_sweep as es, float_scan as fs, synth_window as sw

    for counts in (fs.launches, sw.launches, es.launches):
        for k in counts:
            counts[k] = 0
    out = run()
    counts = {**fs.launches, **sw.launches, **es.launches}
    log(f"phase launches on the main path ({label}): {counts}")
    for name in launch_names:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by the main path ({label})")
    return out, counts


def run_sweep(eng, strikes, label, reps=8):
    import torch

    g = eng.sweep_global_misfits(BASE, 5, strikes)  # plan + first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        g = eng.sweep_global_misfits(BASE, 5, strikes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    g = g.cpu().numpy()
    if g.shape != strikes.shape or not np.isfinite(g).all():
        fail(f"{label}: global misfits not finite [{strikes.size}]: shape {g.shape}")
    best = float(strikes[int(np.argmin(g[:NSTRIKES]))])
    mps = reps * strikes.size / seconds
    log(f"phase sweep {label}: {reps} calls x {strikes.size} rows in {seconds:.4f} s: "
        f"{mps:.0f} models/s; best strike {best:.2f} (true 91.0)")
    if abs(best - 91.0) >= 1.0:
        fail(f"{label}: best strike {best} not within 1 deg of 91")
    return mps


def run_finite(eng, batches, label):
    """bench.py:291-305's throughput loop: one warm batch, then every batch
    through global_misfits_for_source_batch, host clock around work that
    ends in torch.cuda.synchronize()."""
    import torch

    def rows(strikes):
        pb = np.tile(FINITE_BASE, (strikes.size, 1))
        pb[:, 5] = strikes
        return pb

    eng.global_misfits_for_source_batch(rows(batches[0]))  # plan + first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [eng.global_misfits_for_source_batch(rows(s)) for s in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    g = torch.cat(out).cpu().numpy()
    strikes = np.concatenate(batches)
    if g.shape != strikes.shape or not np.isfinite(g).all():
        fail(f"{label}: global misfits not finite: shape {g.shape}")
    best = float(strikes[int(np.argmin(g))])
    mps = strikes.size / seconds
    log(f"phase finite {label}: {len(batches)} batches x {FINITE_B} models in {seconds:.4f} s: "
        f"{mps:.0f} models/s; best strike {best:.2f} (true 91.0)")
    if abs(best - 91.0) > 1.5:
        fail(f"{label}: best strike {best} not within 1.5 deg of 91")
    return mps


def run_eikonal(eng, batches):
    """bench.py:476-490's loop: one warm batch, then every batch of 384
    radii through global_misfits_for_source_batch, host clock around work
    that ends in torch.cuda.synchronize()."""
    import torch

    eng.global_misfits_for_source_batch(eik_rows(batches[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [eng.global_misfits_for_source_batch(eik_rows(r)) for r in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    g = torch.cat(out).cpu().numpy()
    radii = np.concatenate(batches)
    if g.shape != radii.shape or not np.isfinite(g).all():
        fail(f"eikonal: global misfits not finite: shape {g.shape}")
    best = float(radii[int(np.argmin(g))])
    mps = radii.size / seconds
    log(f"phase eikonal: {len(batches)} batches x {batches[0].size} radii in {seconds:.4f} s "
        f"({seconds / len(batches) * 1e3:.3f} ms per batch): {mps:.0f} models/s; "
        f"best radius {best:.2f} m (true 250)")
    if not eng.eikonal_device:
        fail("eikonal: the device discretizer fell back to the host pipeline")
    if abs(best - 250.0) > 10.0:
        fail(f"eikonal: best radius {best} not within 10 m of 250")
    return mps


def profile_eikonal(eng, radii, reps=5):
    """torch.profiler over `reps` eikonal calls after a warm one: device
    time per call by kernel, launches, and the union of device intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pb = eik_rows(radii)
    eng.global_misfits_for_source_batch(pb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng.global_misfits_for_source_batch(pb)
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -np.inf
    for a, b in spans:  # union of device intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    syncs = sum(e.name == "cudaStreamSynchronize" for e in events)
    from kiwi_tpu_torch.sources import eikonal as eiksrc

    t0 = time.perf_counter()
    for _ in range(reps):  # the host-side batch preparation alone
        eiksrc.prepare_batch(eiksrc.named_params_batch("eikonal", pb), eng.effective_dt,
                             eng.eikonal_context())
    log(f"phase profile eikonal: host prepare_batch {(time.perf_counter() - t0) / reps * 1e3:.3f}"
        f" ms per call")
    log(f"phase profile eikonal: per call {len(dev) / reps:.1f} device ops, device busy "
        f"{busy / reps / 1e3:.4f} ms (union of intervals), sum of device time "
        f"{sum(t for _, t in by_name.values()) / reps / 1e3:.4f} ms, "
        f"{syncs / reps:.1f} cudaStreamSynchronize")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {t / reps / 1e3:9.4f} ms  {n / reps:6.1f}x  {name[:110]}")


def compare_finite(eng, cpu, strikes, label):
    pb = np.tile(FINITE_BASE, (strikes.size, 1))
    pb[:, 5] = strikes
    got = [x.cpu().numpy() for x in eng.misfits_for_source_batch(pb)]
    want = [x.numpy() for x in cpu.misfits_for_source_batch(pb)]
    g_gpu = eng.global_misfits_for_source_batch(pb).cpu().numpy()
    g_cpu = cpu.global_misfits_for_source_batch(pb).numpy()
    rels = [float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
            for a, b in ((g_gpu, g_cpu), (got[0], want[0]), (got[1], want[1]))]
    shifts_equal = bool((got[2] == want[2]).all())
    log(f"phase card-vs-cpu finite {label}: {strikes.size} models, max rel diff global "
        f"{rels[0]:.3e}, misfits {rels[1]:.3e}, norms {rels[2]:.3e}; "
        f"floating shifts equal: {shifts_equal}")
    if not max(rels) <= TOL:
        fail(f"finite {label}: card and CPU port disagree: {max(rels):.3e} > {TOL}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run has no CPU path")
    import kiwi_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(kiwi_tpu_torch.__file__))) != HERE:
        fail(f"kiwi_tpu_torch imported from {kiwi_tpu_torch.__file__}, not this checkout")
    from kiwi_tpu_torch.ops import build, eik_sweep as es, float_scan as fs, synth_window as sw

    if any(m == "jax" or m.startswith(("jax.", "kiwi_tpu.")) or m == "kiwi_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package got imported")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build.build_all(*sorted({os.path.basename(s) for s in SOURCES.values()}))
    fs._library()
    fs._scan_library()
    sw._library()
    es._library()
    log(f"phase build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")

    store, build_s = get_store()
    log(f"phase store: {store.data.shape} built in {build_s:.1f} s (0 = cached)")

    strikes = np.linspace(0.0, 360.0, NSTRIKES).astype(np.float32)
    packed = np.concatenate([strikes] * PACK)
    engines = {
        "unfiltered": make_engine(store, dev, filtered=False),
        "filtered": make_engine(store, dev, filtered=True),
    }

    results = {}
    for (label, eng), name in zip(engines.items(), ("fused_scan", "fused_scan_masked")):
        args, kw = capture_operands(eng, packed)
        log(f"phase kernel-vs-plain {name} ({label} sweep operands):")
        check_kernel(name, args, kw, results)

    finite = {
        "finite": make_engine(store, dev, filtered=False, base=FINITE_BASE),
        "finite_filtered": make_engine(store, dev, filtered=True, base=FINITE_BASE),
    }
    # bench.py:299-303: 256 strikes over [0, 359] with N(0, 0.01) noise
    rng = np.random.default_rng(0)
    batches = [np.linspace(0.0, 359.0, FINITE_B).astype(np.float32)
               + rng.normal(0, 0.01, FINITE_B).astype(np.float32) for _ in range(8)]
    log("phase kernel-vs-plain window_synth, scan_sums (finite batch operands):")
    check_finite_kernels(finite["finite"], batches[0], results)
    log("phase kernel-vs-plain window_synth (seeded long windows):")
    check_long_windows(dev, results)

    eik = make_eikonal_engine(store, dev)
    radii = np.linspace(200.0, 350.0, EIK_B).astype(np.float32)  # bench.py:485-487
    log(f"phase kernel-vs-plain eik_sweep ({EIK_B}-radius batch operands):")
    check_eikonal_kernel(eik, radii, results)

    mps, counts = {}, {}
    paths = (
        ("unfiltered", ("fused_scan",),
         lambda: run_sweep(engines["unfiltered"], packed, "unfiltered")),
        ("filtered", ("fused_scan_masked",),
         lambda: run_sweep(engines["filtered"], packed, "filtered")),
        ("finite", ("window_synth", "scan_sums"),
         lambda: run_finite(finite["finite"], batches, "unfiltered")),
        ("finite_filtered", ("window_synth",),
         lambda: run_finite(finite["finite_filtered"], batches[:4], "filtered")),
        ("eikonal", ("eik_sweep", "window_synth"), lambda: run_eikonal(eik, [radii] * 4)),
    )
    for label, names, run in paths:
        mps[label], counts[label] = run_main_path(label, names, run)
    launches = {name: sum(c[name] for c in counts.values()) for name in REPLACES}

    for label, eng in engines.items():
        cpu = make_engine(store, "cpu", filtered=label == "filtered")
        g_cpu = cpu.sweep_global_misfits(BASE, 5, strikes[:16]).numpy()
        g_gpu = eng.sweep_global_misfits(BASE, 5, strikes[:16]).cpu().numpy()
        rel = float(np.abs(g_gpu - g_cpu).max()) / max(float(np.abs(g_cpu).max()), 1e-30)
        log(f"phase card-vs-cpu {label}: 16 strikes, max rel diff {rel:.3e}")
        if not rel <= TOL:
            fail(f"{label}: card and CPU port disagree: {rel:.3e} > {TOL}")
    for label, eng in finite.items():
        cpu = make_engine(store, "cpu", filtered=label == "finite_filtered", base=FINITE_BASE)
        compare_finite(eng, cpu, batches[0][:32], label)
    cpu = make_eikonal_engine(store, "cpu")
    pb = eik_rows(radii[:8])
    g_cpu = cpu.global_misfits_for_source_batch(pb).numpy()
    g_gpu = eik.global_misfits_for_source_batch(pb).cpu().numpy()
    rel = float(np.abs(g_gpu - g_cpu).max()) / max(float(np.abs(g_cpu).max()), 1e-30)
    log(f"phase card-vs-cpu eikonal: 8 radii, max diff {rel:.3e} of the largest |g|")
    if not (rel <= TOL and cpu.eikonal_device and eik.eikonal_device):
        fail(f"eikonal: card and CPU port disagree ({rel:.3e} > {TOL}) or fell back to the host")
    profile_eikonal(eik, radii)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("models/s " + ", ".join(f"{k} {v:.0f}" for k, v in mps.items()))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
