#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives kiwi_tpu_torch's main paths at full size on the card -- the
kiwibench point sweep (bench.py's bench_point / bench_point_filtered
configuration) and the finite-source batches (bench.py's bench_finite, and
the same with a band-pass) -- and fails on the first phase that goes wrong:

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
   events; then the window kernel on seeded long-window operands (ng 8 and
   10, nt_ext ~600, G 1, 3 and 8);
5. the main paths, each with the launch counters set to 0 just before it
   and read just after: both point sweeps (8 calls each) and both finite
   configurations (8 and 4 batches of 256 strikes, linspace(0, 359) plus
   N(0, 0.01) noise as bench.py draws them); steady-state models/s (host
   clock around work that ends in torch.cuda.synchronize()), the best
   strike (91 +- 1 for the sweeps, +- 1.5 for the finite batches), and each
   path's kernels launched;
6. run the first 16 strikes of each sweep and the first 32 models of each
   finite configuration on a CPU Engine and require 1e-5 relative agreement
   with the card (global misfits; for the finite batches also misfits and
   norms).

Prints one line per phase, then the card's name and power limit, the
kernels' JSON line, and last {"ok": true, "device": {...}}.  There is no
CPU path: without a CUDA device it exits nonzero and prints no result.
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
TOL = 1e-5  # the repo's on-card relative bar (bench.py:194)
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])
SOURCES = {
    "fused_scan": "kiwi_tpu_torch/csrc/float_scan.cu",
    "fused_scan_masked": "kiwi_tpu_torch/csrc/float_scan.cu",
    "window_synth": "kiwi_tpu_torch/csrc/synth_window.cu",
    "scan_sums": "kiwi_tpu_torch/csrc/scan_sums.cu",
}
REPLACES = {
    "fused_scan": "kiwi_tpu/ops/float_scan.py:193",
    "fused_scan_masked": "kiwi_tpu/ops/float_scan.py:203",
    # _kernel; also _kernel_dma (:387) and _kernel_compact (:325)
    "window_synth": "kiwi_tpu/ops/synth_window.py:238",
    # _scan_kernel; also _scan_kernel_blocked (:78)
    "scan_sums": "kiwi_tpu/ops/float_scan.py:61",
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


def make_engine(store, device, filtered, base=BASE):
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
    if filtered:
        eng.set_misfit_filter(None, *BAND)
    eng.set_source_params("bilateral", base)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(-1.0, 1.0)
    eng.set_misfit_method("floating_l1norm")
    return eng


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
    log(f"  {name}: kernel {rec['ms']:.4f} ms, plain torch {rec['plain_ms']:.4f} ms")


def check_finite_kernels(eng, strikes, results):
    """The window and scan kernels against their plain versions on the
    operands of one 256-model finite batch (the engine's own), timed."""
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
    ext, node_rows, strides3, kk, wrows, wsp, nt_out = args
    N, ng, nt_ext = ext.shape
    B, R, P = node_rows.shape
    G = kk.shape[2]
    log(f"  window_synth shapes: B={B} R={R} P={P} G={G} ng={ng} nt_ext={nt_ext} "
        f"nt_out={nt_out} N={N} strides={tuple(strides3)}")
    got = sw.window_forward(*args, **kw)
    want = sw.window_forward_reference(*args, **kw)
    rec = record_err(results, "window_synth", got, want, "finite batch operands")
    rec["ms"] = cuda_ms(lambda: sw.window_forward(*args, **kw), 20)
    rec["plain_ms"] = cuda_ms(lambda: sw.window_forward_reference(*args, **kw), 3)
    log(f"  window_synth: kernel {rec['ms']:.4f} ms, plain torch {rec['plain_ms']:.4f} ms")

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
    log(f"  scan_sums: kernel {rec['ms']:.4f} ms, plain torch {rec['plain_ms']:.4f} ms")


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


def run_main_path(label, launch_names, run):
    """run() with every launch counter set to 0 just before and read just
    after; fails unless each of the path's kernels was launched."""
    from kiwi_tpu_torch.ops import float_scan as fs, synth_window as sw

    for counts in (fs.launches, sw.launches):
        for k in counts:
            counts[k] = 0
    out = run()
    counts = {**fs.launches, **sw.launches}
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
    from kiwi_tpu_torch.ops import build, float_scan as fs, synth_window as sw

    if any(m == "jax" or m.startswith(("jax.", "kiwi_tpu.")) or m == "kiwi_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package got imported")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build.build_all(*sorted({os.path.basename(s) for s in SOURCES.values()}))
    fs._library()
    fs._scan_library()
    sw._library()
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("models/s " + ", ".join(f"{k} {v:.0f}" for k, v in mps.items()))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"]}
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
