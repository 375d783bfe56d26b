#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives kiwi_tpu_torch's main path -- the kiwibench point sweep
(bench.py's bench_point / bench_point_filtered configuration) -- at full
size on the card, and fails on the first phase that goes wrong:

1. build the CUDA kernel from kiwi_tpu_torch/csrc with nvcc (sm_90a);
2. build the 200x200x10 analytic fullspace GF store with the port's
   elseis (cached under build/kiwi_tpu_torch/);
3. set up the unfiltered and the band-pass-filtered sweeps (10 `ned`
   receivers at 3-4 km, point bilateral source, floating_l1norm over
   +-1 s, 3610 strikes x 4 = 14,440 rows per call), capture the fused
   kernel's operands from one call of each, and hold the kernel against
   its plain PyTorch version on them (l1 and l2, k_share 3 and 1) at
   1e-5 of the max, with both timed by CUDA events;
4. reset the launch counters, run both sweeps (steady-state models/s,
   host clock around work that ends in torch.cuda.synchronize()), check
   the best strike is 91 +- 1 and that each kernel was launched;
5. run the first 16 strikes of each sweep on a CPU Engine and require
   1e-5 relative agreement with the card.

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
NSTRIKES = 3610
PACK = 4  # sweeps per call: 14,440 rows
TOL = 1e-5  # the repo's on-card relative bar (bench.py:194)
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])
REPLACES = {
    "fused_scan": "kiwi_tpu/ops/float_scan.py:193",
    "fused_scan_masked": "kiwi_tpu/ops/float_scan.py:203",
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


def make_engine(store, device, filtered):
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Engine, Receiver

    olat, olon = 30.0, 70.0
    eng = Engine(store, device=device)
    recs = []
    for d in np.linspace(3000.0, 4000.0, 10):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), float(d), 0.0)
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    if filtered:
        eng.set_misfit_filter(None, *BAND)
    eng.set_source_params("bilateral", BASE)
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


def capture_operands(eng, strikes):
    """The fused kernel's operands of one sweep call (the engine's own)."""
    import torch

    from kiwi_tpu_torch import misfit as mf

    seen = []
    real = mf.fused_scan_sums

    def recorder(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    mf.fused_scan_sums = recorder
    try:
        eng.sweep_global_misfits(BASE, 5, strikes)
    finally:
        mf.fused_scan_sums = real
    torch.cuda.synchronize()
    if len(seen) != 1:
        fail(f"expected one fused-scan call per sweep, saw {len(seen)}")
    return seen[0]


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
    rec = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    for vv, k in variants:
        for l2 in (False, True):
            kk = dict(kw, k_share=k, l2=l2)
            got = fs.fused_scan_sums(ref, vv, wgt, **kk)
            want = fs.fused_scan_sums_reference(ref, vv, wgt, **kk)
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            log(f"  {name}: RC={ref.shape[0]} S={ref.shape[1]} T={vv.shape[1]} "
                f"W={ref.shape[2]} B={wgt.shape[2]} k_share={k} l2={l2}: "
                f"max abs err {err:.3e}, rel {rel:.3e}")
            if not np.isfinite(rel) or rel > TOL:
                fail(f"{name} disagrees with its plain version: rel err {rel:.3e} > {TOL}")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    # time the main path's own call (first variant, l1)
    vv, k = variants[0]
    kk = dict(kw, k_share=k)
    rec["ms"] = cuda_ms(lambda: fs.fused_scan_sums(ref, vv, wgt, **kk), 20)
    rec["plain_ms"] = cuda_ms(lambda: fs.fused_scan_sums_reference(ref, vv, wgt, **kk), 3)
    rec["shape"] = {"RC": ref.shape[0], "S": ref.shape[1], "T": vv.shape[1],
                    "W": ref.shape[2], "B": wgt.shape[2], "k_share": k}
    log(f"  {name}: kernel {rec['ms']:.4f} ms, plain torch {rec['plain_ms']:.4f} ms")


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run has no CPU path")
    import kiwi_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(kiwi_tpu_torch.__file__))) != HERE:
        fail(f"kiwi_tpu_torch imported from {kiwi_tpu_torch.__file__}, not this checkout")
    from kiwi_tpu_torch.ops import build, float_scan as fs

    if any(m == "jax" or m.startswith(("jax.", "kiwi_tpu.")) or m == "kiwi_tpu"
           for m in sys.modules):
        fail("JAX or the JAX package got imported")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = build.build("float_scan.cu")
    fs._library()
    log(f"phase build: {lib.name} in {time.perf_counter() - t0:.1f} s")

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

    for k in fs.launches:
        fs.launches[k] = 0
    mps = {label: run_sweep(eng, packed, label) for label, eng in engines.items()}
    counts = dict(fs.launches)
    log(f"phase launches on the main path: {counts}")
    for name in REPLACES:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by the main path")

    for label, eng in engines.items():
        cpu = make_engine(store, "cpu", filtered=label == "filtered")
        g_cpu = cpu.sweep_global_misfits(BASE, 5, strikes[:16]).numpy()
        g_gpu = eng.sweep_global_misfits(BASE, 5, strikes[:16]).cpu().numpy()
        rel = float(np.abs(g_gpu - g_cpu).max()) / max(float(np.abs(g_cpu).max()), 1e-30)
        log(f"phase card-vs-cpu {label}: 16 strikes, max rel diff {rel:.3e}")
        if not rel <= TOL:
            fail(f"{label}: card and CPU port disagree: {rel:.3e} > {TOL}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"models/s unfiltered {mps['unfiltered']:.0f}, filtered {mps['filtered']:.0f}")
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "kiwi_tpu_torch/csrc/float_scan.cu",
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": results[name]["max_abs_err"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"]}
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
