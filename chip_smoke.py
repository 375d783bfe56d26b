#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Drives kiwi_tpu_torch's main paths at full size on the card -- the
kiwibench point sweep (bench.py's bench_point / bench_point_filtered
configuration), the finite-source batches (bench.py's bench_finite, and
the same with a band-pass) and the eikonal-rupture grid search (bench.py's
bench_eikonal), then a grid search, a Levenberg-Marquardt inversion and
gradient inversion on the finite session, a plan outside the window
kernel, then the minimizer text protocol replaying benchmark/mini.inp --
and fails on the first phase that goes wrong:

1. build the CUDA kernels from kiwi_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc process per source, all started together;
2. build the 200x200x10 analytic fullspace GF store with the port's
   GFDBBuilder in worker processes, its first and last two columns held
   exactly against elseis's direct build (cached under
   build/kiwi_tpu_torch/);
3. point sweeps: set up the unfiltered and the band-pass-filtered sweeps
   (10 `ned` receivers at 3-4 km, point bilateral source, floating_l1norm
   over +-1 s, 3610 strikes x 4 = 14,440 rows per call), capture the fused
   kernel's operands from one call of each, and hold the kernel against its
   plain PyTorch version on them (l1 and l2, k_share 3 and 1) at 1e-5 of
   the max, the kernel's device time (torch.profiler's durations over 20
   calls; the wrapper calls' time by CUDA events beside it) and the plain
   version's beside the bound from this run's spans (the live share and
   the union of live samples logged);
4. finite batches: the same receivers with a 195-centroid bilateral fault,
   256 strikes per global_misfits_for_source_batch call; capture the window
   kernel's and the scan kernel's operands from one call and hold each
   kernel against its plain version (scan: l1 and l2, on the engine's own
   strided views), timed on the device as in 3, with the window kernel's
   launch plan, its share of empty groups and its reckoned L2 reads; the
   scan's one call must run no device work but its kernel (no copy), and
   its time is that of 20 launches of its C entry into one output; then
   the window kernel on seeded long-window operands (ng 8 and 10, nt_ext
   ~600, G 1, 3 and 8);
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
   then the inversions on the finite session, counted the same way: a
   grid search (kiwi_tpu_torch.invert.MisfitGrid over 72 strikes x 7 dips
   x 9 slip-rakes = 4,536 models, floating_l1norm over +-1 s, 200 bootstrap
   iterations; the best source must be the true (91, 87, 164) and each
   parameter's 16-84% band must hold it; models/s) and a
   Levenberg-Marquardt refinement under l2norm (Engine.minimize_lm with
   time, strike, dip and slip-rake free, from (+0.05 s, +5, -4, +6 degrees)
   off the truth; strike, dip and slip-rake within 0.5 degrees of it and a
   global misfit under 0.02; nfev/s and the plans the engine built);
   gradient inversion on the same session (l2norm), where no kernel may
   launch: Engine.global_misfits_and_grad on 64 rows around the truth,
   misfit_jacobian and invert.covariance (symmetric, positive diagonal) at
   LM's start with strike, dip and slip-rake free, and invert.
   minimize_gradient from (+5, -4, +6 degrees) off the truth, 8 starts
   (spread 0.1), 150 steps, lr 0.03: the best global misfit under 0.25 x
   the start's and each angle within 3 degrees of the truth
   (tests/test_gradient.py's bars), steps/s; a plan outside the window
   kernel (item 8 of ROADMAP.md's queue 1): the finite session on a 2 ms
   analytic store (nt_out + s_len above T_MAX = 2048), floating_l1norm
   over +-0.1 s, 32 strikes through global_misfits_for_source_batch: the
   plan's formulation "plain", scan_sums launched, no window kernel, the
   best strike the truth; every other configuration's plan "window"; the
   window and scan kernels then held against their plain versions, as in
   4, on the operands these runs gave them (the long window's scan too): the grid's last full chunk
   (512 models) and its ragged last one (440), LM's last Jacobian call (4
   rows, the source-tile instance) and its closing get_global_misfit (one
   row, the direct instance); then the minimizer text protocol
   (kiwi_tpu_torch.cli.minimizer.MinimizerServer on the card, in
   build/kiwi_tpu_torch/mini/): benchmark/mini.inp replayed as
   benchmark/run_mini.py sets it up (11 `ned` receivers at 3-4 km, the
   first 7 lines warm, the 7 further syntheses and their files timed:
   mini_inp_seconds), then a session (MINI_SESSION: references read back
   from MiniSEED files through the native codec, which must have built;
   floating_l1norm, then ampspec_l2norm and ampspec_l1norm under the
   band-pass; peak amplitudes, Arias intensities, spectra, cross
   correlations, autoshift), MINI_LM (LM from the lm phase's offsets,
   which must recover the truth as there) and MINI_GRADIENT
   (minimize_gradient 20 0.02 2 from LM's end); no command may answer
   nok; the window and scan kernels held against their plain
   versions on the operands of MINI_SESSION's and of MINI_LM's calls, the
   last call of each shape (LM's 4-row Jacobian calls through the
   source-tile instance at the protocol's 11 receivers among them); then
   the Step pipeline: kiwi_tpu_torch.cli.kiwi_main.work on the card at its
   defaults (grid_step_deg 10: 11,664 SDR models, 576 weight-maker models,
   143 moment-depth models; bootstrap 100; shifter over +-1 s; the begin
   table's taper) over a data directory that dataset.save_dataset writes
   in MiniSEED from BASE at 10 `ned` receivers at 3-4 km, 36 degrees apart
   (make_pipeline_session), searched from half the moment and the default
   mechanism: mechanism correlation > 0.9, |log10 moment ratio| < 0.2,
   depth within 150 m (tests/test_kiwi_main.py's bars), report.html, every
   results.pickle loaded in a process that does not initialize CUDA, the
   plan "window", seconds per step, the SDR grid's models/s; the window
   kernel held against its plain version on the operands of its calls
   there; then one autokiwi cycle (pull, prepare through
   prepare.save_kiwi_dataset, process as `kiwi_main --device cuda work` at
   grid_step_deg 30 in a child process, report): the done file present,
   no fail file; then the host paths, where no kernel may launch: gfdb
   (the store's configuration built again through the port's GFDBBuilder
   in spawned workers, exactly get_store()'s store; then cli.gfdb_tools
   info, extract of three nodes and build_ahfull of five nodes on stdin,
   each exactly the store's), acquisition (the finite session's
   synthetics as MiniSEED behind a local FDSN event/station/dataselect
   service on 127.0.0.1, fetched by fdsn_catalog and fetch_dataset through
   the default urllib opener: every file byte for byte what was sent), web
   (kiwi_tpu_torch.web.serve on the card in a thread: the landing page, 8
   calculates of the finite fault at strikes 91 + 10 k in one session, one
   each of moment_tensor, circular, point_lp and eikonal in another, then
   /traces, result.json and /source3d.json of each source type; no error
   page, no non-200; without matplotlib no PNG and the skip named on the
   page; seconds per calculate, plan_builds) and the small tools
   (source_info, eulermt, crust, differential_azidist, ahfull); then
   cli.tools eikonal_benchmark 300 on the card, which must launch
   eik_sweep (its two lines logged), and the kernel held bit for bit
   against its plain version on the operands of its timed call (one 300 x
   300 grid, 8 rounds: the first design, above the shared-memory limit),
   its device time per launch beside its chain floor; then the
   multi-device phase (kiwi_tpu_torch.parallel): 4 spawned ranks of one
   gloo group share cuda:0, each with the finite session (and the lm
   session for the gradient), and take one warm and 3 timed calls through
   sharded_forward on a 4 x 1 mesh (256 models), gfshard.build_plan on
   1 x 4 (distance shards: the 10 receivers in groups of 3/3/2/2, each
   rank holding its group's GF window) and on 2 x 2 (255 models: one pad
   row), and global_misfits_and_grad(mesh=) on 4 x 1 (the gradient
   phase's 64 rows); window_synth and scan_sums launched in every rank
   for each forward mesh (the gradient none), the 1 x 4 windows narrower
   than the whole plan's, far-north and late batches refused with the
   coverage ValueError in every rank, every rank holding the same rows,
   and rank 0's against this process's unsharded card engine (misfits,
   norms and global misfits at 1e-5 of the largest, shifts exactly; the
   gradient at g 2e-5 and GRAD_TOL); models/s per mesh on the slowest
   rank's host clock, 4 processes on one card (not a scaling number);
7. run the first 16 strikes of each sweep, the first 32 models of each
   finite configuration, the first and last 32 of the grid, the LM start
   and end, and the first 8 radii on a CPU Engine and require 1e-5
   relative agreement with the card (global misfits; for the finite
   batches, the grid and LM also misfits and norms; at LM's end, where the
   misfits are near 0, their difference within OPT_TOL of the largest
   norm); the gradient phase's first 8 rows (g at 1e-5, every gradient
   component at 1e-4 of its row's largest on minimize_multistart's scale)
   and its Jacobian, and the long window's first 8 models (1e-5); the
   protocol session on a CPU server, answer by answer (shifts exactly) and
   file by file, its misfits at the card's LM end (at OPT_TOL), and
   MINI_GRADIENT's answer from there (steps and starts exactly, the
   misfit within 1e-5); the pipeline SDR tuner's first and last 32 models
   on a CPU engine set up from the same data directory (misfits and norms
   at 1e-5); the web phase's first generation against an Engine on the CPU
   set up from the same form (the same rows and itmin, values at 1e-5 of
   each row's largest); then the bilateral tables kernel against its plain
   version, bit for bit, on the rows of one sweep call (14,440 on
   (1, 1, 3)) and of a grid compute's chunks (512 and 440 on (13, 5, 3)),
   timed as in 3 beside the bound of its bytes (every bilateral path on
   the card must launch it, the gradient must not);
8. trace 5 calls of each point sweep, 5 unfiltered finite batches, 5
   eikonal calls, 2 grid computes, 2 LM runs from the start, 2 timed
   mini.inp blocks, 1 protocol session, 2 gradient calls of 64 rows and 2
   computes of the pipeline's SDR grid with
   torch.profiler: the device time by kernel, the device's busy time, the
   host syncs, for eikonal the host-side batch preparation alone, and for
   the gradient the backward's share of the device time and the forward's
   device time alone.

Prints one line per phase, then the
card's name and power limit, the kernels' JSON line (each kernel's
launches on the main paths, the multi-device ranks' summed in, its
error against its plain version, its
device time per launch, the plain version's time, one PyTorch call's
where one computes the same function, and its roofline bound from this
run's shapes and data; the window kernel's numbers are those of the
finite batch), and last
{"ok": true, "device": {...}}.  There is no CPU path: without a CUDA
device it exits nonzero and prints no result.
"""

import io
import json
import os
import shutil
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
# the benchmark store (benchmark/kiwibench.py:45-92): 200 x 200 nodes at 50 m
STORE_GRID = dict(nx=200, nz=200, dt=0.1, dx=50.0, dz=50.0, firstx=50.0, firstz=0.0)
MATERIAL = (2300.0, 3200.0, 1600.0)  # rho, alpha, beta
BUILD_WORKERS = min(16, os.cpu_count() or 1)
# blocks of two distance columns: 100 blocks keep every worker busy to the
# end although the far columns' traces take longest
BUILD_BLOCK_NX = 2
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
# card vs CPU at LM's optimum: misfit diff over the largest norm (6.4e-8
# and 1.5e-7 measured on an H100, PERF.md)
OPT_TOL = 1e-6
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
# the grid search over the finite fault: 72 strikes x 7 dips x 9 slip-rakes
# = 4,536 models holding the true (91, 87, 164), bootstrap over receivers
GRID = (("strike", np.arange(1.0, 360.0, 5.0)), ("dip", np.arange(57.0, 90.0, 5.0)),
        ("slip-rake", np.arange(124.0, 205.0, 10.0)))
BOOTSTRAP = 200
# Levenberg-Marquardt from (+0.05 s, +5, -4, +6 degrees) off the truth
LM_FREE = (0, 5, 6, 7)  # time, strike, dip, slip-rake
LM_OFFSET = np.array([0.05, 5.0, -4.0, 6.0], np.float32)
# the text protocol: benchmark/mini.inp's finite source (moment 1.0), the
# session's source off it, and LM's start (time, strike, dip, slip-rake)
MINI_BASE = np.array([0, 0, 0, 5000.0, 1.0, 91.0, 87.0, 164.0, 0.0, 900.0, 700.0, 1000.0,
                      2500.0, 0.2], np.float32)
MINI_OFF = MINI_BASE.copy()
MINI_OFF[[0, 5, 6, 7]] += np.array([0.1, 3.0, -2.0, 4.0], np.float32)
MINI_LM_START = MINI_BASE.copy()
MINI_LM_START[list(LM_FREE)] += LM_OFFSET
MINI_RECEIVERS = 11  # benchmark/run_mini.py:48-53: `ned` at 3-4 km
# the protocol's gradient descent, run after MINI_LM from LM's end
MINI_GRADIENT = "minimize_gradient 20 0.02 2\n"
# gradient inversion on the lm session: value and gradient of GRAD_B rows
# around the truth, the misfit Jacobian and covariance at LM's start, and
# minimize_gradient from LM's angle offsets (tests/test_gradient.py's bars)
GRAD_B = 64
GRAD_FREE = (5, 6, 7)  # strike, dip, slip-rake
GRAD_OFFSET = np.array([5.0, -4.0, 6.0], np.float32)
GRAD_STARTS, GRAD_SPREAD, GRAD_STEPS, GRAD_LR = 8, 0.1, 150, 0.03
GRAD_TOL = 1e-4  # card vs CPU: gradient components, of the row's largest scaled one
# the multi-device phase: MD_RANKS processes of one gloo group sharing the
# card, each with the finite session, through the source-sharded forward
# (4 x 1), the distance shards (1 x 4: 10 receivers in groups of 3/3/2/2),
# both axes (2 x 2, a batch of MD_PAD_B rows: one pad row) and the sharded
# gradient (4 x 1, the gradient phase's rows); MD_REPS timed calls each
MD_RANKS = 4
MD_PAD_B = 255
MD_REPS = 3
# plans outside the window kernel: an analytic store around the finite
# session's source sampled at 2 ms, so that nt_out + s_len > T_MAX = 2048
LONG_STORE = dict(nx=40, nz=26, dt=0.002, dx=100.0, dz=100.0, firstx=1500.0, firstz=3800.0)
LONG_B = 32
LONG_SHIFT = 0.1  # floating_l1norm over +-0.1 s: 101 trial shifts at 2 ms
# the Step pipeline (kiwi_main work, at its own defaults: grid_step_deg 10,
# bootstrap 100): BASE as the observed data at 10 `ned` receivers at 3-4 km
# spread 36 degrees apart in azimuth (one azimuth leaves the mechanism
# unresolved), searched from half its moment and the default mechanism at
# the true depth (from 4000 m, Shifter's +-1 s aligns the references to the
# wrong depth and the depth search stays there)
PIPE_OPTS = {"components": "ned", "effective_dt": "0.1", "sourcetype": "bilateral",
             "depth": "5000", "moment": "5e11", "shiftrange": "-1,1",
             "taper": "begin,0,1,14,15", "rupture-velocity": "2500", "rise-time": "0.2"}
PIPE_STEP_DEG = 10.0  # kiwi_main's default grid_step_deg: 36 x 9 x 36 = 11,664 SDR models
AUTOKIWI_EVENT = "ev-smoke 1700000000.0 30.0 70.0 5000 5.3 smoke region"
# answers compared exactly between the card and the CPU port (shifts)
EXACT = ("set_receivers", "get_floating_shifts", "autoshift_ref_seismogram")
SOURCES = {
    "fused_scan": "kiwi_tpu_torch/csrc/float_scan.cu",
    "fused_scan_masked": "kiwi_tpu_torch/csrc/float_scan.cu",
    "window_synth": "kiwi_tpu_torch/csrc/synth_window.cu",
    "scan_sums": "kiwi_tpu_torch/csrc/scan_sums.cu",
    "eik_sweep": "kiwi_tpu_torch/csrc/eik_sweep.cu",
    "bilat_tables": "kiwi_tpu_torch/csrc/bilat_tables.cu",
    "eik_prepare": "kiwi_tpu_torch/csrc/eik_prepare.cu",
}
# the device kernels of each wrapper, as torch.profiler names them
KERNELS = {
    "fused_scan": ("fused_scan_kernel",),
    "fused_scan_masked": ("fused_scan_kernel",),
    "window_synth": ("window_direct_kernel", "window_tile_kernel"),
    "scan_sums": ("scan_sums_kernel",),
    "eik_sweep": ("eik_wavefront_kernel", "eik_diagonal_kernel"),
    "bilat_tables": ("bilat_tables_kernel",),
    "eik_prepare": ("eik_prepare_kernel",),
}
REPLACES = {
    "fused_scan": "kiwi_tpu/ops/float_scan.py:193",
    "fused_scan_masked": "kiwi_tpu/ops/float_scan.py:203",
    # _kernel; also _kernel_dma (:387) and _kernel_compact (:325)
    "window_synth": "kiwi_tpu/ops/synth_window.py:238",
    # _scan_kernel; also _scan_kernel_blocked (:78)
    "scan_sums": "kiwi_tpu/ops/float_scan.py:61",
    "eik_sweep": "kiwi_tpu/ops/eik_sweep.py:44",
    # no Pallas kernel: XLA fuses the JAX package's discretization
    "bilat_tables": "XLA fusion of kiwi_tpu/sources/bilat.py:73",
    # no Pallas kernel: the JAX package prepares the eikonal batch in numpy
    "eik_prepare": "host numpy of kiwi_tpu/sources/eikonal.py:462",
}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def build_store_parallel():
    """The benchmark store through the port's GFDBBuilder and its analytic
    fullspace backend in BUILD_WORKERS worker processes."""
    from kiwi_tpu_torch.gf.builder import GFDBBuilder, ahfull_backend

    return GFDBBuilder(ahfull_backend(MATERIAL, KIWIBENCH_STF, STORE_GRID["dt"]), ng=10,
                       **STORE_GRID, nworkers=BUILD_WORKERS, block_nx=BUILD_BLOCK_NX).build()


def check_direct_columns(store, cols):
    """The store's consecutive columns cols against elseis.build_ahfull_store
    of those columns alone (the direct build), exactly; its seconds."""
    from kiwi_tpu_torch.gf import elseis

    g = STORE_GRID
    t0 = time.perf_counter()
    part = elseis.build_ahfull_store(
        nx=len(cols), nz=g["nz"], dt=g["dt"], dx=g["dx"], dz=g["dz"],
        firstx=g["firstx"] + cols[0] * g["dx"], firstz=g["firstz"], material=MATERIAL,
        stf=KIWIBENCH_STF)
    seconds = time.perf_counter() - t0
    sub = slice(cols[0], cols[-1] + 1)
    nt = part.data.shape[-1]
    if not (np.array_equal(part.itmin, store.itmin[sub])
            and np.array_equal(part.nsamples, store.nsamples[sub])
            and np.array_equal(part.data, store.data[sub, ..., :nt])
            and (store.data[sub, ..., nt:] == store.data[sub, ..., nt - 1:nt]).all()):
        fail(f"store: columns {cols} differ from their direct build")
    return seconds


def get_store():
    """The benchmark store and its build seconds (0 when cached): built
    through the parallel builder, its first and last two columns held
    exactly against their direct build."""
    from kiwi_tpu_torch.gf.store import GFStore

    if os.path.exists(STORE_CACHE):
        return GFStore.load(STORE_CACHE), 0.0
    t0 = time.perf_counter()
    store = build_store_parallel()
    seconds = time.perf_counter() - t0
    nx = STORE_GRID["nx"]
    direct = sum(check_direct_columns(store, cols) for cols in ([0, 1], [nx - 2, nx - 1]))
    log(f"phase store: built by GFDBBuilder ({BUILD_WORKERS} workers) in {seconds:.3f} s; columns "
        f"0, 1, {nx - 2}, {nx - 1} exactly their direct build ({direct:.3f} s for 4 columns "
        f"directly)")
    os.makedirs(os.path.dirname(STORE_CACHE), exist_ok=True)
    store.save(STORE_CACHE)
    return store, seconds


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


def make_lm_engine(store, device):
    """The finite session under l2norm with no floating shift, its own
    synthetic as the reference (tests/test_invert.py:92-108's setup)."""
    eng = make_session(store, device)
    eng.set_misfit_method("l2norm")
    eng.set_source_params("bilateral", FINITE_BASE)
    eng.set_synthetic_reference()
    return eng


def finite_rows(strikes):
    pb = np.tile(FINITE_BASE, (strikes.size, 1))
    pb[:, 5] = strikes
    return pb


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


def device_ms(fn, reps, names):
    """Device time per launch of the kernels whose name contains one of
    `names`, summed from torch.profiler's device durations over `reps`
    calls of fn after a warm one (so host work around the launches does not
    count), and the other device operations those calls ran, {name: count
    per call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace that holds none of the kernels is taken once more (a trace
    # without the device events of launched kernels has been seen once on
    # an H100); a second such trace fails
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times, others = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if any(n in e.name for n in names):
                times.append(e.time_range.elapsed_us())
            else:
                others[e.name] = others.get(e.name, 0.0) + 1.0 / reps
        if times:
            return sum(times) / len(times) / 1e3, others
        log(f"  device_ms: trace {attempt} holds no device kernel named like {names} "
            f"({len(others)} other device event names: {sorted(others)[:4]})")
    fail(f"no device kernel named like {names} in the trace")


def max_sm_mhz():
    """The card's maximum SM clock, MHz (nvidia-smi)."""
    return float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits"], capture_output=True,
                                text=True, check=True).stdout.split()[0])


def capture(module, name, run, key=None):
    """The operands of every call of module.<name> made by run(); with
    key(args), of the last call for each key only, in the order the keys
    first came (the other calls' operands are let go as the run goes on)."""
    import torch

    seen = {}
    real = getattr(module, name)

    def recorder(*args, **kw):
        seen[len(seen) if key is None else key(args)] = (args, kw)
        return real(*args, **kw)

    setattr(module, name, recorder)
    try:
        run()
    finally:
        setattr(module, name, real)
    torch.cuda.synchronize()
    return list(seen.values())


def window_batch(args):
    """The batch size of a window_forward call: node_rows [B, R, P]."""
    return int(args[1].shape[0])


def scan_batch(args):
    """The batch size of a scan_sums call: syn [RC, B, W]."""
    return int(args[1].shape[1])


def window_shapes(args):
    """A window_forward call's shapes: node_rows [B, R, P], G, nt_ext and
    nt_out."""
    return tuple(args[1].shape) + (int(args[3].shape[2]), int(args[0].shape[2]), int(args[6]))


def scan_shapes(args):
    """A scan_sums call's shapes: ref [S*RC, W] and syn [RC, B, W]."""
    return tuple(args[0].shape) + tuple(args[1].shape)


def capture_operands(eng, strikes):
    """The fused kernel's operands of one sweep call (the engine's own)."""
    from kiwi_tpu_torch import misfit as mf

    seen = capture(mf, "fused_scan_sums", lambda: eng.sweep_global_misfits(BASE, 5, strikes))
    if len(seen) != 1:
        fail(f"expected one fused-scan call per sweep, saw {len(seen)}")
    return seen[0]


def record_err(results, name, got, want, label):
    return record_numbers(results, name, float((got - want).abs().max()),
                          float(want.abs().max()), label)


def record_numbers(results, name, err, scale, label):
    """record_err of a comparison made elsewhere (a rank of the multidevice
    phase): its max abs error and the plain version's largest |value|."""
    rel = err / max(scale, 1e-30)
    log(f"  {name}: {label}: max abs err {err:.3e}, rel {rel:.3e}")
    if not np.isfinite(rel) or rel > TOL:
        fail(f"{name} disagrees with its plain version ({label}): rel err {rel:.3e} > {TOL}")
    rec = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    return rec


def check_kernel(name, args, kw, results):
    """Kernel vs plain on the captured operands, for l1 and l2 and with the
    values rows shared (k_share 3) and per row (k_share 1), timed beside its
    bound from this run's spans."""
    import torch

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
    # time the main path's own call (first variant, l1): the kernel's device
    # time, and the wrapper's (host-bound at this speed) beside it
    vv, k = variants[0]
    kk = dict(kw, k_share=k)
    rec["ms"], _ = device_ms(lambda: fs.fused_scan_sums(ref, vv, wgt, **kk), 20, KERNELS[name])
    wrapper_ms = cuda_ms(lambda: fs.fused_scan_sums(ref, vv, wgt, **kk), 20)
    rec["plain_ms"] = cuda_ms(lambda: fs.fused_scan_sums_reference(ref, vv, wgt, **kk), 3)
    # FP32 lane instructions per model: an FFMA per (t, w) of the synthesis
    # over the samples some shift reads, and a subtraction and an add (|d|
    # as an operand modifier; d^2 as one FFMA) per live (s, w) of the scan.
    # The FP32 peak counts an FMA as 2 flop, so an instruction is 2 flop.
    RC, S, W = ref.shape
    T, B = vv.shape[1], wgt.shape[2]
    spans = [kw[k] for k in ("lo", "hi") if k in kw]
    if spans:
        j = kw.get("basei", 0) + torch.arange(W, device=ref.device)
        live = (j >= kw["lo"].T[..., None]) & (j <= kw["hi"].T[..., None])  # [RC, S, W]
        union = live.any(1).sum(1)  # [RC]
        synth, scan = T * int(union.sum()), 2 * int(live.sum())
        log(f"  {name}: live (s, w) share {float(live.float().mean()):.4f}, union of the live "
            f"samples per rc {float(union.float().mean()):.2f} of {W} "
            f"({int(union.min())}-{int(union.max())})")
    else:
        synth, scan = RC * T * W, 2 * RC * S * W
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(ref, vv, wgt, *spans) + 4 * RC * S * B,
                                             2 * B * (synth + scan))
    rec["library_ms"] = None  # no one PyTorch call synthesizes and scans
    log(f"  {name}: kernel {rec['ms']:.4f} ms on the device (wrapper calls {wrapper_ms:.4f} ms), "
        f"plain torch {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")


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
    ms, _ = device_ms(lambda: sw.window_forward(*args, **kw), 20, KERNELS["window_synth"])
    wrapper_ms = cuda_ms(lambda: sw.window_forward(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: sw.window_forward_reference(*args, **kw), 3)
    # the work these operands need: per live (b, r, group) the 4-node blend
    # over the samples its shifts reach, 7 flop per (component, sample); per
    # live centroid and output sample the moment contraction (2 ng), the
    # rotation (6), the 2-tap shift of 3 channels (9), the accumulation (3)
    io = nbytes(ext, node_rows, kk, wrows, wsp) + 4 * B * R * 3 * nt_out
    bound_ms, bound_by = bound(io, 7 * ng * reads["live_spans"]
                               + reads["live_centroids"] * nt_out * (2 * ng + 18))
    full_ms, full_by = bound(io, B * R * P * (7 * ng * nt_ext + G * nt_out * (2 * ng + 18)))
    log(f"  window_synth ({label}): kernel {ms:.4f} ms on the device (wrapper calls "
        f"{wrapper_ms:.4f} ms), plain torch {plain_ms:.4f} ms, "
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

    pb = finite_rows(strikes)
    scans = []
    windows = capture(sw, "window_forward", lambda: scans.extend(
        capture(mf, "scan_sums", lambda: eng.global_misfits_for_source_batch(pb))))
    if len(windows) != 1 or len(scans) != 1:
        fail(f"expected one window and one scan call per batch, saw {len(windows)}, {len(scans)}")
    args, kw = windows[0]
    check_window(args, kw, "finite", results)

    (ref, syn), skw = scans[0]
    RC, Bs, W = syn.shape
    S = ref.shape[0] // RC
    log(f"  scan_sums shapes: S={S} RC={RC} W={W} B={Bs}; the engine's views: strides ref "
        f"{ref.stride()}, syn {syn.stride()}, element offsets {ref.storage_offset()}, "
        f"{syn.storage_offset()}")
    rec = check_scan(ref, syn, "finite", results)
    l2 = skw.get("l2", False)  # time the main path's own call
    # one call on the engine's views runs the scan kernel and nothing else (no copy)
    _, others = device_ms(lambda: fs.scan_sums(ref, syn, l2=l2), 1, KERNELS["scan_sums"])
    if others:
        fail(f"scan_sums ran other device work beside its kernel: {others}")
    # the kernel's own time: 20 back-to-back launches of the C entry into one
    # output, by the profiler's device durations and by CUDA events; the
    # wrapper's calls beside them
    out = torch.empty((S, RC, Bs), dtype=torch.float32, device=ref.device)  # the kernel's layout
    lib = fs._scan_library()
    c_args = (ref.data_ptr(), syn.data_ptr(), out.data_ptr(), ref.stride(0), syn.stride(0),
              syn.stride(1), S, RC, Bs, W, int(l2), torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.kiwi_scan_sums(*c_args)
        if err:
            fail(f"kiwi_scan_sums launch failed: CUDA error {err}")

    rec["ms"], _ = device_ms(launch, 20, KERNELS["scan_sums"])
    events_ms = cuda_ms(launch, 20)
    wrapper_ms = cuda_ms(lambda: fs.scan_sums(ref, syn, l2=l2), 20)
    rec["plain_ms"] = cuda_ms(lambda: fs.scan_sums_reference(ref, syn, l2=l2), 3)
    # two FP32 lane instructions (2 flop each) per (s, b, rc, w): a
    # subtraction and an add with |d| as an operand modifier, or an FFMA
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(ref, syn) + 4 * S * Bs * RC,
                                             4 * S * RC * Bs * W)
    rec["library_ms"] = None
    if not l2:  # the l1 sums are one cdist: [RC, S, W] x [RC, B, W] -> [RC, S, B]
        def library():
            return torch.cdist(ref.view(S, RC, W).transpose(0, 1), syn, p=1)

        lib_rel = float((library().permute(1, 2, 0) - fs.scan_sums(ref, syn)).abs().max()
                        / fs.scan_sums(ref, syn).abs().max())
        rec["library_ms"] = cuda_ms(library, 20)
        log(f"  scan_sums: torch.cdist(p=1) {rec['library_ms']:.4f} ms "
            f"(max rel diff to the kernel {lib_rel:.2e})")
    log(f"  scan_sums: kernel {rec['ms']:.4f} ms on the device (20 launches of the C entry: "
        f"{events_ms:.4f} ms each by CUDA events; 20 wrapper calls: {wrapper_ms:.4f} ms each), "
        f"plain torch {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']})")


def check_scan(ref, syn, label, results):
    """scan_sums against its plain version on one call's captured operands
    (the engine's strided views), l1 and l2."""
    from kiwi_tpu_torch.ops import float_scan as fs

    RC, B, W = syn.shape
    for l2 in (False, True):
        got = fs.scan_sums(ref, syn, l2=l2)
        want = fs.scan_sums_reference(ref, syn, l2=l2)
        rec = record_err(results, "scan_sums", got, want,
                         f"{label} operands S={ref.shape[0] // RC} RC={RC} W={W} B={B}, l2={l2}")
    return rec


def check_captured(label, windows, scans, results):
    """The window and scan kernels against their plain versions on the
    operands captured from an inversion's own calls (the last call of each
    batch size), timed as check_window times them."""
    for args, kw in windows:
        check_window(args, kw, f"{label} B={window_batch(args)}", results)
    for (ref, syn), _kw in scans:
        check_scan(ref, syn, label, results)


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
    for key, (ntmax, budget, hard) in eng.batch_discretizer().calib.items():
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
    def solve():
        return es.sweep_solve_batch(speed, delta, first, ip, n_rounds=n_rounds)

    rec["ms"], _ = device_ms(solve, 20, KERNELS["eik_sweep"])
    wrapper_ms = cuda_ms(solve, 20)
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
    mhz = max_sm_mhz()
    floor_ms = waves * steps * EIK_CHAIN_CYCLES / (mhz * 1e3)
    log(f"  eik_sweep: kernel {rec['ms']:.4f} ms = {waves} waves x {steps} steps x "
        f"{rec['ms'] / (waves * steps) * 1e3:.4f} us per step ({per_sm} blocks per SM; wrapper "
        f"calls {wrapper_ms:.4f} ms), "
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


def check_bilat(sweep_eng, packed, grid, grid_eng, results):
    """The bilateral tables kernel against its plain version on the rows of
    the main paths' own calls: one sweep call (14,440 rows on (1, 1, 3))
    and the last chunk of each size of a grid compute (512 and 440 rows on
    (13, 5, 3)).  Every table must equal the plain version's bit for bit
    (the float tables compared as int32).  Timed as in 3 beside the plain
    version and the bound of its bytes; the sweep call's numbers are the
    kernels line's."""
    import torch

    from kiwi_tpu_torch.ops import bilat_tables as bl
    from kiwi_tpu_torch.sources import bilat

    sweep = capture(bl, "bilat_tables", lambda: sweep_eng.sweep_global_misfits(BASE, 5, packed))
    if len(sweep) != 1:
        fail(f"expected one bilat_tables call per sweep, saw {len(sweep)}")
    chunks = capture(bl, "bilat_tables", lambda: grid.compute(grid_eng),
                     key=lambda args: int(args[0].shape[0]))
    if len(chunks) < 2:
        fail(f"expected grid chunks of two sizes, saw {[int(a[0].shape[0]) for a, _ in chunks]}")
    rec = results["bilat_tables"] = {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                     "library_ms": None}  # no PyTorch call computes the tables
    for i, ((params, shape), _kw) in enumerate(sweep + chunks):
        B, C = params.shape[0], shape[0] * shape[1] * shape[2]
        got = bl.bilat_tables(params, shape)
        want = bilat.discretize_reference(params, shape)
        ndiff = {}
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"bilat_tables {k}: {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
                     f"{tuple(w.shape)}")
            if w.dtype == torch.float32:
                rec["max_abs_err"] = max(rec["max_abs_err"], float((g - w).abs().max()))
                g, w = g.view(torch.int32), w.view(torch.int32)
            ndiff[k] = int((g != w).sum())
        log(f"  bilat_tables: B={B} shape {tuple(shape)}: entries that differ from the plain "
            f"version {ndiff}")
        if any(ndiff.values()):  # the kernel rounds as the plain version does on the card
            fail(f"bilat_tables differs from its plain version (B={B}, {tuple(shape)}): {ndiff}")

        def tables():
            return bl.bilat_tables(params, shape)

        ms, others = device_ms(tables, 20, KERNELS["bilat_tables"])
        wrapper_ms = cuda_ms(tables, 20)
        plain_ms = cuda_ms(lambda: bilat.discretize_reference(params, shape), 3)
        # each row read once (14 floats), each entry written once: north,
        # east, depth, time, the 6 floats of m and the active byte; the
        # operations are not counted
        bound_ms, bound_by = bound(56 * B + 41 * B * C, 0)
        log(f"  bilat_tables: B={B}: kernel {ms:.4f} ms on the device (20 wrapper calls: "
            f"{wrapper_ms:.4f} ms each by CUDA events; other device ops a call {others}), "
            f"plain torch {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        if i == 0:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def run_main_path(label, launch_names, run):
    """run() with every launch counter set to 0 just before and read just
    after; fails unless each of the path's kernels was launched."""
    from kiwi_tpu_torch.ops import (bilat_tables as bl, eik_prepare as ep, eik_sweep as es,
                                    float_scan as fs, synth_window as sw)

    for counts in (fs.launches, sw.launches, es.launches, bl.launches, ep.launches):
        for k in counts:
            counts[k] = 0
    out = run()
    counts = {**fs.launches, **sw.launches, **es.launches, **bl.launches, **ep.launches}
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

    eng.global_misfits_for_source_batch(finite_rows(batches[0]))  # plan + first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [eng.global_misfits_for_source_batch(finite_rows(s)) for s in batches]
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
    if not eng.batch_discretizer().on_device:
        fail("eikonal: the device discretizer fell back to the host pipeline")
    if abs(best - 250.0) > 10.0:
        fail(f"eikonal: best radius {best} not within 10 m of 250")
    return mps


def run_grid(eng, out):
    """MisfitGrid over GRID on the finite session (floating_l1norm over
    +-1 s, unfiltered), then postprocess with BOOTSTRAP iterations; the best
    source must be the true one and every searched parameter's 16-84%
    bootstrap band must hold its true value.  out["grid"]: the grid;
    out["grid_ops"]: the window and scan operands of its last full chunk
    and of its ragged last one."""
    import torch

    from kiwi_tpu_torch import misfit as mf
    from kiwi_tpu_torch.invert import MisfitGrid, Source
    from kiwi_tpu_torch.ops import synth_window as sw

    grid = MisfitGrid(Source("bilateral", FINITE_BASE), GRID)
    scans = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    windows = capture(sw, "window_forward", lambda: scans.extend(capture(
        mf, "scan_sums", lambda: grid.compute(eng), scan_batch)), window_batch)
    seconds = time.perf_counter() - t0  # compute ends in the results' copy to the host
    out["grid_ops"] = (windows, scans)
    t0 = time.perf_counter()
    best, g, stats = grid.postprocess(bootstrap_iterations=BOOTSTRAP, outer_norm="l2norm")
    boot_s = time.perf_counter() - t0
    out["grid"] = grid
    if g.shape != (grid.nsources,) or not np.isfinite(grid.misfits_by_src).all():
        fail(f"grid: misfits not finite [{grid.nsources}, R, C]")
    mps = grid.nsources / seconds
    found = {name: best[name] for name, _ in GRID}
    log(f"phase grid: {grid.nsources} models in {seconds:.4f} s: {mps:.0f} models/s; "
        f"bootstrap x{BOOTSTRAP} {boot_s:.4f} s; best {found}, global misfit "
        f"{float(np.nanmin(g)):.3e}")
    for name, _ in GRID:
        st = stats[name]
        true = float(FINITE_BASE[best.model.param_index(name)])
        log(f"  grid {name}: best {st.best}, median {st.median}, 16-84% "
            f"[{st.percentile16}, {st.percentile84}] (true {true})")
        if st.best != true:
            fail(f"grid: best {name} {st.best} is not the true {true}")
        if not st.percentile16 <= true <= st.percentile84:
            fail(f"grid: the 16-84% band of {name} misses the true {true}")
    return mps


def run_lm(eng, start, out):
    """minimize_lm from `start` with time, strike, dip and slip-rake free;
    strike, dip and slip-rake must end within 0.5 degrees of the truth and
    the global misfit under 0.02.  out["lm"]: the final parameters;
    out["lm_ops"]: the window operands of its last Jacobian call (4 rows)
    and of its last one-row call (the get_global_misfit that ends it)."""
    import torch

    from kiwi_tpu_torch.ops import synth_window as sw

    mask = np.zeros(FINITE_BASE.size, bool)
    mask[list(LM_FREE)] = True
    eng.set_source_params("bilateral", start)
    eng.set_source_params_mask(mask)
    plans = eng.plan_builds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = []
    windows = capture(sw, "window_forward", lambda: res.extend(eng.minimize_lm()), window_batch)
    seconds = time.perf_counter() - t0
    info, nfev, gm = res
    plans = eng.plan_builds - plans
    out["lm_ops"] = (windows, [])
    p = eng.source_params.copy()
    out["lm"] = p
    log(f"phase lm: info {info}, nfev {nfev} in {seconds:.4f} s: {nfev / seconds:.1f} nfev/s; "
        f"plans built {plans}; global misfit {gm:.4e}; time {p[0]:.5f} s, strike {p[5]:.4f}, "
        f"dip {p[6]:.4f}, slip-rake {p[7]:.4f} (true 0, 91, 87, 164)")
    if not np.isfinite(gm) or gm >= 0.02:
        fail(f"lm: global misfit {gm} not below 0.02")
    off = np.abs(p[[5, 6, 7]] - FINITE_BASE[[5, 6, 7]])
    if not (off < 0.5).all():
        fail(f"lm: strike, dip, slip-rake off the truth by {off} (bar 0.5 degrees)")
    return nfev / seconds


def grad_rows():
    """GRAD_B rows around the truth (seeded): strike, dip and slip-rake
    within a few degrees, the time within 0.05 s; one grid shape."""
    rng = np.random.default_rng(11)
    pb = np.tile(FINITE_BASE, (GRAD_B, 1))
    pb[:, list(GRAD_FREE)] += rng.normal(0.0, 3.0, (GRAD_B, 3)).astype(np.float32)
    pb[:, 0] += rng.uniform(-0.05, 0.05, GRAD_B).astype(np.float32)
    return pb


def grad_start():
    p = FINITE_BASE.copy()
    p[list(GRAD_FREE)] += GRAD_OFFSET
    return p


def grad_mask():
    return np.isin(np.arange(FINITE_BASE.size), GRAD_FREE)


def param_scale(rows):
    """minimize_multistart's per-parameter scale: |p_j|, or 1% of
    model.norm where p_j = 0."""
    from kiwi_tpu_torch.sources import get_source_model

    norm = get_source_model("bilateral").norm.astype(np.float64)
    rows = np.atleast_2d(np.asarray(rows, np.float64))
    return np.where(rows != 0.0, np.abs(rows), 0.01 * norm)


def run_gradient(eng, out):
    """Gradient inversion on the lm session, no kernel launched: value and
    gradient of GRAD_B rows (one call warm, one timed), the misfit Jacobian
    and covariance at the start, then minimize_gradient with strike, dip
    and slip-rake free from GRAD_OFFSET off the truth, GRAD_STARTS starts;
    the best global misfit under 0.25 x the start's and every angle within
    3 degrees of the truth (tests/test_gradient.py's bars).  steps/s on the
    host clock (every step ends in a copy to the host).  out["gradient"]:
    the results, for the card-vs-CPU phase."""
    from kiwi_tpu_torch.invert import covariance, minimize_gradient

    rows = grad_rows()
    eng.global_misfits_and_grad(rows)  # plan + first call
    t0 = time.perf_counter()
    g, grad = eng.global_misfits_and_grad(rows)
    call_s = time.perf_counter() - t0
    if g.shape != (GRAD_B,) or grad.shape != rows.shape or not (
            np.isfinite(g).all() and np.isfinite(grad).all()):
        fail(f"gradient: g {g.shape} / grad {grad.shape} not finite")
    start, mask = grad_start(), grad_mask()
    m, J = eng.misfit_jacobian(start, mask=mask)
    cov, sigma2, _J = covariance(eng, mask=mask, params=start)
    if not (np.isfinite(J).all() and np.allclose(cov, cov.T, rtol=1e-10, atol=0)
            and (np.diag(cov) > 0).all()):
        fail(f"gradient: covariance not symmetric with a positive diagonal: {cov}")
    g0 = float(eng.global_misfits_and_grad(start[None, :])[0][0])
    eng.set_source_params("bilateral", start)
    t0 = time.perf_counter()
    gm, nsteps, nstarts = minimize_gradient(eng, mask=mask, steps=GRAD_STEPS, lr=GRAD_LR,
                                            nstarts=GRAD_STARTS, spread=GRAD_SPREAD)
    seconds = time.perf_counter() - t0
    p = eng.source_params.copy()
    off = np.abs(p[list(GRAD_FREE)] - FINITE_BASE[list(GRAD_FREE)])
    log(f"phase gradient: value and gradient of {GRAD_B} rows in {call_s:.4f} s "
        f"({GRAD_B / call_s:.1f} rows/s); Jacobian [{J.shape[0]}, {J.shape[1]}], covariance "
        f"diagonal {np.diag(cov)}, sigma^2 {sigma2:.4e}; minimize_gradient {nsteps} steps x "
        f"{nstarts} starts in {seconds:.4f} s: {nsteps / seconds:.2f} steps/s, "
        f"{nsteps * nstarts / seconds:.1f} rows x steps/s; global misfit {g0:.4e} -> {gm:.4e} "
        f"({gm / g0:.4f} of the start); strike {p[5]:.4f}, dip {p[6]:.4f}, slip-rake "
        f"{p[7]:.4f} (true 91, 87, 164)")
    if not (np.isfinite(gm) and gm < 0.25 * g0 and (off < 3.0).all()):
        fail(f"gradient: misfit {gm} not under 0.25 x {g0}, or angles off the truth by {off}")
    out["gradient"] = {"rows": rows, "g": g, "grad": grad, "m": m, "J": J,
                       "steps_per_s": nsteps / seconds}
    return nsteps / seconds


def held_on_rank(windows, scans):
    """The window and scan kernels against their plain versions on the
    operands a rank captured (check_window's and check_scan's comparisons):
    (name, label, max abs err, the plain version's largest |value|) each,
    for the parent's record_numbers."""
    from kiwi_tpu_torch.ops import float_scan as fs, synth_window as sw

    held = []
    for args, kw in windows:
        want = sw.window_forward_reference(*args, **kw)
        err = float((sw.window_forward(*args, **kw) - want).abs().max())
        B, R, P = args[1].shape
        held.append(("window_synth", f"B={B} R={R} P={P} nxw*nzw={args[0].shape[0]}", err,
                     float(want.abs().max())))
    for (ref, syn), _kw in scans:
        RC, B, W = syn.shape
        for l2 in (False, True):
            want = fs.scan_sums_reference(ref, syn, l2=l2)
            err = float((fs.scan_sums(ref, syn, l2=l2) - want).abs().max())
            held.append(("scan_sums", f"S={ref.shape[0] // RC} RC={RC} W={W} B={B}, l2={l2}",
                         err, float(want.abs().max())))
    return held


def multidevice_rank(pb, pb_pad, rows):
    """One rank of the multi-device phase (spawned, one gloo group): the
    finite session on cuda:0 through each mesh, one warm call and MD_REPS
    timed ones (host clock around work that ends in
    torch.cuda.synchronize()), the kernel launches of each, and the
    coverage errors of a far and a late batch on the distance shards.  The
    warm call of each forward mesh captures the window and scan kernels'
    operands, held against their plain versions after the launches are
    read (held_on_rank)."""
    import torch
    import torch.distributed as dist

    from kiwi_tpu_torch import misfit as mf
    from kiwi_tpu_torch.ops import bilat_tables as bl, float_scan as fs, synth_window as sw
    from kiwi_tpu_torch.parallel import gfshard, make_mesh, sharded_forward

    dev = torch.device("cuda", 0)
    store, _s = get_store()
    eng = make_engine(store, dev, filtered=False, base=FINITE_BASE)
    lm = make_lm_engine(store, dev)
    m41, m14, m22 = (make_mesh(a, b, device=dev) for a, b in ((4, 1), (1, 4), (2, 2)))
    out = {"rank": dist.get_rank(), "device": str(m41.device)}

    def run(label, fn, forward=True):
        for counts in (fs.launches, sw.launches, bl.launches):
            for k in counts:
                counts[k] = 0
        windows, scans = [], []
        if forward:
            windows = capture(sw, "window_forward", lambda: scans.extend(
                capture(mf, "scan_sums", fn)))
        else:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MD_REPS):
            res = fn()
        torch.cuda.synchronize()
        out[label] = {"result": [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in res],
                      "seconds": time.perf_counter() - t0,
                      "launches": {**fs.launches, **sw.launches, **bl.launches}}
        if forward:  # after the launches are read: these do not count
            out[label]["held"] = held_on_rank(windows, scans)

    run("4x1 sharded_forward", lambda: sharded_forward(eng, pb, m41))
    full = eng._plan["cfg"]
    out["full_window_bytes"] = full.nxw * full.nzw * full.ng * (full.nt_out + full.s_len) * 4
    plan = gfshard.build_plan(eng, m14)
    out["shard_window_bytes"] = plan.shard_window_bytes()
    out["shard_receivers"] = [len(g) for g in plan.groups]
    run("1x4 gfshard", lambda: plan.misfits(pb))
    out["coverage"] = []
    for col, hi in ((1, 1500.0), (0, 30.0)):  # north shift (m), time (s)
        bad = np.tile(FINITE_BASE, (4, 1))
        bad[:, col] = np.linspace(0.0, hi, 4).astype(np.float32)
        try:
            plan.misfits(bad)
        except ValueError as e:
            out["coverage"].append(str(e))
    plan22 = gfshard.build_plan(eng, m22)
    run("2x2 gfshard", lambda: plan22.misfits(pb_pad))
    run("4x1 gradient", lambda: lm.global_misfits_and_grad(rows, mesh=m41), forward=False)
    return out


def run_multidevice(finite_eng, grad, out, results):
    """The multi-device phase: MD_RANKS ranks (spawn_ranks) share the card;
    each mesh's forwards must launch window_synth, scan_sums and
    bilat_tables in every rank (the gradient none), and each kernel must agree with its plain
    version on every call a rank captured from its forwards (into results,
    as record_err records), the 1 x 4 shards' windows must be narrower
    than the whole plan's, every rank must hold the same rows, and rank 0's
    must match this process's unsharded card engine (misfits, norms and
    global misfits at TOL of the largest, shifts exactly; the gradient
    phase's rows at its bars).  out["multidevice"]: the summed launches."""
    import torch

    from kiwi_tpu_torch import misfit as mf
    from kiwi_tpu_torch.parallel import spawn_ranks

    pb = finite_rows(np.linspace(0.0, 359.0, FINITE_B).astype(np.float32))
    pb_pad = pb[:MD_PAD_B]
    t0 = time.perf_counter()
    ranks = spawn_ranks(multidevice_rank, MD_RANKS, (pb, pb_pad, grad["rows"]), timeout=600.0)
    seconds = time.perf_counter() - t0
    forwards = ("4x1 sharded_forward", "1x4 gfshard", "2x2 gfshard")
    for r in ranks:
        if not r["device"].startswith("cuda"):
            fail(f"multidevice: rank {r['rank']} on {r['device']}")
        for label in forwards:
            if min(r[label]["launches"][k] for k in ("window_synth", "scan_sums",
                                                     "bilat_tables")) <= 0:
                fail(f"multidevice: rank {r['rank']} {label} launched {r[label]['launches']}")
            names = {h[0] for h in r[label]["held"]}
            if names != {"window_synth", "scan_sums"}:
                fail(f"multidevice: rank {r['rank']} {label} captured calls of {names} only")
            for name, shapes, err, scale in r[label]["held"]:
                record_numbers(results, name, err, scale,
                               f"multidevice {label} rank {r['rank']} operands {shapes}")
        if any(r["4x1 gradient"]["launches"].values()):
            fail(f"multidevice: the gradient launched {r['4x1 gradient']['launches']}")
        if not 0 < r["shard_window_bytes"] < r["full_window_bytes"]:
            fail(f"multidevice: rank {r['rank']}'s shard window {r['shard_window_bytes']} B not "
                 f"under the whole plan's {r['full_window_bytes']} B")
        if len(r["coverage"]) != 2 or not all("coverage" in e for e in r["coverage"]):
            fail(f"multidevice: rank {r['rank']}: out-of-coverage batches gave {r['coverage']}")
        for label in (*forwards, "4x1 gradient"):
            for a, b in zip(r[label]["result"], ranks[0][label]["result"]):
                if not np.array_equal(a, b):
                    fail(f"multidevice: rank {r['rank']} holds other {label} rows than rank 0")
    rels = {}
    for label, rows in zip(forwards, (pb, pb, pb_pad)):
        m, n, fs = ranks[0][label]["result"]
        want = [x.cpu().numpy() for x in finite_eng.misfits_for_source_batch(rows)]
        g_got = mf.global_misfit(torch.as_tensor(m), torch.as_tensor(n)).numpy()
        g_want = finite_eng.global_misfits_for_source_batch(rows).cpu().numpy()
        rel = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
                  for a, b in ((m, want[0]), (n, want[1]), (g_got, g_want)))
        rels[label] = rel
        if not (rel <= TOL and np.array_equal(fs, want[2])):
            apart = np.argwhere(fs != want[2])[:4].tolist()
            fail(f"multidevice: {label} against the unsharded card engine: {rel:.3e} > {TOL} "
                 f"or shifts differ at (model, receiver) {apart}: "
                 f"{[(int(fs[i, r]), int(want[2][i, r])) for i, r in apart]}")
    g, d = ranks[0]["4x1 gradient"]["result"]
    rel_g = float(np.abs(g - grad["g"]).max()) / max(float(np.abs(grad["g"]).max()), 1e-30)
    scale = param_scale(grad["rows"])
    want = grad["grad"] * scale
    worst = float((np.abs(d * scale - want) / np.maximum(
        np.abs(want).max(axis=1, keepdims=True), 1e-30)).max())
    if not (rel_g <= 2e-5 and worst <= GRAD_TOL):
        fail(f"multidevice: sharded gradient against the unsharded one: g {rel_g:.3e}, "
             f"components {worst:.3e}")
    mps = {}
    for label in (*forwards, "4x1 gradient"):
        slowest = max(r[label]["seconds"] for r in ranks)
        b = len(ranks[0][label]["result"][0])
        mps[label] = MD_REPS * b / slowest
    r0 = ranks[0]
    log(f"phase multidevice: {MD_RANKS} processes sharing one card (gloo combine; not a "
        f"scaling measurement) in {seconds:.2f} s with start-up; devices "
        f"{sorted({r['device'] for r in ranks})}; launches per rank "
        + "; ".join(f"{label} " + ", ".join(
            f"{r[label]['launches']['window_synth']}/{r[label]['launches']['scan_sums']}"
            for r in ranks) for label in forwards)
        + f" (window_synth/scan_sums); 1x4 shard receivers {r0['shard_receivers']}, windows "
        + ", ".join(str(r["shard_window_bytes"]) for r in ranks)
        + f" B against {r0['full_window_bytes']} B; max rel diff to the unsharded engine "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
        + f", gradient g {rel_g:.3e}, components {worst:.3e}; shifts equal; coverage errors "
        f"raised in every rank")
    out["multidevice"] = {
        "mps": mps,
        "launches": {k: sum(r[label]["launches"][k] for r in ranks
                            for label in (*forwards, "4x1 gradient"))
                     for k in ranks[0][forwards[0]]["launches"]},
    }
    return mps


def get_long_store():
    """The 2 ms analytic store of the long-window phase (port elseis), and
    its build seconds."""
    from kiwi_tpu_torch.gf import elseis

    t0 = time.perf_counter()
    store = elseis.build_ahfull_store(**LONG_STORE, material=(2300.0, 3200.0, 1600.0),
                                      stf=KIWIBENCH_STF)
    return store, time.perf_counter() - t0


def make_long_engine(store, device):
    """The finite session (10 `ned` receivers, FINITE_BASE as the reference)
    on the 2 ms store, floating_l1norm over +-LONG_SHIFT."""
    eng = make_session(store, device)
    eng.set_source_params("bilateral", FINITE_BASE)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(-LONG_SHIFT, LONG_SHIFT)
    eng.set_misfit_method("floating_l1norm")
    return eng


def long_rows():
    """LONG_B strikes around the truth, 1.94 degrees apart."""
    pb = np.tile(FINITE_BASE, (LONG_B, 1))
    pb[:, 5] = np.linspace(61.0, 121.0, LONG_B)
    return pb


def run_long_window(eng, out):
    """A plan outside the window kernel: the plain synthesis, then the scan
    kernel; the plan must say "plain" and the best strike be within 1
    degree of the truth.  out["long_ops"]: the scan's operands."""
    import torch

    from kiwi_tpu_torch import misfit as mf
    from kiwi_tpu_torch.ops import synth_window as sw

    pb = long_rows()
    eng.global_misfits_for_source_batch(pb)  # plan + first call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = []
    scans = capture(mf, "scan_sums", lambda: res.append(eng.global_misfits_for_source_batch(pb)))
    seconds = time.perf_counter() - t0  # capture ends in torch.cuda.synchronize()
    cfg = eng._plan["cfg"]
    g = res[0].cpu().numpy()
    best = float(pb[int(np.argmin(g)), 5])
    log(f"phase long window: nt_out {cfg.nt_out} + s_len {cfg.s_len} = "
        f"{cfg.nt_out + cfg.s_len} (T_MAX {sw.T_MAX}): formulation "
        f"{eng._plan['formulation']!r}; {LONG_B} models in {seconds:.4f} s "
        f"({LONG_B / seconds:.1f} models/s) in {len(scans)} scan call(s); best strike "
        f"{best:.2f} (true 91)")
    if eng._plan["formulation"] != "plain" or cfg.nt_out + cfg.s_len <= sw.T_MAX:
        fail("long window: the plan is not outside the window kernel")
    if not np.isfinite(g).all() or abs(best - 91.0) > 1.0:
        fail(f"long window: misfits not finite or best strike {best} off the truth")
    out["long_ops"] = scans
    return LONG_B / seconds


def bilateral(p):
    return "bilateral " + " ".join(f"{float(x):.9g}" for x in p)


# the protocol session after the mini.inp replay: references read back from
# MiniSEED files, floating_l1norm unfiltered (the window kernel, then the
# scan), both ampspec norms under the band-pass (the window kernel), the
# diagnostics; compared answer by answer with a CPU server
MINI_SESSION = f"""set_source_params {bilateral(MINI_BASE)}
output_seismograms ref mseed synthetics plain
set_ref_seismograms ref mseed
set_source_params {bilateral(MINI_OFF)}
set_misfit_method floating_l1norm
set_floating_shiftrange 0 -1.0 1.0
get_global_misfit
get_misfits
get_floating_shifts
set_misfit_filter {" ".join(f"{x:g} {y:g}" for x, y in zip(*BAND))}
set_misfit_method ampspec_l2norm
get_global_misfit
get_misfits
get_floating_shifts
set_misfit_method ampspec_l1norm
get_global_misfit
get_misfits
get_floating_shifts
get_peak_amplitudes 1
get_peak_amplitudes 2
get_arias_intensities
output_seismogram_spectra spec synthetics filtered
output_cross_correlations xcorr -0.5 0.5
autoshift_ref_seismogram 0 -0.5 0.5
"""
# LM on the card from a clean receiver set (no filter, references as read)
MINI_LM = f"""set_receivers receivers.table
set_ref_seismograms ref mseed
set_misfit_method l2norm
set_floating_shiftrange 0 0 0
set_source_params {bilateral(MINI_LM_START)}
set_source_params_mask {" ".join("T" if i in LM_FREE else "F" for i in range(MINI_BASE.size))}
minimize_lm
get_source_subparams
get_misfits
"""


def mini_workdir(name):
    """A fresh directory under build/ for a protocol session: the store
    (benchdb.npz, a link to the cached one) and benchmark/run_mini.py:48-53's
    receivers.table."""
    from kiwi_tpu_torch import geo

    d = os.path.join(HERE, "build", "kiwi_tpu_torch", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    os.symlink(STORE_CACHE, os.path.join(d, "benchdb.npz"))
    rows = []
    for dist in np.linspace(3000.0, 4000.0, MINI_RECEIVERS):
        la, lo = geo.ne_to_latlon(np.radians(30.0), np.radians(70.0), float(dist), 0.0)
        rows.append(f"{np.degrees(float(la)):.6f} {np.degrees(float(lo)):.6f} ned")
    with open(os.path.join(d, "receivers.table"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return d


def protocol(srv, workdir, script):
    """script's lines through srv.run in workdir: [(command, ok, [answer
    lines])]."""
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        srv.run(io.StringIO(script), buf)
    finally:
        os.chdir(cwd)
    out = []
    for line in buf.getvalue().splitlines():
        if ": ok" in line or ": nok" in line:
            cmd, status = line.split(": ", 1)
            out.append((cmd, status.startswith("ok"), []))
        else:
            out[-1][2].append(line)
    return out


def numbers(lines):
    return np.array([float(w) for line in lines for w in line.split()])


def mini_lines():
    with open(os.path.join(HERE, "benchmark", "mini.inp")) as f:
        return f.read().strip().splitlines()


def run_protocol(out, device="cuda"):
    """benchmark/run_mini.py's replay of benchmark/mini.inp through
    kiwi_tpu_torch.cli.minimizer.MinimizerServer on the card (the first 7
    lines warm, the rest timed: mini_inp_seconds), then MINI_SESSION and
    MINI_LM and MINI_GRADIENT (from LM's end) on the same server; no command
    may answer nok, and LM must recover the truth as the lm phase does.
    out["protocol"]: the session's answers and files, LM's end, the
    gradient descent's answer, and the window and scan operands of
    MINI_SESSION's and MINI_LM's calls (the last call of each shape of
    each)."""
    import torch

    from kiwi_tpu_torch import misfit as mf, native
    from kiwi_tpu_torch.cli.minimizer import MinimizerServer
    from kiwi_tpu_torch.ops import synth_window as sw

    if native.get_lib() is None:
        fail("protocol: the native MiniSEED library did not build")
    work = mini_workdir("mini")
    lines = mini_lines()
    srv = MinimizerServer(device=device)
    t0 = time.perf_counter()
    answers = protocol(srv, work, "\n".join(lines[:7]))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers += protocol(srv, work, "\n".join(lines[7:]))
    seconds = time.perf_counter() - t0
    nsynth = sum(c == "output_seismograms" and ok for c, ok, _a in answers)
    tables = [f for f in os.listdir(work) if f.startswith("seis-")]
    log(f"phase protocol: mini.inp {len(lines)} commands, warm block (set-up and 1 synthesis) "
        f"{warm:.4f} s, {nsynth - 1} further syntheses and file output {seconds:.4f} s "
        f"({(nsynth - 1) / seconds:.2f} models/s); {len(tables)} seismogram files")
    log(f"mini_inp_seconds {seconds:.6f}")
    if nsynth != 8 or len(tables) != 3 * MINI_RECEIVERS:
        fail(f"protocol: mini.inp gave {nsynth} syntheses and {len(tables)} files")

    def held(script, answers):
        """script's answers into `answers`; its window and scan operands."""
        scans = []
        windows = capture(sw, "window_forward", lambda: scans.extend(capture(
            mf, "scan_sums", lambda: answers.extend(protocol(srv, work, script)), scan_shapes)),
            window_shapes)
        return windows, scans

    session, lm, grad, ops = [], [], [], {}
    t0 = time.perf_counter()
    ops["session"] = held(MINI_SESSION, session)
    t_session = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops["lm"] = held(MINI_LM, lm)
    t_lm = time.perf_counter() - t0
    lm_end = srv.engine.source_params.copy()
    t0 = time.perf_counter()
    ops["gradient"] = held(MINI_GRADIENT, grad)
    t_grad = time.perf_counter() - t0
    for part, (windows, scans) in ops.items():
        log(f"phase protocol {part}: window_forward shapes (B, R, P, G, nt_ext, nt_out) "
            f"{[window_shapes(a) for a, _kw in windows]}, scan_sums shapes (S*RC, W, RC, B, W) "
            f"{[scan_shapes(a) for a, _kw in scans]}")
    answers += session + lm + grad
    noks = [(c, a) for c, ok, a in answers if not ok]
    log(f"phase protocol: session {len(session)} commands in {t_session:.4f} s, LM session "
        f"{len(lm)} in {t_lm:.4f} s, {MINI_GRADIENT.strip()} in {t_grad:.4f} s: "
        f"{grad[0][2] if grad else None}; nok: {noks}")
    if noks or len(grad) != 1:
        fail(f"protocol: commands answered nok: {noks}")
    if any(ops["gradient"]):
        fail("protocol: minimize_gradient called a kernel wrapper")
    res = {c: a for c, _ok, a in lm}
    info, nfev, gm = numbers(res["minimize_lm"])
    p = lm_end
    log(f"phase protocol lm: info {int(info)}, nfev {int(nfev)}, global misfit {gm:.4e}; "
        f"subparams {' '.join(res['get_source_subparams'])} (true 0, 91, 87, 164)")
    off = np.abs(p[[5, 6, 7]] - MINI_BASE[[5, 6, 7]])
    if not (np.isfinite(gm) and gm < 0.02 and (off < 0.5).all()):
        fail(f"protocol lm: misfit {gm}, strike/dip/slip-rake off the truth by {off}")
    torch.cuda.synchronize()
    out["protocol"] = {"session": session, "dir": work, "lm_end": p, "server": srv,
                       "lm_misfits": numbers(res["get_misfits"]), "ops": ops,
                       "gradient": numbers(grad[0][2])}
    return seconds


def make_pipeline_session(store, device):
    """The observed data of the pipeline phase: make_session's distances
    (3-4 km, 10 `ned` receivers), 36 degrees apart in azimuth, BASE (the
    point bilateral source) under l2norm as its own synthetic reference."""
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Receiver

    eng = make_session(store, device)
    recs = []
    for i, d in enumerate(np.linspace(3000.0, 4000.0, 10)):
        az = np.radians(36.0 * i)
        la, lo = geo.ne_to_latlon(np.radians(30.0), np.radians(70.0), d * np.cos(az),
                                  d * np.sin(az))
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_misfit_method("l2norm")
    eng.set_source_params("bilateral", BASE)
    eng.set_synthetic_reference()
    return eng


def sdr_ranges(step):
    """kiwi_main's strike/dip/slip-rake grid at grid_step_deg = step."""
    return [("strike", np.arange(0.0, 360.0, step)), ("dip", np.arange(step, 91.0, step)),
            ("slip-rake", np.arange(-180.0, 180.0, step))]


def check_recovery(label, best):
    """tests/test_kiwi_main.py's bars against BASE: moment-tensor correlation
    above 0.9, |log10(moment ratio)| under 0.2, depth within 150 m."""
    from kiwi_tpu_torch.euler import mt_from_sdr

    truth = mt_from_sdr(*np.radians(BASE[5:8].astype(np.float64)))
    got = mt_from_sdr(*np.radians([best["strike"], best["dip"], best["slip-rake"]]))
    corr = float((truth * got).sum() / np.sqrt((truth**2).sum() * (got**2).sum()))
    dm = abs(float(np.log10(best["moment"] / BASE[4])))
    dz = abs(float(best["depth"] - BASE[3]))
    log(f"phase {label}: best strike {best['strike']}, dip {best['dip']}, slip-rake "
        f"{best['slip-rake']}, moment {best['moment']:.4e}, depth {best['depth']}: mechanism "
        f"correlation {corr:.4f} (bar > 0.9), |log10 moment ratio| {dm:.4f} (< 0.2), "
        f"|depth - truth| {dz:.1f} m (< 150)")
    if not (corr > 0.9 and dm < 0.2 and dz < 150.0):
        fail(f"{label}: the search missed the truth: {corr}, {dm}, {dz}")


def results_load_without_cuda(workdir):
    """Every step's current/results.pickle loaded in a fresh process that
    sees no card and must not initialize CUDA; returns how many."""
    code = ("import glob, os, pickle, sys, torch\n"
            "fns = sorted(glob.glob(os.path.join(sys.argv[1], '*', 'current', 'results.pickle')))\n"
            "for fn in fns:\n"
            "    with open(fn, 'rb') as f:\n"
            "        pickle.load(f)\n"
            "assert not torch.cuda.is_initialized()\n"
            "print(len(fns))\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-c", code, workdir], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"pipeline: the run's results do not load without the card:\n{r.stderr[-2000:]}")
    return int(r.stdout.split()[-1])


def run_pipeline(store, out, device="cuda"):
    """kiwi_main.work on the card at its defaults over a data directory
    written by save_dataset (MiniSEED through the native codec) from
    make_pipeline_session: informer, shifter (+-1 s), weightmaker, the SDR
    tuner (11,664 models, bootstrap 100), the moment-depth tuner (143) and
    traceplotter (skipped without matplotlib), with the begin-table taper.
    Fails unless the best source meets check_recovery's bars, report.html
    exists and every results.pickle loads without the card.  Logs seconds
    per step and the SDR grid's models/s (MisfitGrid.compute rerun on the
    same engine).  out["pipeline"]: the engine, the steps, the directories
    and the window operands (the last call of each shape)."""
    import torch

    from kiwi_tpu_torch import dataset, native, pipeline
    from kiwi_tpu_torch.cli import kiwi_main
    from kiwi_tpu_torch.invert import MisfitGrid, Source
    from kiwi_tpu_torch.ops import synth_window as sw

    if native.get_lib() is None:
        fail("pipeline: the native MiniSEED library did not build")
    base = os.path.join(HERE, "build", "kiwi_tpu_torch", "pipeline")
    shutil.rmtree(base, ignore_errors=True)
    datadir, workdir = os.path.join(base, "data"), os.path.join(base, "work")
    dataset.save_dataset(datadir, make_pipeline_session(store, device), fmt="mseed")
    engines, seconds, done = [], {}, []
    real = dataset.standard_setup, pipeline.Step.pre_work, pipeline.Step.post_work

    def setup(*a, **kw):
        engines.append(real[0](*a, **kw))
        return engines[-1]

    def pre_work(step):
        seconds[step.name] = time.perf_counter()
        real[1](step)

    def post_work(step):
        real[2](step)
        seconds[step.name] = time.perf_counter() - seconds[step.name]

    dataset.standard_setup, pipeline.Step.pre_work, pipeline.Step.post_work = (
        setup, pre_work, post_work)
    try:
        t0 = time.perf_counter()
        windows = capture(sw, "window_forward", lambda: done.append(
            kiwi_main.work(datadir, STORE_CACHE, workdir, device=device, **PIPE_OPTS)),
            window_shapes)
        wall = time.perf_counter() - t0
    finally:
        dataset.standard_setup, pipeline.Step.pre_work, pipeline.Step.post_work = real
    best, steps = done[0]
    eng = engines[0]
    log(f"phase pipeline: kiwi_main work in {wall:.3f} s; seconds per step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
        + f"; window_forward shapes (B, R, P, G, nt_ext, nt_out) "
          f"{[window_shapes(a) for a, _kw in windows]}")
    check_recovery("pipeline", best)
    names = [st.name for st in steps]
    if names != ["informer", "shifter", "weightmaker", "sdr-tuner", "moment-depth-tuner",
                 "traceplotter"] or not os.path.exists(os.path.join(workdir, "report.html")):
        fail(f"pipeline: steps {names} or report.html missing")
    if not all(r.enabled for r in eng.receivers) or len(eng._tapers) != 30:
        fail("pipeline: the begin-table taper did not keep every receiver")
    nres = results_load_without_cuda(workdir)
    if nres != len(steps):
        fail(f"pipeline: {nres} results.pickle of {len(steps)} steps loaded")
    sdr = next(st for st in steps if st.name == "sdr-tuner")
    dump = sdr.load(sdr.name)
    grid = MisfitGrid(Source("bilateral", dump["params"][0]), sdr_ranges(PIPE_STEP_DEG))
    if not np.array_equal(grid.params, dump["params"]):
        fail("pipeline: the SDR grid is not kiwi_main's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid.compute(eng)  # ends in the results' copy to the host
    mps = grid.nsources / (time.perf_counter() - t0)
    log(f"phase pipeline: SDR grid {grid.nsources} models, {mps:.0f} models/s (compute "
        f"alone; the step {seconds['sdr-tuner']:.4f} s with bootstrap x100); shifts "
        f"{steps[1].out_config['ref_shifts']}; min misfit "
        f"{steps[4].out_config['min_misfit']:.6g}; {nres} results.pickle loaded without CUDA; "
        f"traceplotter: {steps[-1].results.get('skipped', 'figures drawn')}")
    out["pipeline"] = {"engine": eng, "steps": steps, "dump": dump, "grid": grid,
                       "datadir": datadir, "workdir": workdir, "ops": (windows, [])}
    return mps


def compare_pipeline(pipe, store):
    """The SDR tuner's first and last 32 models on a CPU engine of the port
    set up as the run set up its own (standard_setup on the data directory,
    the begin-table taper at the start's depth, Shifter's shifts): misfits
    and norms at TOL."""
    from kiwi_tpu_torch import dataset, phases

    cpu = dataset.standard_setup(pipe["datadir"], store, components="ned", effective_dt=0.1,
                                 device="cpu")
    cpu.set_misfit_method("l2norm")
    dump = pipe["dump"]
    cpu.set_source_params("bilateral", dump["params"][0])
    w = PIPE_OPTS["taper"].split(",")
    phases.apply_taper_to_engine(cpu, phases.Taper(phases=tuple(w[:-4]),
                                                   offsets=[float(x) for x in w[-4:]]))
    for irec, sh in enumerate(pipe["steps"][1].out_config["ref_shifts"]):
        cpu.shift_ref_seismogram(irec, int(round(sh / store.dt)))
    for name, sel in (("first", slice(0, 32)), ("last", slice(-32, None))):
        m, n, _fs = (x.numpy() for x in cpu.misfits_for_source_batch(dump["params"][sel]))
        shape = dump["misfits_by_src"][sel].shape
        compare_misfits(f"pipeline SDR tuner ({name} 32 models)",
                        (dump["misfits_by_src"][sel], dump["norms_by_src"][sel]),
                        (m.reshape(shape), n.reshape(shape)))


def run_autokiwi(out, device="cuda"):
    """One autokiwi cycle (pull, prepare, process, report) over a local
    catalog of one event at the pipeline's source: prepare_hook writes the
    event's data directory with prepare.save_kiwi_dataset from the pipeline
    phase's reference files (the stations as XX.Snn, channels BHN/BHE/BHZ),
    the processing command is kiwi_main --device cuda work at grid_step_deg
    30 in a child process.  Fails unless the done file (the run's
    report.html) exists and the fail file does not."""
    from kiwi_tpu_torch.cli import autokiwi

    base = os.path.join(HERE, "build", "kiwi_tpu_torch", "autokiwi")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    with open(os.path.join(base, "catalog.txt"), "w") as f:
        f.write(AUTOKIWI_EVENT + "\n")
    work = ["work", "data", STORE_CACHE, "run", "grid_step_deg=30", "bootstrap_iterations=20",
            *(f"{k}={v}" for k, v in PIPE_OPTS.items())]
    km = [sys.executable, "-m", "kiwi_tpu_torch.cli.kiwi_main"]
    conf = f"""import os
from kiwi_tpu_torch import prepare
from kiwi_tpu_torch.cli.autokiwi import Event
from kiwi_tpu_torch.dataset import load_receivers_table
from kiwi_tpu_torch.io import readseismogram

SOURCE = {out["pipeline"]["datadir"]!r}
CHANNELS = {{"n": "BHN", "e": "BHE", "d": "BHZ"}}


def prepare_hook(name, pdir):
    ev = Event.load(os.path.join(pdir, "event.txt"))
    stations, traces = [], []
    for i, r in enumerate(load_receivers_table(os.path.join(SOURCE, "receivers.table"))):
        sta = f"S{{i:02d}}"
        stations.append(prepare.Station("XX", sta, "", r.lat_deg, r.lon_deg))
        for c, ch in CHANNELS.items():
            y, t0, dt = readseismogram(os.path.join(SOURCE, f"reference-{{i + 1}}-{{c}}.mseed"))
            traces.append(prepare.RawTrace("XX", sta, "", ch, ev.time + t0, dt, y))
    data = os.path.join(pdir, "data")
    prepare.save_kiwi_dataset(stations, traces, ev, Config(
        wanted_channels=list(CHANNELS.values()),
        kiwi_component_map={{ch: c for c, ch in CHANNELS.items()}},
        trace_time_zero="event",
        receivers_path=os.path.join(data, "receivers.table"),
        displacement_trace_path=os.path.join(data, "reference-%(ireceiver)i-%(component)s.mseed"),
        source_origin_path=os.path.join(data, "source-origin.table"),
        event_info_path=os.path.join(data, "event.txt")))


base_config = Config(base_dir={base!r}, event_dir="%(base_dir)s/events/%(event_name)s",
                     seed_volume="%(event_dir)s/data.kiwi", fail_filename="%(event_dir)s/failed")
pull_config = Config(base_config, catalog=os.path.join({base!r}, "catalog.txt"))
kiwi_config = Config(base_config, processing_dir="%(event_dir)s/work",
                     prepare_hook=prepare_hook,
                     processing_command={km + ["--device", device] + work!r},
                     report_command={km + ["report", "run"]!r},
                     done_filename="%(processing_dir)s/run/report.html")
"""
    conf_fn = os.path.join(base, "autokiwi.conf")
    with open(conf_fn, "w") as f:
        f.write(conf)
    name = AUTOKIWI_EVENT.split()[0]
    event_dir = os.path.join(base, "events", name)
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([HERE] + ([env_path] if env_path else []))
    t0 = time.perf_counter()
    try:
        for cmd in (["pull", "all"], ["prepare,process,report", name]):
            try:
                autokiwi.main(["--config", conf_fn, *cmd])
            except SystemExit as e:
                log(f"phase autokiwi: {' '.join(cmd)} exited {e.code}")
    finally:
        if env_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env_path
    seconds = time.perf_counter() - t0
    done = os.path.join(event_dir, "work", "run", "report.html")
    failed = os.path.join(event_dir, "failed")
    ok = os.path.exists(done) and not os.path.exists(failed)
    log(f"phase autokiwi: pull, prepare, process (kiwi_main --device {device} work, grid_step_deg "
        f"30, in a child process), report in {seconds:.2f} s; done file {os.path.exists(done)}, "
        f"fail file {os.path.exists(failed)}")
    if not ok:
        fail("autokiwi: the cycle did not finish (no done file, or a fail file)")
    from kiwi_tpu_torch.dataset import load_receivers_table

    rows = load_receivers_table(os.path.join(event_dir, "work", "data", "receivers.table"))
    if len(rows) != 10 or {r.components for r in rows} != {"end"}:
        fail(f"autokiwi: prepare wrote {len(rows)} receivers")
    return seconds


def stdout_of(fn, argv, stdin=""):
    """What fn(argv) prints, with `stdin` as its standard input."""
    import contextlib

    buf = io.StringIO()
    real = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(buf):
            fn(argv)
    finally:
        sys.stdin = real
    return buf.getvalue()


def run_gfdb(store):
    """The benchmark store's configuration built again through the port's
    GFDBBuilder in worker processes, exactly equal to get_store()'s; then
    kiwi_tpu_torch.cli.gfdb_tools on the saved .npz: info (its numbers
    against the store), extract of three nodes (MiniSEED, equal to
    store.get_trace) and build_ahfull of five nodes on stdin into an empty
    store of the same grid (equal to the same nodes of the store)."""
    from kiwi_tpu_torch.cli import gfdb_tools
    from kiwi_tpu_torch.gf.store import GFStore, GFStoreBuilder
    from kiwi_tpu_torch.gf.trace import fnint
    from kiwi_tpu_torch.io import readseismogram

    t0 = time.perf_counter()
    built = build_store_parallel()
    build_s = time.perf_counter() - t0
    if not all(np.array_equal(getattr(built, k), getattr(store, k))
               for k in ("data", "itmin", "nsamples")):
        fail("gfdb: the parallel build differs from the benchmark store")
    del built
    work = os.path.join(HERE, "build", "kiwi_tpu_torch", "gfdb")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    t0 = time.perf_counter()
    info = dict(line.split("=", 1) for line in stdout_of(gfdb_tools.gfdb_info, [STORE_CACHE]).split())
    used = int((store.nsamples > 0).sum())
    want = {"dt": store.dt, "dx": store.dx, "dz": store.dz, "firstx": store.firstx,
            "firstz": store.firstz, "nchunks": 1, "nx": store.nx, "nz": store.nz, "ng": store.ng}
    if (any(float(info[k]) != v for k, v in want.items())
            or info["total_traces"] != f"{used}/{store.nx * store.nz * store.ng}"):
        fail(f"gfdb info: {info} does not describe the store")

    nx, nz = store.nx, store.nz
    nodes = ((0, 0, 1), (nx // 2 - 1, nz // 2, 6), (nx - 1, nz - 1, 10))  # ix, iz, 1-based ig
    lines = "".join(f"{store.firstx + ix * store.dx} {store.firstz + iz * store.dz} {ig} "
                    f"'{os.path.join(work, f'extract-{ix}-{iz}-{ig}.mseed')}'\n"
                    for ix, iz, ig in nodes)
    answers = stdout_of(gfdb_tools.gfdb_extract, [STORE_CACHE], lines)
    if answers != "ok\n" * len(nodes):
        fail(f"gfdb extract answered {answers!r}")
    for ix, iz, ig in nodes:
        values, toffset, deltat = readseismogram(
            os.path.join(work, f"extract-{ix}-{iz}-{ig}.mseed"))
        want_v, want_it = store.get_trace(ix, iz, ig - 1)
        it = int(fnint(np.float32(toffset) / np.float32(store.dt)))
        if not (np.array_equal(values, want_v) and it == want_it and abs(deltat - store.dt) < 1e-9):
            fail(f"gfdb extract: node ({ix}, {iz}, {ig}) differs from store.get_trace")

    empty = os.path.join(work, "ahfull.npz")
    GFStoreBuilder(store.nx, store.nz, store.ng, store.dt, store.dx, store.dz, store.firstx,
                   store.firstz).build().save(empty)
    np.savetxt(os.path.join(work, "material"), [MATERIAL])
    np.savetxt(os.path.join(work, "stf"),
               np.column_stack([np.arange(KIWIBENCH_STF.size) * store.dt, KIWIBENCH_STF]))
    ahnodes = ((0, 0), (nx * 2 // 7, 3), (nx * 3 // 5, nz // 2 + 1), (13, nz * 9 // 10),
               (nx - 1, nz - 1))
    stdout_of(gfdb_tools.gfdb_build_ahfull,
              [empty, os.path.join(work, "material"), os.path.join(work, "stf")],
              "".join(f"{store.firstx + ix * store.dx} {store.firstz + iz * store.dz} T T\n"
                      for ix, iz in ahnodes))
    got = GFStore.load(empty)
    for ix, iz in ahnodes:
        for ig in range(store.ng):
            a, b = got.get_trace(ix, iz, ig), store.get_trace(ix, iz, ig)
            if (a is None) != (b is None) or (a is not None and not (
                    a[1] == b[1] and np.array_equal(a[0], b[0]))):
                fail(f"gfdb build_ahfull: node ({ix}, {iz}, {ig}) differs from the store")
    if int((got.nsamples > 0).sum()) != sum(int((store.nsamples[ix, iz] > 0).sum())
                                            for ix, iz in ahnodes):
        fail("gfdb build_ahfull: traces at other nodes than those asked for")
    tools_s = time.perf_counter() - t0
    log(f"phase gfdb: {store.data.shape} through GFDBBuilder with {BUILD_WORKERS} spawned "
        f"workers (blocks of {BUILD_BLOCK_NX} columns) in {build_s:.3f} s, exactly the benchmark "
        f"store; gfdb_tools info ({used} traces), extract of {len(nodes)} nodes, build_ahfull of "
        f"{len(ahnodes)} nodes in {tools_s:.3f} s, each exactly the store's")
    return build_s


FDSN_EVENT_TIME = 1700000000.0  # 2023-11-14T22:13:20
FDSN_CHANNELS = {"n": "BHN", "e": "BHE", "d": "BHZ"}


def run_acquisition(store, device="cuda"):
    """The finite session's synthetics at the 10 `ned` receivers as the
    MiniSEED payloads of a local FDSN service (event, station and
    dataselect text endpoints of a ThreadingHTTPServer on 127.0.0.1, one
    channel each of BHN/BHE/BHZ), fetched through the port's fdsn_catalog
    and fetch_dataset with the default urllib opener (real HTTP round
    trips): every raw file byte for byte what the server sent, the samples
    the synthetics', stations.txt and event.txt written."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from kiwi_tpu_torch import acquisition as acq
    from kiwi_tpu_torch.io import readseismogram, writeseismogram

    eng = make_session(store, device)
    eng.set_source_params("bilateral", FINITE_BASE)
    traces = eng.get_synthetic_seismograms()
    work = os.path.join(HERE, "build", "kiwi_tpu_torch", "acquisition")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    payloads, samples = {}, {}
    fn = os.path.join(work, "payload.mseed")
    for (values, itmin), (irec, comp) in zip(traces, eng._rc_layout()):
        key = (f"S{irec + 1:02d}", FDSN_CHANNELS[comp])
        writeseismogram(fn, "mseed", values, FDSN_EVENT_TIME + itmin * store.dt, store.dt,
                        network="XX", station=key[0], channel=key[1])
        with open(fn, "rb") as f:
            payloads[key] = f.read()
        samples[key] = values
    t = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(FDSN_EVENT_TIME))
    event_text = ("#EventID|Time|Latitude|Longitude|Depth/km|Author|Catalog|Contributor|"
                  "ContributorID|MagType|Magnitude|MagAuthor|EventLocationName\n"
                  f"ev-smoke|{t}.00|30.0|70.0|5.0|XX|XX|XX|1|MW|5.3|XX|SMOKE REGION\n")
    station_text = "#Network|Station|Location|Channel|Latitude|Longitude|Elevation|Depth\n" + "".join(
        f"XX|S{irec + 1:02d}||{ch}|{float(r.lat_deg)!r}|{float(r.lon_deg)!r}|0.0|0.0\n"
        for irec, r in enumerate(eng.receivers) for ch in FDSN_CHANNELS.values())
    sent = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            body = {"/fdsnws/event/1/query": event_text.encode(),
                    "/fdsnws/station/1/query": station_text.encode()}.get(url.path)
            if url.path == "/fdsnws/dataselect/1/query":
                body = payloads.get((q.get("station"), q.get("channel")))
            if body is None:
                self.send_error(404)
                return
            sent.append(url.path)
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    datadir = os.path.join(work, "data")
    try:
        t0 = time.perf_counter()
        events = acq.fdsn_catalog(base, min_magnitude=5.0)(
            time_range=(FDSN_EVENT_TIME - 3600.0, FDSN_EVENT_TIME + 3600.0))
        if [e.name for e in events] != ["ev-smoke"]:
            fail(f"acquisition: the catalog gave {[e.name for e in events]}")
        stations, paths = acq.fetch_dataset(
            acq.as_acquisition_event(events[0]), datadir,
            waveform_source=acq.FDSNWaveforms(base), channels=tuple(FDSN_CHANNELS.values()),
            dist_range_m=(0.0, 1.0e6))
        seconds = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    if len(stations) != len(eng.receivers) or len(paths) != len(payloads):
        fail(f"acquisition: {len(stations)} stations, {len(paths)} files")
    for path in paths:
        _net, sta, _loc, ch = os.path.basename(path)[len("raw-"):-len(".mseed")].split(".")
        with open(path, "rb") as f:
            if f.read() != payloads[(sta, ch)]:
                fail(f"acquisition: {path} is not what the server sent")
        if not np.array_equal(readseismogram(path)[0], samples[(sta, ch)]):
            fail(f"acquisition: {path} does not hold the synthetic's samples")
    for name in ("stations.txt", "event.txt"):
        if not os.path.exists(os.path.join(datadir, name)):
            fail(f"acquisition: no {name}")
    log(f"phase acquisition: catalog and {len(paths)} MiniSEED files of {len(stations)} "
        f"stations over HTTP ({len(sent)} requests) in {seconds:.4f} s; every file byte-equal "
        f"to what the server sent")
    return seconds


# the web phase's second session: one calculate of each other source type on
# the benchmark store (the eikonal rupture below the default constraint
# plane at 1500 m)
WEB_SOURCES = (
    ("moment_tensor", {"depth": 5000.0, "mxx": 1e12, "myy": -5e11, "mzz": -5e11,
                       "mxy": 3e11, "mxz": 1e11, "myz": 2e11, "rise-time": 0.2}),
    ("circular", {"depth": 5000.0, "moment": 1e12, "strike": 91.0, "dip": 87.0,
                  "slip-rake": 164.0, "radius": 500.0, "rupture-velocity": 2500.0,
                  "rise-time": 0.2}),
    ("point_lp", {"depth": 5000.0, "moment": 1e12, "excitation-time": 2.0,
                  "main-period": 0.5}),
    ("eikonal", {"depth": 3000.0, "moment": 1e12, "strike": 30.0, "dip": 80.0,
                 "slip-rake": 164.0, "bord-radius": 400.0, "nukl-shift-x": 50.0,
                 "nukl-shift-y": -50.0, "rel-rupture-velocity": 0.9, "rise-time": 0.3}),
)
WEB_GENERATIONS = 8  # FINITE_BASE at strikes 91 + 10 k


def web_receivers(store):
    """make_session's receivers as the form's text, one `lat lon ned` a line."""
    return "\n".join(f"{float(r.lat_deg)!r} {float(r.lon_deg)!r} {r.components}"
                     for r in make_session(store, "cpu").receivers)


def web_form(session, sourcetype, params, receivers):
    from kiwi_tpu_torch.sources import get_source_model

    model = get_source_model(sourcetype)
    form = {"session": str(session), "sourcetype": sourcetype, "source_latitude": "30.0",
            "source_longitude": "70.0", "effective_dt": "0.1", "interpolation": "bilinear",
            "receivers": receivers, "calculate": "1"}
    form.update({f"param.{n}": repr(float(params[n])) for n in model.names if n in params})
    return form


def engine_from_form(store, form, device):
    """An Engine set up from a web form as SeismogramApp.calculate sets up
    its own (the reference for the web phase)."""
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.sources import get_source_model

    model = get_source_model(form["sourcetype"])
    eng = Engine(store, device=device)
    eng.set_receivers([Receiver(float(w[0]), float(w[1]), w[2])
                       for w in (line.split() for line in form["receivers"].splitlines())])
    eng.set_source_location(float(form["source_latitude"]), float(form["source_longitude"]), 0.0)
    eng.set_effective_dt(float(form["effective_dt"]))
    eng.set_local_interpolation(True)
    eng.set_source_params(form["sourcetype"], np.array(
        [float(form.get(f"param.{n}", model.defaults[i])) for i, n in enumerate(model.names)],
        dtype=np.float32))
    return eng


def run_web(store, out, device="cuda"):
    """kiwi_tpu_torch.web.serve(store, ..., device="cuda") in a thread,
    driven over HTTP: the landing page, WEB_GENERATIONS calculates of
    FINITE_BASE (strikes 91 + 10 k) in session 1 and one of each of
    WEB_SOURCES in session 2, then /traces, result.json and /source3d.json
    of each source type.  No answer may be a non-200 or an error page.
    out["web"]: the seconds per calculate (host clock, request to
    response), the first form and its result rows, the app."""
    import threading
    import urllib.parse
    import urllib.request

    from kiwi_tpu_torch.plotting import matplotlib_missing
    from kiwi_tpu_torch.web import serve

    work = os.path.join(HERE, "build", "kiwi_tpu_torch", "web")
    shutil.rmtree(work, ignore_errors=True)
    srv = serve(store, work, port=0, device=device)
    app = srv.RequestHandlerClass.app
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def request(path, form=None):
        data = None if form is None else urllib.parse.urlencode(form).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + path, data=data, timeout=300) as r:
            body, status = r.read(), r.status
        seconds = time.perf_counter() - t0
        text = body.decode(errors="replace")
        if status != 200 or "<h1>error</h1>" in text or "<h1>card failure</h1>" in text:
            fail(f"web: {path} answered {status}: {text[:400]}")
        return text, seconds

    receivers = web_receivers(store)
    nrows = 3 * len(receivers.splitlines())
    finite = dict(zip(("time", "north-shift", "east-shift", "depth", "moment", "strike", "dip",
                       "slip-rake", "rupture-rake", "length-a", "length-b", "width",
                       "rupture-velocity", "rise-time"), FINITE_BASE.tolist()))
    calcs = [(1, web_form(1, "bilateral", {**finite, "strike": 91.0 + 10.0 * k}, receivers))
             for k in range(WEB_GENERATIONS)]
    calcs += [(2, web_form(2, name, p, receivers)) for name, p in WEB_SOURCES]
    try:
        landing, _ = request("/?session=1")
        if "none yet" not in landing or 'name="param.moment"' not in landing:
            fail("web: the landing page is not the form")
        seconds, bodies = [], []
        for session, form in calcs:
            body, s = request("/", form)
            gens = app.generations(session)
            if f"generation: {gens[-1]}" not in body:
                fail(f"web: calculate of {form['sourcetype']} did not answer its generation")
            seconds.append(s)
            bodies.append(body)
        views = [(1, 1, "bilateral")] + [(2, g + 1, name) for g, (name, _p) in
                                         enumerate(WEB_SOURCES)]
        for session, gen, name in views:
            q = f"session={session}&generation={gen}"
            request(f"/traces?{q}")
            result = json.loads(request(f"/file?{q}&name=result.json")[0])
            cents = json.loads(request(f"/source3d.json?{q}")[0])
            if (cents["sourcetype"] != name or not cents["north"]
                    or len(result["traces"]) != nrows):
                fail(f"web: session {session} generation {gen} ({name}): "
                     f"{len(result['traces'])} rows, {len(cents['north'])} centroids")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    pngs = sorted(f for dp, _d, fs in os.walk(work) for f in fs if f.endswith(".png"))
    missing = matplotlib_missing()
    if missing is not None and (pngs or any("figures skipped" not in b for b in bodies)):
        fail(f"web: without matplotlib, {len(pngs)} PNG files or a page without the skip note")
    log(f"phase web: {len(calcs)} calculates ({WEB_GENERATIONS} of the finite fault, then "
        f"{', '.join(n for n, _p in WEB_SOURCES)}): first {seconds[0]:.4f} s (plan), then "
        f"{np.median(seconds[1:WEB_GENERATIONS]):.4f} s median per finite calculate "
        f"(min {min(seconds[1:WEB_GENERATIONS]):.4f}, max {max(seconds[1:WEB_GENERATIONS]):.4f}); "
        + ", ".join(f"{n} {s:.4f} s" for (n, _p), s in zip(WEB_SOURCES, seconds[WEB_GENERATIONS:]))
        + f"; plan_builds {app.engine.plan_builds}; figures: "
        + (f"skipped ({missing})" if missing else f"{len(pngs)} PNG files"))
    out["web"] = {"seconds": seconds, "form": calcs[0][1], "rows": app._load(1, 1)["traces"]}
    return float(np.median(seconds[1:WEB_GENERATIONS]))


def compare_web(web, store):
    """The web phase's first generation against an Engine on the CPU set up
    from the same form: the same rows (receiver, component) in the same
    order, the same itmin, values within TOL of each row's largest."""
    want = engine_from_form(store, web["form"], "cpu")
    traces, layout = want.get_synthetic_seismograms(), want._rc_layout()
    got = web["rows"]
    if [(r["receiver"], r["component"], r["itmin"]) for r in got] != [
            (irec + 1, c, it) for (_v, it), (irec, c) in zip(traces, layout)]:
        fail("card-vs-cpu web: other rows or itmin than the CPU engine's")
    worst = 0.0
    for row, (values, _it) in zip(got, traces):
        g = np.asarray(row["values"], np.float64)
        if g.shape != values.shape:
            fail(f"card-vs-cpu web: row {row['receiver']}{row['component']} has {g.size} samples, "
                 f"the CPU's {values.size}")
        worst = max(worst, float(np.abs(g - values).max() / max(np.abs(values).max(), 1e-30)))
    log(f"phase card-vs-cpu web: generation 1, {len(got)} rows, max diff {worst:.3e} of each "
        f"row's largest value")
    if not worst <= TOL:
        fail(f"card-vs-cpu web: {worst:.3e} > {TOL}")


def run_small_tools():
    """source_info, eulermt, crust, differential_azidist and ahfull (two
    sources, three receivers, MiniSEED) of kiwi_tpu_torch.cli.tools, with
    their stdout checked for their lines."""
    from kiwi_tpu_torch.cli import tools

    work = os.path.join(HERE, "build", "kiwi_tpu_torch", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tables = {"sources": [[0, 0, 1000, 1e12, -1e12, 0, 3e11, 0, 0],
                          [200, -100, 1100, 0, 0, 0, 0, 5e11, -2e11]],
              "receivers": [[2000, 0, 0], [1500, 1500, 0], [-800, 2500, 300]],
              "material": [MATERIAL],
              "stf": np.column_stack([np.arange(KIWIBENCH_STF.size) * 0.1, KIWIBENCH_STF])}
    for name, rows in tables.items():
        np.savetxt(os.path.join(work, name), rows)
    t0 = time.perf_counter()
    runs = (
        (tools.source_info, [], ("source: bilateral", "source: eikonal", "parameter defaults:")),
        (tools.eulermt, ["91", "87", "164"], ("NED (mxx myy mzz mxy mxz myz):",
                                             "USE (mrr mtt mpp mrt mrp mtp):")),
        (tools.crust, ["40", "30"], ("elevation:", "crustal thickness, ave. vp, vs, rho:",
                                     "7-layer crustal profile")),
        (tools.differential_azidist, [], ("worst distance error [m]:",
                                          "worst backazimuth error [rad]:")),
        (tools.ahfull, [*(os.path.join(work, n) for n in tables), "0.1",
                        os.path.join(work, "ahfull"), "mseed"], ("wrote 3 x 3 seismograms",)),
    )
    for fn, argv, lines in runs:
        text = stdout_of(fn, argv)
        if any(line not in text for line in lines):
            fail(f"tools {fn.__name__} {' '.join(argv)}: printed {text[:300]!r}")
    if len([f for f in os.listdir(work) if f.startswith("ahfull-")]) != 9:
        fail("tools ahfull: not 9 seismogram files")
    seconds = time.perf_counter() - t0
    log(f"phase tools: source_info, eulermt 91 87 164, crust 40 30, differential_azidist and "
        f"ahfull (2 sources, 3 receivers) in {seconds:.3f} s, each printed its lines")
    return seconds


def run_eikonal_benchmark(out, device="cuda"):
    """kiwi_tpu_torch.cli.tools eikonal_benchmark 300 on the card (its
    default device): its two lines, and the operands of its timed solve
    (out["eikbench"])."""
    from kiwi_tpu_torch import eikonal
    from kiwi_tpu_torch.cli import tools

    lines = []
    seen = capture(eikonal, "sweep_solve_batch",
                   lambda: lines.extend(stdout_of(tools.eikonal_benchmark, ["300"] + (
                       [] if device == "cuda" else ["--device", device])).splitlines()))
    if len(lines) != 2 or len(seen) != 2 or not lines[1].startswith("device sweep  300x300: "):
        fail(f"eikonal_benchmark: printed {lines}, {len(seen)} solves")
    for line in lines:
        log(f"phase eikonal_benchmark: {line}")
    out["eikbench"] = {"lines": lines, "operands": seen[-1]}
    return float(lines[1].split(":")[1].split()[0])


def check_eikbench_kernel(bench):
    """The eikonal_benchmark's timed solve (1 x 300 x 300, 8 rounds: above
    the shared-memory limit, the kernel's first design) against the plain
    version on the card, bit for bit, with the kernel's device time per
    launch beside its chain floor."""
    import torch

    from kiwi_tpu_torch.ops import eik_sweep as es

    (speed, delta, first, ip), kw = bench["operands"]
    n_rounds = kw["n_rounds"]
    B, nx, ny = speed.shape
    got = es.sweep_solve_batch(speed, delta, first, ip, n_rounds=n_rounds)
    t0 = time.perf_counter()
    want = es.sweep_solve_batch_reference(speed, delta, first, ip, n_rounds=n_rounds)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    reached = want < 1e29
    ndiff = int((got != want).sum())
    log(f"  eik_sweep (eikonal_benchmark operands, B={B} nx={nx} ny={ny} n_rounds={n_rounds}): "
        f"{int(reached.sum())} reached cells of {want.numel()}, cells that differ from the plain "
        f"version: {ndiff} (plain version {plain_s:.2f} s)")
    if ndiff or not torch.equal(got < 1e29, reached):
        fail(f"eik_sweep differs from its plain version on eikonal_benchmark's operands in "
             f"{ndiff} cells (it must equal it)")
    ms, _ = device_ms(lambda: es.sweep_solve_batch(speed, delta, first, ip, n_rounds=n_rounds),
                      5, KERNELS["eik_sweep"])
    steps = (nx + ny - 1) * 4 * n_rounds
    mhz = max_sm_mhz()
    floor_ms = steps * EIK_CHAIN_CYCLES / (mhz * 1e3)
    log(f"  eik_sweep (eikonal_benchmark): kernel {ms:.4f} ms per launch, {steps} steps x "
        f"{ms / steps * 1e3:.4f} us per step; chain floor {floor_ms:.4f} ms ({steps} steps x "
        f"{EIK_CHAIN_CYCLES} cycles at the {mhz:.0f} MHz maximum SM clock)")


def compare_protocol(prot):
    """MINI_SESSION on a CPU server against the card's answers (each
    numeric answer at TOL of its largest value, shifts exactly) and files
    (each at TOL of its largest sample); then the CPU server at LM's end on
    the card, its misfits at OPT_TOL of the largest norm."""
    from kiwi_tpu_torch.cli.minimizer import MinimizerServer
    from kiwi_tpu_torch.io import readseismogram

    cpu = MinimizerServer(device="cpu")
    work = mini_workdir("mini_cpu")
    prefix = mini_lines()[:5]  # set_database ... set_source_location
    want = protocol(cpu, work, "\n".join(prefix) + "\n" + MINI_SESSION)[len(prefix):]
    got = prot["session"]
    if [(c, ok) for c, ok, _a in got] != [(c, ok) for c, ok, _a in want]:
        fail("protocol: the card's and the CPU's ok/nok sequences differ")
    worst = 0.0
    for (cmd, ok, a), (_c, _ok, b) in zip(got, want):
        if not ok or not b:
            continue
        g, w = numbers(a), numbers(b)
        if g.shape != w.shape or (cmd in EXACT and not (g == w).all()):
            fail(f"protocol: {cmd} answers {a} on the card, {b} on the CPU")
        rel = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, rel)
        if not rel <= TOL:
            fail(f"protocol: {cmd}: card vs CPU rel diff {rel:.3e} > {TOL}")
    files = sorted(f for f in os.listdir(work) if f.startswith(("spec-", "xcorr-", "ref-")))
    fworst = 0.0
    for name in files:
        (g, gt, gdt), (w, wt, wdt) = (readseismogram(os.path.join(d, name))
                                      for d in (prot["dir"], work))
        rel = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        fworst = max(fworst, rel)
        if g.shape != w.shape or gdt != wdt or abs(gt - wt) > 1e-6 * wdt or not rel <= TOL:
            fail(f"protocol: file {name} differs between the card and the CPU ({rel:.3e})")
    log(f"phase card-vs-cpu protocol: {len(got)} answers, max rel diff {worst:.3e}; "
        f"{len(files)} files, max rel diff {fworst:.3e}")
    end = MINI_LM.replace(bilateral(MINI_LM_START), bilateral(prot["lm_end"]))
    end = end.replace("minimize_lm\n", "").replace("get_source_subparams\n", "")
    w = numbers(dict((c, a) for c, _ok, a in protocol(cpu, work, end))["get_misfits"])
    g = prot["lm_misfits"]
    compare_misfits("protocol lm end", (g[0::2], g[1::2]), (w[0::2], w[1::2]), optimum=True)
    # the gradient descent from LM's end on both servers: steps and starts
    # exactly, the global misfit (a ratio to the norm) within TOL of 1
    (cmd, ok, a), = protocol(cpu, work, MINI_GRADIENT)
    got, want = prot["gradient"], numbers(a)
    diff = float(np.abs(got[2] - want[2]))
    log(f"phase card-vs-cpu protocol {MINI_GRADIENT.strip()}: card {got}, CPU {want}; "
        f"misfit diff {diff:.3e} (bar {TOL:g})")
    if not ok or got.shape != (3,) or want.shape != (3,) or not (
            (got[:2] == want[:2]).all() and diff <= TOL):
        fail(f"protocol: {cmd} answers {got} on the card, {want} on the CPU")


def compare_misfits(label, got, want, optimum=False):
    """Card vs CPU (misfits, norms[, shifts]) host arrays: the max abs diff
    of each over its own largest |value|, at TOL.  optimum: the misfits'
    diff over the largest norm instead, at OPT_TOL (at the optimum the
    misfits are differences of nearly equal traces, and their f32 rounding
    is set by the traces, whose size the norms give)."""
    diffs = [float(np.abs(a - b).max()) for a, b in zip(got[:2], want[:2])]
    scales = [float(np.abs(b).max()) for b in want[:2]]
    bars = (OPT_TOL, TOL) if optimum else (TOL, TOL)
    rels = [d / max(s, 1e-30) for d, s in zip(diffs, (scales[1], scales[1]) if optimum
                                                else scales)]
    shifts = len(got) < 3 or bool((got[2] == want[2]).all())
    log(f"phase card-vs-cpu {label}: max abs diff misfits {diffs[0]:.3e} (largest |m| "
        f"{scales[0]:.3e}), {rels[0]:.3e} of the largest "
        f"{'norm' if optimum else '|m|'} (bar {bars[0]:g}); norms {rels[1]:.3e} (bar {TOL:g}); "
        f"floating shifts equal: {shifts}")
    if not (rels[0] <= bars[0] and rels[1] <= bars[1] and shifts):
        fail(f"{label}: card and CPU port disagree: {rels} > {bars} or shifts differ")


def profile_calls(label, call, reps=5):
    """torch.profiler over `reps` calls after a warm one: device time per
    call by kernel, launches, host syncs and the union of device intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    device = sum(t for _, t in by_name.values()) / reps / 1e3
    log(f"phase profile {label}: per call {len(dev) / reps:.1f} device ops, device busy "
        f"{busy / reps / 1e3:.4f} ms (union of intervals) of {wall / reps * 1e3:.4f} ms wall "
        f"(profiled; busy share {busy / 1e3 / (wall * 1e3):.4f}), sum of device time "
        f"{device:.4f} ms, {syncs / reps:.1f} cudaStreamSynchronize")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {t / reps / 1e3:9.4f} ms  {n / reps:6.1f}x  {name[:110]}")
    return events, device


def profile_gradient(eng, reps=2):
    """profile_calls over value-and-gradient calls of GRAD_B rows: the
    backward's share of their device time (the kernels launched under the
    autograd engine's evaluate_function ranges), then the same rows'
    forward alone (the plain formulation under torch.no_grad()) beside it."""
    import torch

    from kiwi_tpu_torch.sources import get_source_model

    rows = grad_rows()
    events, device = profile_calls("gradient", lambda: eng.global_misfits_and_grad(rows), reps)
    backward = 0.0
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function"):
            backward += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    backward = backward / reps / 1e3
    model = get_source_model("bilateral")
    plan, shape = eng._grad_plan(model, rows)

    def forward():
        with torch.no_grad():
            eng._xla_misfits(model, plan, shape, torch.as_tensor(rows, device=eng.device))

    _events, fwd = profile_calls("gradient forward only", forward, reps)
    log(f"phase profile gradient: backward {backward:.4f} ms of {device:.4f} ms device time "
        f"per call (share {backward / max(device, 1e-12):.4f}); the call's device time "
        f"{device / max(fwd, 1e-12):.2f}x the forward's ({fwd:.4f} ms)")


def profile_eikonal(eng, radii, results, reps=5):
    """profile_calls over eikonal calls, one eik_prepare launch each; then
    the batch preparation's kernel against its plain version
    (sources/eikonal._prepare_batch_vec, cast as the discretizer casts) on
    the same rows: sizes and the static shape equal, floats within one
    float32 ulp (equal where the host's BLAS rounds as the kernel assumes,
    csrc/eik_prepare.cu), timed as in 3 beside the plain version's host
    time."""
    import torch

    from kiwi_tpu_torch.ops import eik_prepare as ep
    from kiwi_tpu_torch.sources import eikonal as eiksrc

    pb = eik_rows(radii)
    before = ep.launches["eik_prepare"]
    profile_calls("eikonal", lambda: eng.global_misfits_for_source_batch(pb), reps)
    per_call = (ep.launches["eik_prepare"] - before) / (reps + 1)  # and the warm call
    if per_call != 1:
        fail(f"expected one eik_prepare launch per eikonal call, saw {per_call}")
    ctx, edt = eng.eikonal_context(), eng.effective_dt
    named = eiksrc.named_params_batch("eikonal", pb)
    rows = ep.rows_on(named, eng.device)
    summary, got = ep.eik_prepare(rows, ctx, edt)
    plain_summary, want = ep.eik_prepare(ep.rows_on(named, "cpu"), ctx, edt)
    static = ep.static_from_summary(summary.cpu().numpy())
    if static != ep.static_from_summary(plain_summary.numpy()):
        fail(f"eik_prepare: static shape {static}, plain "
             f"{ep.static_from_summary(plain_summary.numpy())}")
    rec = results["eik_prepare"] = {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                    "library_ms": None}  # no PyTorch call prepares the batch
    ndiff, nfar = {}, {}
    for k, w in want.items():
        g = got[k].cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"eik_prepare {k}: {g.dtype} {tuple(g.shape)}, plain {w.dtype} "
                 f"{tuple(w.shape)}")
        ndiff[k] = int((g != w).sum())
        if w.dtype == torch.float32:
            ulp = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
            nfar[k] = int(((g - w).abs() > ulp).sum())
            rec["max_abs_err"] = max(rec["max_abs_err"], float((g - w).abs().max()))
        else:
            nfar[k] = ndiff[k]
    log(f"  eik_prepare: B={pb.shape[0]}, static {static[0]}, ntmax_hard {static[1]}: entries "
        f"that differ from the plain version {ndiff}, of them more than a float32 ulp or in "
        f"an integer {sum(nfar.values())}")
    if any(nfar.values()):
        fail(f"eik_prepare differs from its plain version: {nfar}")
    ms, others = device_ms(lambda: ep.eik_prepare(rows, ctx, edt), 20, KERNELS["eik_prepare"])
    wrapper_ms = cuda_ms(lambda: ep.eik_prepare(rows, ctx, edt), 20)
    t0 = time.perf_counter()
    for _ in range(reps):
        eiksrc.prepare_batch(named, edt, ctx)
    plain_ms = (time.perf_counter() - t0) / reps * 1e3
    # each row read once (25 doubles), each output written once (33 floats,
    # 5 ints); the operations are not counted
    bound_ms, bound_by = bound((25 * 8 + 38 * 4) * pb.shape[0], 0)
    log(f"  eik_prepare: kernel {ms:.4f} ms on the device (20 wrapper calls: {wrapper_ms:.4f} ms "
        f"each by CUDA events; other device ops a call {others}), plain numpy "
        f"{plain_ms:.3f} ms of host time, bound {bound_ms:.6f} ms ({bound_by})")
    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def compare_gradient(grad, store):
    """The gradient phase's first 8 rows and its Jacobian on a CPU engine of
    the port: g at TOL relative, gradient components and Jacobian entries
    at GRAD_TOL of their row's largest one on minimize_multistart's scale."""
    cpu = make_lm_engine(store, "cpu")
    rows = grad["rows"][:8]
    g, d = cpu.global_misfits_and_grad(rows)
    m, J = cpu.misfit_jacobian(grad_start(), mask=grad_mask())
    rel_g = float(np.abs(grad["g"][:8] - g).max()) / max(float(np.abs(g).max()), 1e-30)
    rel_m = float(np.abs(grad["m"] - m).max()) / max(float(np.abs(m).max()), 1e-30)
    worst = []
    for got, want, scale in ((grad["grad"][:8], d, param_scale(rows)),
                             (grad["J"], J, param_scale(grad_start())[:, list(GRAD_FREE)])):
        got, want = got * scale, want * scale
        bar = np.abs(want).max(axis=1, keepdims=True)
        worst.append(float((np.abs(got - want) / np.maximum(bar, 1e-30)).max()))
    log(f"phase card-vs-cpu gradient: 8 rows, max rel diff g {rel_g:.3e}; gradient components "
        f"{worst[0]:.3e} of the row's largest scaled one; Jacobian at the start: misfits "
        f"{rel_m:.3e}, entries {worst[1]:.3e} (bars {TOL:g}, {GRAD_TOL:g})")
    if not (rel_g <= TOL and rel_m <= TOL and max(worst) <= GRAD_TOL):
        fail(f"gradient: card and CPU port disagree: {rel_g:.3e}, {rel_m:.3e}, {worst}")


def compare_long_window(eng, store):
    """The long-window phase's first 8 models on a CPU engine of the port:
    misfits, norms and global misfits at TOL, floating shifts equal."""
    cpu = make_long_engine(store, "cpu")
    pb = long_rows()[:8]
    got = [x.cpu().numpy() for x in eng.misfits_for_source_batch(pb)]
    want = [x.numpy() for x in cpu.misfits_for_source_batch(pb)]
    g_gpu = eng.global_misfits_for_source_batch(pb).cpu().numpy()
    g_cpu = cpu.global_misfits_for_source_batch(pb).numpy()
    rels = [float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
            for a, b in ((g_gpu, g_cpu), (got[0], want[0]), (got[1], want[1]))]
    shifts_equal = bool((got[2] == want[2]).all())
    log(f"phase card-vs-cpu long window: 8 models, max rel diff global {rels[0]:.3e}, misfits "
        f"{rels[1]:.3e}, norms {rels[2]:.3e}; floating shifts equal: {shifts_equal} "
        f"(CPU formulation {cpu._plan['formulation']!r})")
    if not (max(rels) <= TOL and shifts_equal):
        fail(f"long window: card and CPU port disagree: {max(rels):.3e} > {TOL}")


def compare_finite(eng, cpu, strikes, label):
    pb = finite_rows(strikes)
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
    from kiwi_tpu_torch.ops import (bilat_tables as bl, build, eik_prepare as ep, eik_sweep as es,
                                    float_scan as fs, synth_window as sw)

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
    bl._library()
    ep._library()
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

    inv = {}  # the grid and LM phases' results
    lm = make_lm_engine(store, dev)
    lm_start = FINITE_BASE.copy()
    lm_start[list(LM_FREE)] += LM_OFFSET
    lm.set_source_params("bilateral", lm_start)
    lm_first = lm.get_misfits()  # the start, for the card-vs-CPU phase
    grad_eng = make_lm_engine(store, dev)
    long_store, long_build_s = get_long_store()
    log(f"phase store (long window): {long_store.data.shape} at dt {long_store.dt} built in "
        f"{long_build_s:.1f} s")
    long_eng = make_long_engine(long_store, dev)
    mps, counts = {}, {}
    # every bilateral path on the card discretizes through bilat_tables
    paths = (
        ("unfiltered", ("fused_scan", "bilat_tables"),
         lambda: run_sweep(engines["unfiltered"], packed, "unfiltered")),
        ("filtered", ("fused_scan_masked", "bilat_tables"),
         lambda: run_sweep(engines["filtered"], packed, "filtered")),
        ("finite", ("window_synth", "scan_sums", "bilat_tables"),
         lambda: run_finite(finite["finite"], batches, "unfiltered")),
        ("finite_filtered", ("window_synth", "bilat_tables"),
         lambda: run_finite(finite["finite_filtered"], batches[:4], "filtered")),
        ("eikonal", ("eik_prepare", "eik_sweep", "window_synth"),
         lambda: run_eikonal(eik, [radii] * 4)),
        ("grid", ("window_synth", "scan_sums", "bilat_tables"),
         lambda: run_grid(finite["finite"], inv)),
        ("lm", ("window_synth", "bilat_tables"), lambda: run_lm(lm, lm_start, inv)),
        ("gradient", (), lambda: run_gradient(grad_eng, inv)),
        ("long_window", ("scan_sums", "bilat_tables"), lambda: run_long_window(long_eng, inv)),
        ("protocol", ("window_synth", "scan_sums", "bilat_tables"), lambda: run_protocol(inv)),
        ("pipeline", ("window_synth", "bilat_tables"), lambda: run_pipeline(store, inv)),
        # kiwi_main runs in autokiwi's child process: its launches count there
        ("autokiwi", (), lambda: run_autokiwi(inv)),
        # host paths: the builder's workers, the FDSN client, the web forward
        # (plain synthesis, host FMM) and the small tools launch no kernel
        # but the tables kernel of the synthetics' discretization on the card
        ("gfdb", (), lambda: run_gfdb(store)),
        ("acquisition", ("bilat_tables",), lambda: run_acquisition(store)),
        ("web", ("bilat_tables",), lambda: run_web(store, inv)),
        ("tools", (), run_small_tools),
        ("eikonal_benchmark", ("eik_sweep",), lambda: run_eikonal_benchmark(inv)),
    )
    for label, names, run in paths:
        mps[label], counts[label] = run_main_path(label, names, run)
    # the ranks count their own launches (other processes): their sums
    log("phase multidevice (kernel-vs-plain on each rank's captured operands):")
    mps["multidevice"] = run_multidevice(finite["finite"], inv["gradient"], inv, results)
    counts["multidevice"] = {name: 0 for name in REPLACES} | inv["multidevice"]["launches"]
    launches = {name: sum(c[name] for c in counts.values()) for name in REPLACES}
    # the gradient differentiates the plain formulation: no kernel; the
    # acquisition's and the web's synthetics are plain torch after the
    # tables kernel; the long window's plan has no window kernel
    if (any(counts[label][k] for label in ("gradient", "gfdb", "acquisition", "web", "tools")
            for k in counts[label]
            if not (label in ("acquisition", "web") and k == "bilat_tables"))
            or counts["long_window"]["window_synth"]):
        fail("kernels launched where none may be: " + ", ".join(
            f"{label} {counts[label]}" for label in ("gradient", "long_window", "gfdb",
                                                     "acquisition", "web", "tools")))
    forms = {label: eng._plan["formulation"] for label, eng in (
        *engines.items(), *finite.items(), ("eikonal", eik), ("lm", lm), ("gradient", grad_eng),
        ("long_window", long_eng), ("pipeline", inv["pipeline"]["engine"]))}
    log(f"phase formulations: {forms}")
    if any(f != "window" for label, f in forms.items() if label != "long_window"):
        fail(f"a benchmark configuration left the window kernel: {forms}")
    for label in ("grid", "lm"):
        log(f"phase kernel-vs-plain window_synth, scan_sums ({label} call operands):")
        check_captured(label, *inv[f"{label}_ops"], results)
    for part, ops in inv["protocol"]["ops"].items():
        log(f"phase kernel-vs-plain window_synth, scan_sums (protocol {part} call operands):")
        check_captured(f"protocol {part}", *ops, results)
    log("phase kernel-vs-plain bilat_tables (point sweep and grid chunk rows):")
    check_bilat(engines["unfiltered"], packed, inv["grid"], finite["finite"], results)
    log("phase kernel-vs-plain scan_sums (long window call operands):")
    check_captured("long window", [], inv["long_ops"], results)
    log("phase kernel-vs-plain window_synth (pipeline call operands):")
    check_captured("pipeline", *inv["pipeline"]["ops"], results)
    compare_protocol(inv["protocol"])
    compare_gradient(inv["gradient"], store)
    compare_long_window(long_eng, long_store)
    compare_pipeline(inv["pipeline"], store)
    compare_web(inv["web"], store)
    log("phase kernel-vs-plain eik_sweep (eikonal_benchmark call operands):")
    check_eikbench_kernel(inv["eikbench"])

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
        if label == "finite":  # the grid's first and last 32 models, as the grid holds them
            grid = inv["grid"]
            for name, sel in (("first", slice(0, 32)), ("last", slice(-32, None))):
                m, n, _fs = (x.numpy() for x in cpu.misfits_for_source_batch(grid.params[sel]))
                shape = grid.misfits_by_src[sel].shape
                compare_misfits(f"grid ({name} 32 models)",
                                (grid.misfits_by_src[sel], grid.norms_by_src[sel]),
                                (m.reshape(shape), n.reshape(shape)))
    cpu = make_lm_engine(store, "cpu")
    lm.set_source_params("bilateral", inv["lm"])
    for label, p, got in (("lm start", lm_start, lm_first), ("lm end", inv["lm"], lm.get_misfits())):
        cpu.set_source_params("bilateral", p)
        compare_misfits(label, got, cpu.get_misfits(), optimum=label == "lm end")
    cpu = make_eikonal_engine(store, "cpu")
    pb = eik_rows(radii[:8])
    g_cpu = cpu.global_misfits_for_source_batch(pb).numpy()
    g_gpu = eik.global_misfits_for_source_batch(pb).cpu().numpy()
    rel = float(np.abs(g_gpu - g_cpu).max()) / max(float(np.abs(g_cpu).max()), 1e-30)
    log(f"phase card-vs-cpu eikonal: 8 radii, max diff {rel:.3e} of the largest |g|")
    if not (rel <= TOL and cpu.batch_discretizer().on_device
            and eik.batch_discretizer().on_device):
        fail(f"eikonal: card and CPU port disagree ({rel:.3e} > {TOL}) or fell back to the host")
    for label, eng in engines.items():
        profile_calls(f"point {label}", lambda: eng.sweep_global_misfits(BASE, 5, packed))
    pb = finite_rows(batches[0])
    profile_calls("finite", lambda: finite["finite"].global_misfits_for_source_batch(pb))
    profile_eikonal(eik, radii, results)
    grid = inv["grid"]
    profile_calls("grid", lambda: grid.compute(finite["finite"]), reps=2)

    def lm_run():
        lm.set_source_params("bilateral", lm_start)
        lm.minimize_lm()

    profile_calls("lm", lm_run, reps=2)
    prot = inv["protocol"]
    replay = "\n".join(mini_lines()[7:])
    profile_calls("protocol mini.inp", lambda: protocol(prot["server"], prot["dir"], replay),
                  reps=2)
    profile_calls("protocol session", lambda: protocol(prot["server"], prot["dir"], MINI_SESSION),
                  reps=1)
    profile_gradient(grad_eng)
    pipe = inv["pipeline"]
    profile_calls("pipeline SDR grid", lambda: pipe["grid"].compute(pipe["engine"]), reps=2)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("models/s (lm: rows evaluated per second) "
        + ", ".join(f"{k} {v:.0f}" for k, v in mps.items()
                    if k not in ("protocol", "gradient", "pipeline", "autokiwi", "multidevice",
                                 "gfdb", "acquisition", "web", "tools", "eikonal_benchmark"))
        + f"; gradient {mps['gradient']:.2f} steps/s ({GRAD_STARTS} rows a step) ({smi})")
    log(f"mini_inp_seconds {mps['protocol']:.6f} ({smi})")
    log(f"multidevice ({MD_RANKS} processes sharing one card, not scaling): "
        + ", ".join(f"{k} {v:.0f}" for k, v in mps["multidevice"].items())
        + f" models/s (rows/s for the gradient; {MD_REPS} calls, the slowest rank's host "
        f"clock) ({smi})")
    log(f"pipeline: SDR grid {mps['pipeline']:.0f} models/s, window_synth launches "
        f"{counts['pipeline']['window_synth']}; autokiwi cycle {mps['autokiwi']:.2f} s ({smi})")
    web = inv["web"]["seconds"]
    log(f"store build {build_s:.3f} s, gfdb phase parallel build {mps['gfdb']:.3f} s "
        f"({BUILD_WORKERS} workers); FDSN fetch {mps['acquisition']:.4f} s; web calculate "
        f"first {web[0]:.4f} s, then median {mps['web']:.4f} s; eikonal_benchmark 300 device "
        f"sweep {mps['eikonal_benchmark']:.3f} s, eik_sweep launches "
        f"{counts['eikonal_benchmark']['eik_sweep']} ({smi})")
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
