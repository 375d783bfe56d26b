"""Small command-line tools: source_info, eulermt, crust, ahfull,
differential_azidist, eikonal_benchmark (the reference's L3 utilities;
port of kiwi_tpu/cli/tools.py, the same argv and output).

Only eikonal_benchmark touches a tensor: its device line runs the
fast-sweeping solve on the card (the eik_sweep kernel) unless
`--device cpu` asks for the CPU (the kernel's plain version)."""

from __future__ import annotations

import sys
import time

import numpy as np


def source_info(argv=None):
    """Print source types and parameter tables (source_info.f90; the output
    is machine-parsed by tunguska/source.py:247-312)."""
    argv = sys.argv[1:] if argv is None else argv
    from ..sources import SOURCE_REGISTRY, get_source_model

    names = argv if argv else sorted(SOURCE_REGISTRY)
    for name in names:
        m = get_source_model(name)
        print(f"source: {name}")
        print(f"number of parameters: {m.nparams}")
        print("parameter names: " + " ".join(m.names))
        print("parameter units: " + " ".join(m.units))
        print("parameter hard min: " + " ".join(f"{v:G}" for v in m.min_hard))
        print("parameter hard max: " + " ".join(f"{v:G}" for v in m.max_hard))
        print("parameter soft min: " + " ".join(f"{v:G}" for v in m.min_soft))
        print("parameter soft max: " + " ".join(f"{v:G}" for v in m.max_soft))
        print("parameter defaults: " + " ".join(f"{v:G}" for v in m.defaults))
        print()


def eulermt(argv=None):
    """strike/dip/rake -> moment tensor in NED and USE (eulermt.f90:16-50)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        sys.exit("usage: eulermt strike dip rake")
    from ..euler import mt_from_sdr, sdr_to_m6_use, sym_to_m6

    s, d, r = (np.radians(float(x)) for x in argv)
    m6 = sym_to_m6(mt_from_sdr(s, d, r))
    m6u = sdr_to_m6_use(s, d, r)
    print("NED (mxx myy mzz mxy mxz myz):", " ".join(f"{v:.6G}" for v in m6))
    print("USE (mrr mtt mpp mrt mrp mtp):", " ".join(f"{v:.6G}" for v in m6u))


def crust(argv=None):
    """Print the crust2x2 profile at lat/lon (crust.f90)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        sys.exit("usage: crust lat lon")
    from ..crust2x2 import default_model

    lat, lon = float(argv[0]), float(argv[1])
    m = default_model()
    vp, vs, rho, th, elev = m.profile(lat, lon)
    vvp, vvs, vrho, vthi = m.profile_averages(vp, vs, rho, th)
    print(f"elevation: {elev:g}")
    print(f"crustal thickness, ave. vp, vs, rho: {vthi:g} {vvp:g} {vvs:g} {vrho:g}")
    print(f"mantle below moho: vp, vs, rho: {vp[7]:g} {vs[7]:g} {rho[7]:g}")
    print("7-layer crustal profile (thickness, vp, vs, rho):")
    names = ["water", "ice", "soft sed.", "hard sed.", "upper crust",
             "middle crust", "lower crust"]
    for i in range(7):
        print(f"  {th[i]:12g} {vp[i]:9g} {vs[i]:9g} {rho[i]:9g}  {names[i]}")


def ahfull(argv=None):
    """Standalone fullspace synthetics (ahfull.f90): tables of sources,
    receivers, material and an STF -> seismogram files.

    usage: ahfull sources receivers material stf dt outfnbase format
    sources: rows 'x y z mxx myy mzz mxy mxz myz';
    receivers: rows 'x y z'.
    """
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 7:
        sys.exit("usage: ahfull sources receivers material stf dt outfnbase format")
    src_fn, rec_fn, mat_fn, stf_fn, dt_s, outbase, fmt = argv
    dt = float(dt_s)
    sources = np.loadtxt(src_fn, ndmin=2)
    receivers = np.loadtxt(rec_fn, ndmin=2)
    material = np.loadtxt(mat_fn, ndmin=2)[0]
    stf = np.loadtxt(stf_fn, ndmin=2)[:, 1]

    from ..gf.elseis import FullspaceGF
    from ..io import writeseismogram

    fs = FullspaceGF(material[0], material[1], material[2], stf, dt)
    for irec, rec in enumerate(receivers):
        total = None
        toffset = None
        for src in sources:
            coord = rec[:3] - src[:3]
            r = float(np.sqrt((coord**2).sum()))
            tstf = fs.stf_duration()
            tbeg = np.floor(r / material[1] / dt) * dt
            tend = np.ceil((r / material[2] + tstf) / dt) * dt + 2 * dt
            npt = int(round((tend - tbeg) / dt)) + 1
            w = np.zeros((3, 3))
            m6 = src[3:9]
            w[0, 0], w[1, 1], w[2, 2] = m6[0], m6[1], m6[2]
            w[0, 1] = w[1, 0] = m6[3]
            w[0, 2] = w[2, 0] = m6[4]
            w[1, 2] = w[2, 1] = m6[5]
            u = fs.seismograms_mt(coord, w, tbeg, npt)
            if total is None:
                total = u
                toffset = tbeg
            else:
                lo = min(toffset, tbeg)
                hi = max(toffset + total.shape[1] * dt, tbeg + npt * dt)
                n = int(round((hi - lo) / dt))
                merged = np.zeros((3, n))
                a = int(round((toffset - lo) / dt))
                merged[:, a : a + total.shape[1]] += total
                b = int(round((tbeg - lo) / dt))
                merged[:, b : b + npt] += u
                total, toffset = merged, lo
        for ic, comp in enumerate("ned"):
            writeseismogram(f"{outbase}-{irec + 1}-{comp}.{fmt}", fmt,
                            total[ic].astype(np.float32), toffset, dt,
                            station=str(irec + 1), channel=comp)
    print(f"wrote {len(receivers)} x 3 seismograms")


def differential_azidist(argv=None):
    """Accuracy scan of the differential azimuth/distance approximation
    (differential_azidist.f90): worst-case errors over a world grid."""
    from .. import geo

    rng = np.random.default_rng(7)
    worst_d = worst_a = 0.0
    for _ in range(2000):
        alat = np.radians(rng.uniform(-80, 80))
        alon = np.radians(rng.uniform(-180, 180))
        blat = np.radians(rng.uniform(-80, 80))
        blon = np.radians(rng.uniform(-180, 180))
        dn, de = rng.uniform(-50e3, 50e3, 2)
        azi, bazi = geo.azibazi(alat, alon, blat, blon)
        dist = geo.distance(alat, alon, blat, blon)
        if float(dist) < 200e3:
            continue
        na, nb, nd = geo.approx_differential_azidist(dn, de, azi, bazi, dist)
        plat, plon = geo.ne_to_latlon(alat, alon, dn, de)
        ed = geo.distance(plat, plon, blat, blon)
        eb = geo.azimuth(blat, blon, plat, plon)
        worst_d = max(worst_d, abs(float(nd - ed)))
        worst_a = max(worst_a, abs(float(nb - eb)))
    print(f"worst distance error [m]: {worst_d:g}")
    print(f"worst backazimuth error [rad]: {worst_a:g}")


def eikonal_benchmark(argv=None):
    """Time the eikonal solvers (eikonal_benchmark.f90): the host FMM, then
    the fast-sweeping solve at 8 rounds on the device.

    usage: eikonal_benchmark [n] [--device cuda|cpu]  (n x n cells, 300)
    """
    import argparse

    import torch

    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="eikonal_benchmark")
    p.add_argument("n", nargs="?", type=int, default=300)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opts = p.parse_args(argv)
    n = opts.n
    if opts.device == "cuda" and not torch.cuda.is_available():
        sys.exit("eikonal_benchmark: no CUDA device (--device cpu runs the sweep on the CPU)")
    from .. import eikonal as eik
    from ..profiling import to_device

    rng = np.random.default_rng(0)
    speed = (2500.0 + 500.0 * rng.random((n, n))).astype(np.float32)
    p0 = (n / 2 * 100.0, n / 2 * 100.0)

    t0 = time.time()
    eik.fmm_solve(speed, (100.0, 100.0), (0.0, 0.0), p0)
    t_fmm = time.time() - t0
    print(f"host FMM      {n}x{n}: {t_fmm:.3f} s")

    dev = torch.device(opts.device)
    s = to_device(speed, dev)

    def solve():
        eik.sweep_solve(s, (100.0, 100.0), (0.0, 0.0), p0, n_rounds=8)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    solve()  # warm: the kernel's nvcc build on its first use
    t0 = time.time()
    solve()
    t_swp = time.time() - t0
    print(f"device sweep  {n}x{n}: {t_swp:.3f} s  ({t_fmm / t_swp:.1f}x)")


def main():
    tool = sys.argv[1] if len(sys.argv) > 1 else ""
    fns = {
        "source_info": source_info,
        "eulermt": eulermt,
        "crust": crust,
        "ahfull": ahfull,
        "differential_azidist": differential_azidist,
        "eikonal_benchmark": eikonal_benchmark,
    }
    if tool not in fns:
        sys.exit(f"usage: python -m kiwi_tpu_torch.cli.tools ({'|'.join(fns)}) args...")
    fns[tool](sys.argv[2:])


def _entry(tool):
    """Console-script entry: `<tool> args...` == `... tools <tool> args...`."""
    def run():
        sys.argv = [sys.argv[0], tool] + sys.argv[1:]
        main()
    run.__name__ = f"main_{tool}"
    return run


main_source_info = _entry("source_info")
main_eulermt = _entry("eulermt")
main_crust = _entry("crust")
main_ahfull = _entry("ahfull")
main_differential_azidist = _entry("differential_azidist")
main_eikonal_benchmark = _entry("eikonal_benchmark")


if __name__ == "__main__":
    main()
