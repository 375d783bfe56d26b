"""Plots and reports (matplotlib; replaces the reference's GMT/gmtpy stack).

Covers the workhorse figures of tunguska/plotting.py: reference-vs-synthetic
waveform comparisons, 1D/2D misfit cross sections from grid searches,
station maps, rupture-front snapshots, and a plain-HTML run report
(replacing the Cheetah templates of examples/report_templates).

Port of kiwi_tpu/plotting.py.  matplotlib is imported by the figure
functions only (`_mpl`), so this module imports on a host without it;
`matplotlib_missing()` says whether the figures can be drawn.  Device
tensors come to the host (engine.to_host) before numpy touches them."""

from __future__ import annotations

import os

import numpy as np


def matplotlib_missing():
    """None if matplotlib imports, else the reason it does not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        return f"matplotlib is not installed ({e})"
    return None


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_seismogram_comparison(engine, path, processing="plain"):
    """Reference vs synthetic traces per (receiver, component)."""
    plt = _mpl()
    syn = engine.get_processed_seismograms("synthetics", processing)
    layout = engine._rc_layout()
    dt = engine.store.dt
    nrec = len(engine.receivers)
    ncomp = max(len(r.components) for r in engine.receivers)
    fig, axes = plt.subplots(
        nrec, ncomp, figsize=(4 * ncomp, 1.8 * nrec), squeeze=False, sharex=True
    )
    used = np.zeros((nrec, ncomp), dtype=bool)
    counters = {}
    for irc, (irec, c) in enumerate(layout):
        k = counters.get(irec, 0)
        counters[irec] = k + 1
        ax = axes[irec][k]
        used[irec, k] = True
        sv, si = syn[irc]
        t = (si + np.arange(len(sv))) * dt
        ax.plot(t, sv, color="#c1272d", lw=0.8, label="synthetic")
        if irc in engine._refs:
            rv, ri = engine._refs[irc]
            tr = (ri + np.arange(len(rv))) * dt
            ax.plot(tr, rv, color="#222222", lw=0.8, label="reference")
        ax.set_ylabel(f"r{irec + 1} {c}", fontsize=8)
        ax.tick_params(labelsize=7)
    for irec in range(nrec):
        for k in range(ncomp):
            if not used[irec, k]:
                axes[irec][k].set_visible(False)
    axes[0][0].legend(fontsize=7, loc="upper right")
    axes[-1][0].set_xlabel("time [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_misfit_cross_section(grid, path, outer_norm="l2norm"):
    """1D misfit curve or 2D misfit map over the searched parameters
    (gridsearch.py's plot machinery)."""
    plt = _mpl()
    from .invert.gridsearch import make_global_misfits

    g, _ = make_global_misfits(grid.misfits_by_src, grid.norms_by_src,
                               outer_norm=outer_norm)
    names = [n for n, _v in grid.param_ranges]
    values = [np.asarray(v) for _n, v in grid.param_ranges]
    fig, ax = plt.subplots(figsize=(5, 3.4))
    if len(names) == 1:
        ax.plot(values[0], g, "o-", color="#1b5eab", ms=3)
        ax.set_xlabel(names[0])
        ax.set_ylabel("global misfit")
        i = int(np.nanargmin(g))
        ax.axvline(values[0][i], color="#c1272d", lw=0.8)
    elif len(names) == 2:
        gg = g.reshape(len(values[0]), len(values[1]))
        im = ax.pcolormesh(values[1], values[0], gg, shading="nearest", cmap="viridis")
        fig.colorbar(im, ax=ax, label="global misfit")
        ax.set_xlabel(names[1])
        ax.set_ylabel(names[0])
    else:
        # marginal minima per parameter
        ax.remove()
        fig, axes = plt.subplots(1, len(names), figsize=(3.2 * len(names), 3))
        shape = tuple(len(v) for v in values)
        gg = g.reshape(shape)
        for i, (nm, vv) in enumerate(zip(names, values)):
            other = tuple(j for j in range(len(names)) if j != i)
            prof = np.nanmin(gg, axis=other)
            axes[i].plot(vv, prof, "o-", ms=3)
            axes[i].set_xlabel(nm)
        axes[0].set_ylabel("min global misfit")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_station_map(engine, path):
    """Receivers + source epicenter in lat/lon."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 5))
    lats = [r.lat_deg for r in engine.receivers]
    lons = [r.lon_deg for r in engine.receivers]
    on = [r.enabled for r in engine.receivers]
    ax.scatter(
        [lo for lo, e in zip(lons, on) if e], [la for la, e in zip(lats, on) if e],
        marker="^", color="#1b5eab", label="receivers",
    )
    if not all(on):
        ax.scatter(
            [lo for lo, e in zip(lons, on) if not e],
            [la for la, e in zip(lats, on) if not e],
            marker="^", color="#bbbbbb", label="disabled",
        )
    ax.scatter([engine.src_lon_deg], [engine.src_lat_deg], marker="*", s=180,
               color="#c1272d", label="source")
    for i, (lo, la) in enumerate(zip(lons, lats)):
        ax.annotate(str(i + 1), (lo, la), fontsize=7, xytext=(3, 3),
                    textcoords="offset points")
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    ax.legend(fontsize=8)
    ax.set_aspect(1.0 / max(np.cos(np.radians(np.mean(lats))), 0.1))
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_rupture_front(engine, path):
    """Centroid positions colored by rupture onset time (the reference's
    rupture plots from psm info files)."""
    plt = _mpl()
    from .engine import to_host

    cbatch, _m, _r, _s, _g = engine._discretize_batch(engine.source_params[None, :])
    act, n, e, d, t = to_host(*(cbatch[k][0] for k in ("active", "north", "east", "depth",
                                                       "time")))
    act = act.astype(bool)
    n, e, d, t = n[act], e[act], d[act], t[act]
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    s0 = axes[0].scatter(e, n, c=t, cmap="magma", s=14)
    axes[0].set_xlabel("east [m]")
    axes[0].set_ylabel("north [m]")
    fig.colorbar(s0, ax=axes[0], label="onset time [s]")
    s1 = axes[1].scatter(e, -d, c=t, cmap="magma", s=14)
    axes[1].set_xlabel("east [m]")
    axes[1].set_ylabel("-depth [m]")
    fig.colorbar(s1, ax=axes[1], label="onset time [s]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def html_report(path, title, sections):
    """Minimal HTML run report: sections = [(heading, text, [image paths])]."""
    rows = [f"<html><head><title>{title}</title>",
            "<style>body{font-family:sans-serif;max-width:70em;margin:2em}"
            "pre{background:#f4f4f4;padding:0.8em}img{max-width:100%}</style>",
            f"</head><body><h1>{title}</h1>"]
    for heading, text, images in sections:
        rows.append(f"<h2>{heading}</h2>")
        if text:
            rows.append(f"<pre>{text}</pre>")
        for img in images:
            rel = os.path.relpath(img, os.path.dirname(path) or ".")
            rows.append(f'<img src="{rel}"/>')
    rows.append("</body></html>")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    return path


def source_m6(engine):
    """Full moment tensor (mxx, myy, mzz, mxy, mxz, myz; NED) of the current
    source: explicit m6 params where the model has them, otherwise the
    rotated double couple from strike/dip/slip-rake (source_bilat.f90:437)."""
    from .euler import mt_from_sdr, sym_to_m6
    from .sources import get_source_model
    from .sources.base import DEG2RAD_F32

    model = get_source_model(engine.source_type)
    names = list(model.names)
    p = np.asarray(engine.source_params, dtype=np.float64)
    if "mxx" in names:
        m6 = np.array([p[names.index(k)]
                       for k in ("mxx", "myy", "mzz", "mxy", "mxz", "myz")])
        if "moment-factor" in names:
            m6 = m6 * p[names.index("moment-factor")]
        return m6
    strike = p[names.index("strike")] * float(DEG2RAD_F32)
    dip = p[names.index("dip")] * float(DEG2RAD_F32)
    rake = p[names.index("slip-rake")] * float(DEG2RAD_F32)
    moment = p[names.index("moment")] if "moment" in names else 1.0
    return sym_to_m6(mt_from_sdr(strike, dip, rake)) * moment


def plot_beachball(m6, path=None, ax=None, n=241, title=None):
    """Lower-hemisphere equal-area focal-mechanism plot ('beachball').

    Replaces the reference's GMT psmeca calls (tunguska/plotting.py beachball
    figures).  Works for arbitrary (non-double-couple) tensors: the P-wave
    first-motion sign field sign(gamma^T M gamma) is evaluated on a Lambert
    equal-area grid of the lower focal hemisphere; compressional quadrants
    fill dark.
    """
    plt = _mpl()
    from .euler import m6_to_sym

    m = m6_to_sym(np.asarray(m6, dtype=np.float64))
    # Lambert equal-area disk grid: radius rho = sqrt(2) sin(i/2),
    # x = east, y = north; i = inclination from down
    lin = np.linspace(-1.0, 1.0, n)
    x, y = np.meshgrid(lin, lin)
    rho = np.hypot(x, y)
    inside = rho <= 1.0
    # rho in [0, 1] maps to inclination via rho = sin(i/2)/sin(45 deg)
    i_inc = 2.0 * np.arcsin(np.clip(rho * np.sin(np.pi / 4.0), 0.0, 1.0))
    az = np.arctan2(x, y)  # azimuth from north, clockwise (x = east)
    gn = np.sin(i_inc) * np.cos(az)
    ge = np.sin(i_inc) * np.sin(az)
    gd = np.cos(i_inc)
    g = np.stack([gn, ge, gd], axis=-1)
    u = np.einsum("...i,ij,...j->...", g, m, g)
    field = np.where(inside, u, np.nan)

    own = ax is None
    if own:
        fig, ax = plt.subplots(figsize=(3.2, 3.2))
    ax.contourf(x, y, field, levels=[-np.inf, 0.0, np.inf],
                colors=["#ffffff", "#444444"])
    ax.contour(x, y, field, levels=[0.0], colors="#000000", linewidths=0.7)
    th = np.linspace(0, 2 * np.pi, 256)
    ax.plot(np.cos(th), np.sin(th), color="#000000", lw=1.2)
    ax.set_aspect("equal")
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    ax.axis("off")
    if title:
        ax.set_title(title, fontsize=9)
    if own:
        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=130, transparent=False)
        plt.close(fig)
    return path


def plot_misfogram(engine, path, tmin=-10.0, tmax=10.0, nt=41):
    """Global + per-receiver misfit as a function of source-time shift (the
    reference's misfogram, tunguska/plotting.py misfogram_plot machinery):
    one batched forward over the time sweep."""
    plt = _mpl()
    shifts = np.linspace(float(tmin), float(tmax), int(nt)).astype(np.float32)
    base = np.asarray(engine.source_params, dtype=np.float32)
    batch = np.tile(base, (len(shifts), 1))
    from .sources import get_source_model

    it = get_source_model(engine.source_type).names.index("time")
    batch[:, it] = base[it] + shifts
    from .engine import to_host

    m, nrm, _fs = engine.misfits_for_source_batch(batch)
    m, nrm = (x.astype(np.float64) for x in to_host(m, nrm))
    g = np.sqrt((m**2).sum(axis=1)) / np.sqrt((nrm**2).sum(axis=1))

    layout = engine._rc_layout()
    nrec = len(engine.receivers)
    per_rec = np.zeros((len(shifts), nrec))
    per_nrm = np.zeros((len(shifts), nrec))
    for irc, (irec, _c) in enumerate(layout):
        per_rec[:, irec] += m[:, irc] ** 2
        per_nrm[:, irec] += nrm[:, irc] ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        per = np.sqrt(per_rec) / np.sqrt(per_nrm)

    fig, ax = plt.subplots(figsize=(6, 3.6))
    for irec in range(nrec):
        ax.plot(shifts, per[:, irec], lw=0.7, color="#9db6d4",
                label="receivers" if irec == 0 else None)
    ax.plot(shifts, g, lw=1.8, color="#c1272d", label="global")
    i = int(np.nanargmin(g))
    ax.axvline(shifts[i], color="#333333", lw=0.8, ls="--",
               label=f"best {shifts[i]:+.2f} s")
    ax.set_xlabel("source time shift [s]")
    ax.set_ylabel("misfit")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_spectra_comparison(engine, path, processing="plain"):
    """Reference-vs-synthetic amplitude spectra per (receiver, component)
    (the reference's output_spectra + spectra report panels)."""
    plt = _mpl()
    syn = engine.get_amp_spectra("synthetics", processing)
    ref = engine.get_amp_spectra("references", processing)
    layout = engine._rc_layout()
    nrec = len(engine.receivers)
    ncomp = max(len(r.components) for r in engine.receivers)
    fig, axes = plt.subplots(
        nrec, ncomp, figsize=(4 * ncomp, 1.8 * nrec), squeeze=False,
        sharex=True,
    )
    used = np.zeros((nrec, ncomp), dtype=bool)
    counters = {}
    for irc, (irec, c) in enumerate(layout):
        k = counters.get(irec, 0)
        counters[irec] = k + 1
        ax = axes[irec][k]
        used[irec, k] = True
        sv, df = syn[irc]
        f = np.arange(len(sv)) * df
        ax.plot(f, sv, color="#c1272d", lw=0.8, label="synthetic")
        rv, dfr = ref[irc]
        ax.plot(np.arange(len(rv)) * dfr, rv, color="#222222", lw=0.8,
                label="reference")
        ax.set_ylabel(f"r{irec + 1} {c}", fontsize=8)
        ax.set_yscale("log")
        ax.tick_params(labelsize=7)
    for irec in range(nrec):
        for k in range(ncomp):
            if not used[irec, k]:
                axes[irec][k].set_visible(False)
    axes[0][0].legend(fontsize=7, loc="upper right")
    axes[-1][0].set_xlabel("frequency [Hz]")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
