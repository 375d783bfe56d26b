"""`minimizer`-protocol compatible REPL server on the port's engine (port of
kiwi_tpu/cli/minimizer.py).

Speaks the reference's line-oriented stdin/stdout command protocol
(minimizer.f90:1676-1812): one command per line, answers framed as
"<cmd>: ok", "<cmd>: ok >\\n<answer>", "<cmd>: nok" or "<cmd>: nok >\\n<err>".
Programs written against the Fortran binary (tunguska's seismosizer pool,
benchmark/mini.inp scripts) work unchanged against this server.  The engine
computes on the card (MinimizerServer(device="cuda"), the default); without
one every command that computes answers nok.  minimize_gradient is the JAX
package's extension of the protocol (autodiff descent, invert.gradient).

Run: python -m kiwi_tpu_torch.cli.minimizer [--device cuda|cpu] [< commands]
"""

from __future__ import annotations

import argparse
import signal
import sys

import numpy as np

from ..engine import Engine, Receiver
from ..gf.trace import fnint
from ..io import writeseismogram
from ..profiling import to_host

def _fmt(x):
    """List-directed-output style float formatting."""
    return f"{float(x):.8G}"


def _fmt_list(xs):
    return " ".join(_fmt(x) for x in np.atleast_1d(np.asarray(xs)).ravel())


class MinimizerServer:
    def __init__(self, device="cuda"):
        self.engine = Engine(device=device)
        self.verbose = False

    # -- command implementations ----------------------------------------------

    def do_set_database(self, args):
        words = args.split()
        path = words[0]
        nipx = nipz = 1
        if len(words) == 3:
            nipx, nipz = int(words[1]), int(words[2])
        from ..gf.store import GFStore

        if path.endswith(".npz"):
            store = GFStore.load(path)
        else:
            from ..io.gfdb_hdf5 import load_gfdb

            store = load_gfdb(path)
        if nipx != 1 or nipz != 1:
            from ..gf.interpolation import oversample_store

            store = oversample_store(store, nipx, nipz)
        self.engine.set_database(store)
        return ""

    def do_set_local_interpolation(self, args):
        if args == "nearest_neighbor":
            self.engine.set_local_interpolation(False)
        elif args == "bilinear":
            self.engine.set_local_interpolation(True)
        else:
            raise ValueError(f"unknown interpolation method: {args}")
        return ""

    def do_set_spacial_undersampling(self, args):
        x, z = (int(w) for w in args.split())
        self.engine.set_spacial_undersampling(x, z)
        return ""

    def do_set_receivers(self, args):
        words = args.split()
        fn = words[0]
        has_depth = len(words) > 1 and words[1] == "has_depth"
        recs = []
        with open(fn) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                w = line.split()
                depth = 0.0
                comps = ""
                if has_depth and len(w) >= 4:
                    lat, lon, depth, comps = float(w[0]), float(w[1]), float(w[2]), w[3]
                elif has_depth and len(w) == 3:
                    lat, lon, depth = float(w[0]), float(w[1]), float(w[2])
                elif len(w) >= 3:
                    lat, lon, comps = float(w[0]), float(w[1]), w[2]
                elif len(w) == 2:
                    lat, lon = float(w[0]), float(w[1])
                else:
                    raise ValueError(f"bad receiver line: {line!r}")
                recs.append(Receiver(lat, lon, comps, depth=depth, enabled=bool(comps)))
        self.engine.set_receivers(recs)
        return str(len(recs))

    def do_switch_receiver(self, args):
        w = args.split()
        irec = int(w[0]) - 1
        self.engine.switch_receiver(irec, w[1] == "on")
        return ""

    def do_set_ref_seismograms(self, args):
        fnbase, fmt = args.split()
        from ..dataset import load_ref_seismograms

        # one shared implementation of the file->engine itmin conversion
        # (see dataset.load_ref_seismograms: 0-based, no Fortran +1);
        # missing files for enabled receivers raise, as the reference does
        load_ref_seismograms(self.engine, fnbase, fmt)
        return ""

    def do_set_source_location(self, args):
        lat, lon, ref_time = (float(w) for w in args.split())
        self.engine.set_source_location(lat, lon, ref_time)
        return ""

    def do_set_source_constraints(self, args):
        v = [float(w) for w in args.split()]
        if len(v) % 6 != 0 or not v:
            raise ValueError("expected multiple of 6 values")
        a = np.asarray(v).reshape(-1, 6)
        self.engine.set_source_constraints(a[:, :3], a[:, 3:])
        return ""

    def do_set_source_crustal_thickness_limit(self, args):
        self.engine.set_source_crustal_thickness_limit(float(args))
        return ""

    def do_get_source_crustal_thickness(self, args):
        return _fmt(self.engine.get_source_crustal_thickness())

    def do_set_source_params(self, args):
        w = args.split()
        self.engine.set_source_params(w[0], np.array([float(x) for x in w[1:]], np.float32))
        return ""

    def do_set_source_params_mask(self, args):
        mask = [w in ("T", "t", "true", "True", "1") for w in args.split()]
        self.engine.set_source_params_mask(mask)
        return ""

    def do_set_source_subparams(self, args):
        self.engine.set_source_subparams([float(w) for w in args.split()])
        return ""

    def do_set_source_subparams_limits(self, args):
        v = [float(w) for w in args.split()]
        n = len(v) // 2
        self.engine.set_source_subparams_limits(v[:n], v[n:])
        return ""

    def do_get_source_subparams(self, args):
        return _fmt_list(self.engine.get_source_subparams())

    def do_set_effective_dt(self, args):
        self.engine.set_effective_dt(float(args))
        return ""

    def do_set_misfit_method(self, args):
        self.engine.set_misfit_method(args.strip())
        return ""

    def do_set_misfit_filter(self, args):
        v = [float(w) for w in args.split()]
        x, y = v[0::2], v[1::2]
        self.engine.set_misfit_filter(None, x, y)
        return ""

    def do_set_misfit_filter_1(self, args):
        w = args.split()
        irec = int(w[0]) - 1
        v = [float(x) for x in w[1:]]
        self.engine.set_misfit_filter(irec, v[0::2], v[1::2])
        return ""

    def do_set_misfit_taper(self, args):
        w = args.split()
        irec = int(w[0]) - 1
        v = [float(x) for x in w[1:]]
        self.engine.set_misfit_taper(irec, v[0::2], v[1::2])
        return ""

    def do_set_synthetics_factor(self, args):
        self.engine.set_synthetics_factor(float(args))
        return ""

    def do_set_floating_shiftrange(self, args):
        w = args.split()
        irec = int(w[0])  # 0 = all receivers (minimizer.f90 convention)
        tmin, tmax = float(w[1]), float(w[2])
        self.engine.set_floating_shiftrange(
            tmin, tmax, None if irec == 0 else irec - 1
        )
        return ""

    def do_get_floating_shifts(self, args):
        return _fmt_list(self.engine.get_floating_shifts())

    def do_get_global_misfit(self, args):
        return _fmt(self.engine.get_global_misfit())

    def do_get_misfits(self, args):
        m, n, _fs = self.engine.get_misfits()
        layout = self.engine._rc_layout()
        enabled_rows = [
            i for i, (r, _c) in enumerate(layout) if self.engine.receivers[r].enabled
        ]
        pairs = []
        for i in enabled_rows:
            pairs += [m[i], n[i]]
        return _fmt_list(pairs)

    def do_minimize_lm(self, args):
        info, iters, misfit = self.engine.minimize_lm()
        return f"{info} {iters} {_fmt(misfit)}"

    def do_minimize_gradient(self, args):
        """Protocol EXTENSION of the JAX package (not in minimizer.f90):
        multi-start autodiff descent on the masked subparams.  args:
        [steps [lr [nstarts]]]; answers "steps starts misfit"."""
        parts = args.split()
        steps = int(parts[0]) if len(parts) > 0 else 150
        lr = float(parts[1]) if len(parts) > 1 else 0.03
        nstarts = int(parts[2]) if len(parts) > 2 else 1
        misfit, nsteps, ns = self.engine.minimize_gradient(steps=steps, lr=lr, nstarts=nstarts)
        return f"{nsteps} {ns} {_fmt(misfit)}"

    def do_get_principal_axes(self, args):
        pax, tax = self.engine.get_principal_axes()
        return _fmt_list(list(pax) + list(tax))

    def do_get_peak_amplitudes(self, args):
        return _fmt_list(self.engine.get_peak_amplitudes(int(args)))

    def do_get_arias_intensities(self, args):
        return _fmt_list(self.engine.get_arias_intensities())

    def do_output_seismograms(self, args):
        fnbase, fmt, which, processing = args.split()
        which = {"synthetics": "synthetics", "references": "references"}[which]
        traces = self.engine.get_processed_seismograms(which, processing)
        layout = self.engine._rc_layout()
        dt = self.engine.store.dt
        for irc, (irec, c) in enumerate(layout):
            if not self.engine.receivers[irec].enabled:
                continue
            values, itmin = traces[irc]
            fn = f"{fnbase}-{irec + 1}-{c}.{fmt}"
            toffset = self.engine.ref_time + itmin * dt
            writeseismogram(
                fn, fmt, values, toffset, dt,
                network="", station=str(irec + 1), location="",
                channel=c + ("s" if which == "synthetics" else "r"),
            )
        return ""

    def do_output_seismogram_spectra(self, args):
        fnbase, which, processing = args.split()
        spectra = self.engine.get_amp_spectra(which, processing)
        layout = self.engine._rc_layout()
        for irc, (irec, c) in enumerate(layout):
            if not self.engine.receivers[irec].enabled:
                continue
            amps, df = spectra[irc]
            fn = f"{fnbase}-{irec + 1}-{c}.table"
            writeseismogram(fn, "table", amps, 0.0, df)
        return ""

    def do_output_source_model(self, args):
        fnbase = args.strip()
        cbatch = self.engine.discretize(self.engine.source_params[None, :]).tables
        keys = ("active", "north", "east", "depth", "time", "m")
        act, north, east, depth, time, m = (a[0] for a in to_host(*(cbatch[k] for k in keys)))
        with open(f"{fnbase}-dsm.table", "w") as f:
            for i in np.flatnonzero(act):
                row = [float(north[i]), float(east[i]), float(depth[i]), float(time[i])]
                row += [float(x) for x in m[i]]
                f.write(" ".join(_fmt(x) for x in row) + "\n")
        return ""

    def do_output_distances(self, args):
        fn = args.strip()
        dists, azis = self.engine.get_distances()
        with open(fn, "w") as f:
            for d, a in zip(dists, azis):
                f.write(f"{_fmt(d)} {_fmt(a)}\n")
        return ""

    def do_output_cross_correlations(self, args):
        w = args.split()
        fnbase = w[0]
        tmin, tmax = float(w[1]), float(w[2])
        cc, shifts = self.engine.get_cross_correlations((tmin, tmax))
        dt = self.engine.store.dt
        layout = self.engine._rc_layout()
        for irc, (irec, c) in enumerate(layout):
            if not self.engine.receivers[irec].enabled:
                continue
            fn = f"{fnbase}-{irec + 1}-{c}.table"
            writeseismogram(fn, "table", cc[:, irc], shifts[0] * dt, dt)
        return ""

    def do_shift_ref_seismogram(self, args):
        w = args.split()
        irec = int(w[0]) - 1
        shift = float(w[1])
        ishift = int(fnint(np.float32(shift) / np.float32(self.engine.store.dt)))
        self.engine.shift_ref_seismogram(irec, ishift)
        return ""

    def do_autoshift_ref_seismogram(self, args):
        w = args.split()
        irec = int(w[0]) - 1  # -1 means 0 in reference = all
        tmin, tmax = float(w[1]), float(w[2])
        shifts = self.engine.autoshift_ref_seismograms(
            (tmin, tmax), None if irec < 0 else irec
        )
        return _fmt_list(shifts)

    def do_get_cached_traces_memory(self, args):
        return str(int(self.engine.store.data.nbytes)) if self.engine.store else "0"

    def do_set_cached_traces_memory_limit(self, args):
        return ""  # device-resident store: no cache to limit

    def do_set_verbose(self, args):
        self.verbose = args.strip() in ("T", "t", "true", "True", "1")
        return ""

    def do_set_ignore_sigint(self, args):
        if args.strip() in ("T", "t", "true", "True", "1"):
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        else:
            signal.signal(signal.SIGINT, signal.default_int_handler)
        return ""

    # -- protocol loop ---------------------------------------------------------

    def handle(self, line):
        line = line.strip()
        if not line:
            return None
        words = line.split(None, 1)
        command = words[0]
        args = words[1] if len(words) > 1 else ""
        fn = getattr(self, f"do_{command}", None)
        if fn is None:
            return command, False, f"unknown command: {command}"
        try:
            answer = fn(args)
            return command, True, answer
        except Exception as e:  # protocol: report, don't crash
            return command, False, str(e)

    def run(self, infile=sys.stdin, outfile=sys.stdout):
        for line in infile:
            res = self.handle(line)
            if res is None:
                continue
            command, ok, answer = res
            if ok:
                if answer:
                    outfile.write(f"{command}: ok >\n{answer}\n")
                else:
                    outfile.write(f"{command}: ok\n")
            else:
                if answer:
                    outfile.write(f"{command}: nok >\n{answer}\n")
                else:
                    outfile.write(f"{command}: nok\n")
            outfile.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description="minimizer protocol server (stdin -> stdout)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    MinimizerServer(device=ap.parse_args(argv).device).run()


if __name__ == "__main__":
    main()
