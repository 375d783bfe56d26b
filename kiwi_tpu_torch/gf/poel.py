"""POEL poroelastic GF builder (tunguska/poel.py; port of
kiwi_tpu/gf/poel.py, numpy and subprocess, the input deck unchanged).

Drives Rongjiang Wang's POEL06 F77 code (coupled deformation-diffusion in
layered poroelastic media, injection/pump sources): writes the exact POEL
input deck (poel.py:160-308), runs the binary per depth over a distance
fan, and fills a GF store with one component per output channel
(uz ur ut ezz err ett ezr ert etz tr p vz vr vt -> ig 1..14,
poel.py:546-590).

The `poel` binary is not shipped with the package; point
`qseis.program_bins["poel"]` at an executable.  The deck writer/parsers are
exercised by tests with a synthetic stand-in binary.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from .qseis import program_bins
from .store import GFStore, GFStoreBuilder
from .trace import fnint

POEL_COMPONENTS = "uz ur ut ezz err ett ezr ert etz tr p vz vr vt".split()


def _fvals(vals):
    return " ".join(f"{v:g}" for v in vals)


class PoelSourceFunction:
    """Source time series rows [time, rate] (poel.py:64-71)."""

    def __init__(self):
        self.data = [[0.0, 0.0], [0.0, 1.0]]

    def __str__(self):
        return "\n".join(f"{i} {_fvals(row)}" for i, row in enumerate(self.data))


class PoelLayeredModel:
    """depth, mu, nu, nu_u, B, D rows (poel.py:73-120)."""

    def __init__(self):
        self.data = None

    def set_model_from_string(self, s):
        from io import StringIO

        self.data = np.loadtxt(StringIO(s))
        if self.data.ndim == 1:
            self.data = self.data[np.newaxis, :]

    def set_model(self, depth, mu, nu, nu_u, b, d):
        self.data = np.zeros((len(depth), 6), dtype=float)
        for i, col in enumerate((depth, mu, nu, nu_u, b, d)):
            self.data[:, i] = col

    def get_nlines(self):
        return self.data.shape[0]

    def __str__(self):
        return "\n".join(
            f"{i + 1} {_fvals(row)}" for i, row in enumerate(self.data)
        )


class PoelConfig:
    """POEL input-deck parameters, defaults as poel.py:122-156."""

    def __init__(self):
        self.s_start_depth = 50.0
        self.s_end_depth = 50.0
        self.s_radius = 1.0
        self.source_function = PoelSourceFunction()
        self.receiver_depth = 0.0
        self.sw_equidistant = 1
        self.no_distances = 10
        self.distances = [10.0, 100.0]
        self.t_window = 20.0
        self.no_t_samples = 120
        self.accuracy = 0.025
        self.t_files = [x + ".t" for x in POEL_COMPONENTS]
        self.sw_t_files = [1 for _ in self.t_files]
        self.isurfcon = 1
        self.model = PoelLayeredModel()
        self.model.set_model_from_string(
            "   0.00    0.4E+09   0.2   0.4    0.75  5.00\n"
            " 200.00    0.4E+09   0.2   0.4    0.75  5.00\n"
        )

    def copy(self):
        import copy

        return copy.deepcopy(self)

    def get_output_filenames(self, rundir):
        return [os.path.join(rundir, fn) for fn in self.t_files]

    def __str__(self):
        d = self.__dict__.copy()
        if not self.sw_equidistant:
            d["no_distances"] = len(self.distances)
        d["str_distances"] = _fvals(self.distances)
        d["sw_t_files_1_3"] = " ".join(str(i) for i in self.sw_t_files[0:3])
        d["t_files_1_3"] = " ".join(f"'{s}'" for s in self.t_files[0:3])
        d["sw_t_files_4_10"] = " ".join(str(i) for i in self.sw_t_files[3:10])
        d["t_files_4_10"] = " ".join(f"'{s}'" for s in self.t_files[3:10])
        d["sw_t_files_11_14"] = " ".join(str(i) for i in self.sw_t_files[10:14])
        d["t_files_11_14"] = " ".join(f"'{s}'" for s in self.t_files[10:14])
        d["no_model_lines"] = self.model.get_nlines()

        template = """
# POEL06 input (layout as tunguska/poel.py:178-305)
#
#	SOURCE PARAMETERS
#-------------------------------------------------------------------------------
  %(s_start_depth)g %(s_end_depth)g  %(s_radius)g                 |dble: s_start_depth, s_end_depth, s_radius;
#-------------------------------------------------------------------------------
 2
#-------------------------------------------------------------------------------
  %(source_function)s
#-------------------------------------------------------------------------------
#	RECEIVER PARAMETERS
#-------------------------------------------------------------------------------
 %(receiver_depth)g              |dble: r_depth;
 %(sw_equidistant)i              |int: sw_equidistant;
 %(no_distances)i                |int: no_distances;
 %(str_distances)s               |dble: d_1,d_n; or d_1,d_2, ...;
 %(t_window)s %(no_t_samples)i   |dble: t_window; int: no_t_samples;
#-------------------------------------------------------------------------------
#	WAVENUMBER INTEGRATION PARAMETERS
#-------------------------------------------------------------------------------
 %(accuracy)s                           |dble: accuracy;
#-------------------------------------------------------------------------------
#	OUTPUTS A: DISPLACEMENT
#-------------------------------------------------------------------------------
 %(sw_t_files_1_3)s                                        |int: sw_t_files(1-3);
 %(t_files_1_3)s                                   |char: t_files(1-3);
#-------------------------------------------------------------------------------
#	OUTPUTS B: STRAIN TENSOR & TILT
#-------------------------------------------------------------------------------
 %(sw_t_files_4_10)s      |int: sw_t_files(4-10);
 %(t_files_4_10)s |char: t_files(4-10);
#-------------------------------------------------------------------------------
#	OUTPUTS C: PORE PRESSURE & DARCY VELOCITY
#-------------------------------------------------------------------------------
 %(sw_t_files_11_14)s                              |int: sw_t_files(11-14);
 %(t_files_11_14)s                         |char: t_files(11-14);
#-------------------------------------------------------------------------------
#	GLOBAL MODEL PARAMETERS
#-------------------------------------------------------------------------------
 %(isurfcon)i                   |int: isurfcon
 %(no_model_lines)i             |int: no_model_lines;
#-------------------------------------------------------------------------------
#	MULTILAYERED MODEL PARAMETERS
#-------------------------------------------------------------------------------
%(model)s
#--------------------------end of all inputs------------------------------------
""".lstrip()
        return template % d


class PoelError(Exception):
    pass


class PoelRunner:
    """Run the poel binary on a config in a temp dir and parse the selected
    component tables (poel.py:311-407)."""

    def __init__(self, tmp=None, program=None):
        self.tempdir = tempfile.mkdtemp(prefix="poelrun", dir=tmp)
        self.program = program or program_bins["poel"]
        self.config = None

    def run(self, config):
        self.config = config
        input_fn = os.path.join(self.tempdir, "input")
        with open(input_fn, "w") as f:
            f.write(str(config))
        try:
            proc = subprocess.Popen(
                [self.program], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, cwd=self.tempdir, text=True,
            )
        except OSError as e:
            raise PoelError(f'could not start poel: "{self.program}" ({e})')
        out, err = proc.communicate("input\n")
        problems = []
        if proc.returncode != 0:
            problems.append(f"poel had a non-zero exit state: {proc.returncode}")
        if err:
            problems.append("poel emitted something via stderr")
        if "error" in out.lower():
            problems.append("the string 'error' appeared in poel output")
        if problems:
            raise PoelError("\n".join(problems) + "\n" + out + err)

    def get_traces(self):
        """[(component, x_m, tmin_s, deltat_s, values)]."""
        c = self.config
        if c.sw_equidistant == 1:
            nx = c.no_distances
            xmin, xmax = c.distances
            dx = (xmax - xmin) / (nx - 1) if nx > 1 else 1.0
            distances = [xmin + ix * dx for ix in range(nx)]
        else:
            distances = list(c.distances)
        out = []
        for comp, fn, sw in zip(POEL_COMPONENTS, c.get_output_filenames(self.tempdir),
                                c.sw_t_files):
            if not sw or not os.path.exists(fn):
                continue
            data = np.loadtxt(fn, skiprows=1, dtype=float)
            nsamples, ncols = data.shape
            tmin = data[0, 0]
            deltat = (data[-1, 0] - data[0, 0]) / (nsamples - 1)
            for itrace in range(ncols - 1):
                out.append((comp, distances[itrace], tmin, deltat,
                            data[:, itrace + 1].astype(np.float32)))
        return out

    def __del__(self):
        shutil.rmtree(self.tempdir, ignore_errors=True)


class PoelGFBuilder:
    """Fill a ng=14 GF store with POEL runs, one per depth block
    (poel.py:546-590; component order = ig order)."""

    def __init__(self, gfdb_config, poel_config, block_nx=None, tmp=None,
                 program=None):
        c = gfdb_config
        assert c["ng"] == len(POEL_COMPONENTS)
        self.c = c
        self.poel_config = poel_config
        self.block_nx = block_nx or c["nx"]
        self.tmp = tmp
        self.program = program
        self.builder = GFStoreBuilder(
            c["nx"], c["nz"], c["ng"], c["dt"], c["dx"], c["dz"],
            c.get("firstx", 0.0), c.get("firstz", 0.0))

    def work_block(self, firstx, lastx, nx, z):
        runner = PoelRunner(tmp=self.tmp, program=self.program)
        conf = self.poel_config.copy()
        conf.s_start_depth = z
        conf.s_end_depth = z
        conf.sw_equidistant = 1
        conf.distances = [firstx, lastx]
        conf.no_distances = nx
        conf.no_t_samples = int(round(conf.t_window / self.c["dt"])) + 1
        conf.t_window = (conf.no_t_samples - 1) * self.c["dt"]
        runner.run(conf)
        comp2ig = {comp: ig + 1 for ig, comp in enumerate(POEL_COMPONENTS)}
        traces = []
        for comp, x, tmin, deltat, values in runner.get_traces():
            ix = int(round((x - self.c.get("firstx", 0.0)) / self.c["dx"]))
            if 0 <= ix < self.c["nx"]:
                traces.append((ix, comp2ig[comp], tmin, values))
        return traces

    def build(self) -> GFStore:
        c = self.c
        for iz in range(c["nz"]):
            z = c.get("firstz", 0.0) + iz * c["dz"]
            for ix0 in range(0, c["nx"], self.block_nx):
                bnx = min(c["nx"] - ix0, self.block_nx)
                firstx = c.get("firstx", 0.0) + ix0 * c["dx"]
                lastx = c.get("firstx", 0.0) + (ix0 + bnx - 1) * c["dx"]
                for ix, ig, tmin, values in self.work_block(firstx, lastx, bnx, z):
                    itmin = int(fnint(np.float32(tmin) / np.float32(c["dt"])))
                    self.builder.put_trace(ix, iz, ig - 1, values, itmin)
        return self.builder.build()
