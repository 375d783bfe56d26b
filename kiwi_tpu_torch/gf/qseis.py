"""QSEIS layered-earth GF builder (tunguska/qseis.py; port of
kiwi_tpu/gf/qseis.py, numpy and subprocess, the input deck unchanged).

Drives Rongjiang Wang's QSEIS F77 code to fill a GF store: writes the exact
QSEIS input file format (qseis.py:296-378), auto-configures the modeling
time/slowness windows from the target store geometry and the velocity model
(autoconf_modelling, qseis.py:202-287), runs the binary once per
(source depth, moment-tensor basis source) over the whole distance fan, and
maps the (z, r, t) outputs onto the ng=8/10 elementary GF components with
the reference's basis/sign table (QSeisGFDBBuilder.gfmapping,
qseis.py:572-581).

The `qseis` binary is not shipped with the package; point `program_bins`
["qseis"] at an executable (anything that consumes the input file and
writes `<seismogram_filename>.t{z,r,t}` tables works -- the tests exercise
the full pipeline with a synthetic stand-in).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from .store import GFStore, GFStoreBuilder
from .trace import fnint

KM = 1000.0

program_bins = {"qseis": "qseis", "poel": "poel"}


def str_float_vals(vals):
    return " ".join(f"{v:e}" for v in vals)


def str_int_vals(vals):
    return " ".join(f"{int(v)}" for v in vals)


def str_str_vals(vals):
    return " ".join(f"'{v}'" for v in vals)


def str_complex_vals(vals):
    return " ".join(f"({v.real:e},{v.imag:e})" for v in vals)


class QSeisLayeredModel:
    """Layered earth model table: depth, vp, vs, density, qp, qs
    (qseis.py:66-120; 'ugly' units = km and g/cm^3)."""

    def __init__(self):
        self.data = None

    def set_model_from_string(self, s, units="standard"):
        from io import StringIO

        self.data = np.loadtxt(StringIO(s))
        if self.data.ndim == 1:
            self.data = self.data[np.newaxis, :]
        if units == "ugly":
            self.data[:, 0] *= 1000.0
            self.data[:, 1] *= 1000.0
            self.data[:, 2] *= 1000.0
            self.data[:, 3] *= 1000.0

    def set_model(self, depth, vp, vs, density, qp, qs):
        self.data = np.zeros((len(depth), 6), dtype=float)
        self.data[:, 0] = depth
        self.data[:, 1] = vp
        self.data[:, 2] = vs
        self.data[:, 3] = density
        self.data[:, 4] = qp
        self.data[:, 5] = qs

    def get_vp(self):
        return self.data[:, 1]

    def get_vs(self):
        return self.data[:, 2]

    def __str__(self):
        if self.data is None:
            return "0"
        srows = []
        for i, row in enumerate(self.data):
            ugly = (row[0] / 1000.0, row[1] / 1000.0, row[2] / 1000.0,
                    row[3] / 1000.0, row[4], row[5])
            srows.append(f"{i + 1} " + str_float_vals(ugly))
        return (f"{self.data.shape[0]}\n") + "\n".join(srows)


class QSeisConfig:
    """QSEIS input-deck parameters, defaults as qseis.py:122-200."""

    def __init__(self):
        self.source_depth_km = 10.0
        self.receiver_depth_km = 0.0
        self.sw_equidistant = 1
        self.sw_d_unit = 1
        self.no_distances = 100
        self.distances_km = [100.0, 600.0]
        self.t_start = -20.0
        self.t_window = 1024.0 / 2
        self.no_t_samples = 1024
        self.sw_t_reduce = 1
        self.t_reduce = 12.0
        self.sw_algorithm = 0
        self.slw = (0.01, 0.02, 0.5, 0.6)
        self.sample_rate = 2.5
        self.supp_factor = 0.01
        self.isurf = 0
        self.sw_path_filter = 0
        self.shallow_depth_limit = 560.0
        self.no_of_depth_ranges = 0
        self.wavelet_duration = 4.0
        self.sw_wavelet = 2
        self.norm_factor = 1.0
        self.filter_no_roots = 0
        self.roots = []
        self.filter_no_poles = 0
        self.poles = []
        self.gf_sw_source_types = (1, 1, 1, 1, 0, 0)
        self.gf_filenames = ("ex", "ss", "ds", "cl", "fz", "fh")
        self.source_type = 1
        self.source_vals = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]
        self.seismogram_filename = "seis"
        self.sw_irregular_station_azimuths = 0
        self.station_azimuths = [0.0]
        self.sw_flat_earth_transform = 0
        self.gradient_resolutions = (0.25, 0.25, 5.0)
        self.layered_model = QSeisLayeredModel()
        self.receiver_model = QSeisLayeredModel()

    def autoconf_modelling(self, gfdb_config, length_factor=1.0,
                           tlead_in=0.0, tlead_out=0.0,
                           slowness_window_factors=(0.005, 0.01, 2.0, 4.0),
                           allow_time_reduction=True):
        """Set time/slowness windows from the store geometry + model
        velocities (qseis.py:202-287)."""
        xmax = gfdb_config["firstx"] + (gfdb_config["nx"] - 1) * gfdb_config["dx"]
        xmin = gfdb_config["firstx"]
        vmin = self.layered_model.get_vs().min()
        vmax = self.layered_model.get_vp().max()
        vred = vmax if allow_time_reduction else None

        if vred is not None:
            tmin_red = xmin / vmax - xmin / vred - tlead_in
            tmax_red = xmax / vmin * length_factor - xmax / vred + tlead_out
        else:
            tmin_red = xmin / vmax - tlead_in
            tmax_red = xmax / vmin * length_factor + tlead_out

        nsamples_phys = (tmax_red - tmin_red) / gfdb_config["dt"]
        nsamples = 2 ** (int(np.log(nsamples_phys) / np.log(2)) + 1)
        sw = (1.0 / vmax * slowness_window_factors[0],
              1.0 / vmax * slowness_window_factors[1],
              1.0 / vmin * slowness_window_factors[2],
              1.0 / vmin * slowness_window_factors[3])

        self.t_start = tmin_red
        self.t_window = (nsamples - 1) * gfdb_config["dt"]
        self.no_t_samples = nsamples
        self.sw_t_reduce = 1
        self.t_reduce = vred / KM if vred is not None else 0
        self.sw_algorithm = 0
        self.slw = tuple(s * KM for s in sw)

    def copy(self):
        import copy

        return copy.deepcopy(self)

    def get_seismogram_filenames_zrt(self, rundir):
        fn = self.seismogram_filename
        return (os.path.join(rundir, fn + ".tz"),
                os.path.join(rundir, fn + ".tr"),
                os.path.join(rundir, fn + ".tt"))

    def __str__(self):
        d = self.__dict__.copy()
        if not self.sw_equidistant:
            d["no_distances"] = len(self.distances_km)
        d["str_distances"] = str_float_vals(self.distances_km)
        d["str_slw"] = str_float_vals(self.slw)
        d["str_roots"] = ("\n" + str_complex_vals(self.roots)) if self.roots else "\n#"
        d["str_poles"] = ("\n" + str_complex_vals(self.poles)) if self.poles else "\n#"
        d["str_gf_sw_source_types"] = str_int_vals(self.gf_sw_source_types)
        d["str_gf_filenames"] = str_str_vals(self.gf_filenames)
        d["str_source_vals"] = str_float_vals(self.source_vals)
        d["str_station_azimuths"] = str_float_vals(self.station_azimuths)
        d["str_gradient_resolutions"] = str_float_vals(self.gradient_resolutions)

        template = """
# source_depth_km
%(source_depth_km)g
#
# receiver_depth_km
%(receiver_depth_km)g
# sw_equidistant sw_d_unit
%(sw_equidistant)i %(sw_d_unit)i
# no_distances
%(no_distances)i
%(str_distances)s
# t_start t_window no_t_samples
%(t_start)g %(t_window)g %(no_t_samples)i
# sw_t_reduce t_reduce
%(sw_t_reduce)i %(t_reduce)g
#
# sw_algorithm
%(sw_algorithm)i
# slowness_window
%(str_slw)s
# sl_sample_rate
%(sample_rate)g
# supp_factor
%(supp_factor)g
#
# isurf
%(isurf)i
# sw_path_filter shallow_depth_limit
%(sw_path_filter)i %(shallow_depth_limit)g
# no_of_depth_ranges
%(no_of_depth_ranges)i
#
# wavelet_duration sw_wavelet
%(wavelet_duration)g %(sw_wavelet)i
#
# norm_factor
%(norm_factor)g
# roots
%(filter_no_roots)i%(str_roots)s
# poles
%(filter_no_poles)i%(str_poles)s
#
# gf_sw_source_types
%(str_gf_sw_source_types)s
%(str_gf_filenames)s
#
# source_type source_vals seismogram_filename
%(source_type)i %(str_source_vals)s '%(seismogram_filename)s'
# sw_irregular_station_azimuths
%(sw_irregular_station_azimuths)i
%(str_station_azimuths)s
#
# sw_flat_earth_transform
%(sw_flat_earth_transform)i
# gradient_resolutions
%(str_gradient_resolutions)s
#
%(layered_model)s
%(receiver_model)s
""".lstrip()
        return template % d


class QSeisError(Exception):
    pass


class QSeisRunner:
    """Run the qseis binary on a config in a temp dir and parse its
    z/r/t seismogram tables (qseis.py:383-485)."""

    def __init__(self, tmp=None, program=None):
        self.tempdir = tempfile.mkdtemp(prefix="qseisrun", dir=tmp)
        self.program = program or program_bins["qseis"]
        self.config = None

    def run(self, config):
        self.config = config
        input_fn = os.path.join(self.tempdir, "input")
        qseis_input = str(config) % {"tempdir": self.tempdir}
        with open(input_fn, "w") as f:
            f.write(qseis_input)
        try:
            proc = subprocess.Popen(
                [self.program], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, cwd=self.tempdir, text=True,
            )
        except OSError as e:
            raise QSeisError(f'could not start qseis: "{self.program}" ({e})')
        out, err = proc.communicate("input\n")
        problems = []
        if proc.returncode != 0:
            problems.append(f"qseis had a non-zero exit state: {proc.returncode}")
        if err:
            problems.append("qseis emitted something via stderr")
        if "error" in out.lower():
            problems.append("the string 'error' appeared in qseis output")
        if problems:
            raise QSeisError(
                "===== qseis input =====\n%s===== qseis output =====\n%s"
                "===== qseis error =====\n%s\n%s" % (qseis_input, out, err,
                                                     "\n".join(problems)))

    def get_traces(self):
        """[(component, x_m, tmin_s, deltat_s, values)] with time reduction
        unapplied (qseis.py:442-483)."""
        c = self.config
        assert c.sw_d_unit == 1, "can only handle distances given in km"
        assert c.sw_t_reduce == 1, "can only handle t_reduce given in km/s"
        if c.sw_equidistant == 1:
            nx = c.no_distances
            xmin, xmax = (d * KM for d in c.distances_km)
            dx = (xmax - xmin) / (nx - 1) if nx > 1 else 1.0
            distances = [xmin + ix * dx for ix in range(nx)]
        else:
            distances = [x * KM for x in c.distances_km]
        vred = c.t_reduce * KM
        if vred == 0.0:
            vred = None

        out = []
        for comp, fn in zip(("z", "r", "t"), c.get_seismogram_filenames_zrt(self.tempdir)):
            fn = fn % {"tempdir": self.tempdir}
            if not os.path.exists(fn):
                continue
            data = np.loadtxt(fn, skiprows=1, dtype=float)
            nsamples, ncols = data.shape
            ntraces = ncols - 1
            tmin = data[0, 0]
            deltat = (data[-1, 0] - data[0, 0]) / (nsamples - 1)
            for itrace in range(ntraces):
                x = distances[itrace]
                t0 = tmin + (x / vred if vred is not None else 0.0)
                out.append((comp, x, t0, deltat, data[:, itrace + 1].astype(np.float32)))
        return out

    def __del__(self):
        shutil.rmtree(self.tempdir, ignore_errors=True)


# the MT basis runs and their (component -> (ig 1-based, sign)) mapping
# (QSeisGFDBBuilder.gfmapping, qseis.py:572-581); m6 as
# (mxx, myy, mzz, mxy, myz, mzx) like the QSEIS source line
GF_MAPPING = [
    ((1.0, 1.0, 0.0, 0.0, 0.0, 0.0), {"r": (1, +1), "t": (4, +1), "z": (6, +1)}),
    ((0.0, 0.0, 0.0, 0.0, 1.0, 1.0), {"r": (2, +1), "t": (5, +1), "z": (7, +1)}),
    ((0.0, 0.0, 1.0, 0.0, 0.0, 0.0), {"r": (3, +1), "z": (8, +1)}),
]
GF_MAPPING_10 = GF_MAPPING + [
    ((0.0, 1.0, 0.0, 0.0, 0.0, 0.0), {"r": (9, +1), "z": (10, +1)}),
]


class QSeisGFBuilder:
    """Fill a GF store with QSEIS runs: one run per (depth, basis source)
    covering the whole distance fan of a block (qseis.py:583-713)."""

    def __init__(self, gfdb_config, qseis_config, block_nx=None, cutting=None,
                 tmp=None, program=None):
        c = gfdb_config
        self.c = c
        self.qseis_config = qseis_config
        self.block_nx = block_nx or c["nx"]
        self.cutting = cutting
        self.tmp = tmp
        self.program = program
        self.builder = GFStoreBuilder(
            c["nx"], c["nz"], c["ng"], c["dt"], c["dx"], c["dz"],
            c.get("firstx", 0.0), c.get("firstz", 0.0))
        self.mapping = GF_MAPPING_10 if c["ng"] == 10 else GF_MAPPING

    def work_block(self, firstx, lastx, nx, z):
        traces = []
        runner = QSeisRunner(tmp=self.tmp, program=self.program)
        have_gfs = False
        for m6, gfmap in self.mapping:
            conf = self.qseis_config.copy()
            conf.gf_sw_source_types = (1, 1, 1, 1, 0, 0) if not have_gfs else (0,) * 6
            conf.source_type = 1
            conf.source_vals = list(m6)
            conf.source_depth_km = z / KM
            conf.sw_equidistant = 0
            conf.sw_d_unit = 1
            distances_km = list(np.linspace(firstx, lastx, nx) / KM)
            # one station beyond the fan keeps QSEIS's last-sample behavior
            # away from the used range (qseis.py:621-624)
            onebeyond = self.c.get("firstx", 0.0) + self.c["dx"] * self.c["nx"]
            distances_km.append(onebeyond / KM)
            conf.distances_km = distances_km
            conf.no_distances = len(distances_km)
            conf.sw_irregular_station_azimuths = 0
            conf.station_azimuths = [0.0]
            runner.run(conf)
            have_gfs = True
            for comp, x, tmin, deltat, values in runner.get_traces():
                if comp not in gfmap:
                    continue
                ig, factor = gfmap[comp]
                if factor != 1.0:
                    values = values * factor
                if self.cutting is not None:
                    tcut0 = self.cutting[0](x, z)
                    tcut1 = self.cutting[1](x, z)
                    i0 = max(0, int(np.floor((tcut0 - tmin) / deltat)))
                    i1 = min(len(values), int(np.ceil((tcut1 - tmin) / deltat)) + 1)
                    values = values[i0:i1]
                    tmin = tmin + i0 * deltat
                ix = int(round((x - self.c.get("firstx", 0.0)) / self.c["dx"]))
                if ix >= self.c["nx"]:
                    continue
                traces.append((ix, ig, tmin, values))
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
