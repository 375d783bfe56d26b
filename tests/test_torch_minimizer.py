"""The minimizer text protocol on the port (kiwi_tpu_torch.cli.minimizer)
against kiwi_tpu.cli.minimizer: the scripted sessions of
tests/test_minimizer_repl.py on its 40x6 store and 3 `ned` receivers, and
sessions that reach the rest of the protocol (ampspec norms, spectra, cross
correlations, shifts, tapers and filters that pass a band, the source model,
LM, SAC and table files, an HDF5 database and an oversampled one), through
both servers, the port's on the CPU.

Both servers must give the same sequence of commands with the same ok/nok,
the same number of answer values, and the values at the port's bar (rtol
2e-5 with an absolute floor of 2e-5 of the answer's largest value; a global
misfit is a ratio to the reference norm, so its floor is 2e-5 of 1;
minimize_lm's info and nfev and minimize_gradient's steps and starts
exactly, their misfits as ratios), and write the same files, whose values
meet the same bar and whose start times and sampling are equal.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu.cli.minimizer import MinimizerServer as JServer
from kiwi_tpu.gf import elseis
from kiwi_tpu.io import readseismogram
from kiwi_tpu_torch.cli.minimizer import MinimizerServer as TServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
RATIOS = ("get_global_misfit",)  # answers that are misfit / norm ratios
SRC = "bilateral 0 0 0 400 1e12 91 87 164 0 300 200 250 2500 0.2"
SRC_OFF = "bilateral 0 0 0 400 1e12 97 84 168 0.1 300 200 250 2500 0.2"
PREFIX = """set_database            {db}
set_effective_dt        0.1
set_local_interpolation bilinear
set_receivers           {rcv}
set_source_location     30.0 70.0 0
"""

# tests/test_minimizer_repl.py's sessions, verbatim but for the paths
REPL_SESSIONS = {
    "scripted": PREFIX + f"""set_source_params       {SRC}
output_seismograms      {{out}}/seis table synthetics plain
get_global_misfit
bogus_command 1 2 3
""",
    "self_consistency": PREFIX + f"""set_source_params {SRC}
output_seismograms {{out}}/ref mseed synthetics plain
set_ref_seismograms {{out}}/ref mseed
set_misfit_method l2norm
get_global_misfit
get_misfits
set_source_params bilateral 0 0 0 400 1e12 121 87 164 0 300 200 250 2500 0.2
get_global_misfit
""",
    "subparams_and_axes": """set_database {db}
set_effective_dt 0.1
set_receivers {rcv}
set_source_location 30.0 70.0 0
""" + f"""set_source_params {SRC}
set_source_params_mask F F F F F T F F F F F F F F
get_source_subparams
set_source_subparams 101.0
get_source_subparams
get_principal_axes
""",
    "diagnostics_and_lm": PREFIX + f"""set_source_params       {SRC}
output_seismograms      {{out}}/out-ref mseed synthetics plain
set_ref_seismograms     {{out}}/out-ref mseed
set_misfit_method       floating_l1norm
set_floating_shiftrange 0 -0.5 0.5
set_misfit_taper        1 0.1 0 2.5 1 6.0 1 8.0 0
set_misfit_filter       0 0 1 0.2 1 3.0 0 4.0
get_global_misfit
get_floating_shifts
get_peak_amplitudes     1
get_peak_amplitudes     2
get_arias_intensities
output_distances        {{out}}/out-dist.table
output_source_model     {{out}}/out-model
output_seismogram_spectra {{out}}/out-spec references plain
output_cross_correlations {{out}}/out-xcorr -0.3 0.3
shift_ref_seismogram    1 0.2
autoshift_ref_seismogram 1 -0.5 0.5
get_source_crustal_thickness
set_source_crustal_thickness_limit 40000
set_cached_traces_memory_limit 1000000000
get_cached_traces_memory
set_synthetics_factor   1.0
set_source_params_mask  F F F T F T F F F F F F F F
set_source_subparams_limits 300 85 500 95
minimize_lm
minimize_gradient       10 0.01
get_source_subparams    2 3 5
set_verbose             T
set_ignore_sigint       T
""",
    "malformed": """bogus_command 1 2 3
set_database
set_database /nonexistent/path.npz
set_database {db}
set_source_location not a number
set_source_params bilateral 1 2
set_receivers /nonexistent.table
set_receivers {rcv}
set_source_location 30.0 70.0 0
""" + f"""set_source_params {SRC}
set_effective_dt 0.1
get_global_misfit
minimize_lm extra args here
output_seismograms
get_distances_typo
set_misfit_method not_a_norm
get_source_subparams 99
""",
}

# the rest of the protocol, with a band-pass that passes (the session above
# gives its filter's corners out of order, so everything filtered is zero)
FULL = PREFIX + f"""set_source_params       {SRC}
output_seismograms      {{out}}/ref sac synthetics plain
output_seismograms      {{out}}/reft table synthetics plain
set_ref_seismograms     {{out}}/ref sac
set_misfit_method       floating_l2norm
set_floating_shiftrange 0 -0.5 0.5
set_floating_shiftrange 2 -0.3 0.4
set_misfit_taper        1 0.1 0 2.5 1 6.0 1 8.0 0
set_misfit_filter       0 0 0.2 1 3.0 1 4.0 0
set_misfit_filter_1     3 0 0 0.3 1 2.5 1 3.5 0
set_source_params       {SRC_OFF}
get_global_misfit
get_misfits
get_floating_shifts
get_peak_amplitudes     1
get_peak_amplitudes     2
get_arias_intensities
output_seismograms      {{out}}/tap table synthetics tapered
output_seismograms      {{out}}/fil sac synthetics filtered
output_seismograms      {{out}}/rfil table references filtered
output_seismogram_spectra {{out}}/spec references plain
output_seismogram_spectra {{out}}/specs synthetics filtered
output_cross_correlations {{out}}/xcorr -0.3 0.4
output_source_model     {{out}}/model
output_distances        {{out}}/dist.table
set_misfit_method       ampspec_l2norm
get_global_misfit
get_misfits
set_misfit_method       ampspec_l1norm
get_global_misfit
get_misfits
set_synthetics_factor   1.2
get_misfits
switch_receiver         2 off
get_misfits
get_global_misfit
switch_receiver         2 on
set_misfit_method       l1norm
get_misfits
set_misfit_method       scalar_product
get_misfits
set_misfit_method       peak
get_misfits
set_misfit_method       floating_l1norm
shift_ref_seismogram    2 -0.2
get_misfits
autoshift_ref_seismogram 0 -0.5 0.5
autoshift_ref_seismogram 3 -0.5 0.5
get_misfits
set_synthetics_factor   1.0
set_misfit_method       l2norm
set_source_params_mask  F F F F F T T F F F F F F F
set_source_subparams_limits 80 70 110 95
get_source_subparams
minimize_lm
get_source_subparams
get_principal_axes
minimize_gradient
"""

# databases: HDF5 in the reference layout, and the store oversampled
DATABASES = PREFIX.replace("{db}", "{h5}") + f"""set_source_params       {SRC}
output_seismograms      {{out}}/h5 table synthetics plain
set_database            {{db}} 2 1
set_source_params       {SRC_OFF}
output_seismograms      {{out}}/over table synthetics plain
set_ref_seismograms     {{out}}/h5 table
set_misfit_method       l2norm
get_global_misfit
get_misfits
get_cached_traces_memory
set_spacial_undersampling 2 1
get_global_misfit
set_local_interpolation nearest_neighbor
get_global_misfit
set_local_interpolation cubic
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("db")
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=40, nz=6, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    db = str(d / "testdb.npz")
    store.save(db)
    lines = []
    for dist, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0)]:
        la, lo = geo.ne_to_latlon(
            np.radians(30.0), np.radians(70.0), dist * np.cos(az), dist * np.sin(az)
        )
        lines.append(f"{np.degrees(float(la)):.6f} {np.degrees(float(lo)):.6f} ned")
    rcv = str(d / "receivers.table")
    with open(rcv, "w") as f:
        f.write("\n".join(lines) + "\n")
    out = {"db": db, "rcv": rcv}
    try:
        import h5py  # noqa: F401

        from kiwi_tpu.io.gfdb_hdf5 import save_gfdb

        save_gfdb(store, str(d / "testdb"), nchunks=2)
        out["h5"] = str(d / "testdb")
    except ImportError:
        pass
    return out


def _parse(text):
    """[(command, ok, [answer lines])] from a server's output."""
    out = []
    for line in text.splitlines():
        if ": ok" in line or ": nok" in line:
            cmd, status = line.split(": ", 1)
            out.append((cmd, status.startswith("ok"), []))
        else:
            out[-1][2].append(line)
    return out


def _run(server, script, outdir):
    os.makedirs(outdir, exist_ok=True)
    buf = io.StringIO()
    server.run(io.StringIO(script.replace("{out}", outdir)), buf)
    return _parse(buf.getvalue())


def _numbers(lines):
    return np.array([float(w) for line in lines for w in line.split()])


def _close(got, want, atol_floor=0.0):
    assert got.shape == want.shape
    finite = want[np.isfinite(want)]
    scale = max(float(np.abs(finite).max()) if finite.size else 0.0, atol_floor)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _compare_answers(got, want):
    assert [c for c, _ok, _a in got] == [c for c, _ok, _a in want]
    for (cmd, ok, ans), (_c, wok, wans) in zip(got, want):
        assert ok == wok, (cmd, ans, wans)
        if not ok:
            continue
        assert len(ans) == len(wans), cmd
        if cmd in ("minimize_lm", "minimize_gradient"):
            g, w = _numbers(ans), _numbers(wans)
            # info and nfev, or steps and starts; then the global misfit
            np.testing.assert_array_equal(g[:2], w[:2])
            _close(g[2:], w[2:], atol_floor=1.0)
        elif cmd == "set_receivers":
            assert ans == wans
        elif ans:
            _close(_numbers(ans), _numbers(wans), atol_floor=1.0 if cmd in RATIOS else 0.0)


def _compare_files(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(("dsm.table", "dist.table")):
            _close(np.loadtxt(g, ndmin=2), np.loadtxt(w, ndmin=2))
            continue
        gv, gt, gdt = readseismogram(g)
        wv, wt, wdt = readseismogram(w)
        assert gv.shape == wv.shape and gdt == wdt, name
        assert gt == pytest.approx(wt, abs=1e-6 * wdt), name
        _close(gv, wv)
    return names


def _both(files, script, tmp_path):
    script = script.format(out="{out}", **files)
    want = _run(JServer(), script, str(tmp_path / "jax"))
    got = _run(TServer(device="cpu"), script, str(tmp_path / "port"))
    _compare_answers(got, want)
    return got, _compare_files(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("session", sorted(REPL_SESSIONS))
def test_repl_sessions_match(files, tmp_path, session):
    got, names = _both(files, REPL_SESSIONS[session], tmp_path)
    assert any(ok for _c, ok, _a in got)
    if session == "diagnostics_and_lm":
        assert {"out-dist.table", "out-model-dsm.table", "out-spec-1-n.table",
                "out-xcorr-1-n.table"} <= set(names)
    if session == "scripted":
        assert len(names) == 9


def test_full_protocol_session_matches(files, tmp_path):
    got, names = _both(files, FULL, tmp_path)
    noks = [c for c, ok, _a in got if not ok]
    assert noks == []
    answers = {c: a for c, _ok, a in got}
    assert float(answers["get_global_misfit"][0]) > 0.01  # an off-truth source
    assert len(names) == 8 * 9 + 2
    # the ampspec misfits differ from the time-domain ones and from zero
    misfits = [_numbers(a) for c, _ok, a in got if c == "get_misfits"]
    assert all(m[0::2].max() > 0 for m in misfits)
    assert not np.allclose(misfits[1], misfits[2])


def test_databases_session_matches(files, tmp_path):
    if "h5" not in files:
        pytest.skip("h5py is not installed")
    got, names = _both(files, DATABASES, tmp_path)
    assert [c for c, ok, _a in got if not ok] == ["set_local_interpolation"]
    assert len(names) == 18


def test_server_defaults_to_the_card(files, tmp_path):
    """Without a card every command that computes answers nok: the server
    never falls back to the CPU."""
    srv = TServer()
    assert srv.engine.device.type == "cuda"
    script = PREFIX.format(**files) + f"set_source_params {SRC}\n"
    answers = _run(srv, script + "output_source_model {out}/x\nget_peak_amplitudes 1\n",
                   str(tmp_path))
    last = {c: ok for c, ok, _a in answers}
    assert last["set_database"] and last["set_receivers"]
    computed = [last["output_source_model"], last["get_peak_amplitudes"]]
    assert computed == [torch.cuda.is_available()] * 2


def test_module_entry_point(files, tmp_path):
    script = PREFIX.format(**files) + (f"set_source_params {SRC}\n"
                                       f"output_seismograms {tmp_path}/s table synthetics plain\n"
                                       "get_source_crustal_thickness\n")
    r = subprocess.run([sys.executable, "-m", "kiwi_tpu_torch.cli.minimizer", "--device", "cpu"],
                       input=script, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-2:] == ["get_source_crustal_thickness: ok >", "41000"]
    assert "output_seismograms: ok" in r.stdout.splitlines()
    assert len(os.listdir(tmp_path)) == 9
