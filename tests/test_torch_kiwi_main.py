"""kiwi_main work/report on the port against kiwi_tpu.cli.kiwi_main:
tests/test_kiwi_main.py's scenario (45 x 8 fullspace store, 4 `ned`
receivers, a point bilateral source at 400 m as the observed data, the
search started at 600 m and half the moment) through both work functions,
the port's on the CPU: the same best source parameters, min_misfit within
1e-5 relative, the same run-dir layout, report mode rereading the port's
run, unknown options refused by both, and, with matplotlib made
unimportable, the figures step recorded as skipped in report.html and on
stdout while the search is unchanged."""

import os
import sys

import numpy as np
import pytest

from kiwi_tpu import geo
from kiwi_tpu.cli import kiwi_main as jkm
from kiwi_tpu.dataset import save_dataset
from kiwi_tpu.engine import Engine, Receiver
from kiwi_tpu.gf import elseis
from kiwi_tpu_torch.cli import kiwi_main as tkm

TRUE = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0, 2500.0, 0.2],
                dtype=np.float32)
OPTS = dict(components="ned", effective_dt="0.1", sourcetype="bilateral", depth="600",
            moment="5e11", grid_step_deg="20", bootstrap_iterations="20",
            **{"rupture-velocity": "2500", "rise-time": "0.2"})


@pytest.fixture(scope="module")
def event(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kiwi_main")
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    dbfile = str(tmp / "db.npz")
    store.save(dbfile)
    eng = Engine(store)
    olat, olon = 30.0, 70.0
    recs = []
    for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0), (2700.0, 2.6)]:
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d * np.cos(az),
                                  d * np.sin(az))
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_params("bilateral", TRUE)
    eng.set_synthetic_reference()
    datadir = str(tmp / "event")
    save_dataset(datadir, eng, which="references", fmt="mseed")
    return tmp, datadir, dbfile


@pytest.fixture(scope="module")
def runs(event):
    tmp, datadir, dbfile = event
    out = {}
    for key, km, kw in (("jax", jkm, {}), ("torch", tkm, {"device": "cpu"})):
        wd = str(tmp / f"work-{key}")
        out[key] = km.work(datadir, dbfile, wd, **kw, **OPTS) + (wd,)
    return out


def _layout(workdir):
    out = []
    for root, dirs, files in os.walk(workdir):
        rel = os.path.relpath(root, workdir)
        out += [os.path.join(rel, d) + "/" for d in dirs]
        out += [os.path.join(rel, f) for f in files]
    return sorted(out)


def test_work_same_best_source(runs):
    """The same best source: every parameter equal, the mechanism as a
    moment tensor (the SDR grid holds both planes of a double couple, whose
    misfits tie to float rounding, so either plane may win)."""
    from kiwi_tpu_torch.euler import mt_from_sdr

    (jbest, jsteps, jwd), (tbest, tsteps, twd) = runs["jax"], runs["torch"]
    sdr = [5, 6, 7]
    np.testing.assert_array_equal(np.delete(tbest.params, sdr), np.delete(jbest.params, sdr))
    mts = [mt_from_sdr(*np.radians(b.params[sdr].astype(np.float64))) for b in (tbest, jbest)]
    np.testing.assert_allclose(mts[0], mts[1], atol=1e-6)
    jm = jsteps[-2].out_config["min_misfit"]
    tm = tsteps[-2].out_config["min_misfit"]
    assert tm == pytest.approx(jm, rel=1e-5)
    for js, ts in zip(jsteps, tsteps):
        assert ts.name == js.name
        for k in ("min_misfit", "receiver_weights"):
            if k in js.out_config:
                np.testing.assert_allclose(ts.out_config[k], js.out_config[k], rtol=1e-5)
    # tests/test_kiwi_main.py's recovery bars, on the port
    truth = mt_from_sdr(np.radians(91.0), np.radians(87.0), np.radians(164.0))
    got = mt_from_sdr(np.radians(tbest["strike"]), np.radians(tbest["dip"]),
                      np.radians(tbest["slip-rake"]))
    corr = (truth * got).sum() / np.sqrt((truth**2).sum() * (got**2).sum())
    assert corr > 0.9
    assert abs(np.log10(tbest["moment"] / 1e12)) < 0.2
    assert abs(tbest["depth"] - 400.0) < 150.0
    assert _layout(twd) == _layout(jwd)
    assert os.path.exists(os.path.join(twd, "traceplotter", "current", "seismograms.png"))


def test_report_rereads_the_run(runs, capsys):
    _best, steps, wd = runs["torch"]
    os.remove(os.path.join(wd, "report.html"))
    out = tkm.report(wd)
    assert out == os.path.join(wd, "report.html") and "report:" in capsys.readouterr().out
    html = open(out).read()
    for step in steps:
        assert f"<h2>{step.name}</h2>" in html
    assert "strike" in html and "receiver_weights" in html and "seismograms.png" in html


@pytest.mark.parametrize("bad", [{"strikee": "10"}, {"grid_step": "10"}])
def test_unknown_option_raises_in_both(event, tmp_path, bad):
    _tmp, datadir, dbfile = event
    for km, kw in ((jkm, {}), (tkm, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unknown option"):
            km.work(datadir, dbfile, str(tmp_path / "w"), **kw, **bad)


def test_main_cli(event, tmp_path, monkeypatch):
    """--device cpu work ... through main(); a device given as an option is
    refused, and so is an unknown option."""
    _tmp, datadir, dbfile = event
    wd = str(tmp_path / "w")
    with pytest.raises(SystemExit):
        tkm.main(["--device", "gpu", "work", datadir, dbfile, wd])
    with pytest.raises(SystemExit):
        tkm.main(["--device", "cpu", "work", datadir, dbfile, wd, "device=cpu"])
    with pytest.raises(ValueError, match="unknown option"):
        tkm.main(["--device", "cpu", "work", datadir, dbfile, wd, "bogus=1"])
    seen = {}
    monkeypatch.setattr(tkm, "work", lambda *a, **kw: seen.update(args=a, kw=kw))
    tkm.main(["work", datadir, dbfile, wd, "grid_step_deg=30"])
    assert seen["kw"] == {"device": "cuda", "grid_step_deg": "30"}
    assert seen["args"] == (datadir, dbfile, wd)


def test_work_without_matplotlib(event, runs, tmp_path, monkeypatch, capsys):
    """matplotlib unimportable: the traceplotter step is recorded as skipped,
    report.html and stdout name the package and the figures, and the search
    finds what it finds with matplotlib."""
    _tmp, datadir, dbfile = event
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    wd = str(tmp_path / "w")
    best, steps = tkm.work(datadir, dbfile, wd, device="cpu", **OPTS)
    out = capsys.readouterr().out
    assert "traceplotter skipped" in out and "matplotlib" in out
    np.testing.assert_array_equal(best.params, runs["torch"][0].params)
    html = open(os.path.join(wd, "report.html")).read()
    assert "<h2>traceplotter</h2>" in html and "matplotlib" in html
    for fig in ("seismograms", "stations", "beachball", "misfogram", "spectra"):
        assert fig in html
    cur = os.path.join(wd, "traceplotter", "current")
    assert sorted(os.listdir(cur)) == ["config-in.pickle", "config-out.pickle", "results.pickle"]
    assert "matplotlib" in steps[-1].results["skipped"]
