"""The port's plotting module: tests/test_plotting.py's three tests on
kiwi_tpu_torch.plotting, source_m6 equal to kiwi_tpu.plotting's for every
source type, and the figures of a port engine on the CPU (TracePlotter,
the rupture front and a misfit cross section, as
tests/test_tools_dataset.py::test_plots_smoke draws them)."""

import os

import numpy as np
import pytest

from kiwi_tpu import plotting as jplot
from kiwi_tpu.sources import get_source_model as jmodel
from kiwi_tpu_torch import plotting
from kiwi_tpu_torch.sources import SOURCE_REGISTRY


class FakeEngine:
    pass


def test_beachball_explosion_all_compressional(tmp_path):
    """Isotropic source: every lower-hemisphere first motion is positive."""
    from kiwi_tpu_torch.euler import m6_to_sym

    m6 = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    m = m6_to_sym(m6)
    rng = np.random.default_rng(0)
    g = rng.normal(size=(200, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    u = np.einsum("ki,ij,kj->k", g, m, g)
    assert np.all(u > 0)
    plotting.plot_beachball(m6, str(tmp_path / "exp.png"))
    assert (tmp_path / "exp.png").exists()


def test_beachball_strike_slip_quadrants(tmp_path):
    """Vertical strike-slip (strike 0): compression in the NE and SW
    quadrants for mxy > 0 (radiation sign = 2 mxy gn ge)."""
    from kiwi_tpu_torch.euler import m6_to_sym

    m = m6_to_sym(np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0]))

    def sign_at(gn, ge, gd):
        g = np.array([gn, ge, gd])
        g = g / np.linalg.norm(g)
        return float(g @ m @ g)

    assert sign_at(1.0, 1.0, 0.5) > 0  # NE
    assert sign_at(-1.0, -1.0, 0.5) > 0  # SW
    assert sign_at(1.0, -1.0, 0.5) < 0  # NW
    assert sign_at(-1.0, 1.0, 0.5) < 0  # SE
    plotting.plot_beachball(np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0]), str(tmp_path / "ss.png"))
    assert (tmp_path / "ss.png").exists()


def test_source_m6_sdr_vs_explicit():
    """source_m6 agrees between an sdr source and the equivalent explicit
    moment-tensor source."""
    from kiwi_tpu_torch.euler import mt_from_sdr, sym_to_m6

    e = FakeEngine()
    e.source_type = "bilateral"
    e.source_params = np.zeros(14, np.float32)
    e.source_params[4] = 2.5e12  # moment
    e.source_params[5:8] = [30.0, 60.0, 45.0]  # strike, dip, slip-rake
    m_sdr = plotting.source_m6(e)
    expect = sym_to_m6(mt_from_sdr(np.radians(30.0), np.radians(60.0), np.radians(45.0))) * 2.5e12
    np.testing.assert_allclose(m_sdr, expect, rtol=1e-5)

    e2 = FakeEngine()
    e2.source_type = "moment_tensor"
    e2.source_params = np.zeros(11, np.float32)
    e2.source_params[4:10] = expect.astype(np.float32)
    np.testing.assert_allclose(plotting.source_m6(e2), expect.astype(np.float32), rtol=1e-6)


@pytest.mark.parametrize("source_type", sorted(SOURCE_REGISTRY))
def test_source_m6_equals_reference(source_type):
    """Seeded parameters of every source model: the port's tensor equals
    kiwi_tpu's to float64 rounding.  point_lp names its tensor m_xx..m_yz
    and has no strike: both packages raise ValueError for it."""
    names = list(jmodel(source_type).names)
    assert names == list(SOURCE_REGISTRY[source_type].names)
    rng = np.random.default_rng(len(source_type))
    for _ in range(8):
        p = rng.uniform(-180.0, 180.0, len(names)).astype(np.float32)
        for k in ("moment", "moment-factor"):
            if k in names:
                p[names.index(k)] = rng.uniform(1e10, 1e13)
        e = FakeEngine()
        e.source_type, e.source_params = source_type, p
        if source_type == "point_lp":
            for pkg in (plotting, jplot):
                with pytest.raises(ValueError, match="strike"):
                    pkg.source_m6(e)
            continue
        got, want = plotting.source_m6(e), jplot.source_m6(e)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_figures_of_a_port_engine(tmp_path):
    """TracePlotter's five figures, the rupture front of a finite fault (its
    centroid tables come from the engine's device), a misfit cross section
    and the HTML report, from a port engine on the CPU."""
    from kiwi_tpu_torch import geo
    from kiwi_tpu_torch.engine import Engine, Receiver
    from kiwi_tpu_torch.gf import elseis
    from kiwi_tpu_torch.invert import MisfitGrid, Source
    from kiwi_tpu_torch.pipeline import TracePlotter

    store = elseis.build_ahfull_store(
        nx=40, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0),
        stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64),
    )
    eng = Engine(store, device="cpu")
    recs = []
    for d in (1500.0, 2300.0):
        la, lo = geo.ne_to_latlon(np.radians(30.0), np.radians(70.0), d, 0.0)
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(30.0, 70.0, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    bilat = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                      2500.0, 0.2], np.float32)
    eng.set_source_params("bilateral", bilat)
    eng.set_synthetic_reference()
    figs = TracePlotter(str(tmp_path)).work(eng)
    assert [os.path.basename(f) for f in figs] == [
        "seismograms.png", "stations.png", "beachball.png", "misfogram.png", "spectra.png",
        "report.html"]
    p1 = plotting.plot_rupture_front(eng, str(tmp_path / "rupture.png"))
    grid = MisfitGrid(Source("bilateral", bilat), [("strike", np.arange(61.0, 122.0, 10.0))])
    grid.compute(eng)
    p2 = plotting.plot_misfit_cross_section(grid, str(tmp_path / "misfit.png"))
    rep = plotting.html_report(str(tmp_path / "report.html"), "test",
                               [("waveforms", "hello", [figs[0]]), ("map", "", [p1, p2])])
    for p in figs + [p1, p2, rep]:
        assert os.path.exists(p) and os.path.getsize(p) > 0
    assert plotting.matplotlib_missing() is None
