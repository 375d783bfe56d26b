"""The port's Step pipeline against kiwi_tpu.pipeline, step by step, on
tests/test_pipeline.py's session (45 x 8 fullspace store, 3 `ned`
receivers, a finite bilateral fault as its own synthetic reference), both
packages on the CPU: ParamTuner's dumped misfits within 1e-5 of their max
with the same best values and bootstrap statistics, WeightMaker's weights
within 1e-5 relative, Shifter's shifts equal, EffectiveDtTester's and
EnduringPointSource's choices equal with curves within 1e-5,
ExtConfigurator's outputs equal, Greeper and GradientGreeper within
tests/test_pipeline.py's bars, the same run-dir layout, and no torch class
in any persisted pickle.  Then Greeper's error policy: kernel and CUDA
errors propagate, a start that fails otherwise (a depth outside the store)
is skipped."""

import os
import pickle
import pickletools

import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu import pipeline as jpl
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu.invert import Source as JSource
from kiwi_tpu.plf import PLF as JPLF
from kiwi_tpu_torch import pipeline as tpl
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.invert import Source as TSource
from kiwi_tpu_torch.ops.build import KernelError
from kiwi_tpu_torch.plf import PLF as TPLF

TRUE = np.array(
    [0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0, 2500.0, 0.2],
    dtype=np.float32,
)
PKGS = {"jax": (jpl, JSource), "torch": (tpl, TSource)}


@pytest.fixture(scope="module")
def engines():
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    out = {}
    for key, eng, rec in (("jax", JEngine(store), JReceiver),
                          ("torch", TEngine(tstore, device="cpu"), TReceiver)):
        olat, olon = 30.0, 70.0
        recs = []
        for d, az in [(1500.0, 0.0), (2300.0, 1.2), (3100.0, -2.0)]:
            la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d * np.cos(az),
                                      d * np.sin(az))
            recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
        eng.set_receivers(recs)
        eng.set_source_location(olat, olon, 0.0)
        eng.set_effective_dt(0.1)
        eng.set_local_interpolation(True)
        out[key] = eng
    return out


def _reset(eng):
    eng.set_source_params("bilateral", TRUE)
    eng.set_misfit_method("l2norm")
    eng.set_synthetic_reference()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _layout(workdir):
    out = []
    for root, dirs, files in os.walk(workdir):
        rel = os.path.relpath(root, workdir)
        out += [os.path.join(rel, d) + "/" for d in dirs]
        out += [os.path.join(rel, f) for f in files]
    return sorted(out)


def _torch_free(workdir):
    """Every pickle under workdir: the modules its classes come from, none
    of them torch's (so it loads on a host whatever its torch build), and
    the object itself holds no tensor."""
    n = 0
    for root, _dirs, files in os.walk(workdir):
        for fn in files:
            if not fn.endswith(".pickle"):
                continue
            with open(os.path.join(root, fn), "rb") as f:
                data = f.read()
            strings = [arg for op, arg, _pos in pickletools.genops(data) if isinstance(arg, str)]
            assert not [s for s in strings if s == "torch" or s.startswith("torch.")], fn
            tpl.host_only(pickle.loads(data))
            n += 1
    return n


def test_param_tuner(engines, tmp_path):
    """Informer then ParamTuner over 13 strikes (bootstrap 20), chained."""
    res = {}
    for key, (pl, src_cls) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        base = src_cls("bilateral", TRUE)
        base["strike"] = 60.0
        wd = str(tmp_path / key)
        info = pl.Informer(wd, "informer")
        lines = info.work(eng)
        tuner = pl.ParamTuner(wd, [("strike", np.arange(31.0, 152.0, 10.0))],
                              bootstrap_iterations=20).chain(info)
        best, stats = tuner.work(eng, base)
        res[key] = (lines, tuner, base, stats, wd)
    (jl, jt, jb, js, jwd), (tl, tt, tb, ts, twd) = res["jax"], res["torch"]
    assert tl == jl
    assert tb["strike"] == jb["strike"] == pytest.approx(91.0)
    jd, td = jt.load(jt.name), tt.load(tt.name)
    np.testing.assert_array_equal(td["params"], jd["params"])
    _close(td["misfits_by_src"], jd["misfits_by_src"])
    _close(td["norms_by_src"], jd["norms_by_src"])
    st, sj = ts["strike"], js["strike"]
    assert (st.best, st.median, st.percentile16, st.percentile84, st.mean, st.std) == \
        (sj.best, sj.median, sj.percentile16, sj.percentile84, sj.mean, sj.std)
    assert str(st) == str(sj)
    assert tt.out_config["min_misfit"] == pytest.approx(jt.out_config["min_misfit"], rel=1e-5,
                                                        abs=1e-6)
    assert tt.in_config == jt.in_config == {"nreceivers": 3}
    assert _layout(twd) == _layout(jwd)
    assert _torch_free(twd) == 7


def test_weightmaker(engines, tmp_path):
    """Weights from the zero-reference SDR grid: 1e-5 relative; afterwards the
    references, and what the engine computes from them, are restored."""
    weights = {}
    for key, (pl, src_cls) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        refs = {k: (v[0].copy(), v[1]) for k, v in eng._refs.items()}
        wm = pl.WeightMaker(str(tmp_path / key))
        weights[key] = wm.work(eng, src_cls("bilateral", TRUE))
        for k, (v, i) in refs.items():
            np.testing.assert_array_equal(eng._refs[k][0], v)
            assert eng._refs[k][1] == i
        eng.set_source_params("bilateral", TRUE)  # the grid moved the source
        assert eng.get_global_misfit() < 1e-4
    assert weights["torch"].shape == (3,) and np.all(weights["torch"] > 0)
    _close(weights["torch"], weights["jax"])
    assert _layout(str(tmp_path / "torch")) == _layout(str(tmp_path / "jax"))


def test_gen_dweights_zero_references(engines):
    """gen_dweights leaves one-sample zero references in place, and the port
    evaluates against them as kiwi_tpu does (misfits of the zero reference
    equal the synthetics' norms, per rc row)."""
    got = {}
    for key, (pl, src_cls) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        pl.gen_dweights(eng, src_cls("bilateral", TRUE))
        assert all(v[0].shape == (1,) and v[1] == 0 for v in eng._refs.values())
        m, n, _fs = eng.get_misfits()
        got[key] = (np.asarray(m), np.asarray(n))
        _reset(eng)
    _close(got["torch"][0], got["jax"][0])
    _close(got["torch"][1], got["jax"][1])


def test_shifter(engines, tmp_path):
    shifts = {}
    for key, (pl, _src) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        for irec in range(3):
            eng.shift_ref_seismogram(irec, 4)
        shifts[key] = pl.Shifter(str(tmp_path / key), shiftrange=(-1.0, 1.0)).work(eng)
        assert eng.get_global_misfit() < 1e-4
    np.testing.assert_array_equal(shifts["torch"], shifts["jax"])
    assert np.allclose(shifts["torch"], -0.4, atol=1e-6)


def test_effective_dt_tester(engines, tmp_path):
    out = {}
    for key, (pl, src_cls) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        t = pl.EffectiveDtTester(str(tmp_path / key), dts=[0.1, 0.2, 0.4], tolerance=0.05)
        out[key] = t.work(eng, src_cls("bilateral", TRUE))
        assert eng.effective_dt == 0.1
    (jc, jcurve), (tc, tcurve) = out["jax"], out["torch"]
    assert tc == jc and sorted(tcurve) == sorted(jcurve) == [0.1, 0.2, 0.4]
    _close([tcurve[k] for k in sorted(tcurve)], [jcurve[k] for k in sorted(jcurve)])


def test_enduring_point_source(engines, tmp_path):
    """Four stages (strike x dip, slip-rake, moment, depth), each with 100
    bootstrap iterations: the same choices and min misfit within 1e-5."""
    out = {}
    for key, (pl, src_cls) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        base = src_cls("bilateral", TRUE)
        base["strike"] = 0.0
        eps = pl.EnduringPointSource(str(tmp_path / key))
        src = eps.work(eng, base)
        out[key] = (src, eps.out_config)
    (jsrc, joc), (tsrc, toc) = out["jax"], out["torch"]
    for k in ("strike", "dip", "slip-rake", "moment", "depth"):
        assert toc[k] == joc[k], k
    np.testing.assert_array_equal(tsrc.params, jsrc.params)
    assert toc["min_misfit"] == pytest.approx(joc["min_misfit"], rel=1e-5)
    assert toc["min_misfit"] < 0.9


def test_ext_configurator(tmp_path):
    outs = {}
    for key, (pl, _src), plf in (("jax", PKGS["jax"], JPLF), ("torch", PKGS["torch"], TPLF)):
        for filt in (plf([0.05, 0.1, 2.0, 4.0], [0.0, 1.0, 1.0, 0.0]),
                     ([0.05, 0.1, 2.0, 4.0], [0.0, 1.0, 1.0, 0.0])):
            ec = pl.ExtConfigurator(str(tmp_path / key), frequency_factor=2.0,
                                    size_factor=4000.0, steps=5.0)
            ec.in_config = {
                "rise_time": 0.5, "depth": 1000.0, "filter": filt,
                "constraining_planes": [((0.0, 0.0, 0.0), (0.0, 0.0, -1.0)),
                                        ((0.0, 0.0, 30000.0), (0.0, 0.0, 1.0))],
            }
            outs.setdefault(key, []).append(ec.work())
    for j, t in zip(outs["jax"], outs["torch"]):
        assert sorted(t) == sorted(j)
        for k in j:
            if k == "filter":
                jx, jy = (j[k].x, j[k].y) if hasattr(j[k], "x") else j[k]
                tx, ty = (t[k].x, t[k].y) if hasattr(t[k], "x") else t[k]
                np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))
                np.testing.assert_array_equal(np.asarray(ty), np.asarray(jy))
            else:
                assert t[k] == j[k], k
    assert outs["torch"][0]["bord_radius_range"] == (0.0, 2000.0, 400.0)


def test_greepers(engines, tmp_path):
    """Greeper (LM from strikes 70 and 110) and GradientGreeper (Adam from 78
    and 104, 40 steps, then LM) recover the strike in both packages
    (tests/test_pipeline.py's bars); the port's Adam matches optax only to
    float32 rounding, so the results compare by those bars."""
    for key, (pl, src_cls) in PKGS.items():
        eng = engines[key]
        _reset(eng)
        base = src_cls("bilateral", TRUE)
        src, gm = pl.Greeper(str(tmp_path / key), [("strike", np.array([70.0, 110.0]))]) \
            .work(eng, base)
        assert gm < 1e-3 and abs(src["strike"] - 91.0) < 1.0, key
        _reset(eng)
        gg = pl.GradientGreeper(str(tmp_path / key), [("strike", np.array([78.0, 104.0]))],
                                steps=40, lr=0.02)
        src, gm = gg.work(eng, base)
        assert gm < 1e-3 and abs(src["strike"] - 91.0) < 1.0, key
        assert isinstance(gg.out_config["min_misfit"], float)
    assert _layout(str(tmp_path / "torch")) == _layout(str(tmp_path / "jax"))
    assert _torch_free(str(tmp_path / "torch")) == 6


@pytest.mark.parametrize("exc", [
    KernelError("kiwi_window_synth launch failed: CUDA error 700"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["kernel", "oom", "cuda_runtime"])
def test_greeper_lets_card_failures_through(engines, tmp_path, monkeypatch, exc):
    eng = engines["torch"]
    _reset(eng)
    calls = []

    def failing():
        calls.append(1)
        raise exc

    monkeypatch.setattr(eng, "minimize_lm", failing)
    gr = tpl.Greeper(str(tmp_path), [("strike", np.array([70.0, 110.0]))])
    with pytest.raises(type(exc)):
        gr.work(eng, TSource("bilateral", TRUE))
    assert len(calls) == 1  # the first start's failure ends the search


def test_greeper_skips_a_start_outside_the_store(engines, tmp_path):
    """A start at 50 km depth lies outside the 45 x 8 store (0-700 m): its
    search raises ValueError and is skipped, as in kiwi_tpu; the other
    start recovers the truth.  A failure of every start still raises."""
    eng = engines["torch"]
    _reset(eng)
    eng.set_source_params("bilateral", np.where(np.arange(14) == 3, 5e4, TRUE)
                          .astype(np.float32))
    with pytest.raises(ValueError):
        eng.minimize_lm()
    _reset(eng)
    gr = tpl.Greeper(str(tmp_path), [("depth", np.array([5e4, 400.0]))])
    src, gm = gr.work(eng, TSource("bilateral", TRUE))
    assert gm < 1e-3 and src["depth"] == pytest.approx(400.0, abs=1.0)
    _reset(eng)
    with pytest.raises(RuntimeError, match="all gradient searches failed"):
        tpl.Greeper(str(tmp_path), [("depth", np.array([5e4]))]).work(
            eng, TSource("bilateral", TRUE))


def test_dump_refuses_tensors(tmp_path):
    step = tpl.Step(str(tmp_path), "s")
    step.make_rundir()
    for bad in (torch.zeros(2), {"a": [1, (torch.ones(1),)]}, TSource("bilateral", TRUE)):
        if isinstance(bad, TSource):
            bad.params = torch.as_tensor(bad.params)
        with pytest.raises(TypeError, match="torch.Tensor"):
            step.dump(bad, "x")
    step.dump({"a": np.zeros(2), "b": [1.0, "x"]}, "ok")
    assert _torch_free(str(tmp_path)) == 1
