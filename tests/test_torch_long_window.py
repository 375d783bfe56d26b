"""Plans outside the window kernel, and the kernels' refusal of autograd.

A store sampled at 1 ms puts the extended time axis (nt_out + s_len = 2888
samples) above the window kernel's T_MAX = 2048: the port's plan takes the
plain synthesis (plan["formulation"] == "plain") and answers where it used
to raise, against kiwi_tpu on the CPU at the port's bar (rtol 2e-5, absolute
floor 2e-5 of the largest value; floating shifts exactly), under l2norm and
floating_l1norm, the latter through the scan kernel's wrapper.  Plans inside
the kernel keep it.  Each CUDA kernel's wrapper raises RuntimeError, on every
device, for an input that requires grad (no kernel has a backward).
"""

import numpy as np
import pytest
import torch

from kiwi_tpu import geo
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu_torch import misfit as tmf
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.ops import eik_sweep as tes, float_scan as tfs, synth_window as tsw

FAULT = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                  2500.0, 0.2], np.float32)
STRIKES = np.array([20.0, 91.0, 150.0, 260.0], np.float32)


def _close(got, want, rtol=2e-5):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _engines(dt):
    store = elseis.build_ahfull_store(
        nx=40, nz=8, dt=dt, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0),
        stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64),
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return JEngine(store), TEngine(tstore, device="cpu")


@pytest.fixture(scope="module")
def long_engines():
    return _engines(0.001)


def _configure(eng, method, shiftrange):
    """tests/test_torch_finite.py's session: 4 `ned` receivers, the fault's
    own synthetic as the reference."""
    rec = JReceiver if isinstance(eng, JEngine) else TReceiver
    olat, olon = 30.0, 70.0
    recs = []
    for i in range(4):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), 1200.0 + 400.0 * i, 0.3 * i)
        recs.append(rec(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_params("bilateral", FAULT)
    eng.set_misfit_method(method)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(*shiftrange)


def _spy(monkeypatch):
    calls = {"window": 0, "scan": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tsw, "synthesize_ard_batch", spy("window", tsw.synthesize_ard_batch))
    monkeypatch.setattr(tmf, "scan_sums", spy("scan", tmf.scan_sums))
    return calls


@pytest.mark.parametrize("method,shiftrange", [("l2norm", (0.0, 0.0)),
                                               ("floating_l1norm", (-0.02, 0.02))])
def test_long_window_plan_matches(long_engines, monkeypatch, method, shiftrange):
    je, te = long_engines
    for eng in long_engines:
        _configure(eng, method, shiftrange)
    calls = _spy(monkeypatch)
    pb = np.tile(FAULT, (len(STRIKES), 1))
    pb[:, 5] = STRIKES
    m, n, fs = te.misfits_for_source_batch(pb)
    cfg = te._plan["cfg"]
    assert cfg.nt_out + cfg.s_len > tsw.T_MAX and not tsw.usable(cfg)
    assert te._plan["formulation"] == "plain"
    # the plain synthesis; the scan kernel's wrapper under the floating norm
    assert calls == {"window": 0, "scan": 1 if method == "floating_l1norm" else 0}
    jm, jn, jfs = je.misfits_for_source_batch(pb)
    _close(m, jm)
    _close(n, jn)
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))
    g = te.global_misfits_for_source_batch(pb)
    _close(g, je.global_misfits_for_source_batch(pb))
    assert int(torch.argmin(g)) == 1  # the true strike
    # the differentiable formulation gives the same misfits
    tm, tn, tfs_ = te._plan["forward_batch_xla"](*_tables(te, pb))
    _close(tm, jm)
    np.testing.assert_array_equal(tfs_.numpy(), np.asarray(jfs))


def _tables(eng, pb):
    d = eng.discretize(pb)
    return d.tables, torch.as_tensor(d.moments), torch.as_tensor(d.risetimes)


def test_window_plans_keep_the_kernel(monkeypatch):
    _je, te = _engines(0.1)
    _configure(te, "floating_l1norm", (-0.5, 0.5))
    calls = _spy(monkeypatch)
    pb = np.tile(FAULT, (2, 1))
    pb[:, 5] = (91.0, 150.0)
    te.global_misfits_for_source_batch(pb)
    assert te._plan["formulation"] == "window"
    assert calls == {"window": 1, "scan": 1}


def _wrapper_operands(name):
    """Small valid operands of each kernel wrapper (f32 unless an index)."""
    rng = np.random.default_rng(0)

    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    if name == "window_forward":
        B, R, P, G, ng, nt_ext, nt_out = 2, 2, 3, 2, 8, 24, 16
        return tsw.window_forward, [
            f32(40, ng, nt_ext), torch.zeros((B, R, P), dtype=torch.int32), (1, 4, 5),
            torch.zeros((B, P, G), dtype=torch.int32), f32(B, R, P, G, tsw.NW),
            f32(B, R, P, 4), nt_out]
    if name == "fused_scan_sums":
        return tfs.fused_scan_sums, [f32(6, 3, 16), f32(6, 4, 16), f32(6, 4, 5)]
    if name == "scan_sums":
        return tfs.scan_sums, [f32(3 * 6, 16), f32(6, 5, 16)]
    return tes.sweep_solve_batch, [
        torch.ones((2, 9, 7)), torch.full((2, 2), 10.0), torch.zeros((2, 2)),
        torch.full((2, 2), 30.0)]


@pytest.mark.parametrize("name", ["window_forward", "fused_scan_sums", "scan_sums",
                                  "sweep_solve_batch"])
def test_kernel_wrappers_refuse_grad(name):
    fn, args = _wrapper_operands(name)
    with torch.no_grad():
        want = fn(*args)  # the plain version on the CPU
    f = next(i for i, a in enumerate(args)
             if isinstance(a, torch.Tensor) and a.dtype == torch.float32)
    args[f] = args[f].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():
        torch.testing.assert_close(fn(*args), want, rtol=0, atol=0)
