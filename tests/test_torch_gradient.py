"""Gradient inversion on the port (Engine.global_misfits_and_grad,
misfit_jacobian, minimize_gradient; kiwi_tpu_torch.invert.gradient)
against the JAX package on the CPU, on tests/test_gradient.py's 45 x 8
fullspace store, its 3 `ned` receivers and bilateral fault, both stores
built from the same numpy arrays.

Global misfits compare at rtol 2e-5 with an absolute floor of 2e-5 of the
largest value (the port's bar against the reference).  Every gradient
component and Jacobian entry compares on minimize_multistart's scale
(times |p_j|, or 1% of model.norm where p_j = 0) at 1e-4 of its row's
largest scaled component, at points off the grid-snap kinks; a cut graph
would show as a zero where the JAX package has a value.  The covariance's
numpy bookkeeping holds to float64 rounding over equal Jacobians, and the
Adam + cosine schedule to float32 rounding against optax.  Then each case
of tests/test_gradient.py runs on the port with its own bars.
"""

import numpy as np
import optax
import pytest

from kiwi_tpu import geo
from kiwi_tpu import invert as jinv
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu_torch import invert as tinv
from kiwi_tpu_torch.engine import Engine as TEngine, Receiver as TReceiver
from kiwi_tpu_torch.gf.store import GFStore as TStore
from kiwi_tpu_torch.invert import gradient as tgrad
from kiwi_tpu_torch.sources import get_source_model

BILAT = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                  2500.0, 0.2], np.float32)
# the source types with a device discretizer: (truth, two points off it,
# each an index -> value map applied to the truth; off the kinks too: at
# length-a 300 with rupture velocity 2300 a centroid sits on one, and the
# two packages take its two sides)
SOURCES = {
    "bilateral": (BILAT, {0: 0.03, 5: 104.0, 6: 80.0, 7: 160.3},
                  {4: 1.3e12, 5: 84.7, 8: 6.0, 9: 301.3, 12: 2300.0}),
    "circular": (np.array([0.0, 0.0, 0.0, 400.0, 1e12, 40.0, 60.0, 110.0, 200.0, 2500.0,
                           0.2], np.float32),
                 {0: 0.03, 5: 47.3, 6: 55.2}, {4: 8e11, 7: 117.6, 9: 2650.0}),
    "moment_tensor": (np.array([0.2, 50.0, -30.0, 400.0, 1e12, -5e11, 2e11, 3e11, -1e11, 5e11,
                                0.4], np.float32),
                      {4: 1.6e12, 7: 1.2e11, 0: 0.23}, {1: 73.0, 3: 430.0, 9: 2e11}),
    "point_lp": (np.array([0.1, 60.0, -40.0, 400.0, 1e12, 0.5, -2.0, 2.0, 9.0, 0.3, -1.0,
                           1.0, 0.8], np.float32),
                 {0: 0.13, 5: 0.9, 8: 7.1}, {4: 1.4e12, 2: -23.0, 12: 0.85}),
}
METHODS = {"l2norm": (0.0, 0.0), "floating_l1norm": (-0.5, 0.5)}


def _close(got, want, rtol=2e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _scale(rows, model):
    """minimize_multistart's per-parameter scale: |p_j|, or 1% of model.norm
    where p_j = 0."""
    rows = np.atleast_2d(np.asarray(rows, np.float64))
    return np.where(rows != 0.0, np.abs(rows), 0.01 * model.norm.astype(np.float64))


def _close_scaled(got, want, scale, rtol=1e-4):
    """Each row's scaled components at rtol of that row's largest one."""
    got = np.atleast_2d(np.asarray(got, np.float64)) * scale
    want = np.atleast_2d(np.asarray(want, np.float64)) * scale
    assert got.shape == want.shape and np.isfinite(got).all()
    bar = rtol * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(want).max(axis=1) > 0).all()
    assert (np.abs(got - want) <= bar).all(), np.abs(got - want) / bar


@pytest.fixture(scope="module")
def engines():
    store = elseis.build_ahfull_store(
        nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0),
        stf=np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64),
    )
    tstore = TStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                               store.data, store.itmin, store.nsamples)
    return JEngine(store), TEngine(tstore, device="cpu")


def _configure(eng, method="l2norm", source="bilateral", truth=BILAT):
    """tests/test_gradient.py's session, the truth's synthetic as the
    reference."""
    rec = JReceiver if isinstance(eng, JEngine) else TReceiver
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
    eng.set_source_params(source, truth)
    eng.set_misfit_method(method)
    eng.set_synthetic_reference()
    eng.set_floating_shiftrange(*METHODS[method])


def _points(source):
    truth, *offs = SOURCES[source]
    rows = np.tile(truth, (len(offs), 1))
    for row, off in zip(rows, offs):
        for j, v in off.items():
            row[j] = v
    return rows


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_value_and_grad_match(engines, source, method):
    je, te = engines
    for eng in engines:
        _configure(eng, method, source, SOURCES[source][0])
    pb = _points(source)
    gj, dj = je.global_misfits_and_grad(pb)
    gt, dt = te.global_misfits_and_grad(pb)
    assert isinstance(gt, np.ndarray) and gt.dtype == np.float32 and dt.dtype == np.float32
    assert dt.shape == (len(pb), get_source_model(source).nparams)
    _close(gt, np.asarray(gj))
    assert (gt > 1e-3).all()  # off the truth
    # every component, free or not, against the reference
    _close_scaled(dt, np.asarray(dj), _scale(pb, get_source_model(source)))
    # the value is the batch forward's global misfit
    _close(gt, te.global_misfits_for_source_batch(pb).numpy())


@pytest.mark.parametrize("method", sorted(METHODS))
def test_misfit_jacobian_and_covariance_match(engines, monkeypatch, method):
    je, te = engines
    for eng in engines:
        _configure(eng, method)
    p = _points("bilateral")[0]
    mask = np.zeros(p.size, bool)
    mask[[0, 4, 5, 6, 7]] = True
    mj, Jj = (np.asarray(x) for x in je.misfit_jacobian(p, mask=mask))
    mt, Jt = te.misfit_jacobian(p, mask=mask)
    assert mt.dtype == np.float32 and Jt.shape == (mt.size, 5)
    _close(mt, mj)
    scale = _scale(p, get_source_model("bilateral"))[:, mask]
    _close_scaled(Jt, Jj, scale)
    # the rows are those the batch forward gives
    _close(mt, te.misfits_for_source_batch(p[None, :])[0][0].numpy())

    cov_j, s2_j, _ = jinv.covariance(je, mask=mask, params=p)
    monkeypatch.setattr(te, "misfit_jacobian", lambda params, mask=None: (mj, Jj))
    cov_t, s2_t, J_t = tinv.covariance(te, mask=mask, params=p)
    np.testing.assert_allclose(cov_t, np.asarray(cov_j), rtol=1e-12, atol=0)
    assert s2_t == pytest.approx(s2_j, rel=1e-14)
    np.testing.assert_array_equal(J_t, Jj.astype(np.float64))


def test_covariance_counts_enabled_rows(engines):
    """A disabled receiver's rows leave sigma^2's degrees of freedom."""
    je, te = engines
    for eng in engines:
        _configure(eng)
        eng.switch_receiver(1, False)
    try:
        p = _points("bilateral")[0]
        mask = np.zeros(p.size, bool)
        mask[[5, 6]] = True
        cov_j, s2_j, _ = jinv.covariance(je, mask=mask, params=p)
        cov_t, s2_t, Jt = tinv.covariance(te, mask=mask, params=p)
        assert not Jt[3:6].any()  # the disabled receiver's rows
        assert s2_t == pytest.approx(s2_j, rel=1e-4)
        np.testing.assert_allclose(cov_t, np.asarray(cov_j), rtol=1e-3)
    finally:
        for eng in engines:
            eng.switch_receiver(1, True)


def test_multistart_steps_match(engines):
    """Five Adam steps of two starts with strike free: the best rows and
    misfits of each start."""
    je, te = engines
    for eng in engines:
        _configure(eng)
    mask = np.zeros(BILAT.size, bool)
    mask[5] = True
    starts = np.tile(BILAT, (2, 1))
    starts[:, 5] = (75.0, 109.0)
    rj, gj, nj = jinv.minimize_multistart(je, starts, mask=mask, steps=5, lr=0.02)
    rt, gt, nt = tinv.minimize_multistart(te, starts, mask=mask, steps=5, lr=0.02)
    assert nt == nj == 5 and gt.dtype == np.float64
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=1e-4)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-4)
    assert (rt[:, 5] != starts[:, 5]).all()


def test_adam_cosine_matches_optax():
    """CosineAdam against optax.adam(optax.cosine_decay_schedule(lr, steps,
    0.05)) on a fixed gradient sequence, past the decay's end."""
    rng = np.random.default_rng(3)
    lr, steps = 0.03, 12
    x0 = rng.normal(size=(3, 4)).astype(np.float32)
    grads = rng.normal(size=(steps + 4, 3, 4)).astype(np.float32) * np.float32(1e-3)
    grads[5, 1] = 0.0
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, 0.05))
    state = opt.init(x0)
    want = x0
    adam = tgrad.CosineAdam(x0, lr, steps)
    got = x0
    for k, g in enumerate(grads):
        upd, state = opt.update(g, state)
        want = np.asarray(optax.apply_updates(want, upd), np.float32)
        got = adam.step(got, g)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7 * lr)
        assert adam.sched.get_last_lr()[0] == pytest.approx(
            float(optax.cosine_decay_schedule(lr, steps, 0.05)(k + 1)), rel=1e-6)


@pytest.mark.parametrize("source", ["eikonal", "mt_eikonal"])
def test_host_discretized_models_raise(engines, source):
    _je, te = engines
    _configure(te)
    model = get_source_model(source)
    te.set_source_params(source, model.defaults)
    try:
        with pytest.raises(NotImplementedError):
            te.global_misfits_and_grad(model.defaults[None, :])
        with pytest.raises(NotImplementedError):
            te.misfit_jacobian(model.defaults)
    finally:
        te.set_source_params("bilateral", BILAT)


def test_grad_needs_references(engines):
    _je, te = engines
    te.set_receivers(te.receivers)  # clears the references
    with pytest.raises(RuntimeError, match="no reference"):
        te.global_misfits_and_grad(BILAT[None, :])


# -- tests/test_gradient.py's cases on the port, with their bars ------------


def _fd_grad(te):
    p = BILAT.copy()
    p[5], p[6] = 104.0, 80.0
    g, grad = te.global_misfits_and_grad(p[None, :])
    assert g.shape == (1,) and grad.shape == (1, p.size) and np.isfinite(grad).all()
    probes = [(5, 0.25), (6, 0.25), (4, 2e10)]
    rows = []
    for j, h in probes:
        lo, hi = p.copy(), p.copy()
        lo[j] -= h
        hi[j] += h
        rows += [lo, hi]
    gfd = te.global_misfits_for_source_batch(np.stack(rows)).numpy().astype(np.float64)
    for k, (j, h) in enumerate(probes):
        fd = (gfd[2 * k + 1] - gfd[2 * k]) / (2.0 * h)
        assert abs(grad[0, j] - fd) <= 0.08 * max(abs(fd), 1e-12), (j, grad[0, j], fd)


def _zero_at_truth(te):
    g, grad = te.global_misfits_and_grad(BILAT[None, :])
    assert g[0] < 1e-5 and np.isfinite(grad).all()


def _multistart_strike(te):
    mask = np.zeros(BILAT.size, bool)
    mask[5] = True
    starts = np.tile(BILAT, (2, 1))
    starts[:, 5] = (75.0, 109.0)
    g0 = te.global_misfits_for_source_batch(starts).numpy().astype(np.float64)
    best_rows, best_g, nsteps = tinv.minimize_multistart(te, starts, mask=mask, steps=60,
                                                         lr=0.02)
    assert nsteps == 60 and (best_g <= g0 + 1e-12).all()
    k = int(np.argmin(best_g))
    assert abs(float(best_rows[k, 5]) - 91.0) < 3.0, best_rows[:, 5]
    assert best_g[k] < 0.25 * g0.min()


def _floating_fd(te):
    te.set_misfit_method("floating_l1norm")
    te.set_floating_shiftrange(-0.5, 0.5)
    p = BILAT.copy()
    p[5] = 99.0
    _g, grad = te.global_misfits_and_grad(p[None, :])
    assert np.isfinite(grad).all() and abs(grad[0, 5]) > 0
    h = 0.3
    lo, hi = p.copy(), p.copy()
    lo[5] -= h
    hi[5] += h
    gfd = te.global_misfits_for_source_batch(np.stack([lo, hi])).numpy().astype(np.float64)
    fd = (gfd[1] - gfd[0]) / (2.0 * h)
    assert abs(grad[0, 5] - fd) <= 0.15 * max(abs(fd), 1e-12), (grad[0, 5], fd)


def _mt_linear(te):
    true = SOURCES["moment_tensor"][0]
    te.set_source_params("moment_tensor", true)
    te.set_synthetic_reference()
    start = true.copy()
    start[4] *= 1.6
    start[7] *= 0.4
    mask = np.zeros(true.size, bool)
    mask[[4, 7]] = True
    rows, g, _ = tinv.minimize_multistart(te, start[None, :], mask=mask, steps=80, lr=0.03)
    assert g[0] < 0.02, g
    assert abs(rows[0, 4] / true[4] - 1.0) < 0.05
    assert abs(rows[0, 7] / true[7] - 1.0) < 0.05


def _minimize_gradient(te):
    p = BILAT.copy()
    p[5] = 103.0
    te.set_source_params("bilateral", p)
    mask = np.zeros(BILAT.size, bool)
    mask[5] = True
    gm0 = te.get_global_misfit()
    gm, nsteps, nstarts = tinv.minimize_gradient(te, mask=mask, steps=50, lr=0.02, nstarts=3,
                                                 spread=0.05, seed=1)
    assert nstarts == 3 and nsteps == 50
    assert gm < gm0
    assert abs(float(te.source_params[5]) - 91.0) < 4.0


def _jacobian_fd(te):
    p = BILAT.copy()
    p[5] = 99.0
    mask = np.zeros(p.size, bool)
    mask[[4, 5]] = True
    m, J = te.misfit_jacobian(p, mask=mask)
    assert J.shape == (m.size, 2) and np.isfinite(J).all()
    for k, (j, h) in enumerate([(4, 2e10), (5, 0.25)]):
        lo, hi = p.copy(), p.copy()
        lo[j] -= h
        hi[j] += h
        mm = te.misfits_for_source_batch(np.stack([lo, hi]))[0].numpy().astype(np.float64)
        fd = (mm[1] - mm[0]) / (2 * h)
        big = np.abs(fd) > 0.2 * np.abs(fd).max()
        np.testing.assert_allclose(J[big, k], fd[big], rtol=0.1)
    cov, sigma2, _J = tinv.covariance(te, mask=mask, params=p)
    assert cov.shape == (2, 2) and sigma2 > 0 and (np.diag(cov) > 0).all()
    np.testing.assert_allclose(cov, cov.T, rtol=1e-10)
    assert np.linalg.eigvalsh(cov).min() >= -1e-12 * np.abs(cov).max()


CASES = {
    "grad_matches_finite_differences": _fd_grad,
    "grad_finite_at_the_truth": _zero_at_truth,
    "multistart_recovers_strike": _multistart_strike,
    "grad_through_floating_norm": _floating_fd,
    "moment_tensor_linear_recovery": _mt_linear,
    "minimize_gradient_updates_engine": _minimize_gradient,
    "misfit_jacobian_matches_fd_and_covariance": _jacobian_fd,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_case_on_port(engines, case):
    _je, te = engines
    _configure(te)
    CASES[case](te)


def test_engine_minimize_gradient_honours_mask_and_limits(engines):
    """Engine.minimize_gradient takes the mask and limit setters: only the
    free parameters move, and they stay inside the box."""
    _je, te = engines
    _configure(te)
    p = BILAT.copy()
    p[5], p[6] = 97.0, 84.0
    te.set_source_params("bilateral", p)
    mask = np.zeros(p.size, bool)
    mask[[5, 6]] = True
    te.set_source_params_mask(mask)
    te.set_source_subparams_limits([90.0, 83.0], [96.0, 88.0])
    try:
        gm, nsteps, nstarts = te.minimize_gradient(steps=20, lr=0.02, nstarts=2)
        q = te.source_params
        assert (nsteps, nstarts) == (20, 2) and np.isfinite(gm)
        np.testing.assert_array_equal(q[~mask], p[~mask])
        assert 90.0 <= q[5] <= 96.0 and 83.0 <= q[6] <= 88.0
        assert gm <= te.global_misfits_for_source_batch(p[None, :]).numpy()[0]
    finally:
        te.params_mask = te.subparam_mins = te.subparam_maxs = None


def test_grad_finite_at_tiny_amplitudes(engines):
    """Moment-1.0 sessions put misfits near 1e-19: the gradient stays
    finite, nonzero and the reference's."""
    je, te = engines
    truth = BILAT.copy()
    truth[4] = 1.0
    for eng in engines:
        _configure(eng, truth=truth)
    p = truth.copy()
    p[5], p[6] = 104.0, 80.0
    gj, dj = je.global_misfits_and_grad(p[None, :])
    gt, dt = te.global_misfits_and_grad(p[None, :])
    assert float(te.misfits_for_source_batch(p[None, :])[0].abs().max()) < 1e-15
    _close(gt, np.asarray(gj))
    assert np.abs(dt[0, [5, 6]]).min() > 0
    _close_scaled(dt, np.asarray(dj), _scale(p[None, :], get_source_model("bilateral")))
