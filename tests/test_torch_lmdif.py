"""kiwi_tpu_torch.invert.lmdif against kiwi_tpu.invert.lmdif.

Both are float64 numpy, so the port's copy must give the same numbers bit
for bit: enorm, qrfac, qrsolv and lmpar on seeded inputs, and whole lmdif
runs (iterate, residuals, info code, nfev and every batch shape that
reaches fcn_batch) on tests/test_lmdif.py's problems.
"""

import numpy as np
import pytest

from kiwi_tpu.invert import lmdif as J
from kiwi_tpu_torch.invert import lmdif as T

F32_EPS = float(np.finfo(np.float32).eps)


def problem(case):
    """(residual function, x0) of tests/test_lmdif.py's cases."""
    rng = np.random.default_rng(7)
    if case == "rosenbrock":
        def f(x):
            return np.array([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])
        return f, np.array([-1.2, 1.0])
    if case == "exp_fit":
        t = np.linspace(0, 1, 25)
        y = 2.5 * np.exp(-1.3 * t) + 0.4 + 0.01 * rng.normal(size=25)

        def f(x):
            return x[0] * np.exp(-x[1] * t) + x[2] - y
        return f, np.array([1.0, 1.0, 0.0])
    if case == "exp_decay":  # test_lmdif_batches_jacobian_probes
        t = np.linspace(0, 1, 30)
        y = 1.7 * np.exp(-2.2 * t) + 0.1

        def f(x):
            return x[0] * np.exp(-x[1] * t) + x[2] - y
        return f, np.array([1.0, 1.0, 0.0])
    A = rng.normal(size=(12, 4))
    b = rng.normal(size=12)

    def f(x):
        return A @ x - b
    return f, np.zeros(4)


@pytest.mark.parametrize("scale", [0.0, 1e-30, 1.0, 1e15, 1e170])
def test_enorm_equals_reference(scale):
    v = np.random.default_rng(0).normal(size=13) * scale
    assert T.enorm(v) == J.enorm(v)


@pytest.mark.parametrize("shape", [(9, 5), (6, 6), (30, 3)])
def test_qrfac_qrsolv_lmpar_equal_reference(shape):
    rng = np.random.default_rng(shape[0])
    A = rng.normal(size=shape)
    got, want = T.qrfac(A.copy()), J.qrfac(A.copy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    a, ipvt, rdiag, _acnorm = want
    n = shape[1]
    r = np.triu(a[:n, :n], 1) + np.diag(rdiag)
    diag = rng.uniform(0.5, 2.0, n)
    qtb = rng.normal(size=n)
    for g, w in zip(T.qrsolv(r.copy(), ipvt, diag, qtb), J.qrsolv(r.copy(), ipvt, diag, qtb)):
        np.testing.assert_array_equal(g, w)
    for delta in (1e-3, 0.1, 10.0):
        for g, w in zip(T.lmpar(r.copy(), ipvt, diag, qtb, delta, 0.0),
                        J.lmpar(r.copy(), ipvt, diag, qtb, delta, 0.0)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["rosenbrock", "exp_fit", "linear", "exp_decay"])
@pytest.mark.parametrize("kind", ["f64", "f32_steps"])
def test_lmdif_equals_reference(case, kind):
    """The reference's settings of tests/test_lmdif.py (f64 tolerances,
    factor 100) and minimize_lm's (f32 tolerances and steps, factor 0.01,
    unit diag, mode 2)."""
    f, x0 = problem(case)
    if kind == "f64":
        tol = float(np.sqrt(np.finfo(np.float64).eps))
        kw = dict(ftol=tol, xtol=tol, gtol=0.0, maxfev=2000, factor=100.0)
    else:
        tol = float(np.sqrt(F32_EPS))
        kw = dict(ftol=tol, xtol=tol, gtol=0.0, maxfev=500 * (x0.size + 1), epsfcn=F32_EPS,
                  factor=0.01, diag=np.ones(x0.size))
    runs = []
    for mod in (T, J):
        shapes = []

        def fcn_batch(X, shapes=shapes):
            shapes.append(X.shape)
            return np.stack([f(x) for x in X])

        runs.append((mod.lmdif(fcn_batch, x0.copy(), **kw), shapes))
    (xt, ft, it, nt), st = runs[0]
    (xj, fj, ij, nj), sj = runs[1]
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(ft, fj)
    assert (it, nt) == (ij, nj)
    assert it in (1, 2, 3, 4)
    assert st == sj and set(st) == {(x0.size + 1, x0.size)}
