"""Gradient-based source inversion: autodiff through the port's misfit
engine (port of kiwi_tpu/invert/gradient.py).

No counterpart in the reference Fortran stack, whose only smooth optimizer
is lmdif over forward-difference Jacobians (minimizer_engine.f90:729-874).
Here Engine.global_misfits_and_grad returns d(global misfit)/d(every
parameter) for a whole batch of starts by one backward pass through the
plain-torch formulation, so B starts descend together, one engine call per
step.

`minimize_multistart` runs projected Adam on a per-parameter normalized
scale: torch.optim.Adam (betas 0.9, 0.999, eps 1e-8) under a cosine decay
of the learning rate to 5% over `steps` updates, which is what the JAX
package's optax.adam(optax.cosine_decay_schedule(lr, steps, 0.05))
computes.  The iterate is kept in float64 on the host, projected into the
box after every step, and cast to float32 for each update, as there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["minimize_multistart", "minimize_gradient", "covariance"]

ALPHA = 0.05  # the cosine decay's floor, a fraction of lr


class CosineAdam:
    """torch.optim.Adam under optax.cosine_decay_schedule(lr, steps, ALPHA)
    on a float32 iterate [B, n]: the k-th update (k = 0 first) takes
    lr * ((1 - ALPHA) * (1 + cos(pi * min(k, steps) / steps)) / 2 + ALPHA).
    step(x, grad) applies one update to x and returns the new iterate (host
    float32 arrays)."""

    def __init__(self, x0, lr, steps):
        steps = max(int(steps), 1)
        self.x = torch.tensor(np.asarray(x0, np.float32))
        self.opt = torch.optim.Adam([self.x], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, lambda k: (
            (1.0 - ALPHA) * 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps)) + ALPHA))

    def step(self, x, grad):
        with torch.no_grad():
            self.x.copy_(torch.as_tensor(np.asarray(x, np.float32)))
        self.x.grad = torch.as_tensor(np.asarray(grad, np.float32))
        self.opt.step()
        self.sched.step()
        return self.x.detach().numpy().copy()


def minimize_multistart(engine, p0_batch, mask=None, mins=None, maxs=None,
                        steps=150, lr=0.03, tol=0.0, mesh=None):
    """Descend B starting parameter vectors in parallel.

    p0_batch: f32[B, nparams] starting points.
    mask: bool[nparams], True = free (default all free).
    mins/maxs: optional box limits over the free subparams, unnormalized
        (minimize_lm's convention); iterates are projected into the box
        after every step.
    steps / lr: Adam iterations and learning rate on the normalized scale:
        each free parameter over the largest |start| of the batch, or 1% of
        model.norm where every start is 0 (Adam moves about lr scale units
        a step whatever the gradient's size, so the scale follows the
        parameter, not its norm column).
    tol: stop when the best global misfit improves by less than tol over
        10 steps (0 = run all steps).
    mesh: a parallel.make_mesh mesh: each step's starts are split over its
        "s" axis (Engine.global_misfits_and_grad(mesh=)); every rank then
        holds every start's (g, grad) and runs the same host Adam, so all
        ranks return the same result.  Call it on every rank.

    Returns (best_params f32[B, nparams], best_g f64[B], nsteps): the best
    iterate of each start, so that every basin keeps its solution.
    """
    from ..sources import get_source_model
    from .lm import shape_buckets

    model = get_source_model(engine.source_type)
    rows = np.atleast_2d(np.asarray(p0_batch, dtype=np.float32)).copy()
    b = rows.shape[0]
    norm = model.norm.astype(np.float64)
    if mask is None:
        mask = np.ones(model.nparams, dtype=bool)
    idx = np.flatnonzero(np.asarray(mask, dtype=bool))
    start_mag = np.abs(rows[:, idx].astype(np.float64)).max(axis=0)
    sub_norm = np.where(start_mag > 0.0, start_mag, 0.01 * norm[idx])

    lo = None if mins is None else np.asarray(mins, np.float64) / sub_norm
    hi = None if maxs is None else np.asarray(maxs, np.float64) / sub_norm

    def project(x):
        if lo is not None:
            x = np.maximum(x, lo)
        if hi is not None:
            x = np.minimum(x, hi)
        return x

    def eval_batch(full_rows):
        """g, grad, one engine call per discretization grid shape (a free
        geometry parameter can move starts onto different grids)."""
        g = np.zeros(b)
        grad = np.zeros((b, model.nparams))
        for sel, rb in shape_buckets(model, engine.effective_dt, full_rows):
            g[sel], grad[sel] = engine.global_misfits_and_grad(rb, mesh=mesh)
        return g, grad

    x = project(rows[:, idx].astype(np.float64) / sub_norm)
    # the cosine decay: a constant-lr endgame oscillates across the coupled
    # strike/dip valleys; decaying to 5% of lr converges instead
    adam = CosineAdam(x, lr, steps)

    best_g = np.full(b, np.inf)
    best_rows = rows.copy()
    last_best = np.inf
    nsteps = 0
    for step in range(steps):
        rows[:, idx] = (x * sub_norm).astype(np.float32)
        g, grad = eval_batch(rows)
        improved = g < best_g
        best_g[improved] = g[improved]
        best_rows[improved] = rows[improved]
        nsteps = step + 1
        if tol > 0.0 and step % 10 == 9:
            cur = float(best_g.min())
            if last_best - cur < tol:
                break
            last_best = cur
        # chain rule to the normalized scale: dG/dx = dG/dp * scale
        sub_grad = (grad[:, idx] * sub_norm).astype(np.float32)
        # a non-finite gradient row (a kink the guards do not cover) must
        # not freeze the whole batch: zero it, keep descending the rest
        sub_grad = np.where(np.isfinite(sub_grad), sub_grad, 0.0).astype(np.float32)
        x = project(adam.step(x, sub_grad).astype(np.float64))
    return best_rows, best_g, nsteps


def covariance(engine, mask=None, params=None):
    """Linearized least-squares parameter covariance at `params` (default:
    the engine's current source): cov = sigma^2 (J^T J)^-1, J the autodiff
    Jacobian of the misfit rows minimize_lm minimizes, sigma^2 = sum m^2 /
    (enabled rows - free parameters).  The pseudo-inverse stands in where
    J^T J is singular (a parameter the data do not constrain).

    Returns (cov [n_free, n_free], sigma2, J [RC, n_free])."""
    from ..sources import get_source_model

    model = get_source_model(engine.source_type)
    if params is None:
        params = engine.source_params
    if mask is None:
        mask = np.ones(model.nparams, dtype=bool)
    idx = np.flatnonzero(np.asarray(mask, dtype=bool))

    m, J = engine.misfit_jacobian(params, mask=mask)
    m = m.astype(np.float64)
    J = J.astype(np.float64)
    # degrees of freedom count enabled rows only: a disabled receiver's rows
    # are exact zeros and would deflate sigma^2
    n_rows = sum(1 for irec, _c in engine._rc_layout() if engine.receivers[irec].enabled)
    dof = max(n_rows - idx.size, 1)
    sigma2 = float((m * m).sum() / dof)
    jtj = J.T @ J
    try:
        cov = sigma2 * np.linalg.inv(jtj)
    except np.linalg.LinAlgError:
        cov = sigma2 * np.linalg.pinv(jtj)
    return cov, sigma2, J


def minimize_gradient(engine, mask=None, subparam_mins=None, subparam_maxs=None,
                      steps=150, lr=0.03, nstarts=1, spread=0.1, seed=0):
    """Refine engine.source_params in place by multi-start gradient descent
    (the autodiff sibling of invert.minimize_lm).

    nstarts > 1 scatters extra starts around the current source, each free
    subparam moved uniformly within +-spread scale units (the start's
    magnitude, or 1% of model.norm where it is 0), clipped to the box; all
    starts descend together.

    Returns (best_global_misfit, nsteps, nstarts).
    """
    from ..sources import get_source_model

    model = get_source_model(engine.source_type)
    p0 = engine.source_params.astype(np.float32)
    if mask is None:
        mask = np.ones(model.nparams, dtype=bool)
    idx = np.flatnonzero(np.asarray(mask, dtype=bool))

    rows = np.tile(p0, (int(nstarts), 1))
    if nstarts > 1:
        rng = np.random.default_rng(seed)
        mag = np.abs(p0.astype(np.float64)[idx])
        scale = np.where(mag > 0.0, mag, 0.01 * model.norm.astype(np.float64)[idx])
        jitter = rng.uniform(-spread, spread, size=(nstarts - 1, idx.size))
        rows[1:, idx] = (rows[1:, idx].astype(np.float64) + jitter * scale).astype(np.float32)
        if subparam_mins is not None:
            rows[1:, idx] = np.maximum(rows[1:, idx], subparam_mins)
        if subparam_maxs is not None:
            rows[1:, idx] = np.minimum(rows[1:, idx], subparam_maxs)

    best_rows, best_g, nsteps = minimize_multistart(
        engine, rows, mask=mask, mins=subparam_mins, maxs=subparam_maxs, steps=steps, lr=lr)
    k = int(np.argmin(best_g))
    engine.set_source_params(engine.source_type, best_rows[k])
    return float(best_g[k]), nsteps, int(nstarts)
