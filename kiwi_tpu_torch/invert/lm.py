"""Levenberg-Marquardt refinement with the reference's lmdif semantics
(port of kiwi_tpu/invert/lm.py).

Counterpart of minimize_lm (minimizer_engine.f90:729-874 + sminpack/lmdif.f):
minimize the vector of per-(receiver, component) misfits over a masked,
*normalized* subset of source parameters, with a forward-difference Jacobian
and a penalty clip to box limits.

The MINPACK lmdif algorithm itself is provided by scipy.optimize.leastsq
(the same published algorithm the reference links as sminpack); we pass the
reference's exact control parameters: ftol = xtol = sqrt(single-precision
machine eps) (minimizer_engine.f90:773), gtol = 0, maxfev = 500*(n+1),
factor = 0.01, unit diag with mode 2, and epsfcn = f32 machine eps so the
forward-difference steps match a single-precision forward model
(lmdif uses max(epsfcn, eps_machine); the reference's forward pass is f32).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import leastsq

from ..profiling import span, to_host

F32_EPS = float(np.finfo(np.float32).eps)


def shape_buckets(model, effective_dt, rows):
    """Yield (sel, rows[sel]) per distinct discretization grid shape.

    Probe/start rows can straddle a grid-shape boundary (a step on a
    geometry parameter quantizes to a different grid), and one batch takes
    one shape.  The JAX package pads each bucket to k rows to keep one
    compiled program per shape; the port compiles nothing per shape, so a
    bucket holds its own rows only.  Each row's misfits do not depend on
    the rows beside it (tests/test_torch_invert.py holds a lone row against
    the JAX package's padded bucket)."""
    shapes = [model.grid_shape(r, effective_dt) for r in rows]
    for shp in sorted(set(shapes)):
        sel = np.array([i for i, s in enumerate(shapes) if s == shp])
        yield sel, rows[sel]


def minimize_lm(engine, mask=None, subparam_mins=None, subparam_maxs=None,
                method="batched"):
    """Refine engine.source_params in place.

    mask: bool array over params (default: all True -- the reference
    requires set_source_params_mask first; here all-free is a usable
    default); subparam_mins/maxs: optional box limits in *unnormalized*
    units (minimizer commands set_source_subparams_limits).

    method: "batched" (default) runs the from-scratch lmdif in
    kiwi_tpu_torch.invert.lmdif, whose forward-difference Jacobian probes
    reach the device as ONE misfits_for_source_batch call per iteration
    (n rows; lmdif's repeats of a last row, which pad every call to n+1,
    are evaluated once, so a trial step is one row); "scipy" keeps the compiled-MINPACK path with
    one-source-per-call forwards for cross-checking.  Each call's misfits
    come back to the host in one copy.

    Returns (info, nfev, final_global_misfit).
    """
    with span("kiwi.invert.lm"):
        return _minimize_lm(engine, mask, subparam_mins, subparam_maxs, method)


def _minimize_lm(engine, mask, subparam_mins, subparam_maxs, method):
    from ..sources import get_source_model

    model = get_source_model(engine.source_type)
    params = engine.source_params.astype(np.float64).copy()
    norm = model.norm.astype(np.float64)
    if mask is None:
        mask = np.ones(model.nparams, dtype=bool)
    mask = np.asarray(mask, dtype=bool)
    idx = np.flatnonzero(mask)
    sub_norm = norm[idx]
    n = idx.size
    tol = float(np.sqrt(F32_EPS))

    def clip_penalty(sub):
        """lm_forward_step's box-limit penalty clip
        (minimizer_engine.f90:822-844)."""
        penalty = 0.0
        if subparam_mins is not None and subparam_maxs is not None:
            mins = np.asarray(subparam_mins, dtype=np.float64)
            maxs = np.asarray(subparam_maxs, dtype=np.float64)
            un = sub * sub_norm
            below = un < mins
            above = un > maxs
            penalty = (
                np.abs(un[below] - mins[below]) / np.abs(maxs[below] - mins[below])
            ).sum() + (
                np.abs(un[above] - maxs[above]) / np.abs(maxs[above] - mins[above])
            ).sum()
            un = np.clip(un, mins, maxs)
            sub = un / sub_norm
        return sub, penalty

    sub0 = params[idx] / sub_norm

    if method == "batched":
        from .lmdif import lmdif

        nfev = [0]

        def fcn_batch(X):
            k = X.shape[0]
            rows = np.tile(params.astype(np.float32), (k, 1))
            penalties = np.zeros(k)
            for i in range(k):
                sub, pen = clip_penalty(np.asarray(X[i], dtype=np.float64))
                rows[i, idx] = (sub * sub_norm).astype(np.float32)
                penalties[i] = pen
            # lmdif pads a trial step to k rows with repeats of its last
            # row: evaluate that row once
            u = k
            while u > 1 and (rows[u - 1] == rows[u - 2]).all():
                u -= 1
            out = None
            for sel, rb in shape_buckets(model, engine.effective_dt, rows[:u]):
                m, _n, _fs = engine.misfits_for_source_batch(rb)
                m = to_host(m)[0].astype(np.float64)
                if out is None:
                    out = np.zeros((k, m.shape[1]))
                out[sel] = m
            out[u:] = out[u - 1]
            nfev[0] += k
            return out * (1.0 + penalties)[:, None]

        sub, _fvec, ier, _nf = lmdif(
            fcn_batch, sub0, ftol=tol, xtol=tol, gtol=0.0,
            maxfev=500 * (n + 1), epsfcn=F32_EPS, factor=0.01,
            diag=np.ones(n),
        )
        nfev_total = nfev[0]
    else:
        nfev = [0]

        def residuals(sub):
            sub, penalty = clip_penalty(np.asarray(sub, dtype=np.float64))
            p = params.copy()
            p[idx] = sub * sub_norm
            m, _n, _fs = engine.misfits_for_source_batch(
                p.astype(np.float32)[None, :]
            )
            nfev[0] += 1
            return to_host(m[0])[0].astype(np.float64) * (1.0 + penalty)

        sub, _cov, infodict, _mesg, ier = leastsq(
            residuals,
            sub0,
            full_output=True,
            ftol=tol,
            xtol=tol,
            gtol=0.0,
            maxfev=500 * (n + 1),
            epsfcn=F32_EPS,
            factor=0.01,
            diag=np.ones(n),
        )
        nfev_total = nfev[0]
    if ier == 8:
        ier = 4  # mirror minimizer_engine.f90:799

    params[idx] = np.asarray(sub) * sub_norm
    engine.set_source_params(engine.source_type, params.astype(np.float32))
    gm = engine.get_global_misfit()
    return ier, nfev_total, gm
