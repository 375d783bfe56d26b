"""Levenberg-Marquardt (MINPACK lmdif semantics) with batched residuals
(a copy of kiwi_tpu/invert/lmdif.py, which is numpy throughout; the port
cannot import it, since importing kiwi_tpu imports jax).

From-scratch implementation of the published Levenberg-Marquardt algorithm
of More (1978) as shipped in MINPACK `lmdif` (the reference links it as
sminpack/lmdif.f; engine call site minimizer_engine.f90:742-805) with one
structural change for device execution: the residual function is BATCHED --
`fcn_batch(X[k, n]) -> F[k, m]` -- so the forward-difference Jacobian's n
probes are a single device call per iteration instead of n serial ones.
Trial steps within an iteration are inherently sequential (each depends on
the previous ratio) and go through the same batched entry point padded to a
fixed row count.

Semantics preserved from lmdif: forward differences with step
sqrt(max(epsfcn, eps))*|x_j| (fdjac2.f), Householder QR with column
pivoting and norm downdating (qrfac.f), the lmpar trust-region parameter
iteration with Givens-based qrsolv (lmpar.f/qrsolv.f), the exact trust
region update rules, convergence tests and info codes of lmdif.f, and
MINPACK's three-partition `enorm`.

All linear algebra runs on host in float64 (n <= ~20 parameters, m = a few
dozen misfits -- microseconds); the device time is entirely inside
fcn_batch.
"""

from __future__ import annotations

import numpy as np

_EPS = float(np.finfo(np.float64).eps)
_DWARF = float(np.finfo(np.float64).tiny)


def enorm(v):
    """Euclidean norm with MINPACK's over/underflow partitioning (enorm.f).

    Sums are accumulated in three ranges (small/intermediate/large) so that
    the norm of vectors with entries near the over/underflow limits is
    computed without spurious inf/0.  For ordinary magnitudes this equals
    sqrt(sum(v**2)) in exact arithmetic.
    """
    v = np.asarray(v, dtype=np.float64)
    if v.size == 0:
        return 0.0
    agiant = 1.304e19 / max(v.size, 1)
    rdwarf = 3.834e-20
    a = np.abs(v)
    big = a > agiant
    small = (a <= rdwarf) & ~big
    mid = ~big & ~small
    s_mid = float((a[mid] ** 2).sum())
    n1 = 0.0
    if big.any():
        x1max = float(a[big].max())
        n1 = x1max * np.sqrt(float(((a[big] / x1max) ** 2).sum()))
    n3 = 0.0
    if small.any():
        x3max = float(a[small].max())
        if x3max > 0:
            n3 = x3max * np.sqrt(float(((a[small] / x3max) ** 2).sum()))
    if n1 > 0.0:
        return float(n1 * np.sqrt(1.0 + (np.sqrt(s_mid) / n1) ** 2)) if s_mid > 0 else n1
    if s_mid > 0.0:
        m = np.sqrt(s_mid)
        return float(np.sqrt(s_mid) * np.sqrt(1.0 + (n3 / m) ** 2)) if n3 > 0 else float(m)
    return float(n3)


def qrfac(a):
    """Householder QR with column pivoting and norm downdating (qrfac.f).

    a: [m, n] (overwritten copy).  Returns (a, ipvt, rdiag, acnorm) where
    a's strict upper triangle + rdiag hold R, the lower trapezoid holds the
    Householder vectors, ipvt the pivot permutation (a[:, ipvt] was
    factored), acnorm the original column norms.
    """
    a = np.array(a, dtype=np.float64)
    m, n = a.shape
    acnorm = np.array([enorm(a[:, j]) for j in range(n)])
    rdiag = acnorm.copy()
    wa = rdiag.copy()
    ipvt = np.arange(n)
    minmn = min(m, n)
    for j in range(minmn):
        # pivot: bring the column of largest downdated norm into position j
        kmax = j + int(np.argmax(rdiag[j:]))
        if kmax != j:
            a[:, [j, kmax]] = a[:, [kmax, j]]
            rdiag[kmax] = rdiag[j]
            wa[kmax] = wa[j]
            ipvt[[j, kmax]] = ipvt[[kmax, j]]
        ajnorm = enorm(a[j:, j])
        if ajnorm != 0.0:
            if a[j, j] < 0.0:
                ajnorm = -ajnorm
            a[j:, j] /= ajnorm
            a[j, j] += 1.0
            for k in range(j + 1, n):
                temp = float(a[j:, j] @ a[j:, k]) / a[j, j]
                a[j:, k] -= temp * a[j:, j]
                if rdiag[k] != 0.0:
                    temp = a[j, k] / rdiag[k]
                    rdiag[k] *= np.sqrt(max(0.0, 1.0 - temp * temp))
                    if 0.05 * (rdiag[k] / wa[k]) ** 2 <= _EPS:
                        rdiag[k] = enorm(a[j + 1:, k])
                        wa[k] = rdiag[k]
        rdiag[j] = -ajnorm
    return a, ipvt, rdiag, acnorm


def qrsolv(r, ipvt, diag, qtb):
    """Solve the augmented least-squares system of lmpar (qrsolv.f).

    Given R (upper triangle of r, [n, n]), permutation ipvt, diagonal D and
    Q^T b, determine x minimizing ||A x - b||^2 + ||D x||^2 via Givens
    rotations.  Returns (x, sdiag, s): sdiag is the diagonal of the rotated
    upper-triangular S and s its full upper triangle (MINPACK's qrsolv
    stores S's strict upper triangle back into r for lmpar's Newton
    correction; we return it instead of mutating the caller's array).
    """
    n = r.shape[1]
    s = np.triu(r[:n, :n]).copy()
    # store r's diagonal for restoration; MINPACK keeps it in a register
    x = np.zeros(n)
    wa = np.array(qtb[:n], dtype=np.float64)
    sdiag = np.zeros(n)
    for j in range(n):
        l = ipvt[j]
        if diag[l] != 0.0:
            sd = np.zeros(n)
            sd[j] = diag[l]
            qtbpj = 0.0
            for k in range(j, n):
                if sd[k] == 0.0:
                    continue
                if abs(s[k, k]) < abs(sd[k]):
                    cotan = s[k, k] / sd[k]
                    sin = 0.5 / np.sqrt(0.25 + 0.25 * cotan * cotan)
                    cos = sin * cotan
                else:
                    tan = sd[k] / s[k, k]
                    cos = 0.5 / np.sqrt(0.25 + 0.25 * tan * tan)
                    sin = cos * tan
                s[k, k] = cos * s[k, k] + sin * sd[k]
                temp = cos * wa[k] + sin * qtbpj
                qtbpj = -sin * wa[k] + cos * qtbpj
                wa[k] = temp
                if k + 1 < n:
                    row = s[k, k + 1:].copy()
                    tail = sd[k + 1:].copy()
                    s[k, k + 1:] = cos * row + sin * tail
                    sd[k + 1:] = -sin * row + cos * tail
        sdiag[j] = s[j, j]
    # solve S z = wa (S upper triangular with diagonal sdiag), singular-aware
    nsing = n
    for j in range(n):
        if sdiag[j] == 0.0 and nsing == n:
            nsing = j
    wa[nsing:] = 0.0
    z = np.zeros(n)
    for j in range(nsing - 1, -1, -1):
        acc = float(s[j, j + 1: nsing] @ z[j + 1: nsing]) if j + 1 < nsing else 0.0
        z[j] = (wa[j] - acc) / sdiag[j]
    x[ipvt] = z
    return x, sdiag, s


def lmpar(r, ipvt, diag, qtb, delta, par0):
    """Trust-region parameter iteration (lmpar.f).

    Finds par >= 0 and x solving (A^T A + par D^2) x = A^T b such that
    ||D x|| is within 10% of delta (or par = 0 if the Gauss-Newton step
    fits).  r holds R in its upper triangle.  Returns (par, x).
    """
    n = r.shape[1]
    R = np.triu(r[:n, :n])
    # Gauss-Newton direction, rank-aware
    nsing = n
    wa1 = np.array(qtb[:n], dtype=np.float64)
    for j in range(n):
        if R[j, j] == 0.0 and nsing == n:
            nsing = j
    wa1[nsing:] = 0.0
    for j in range(nsing - 1, -1, -1):
        wa1[j] /= R[j, j]
        wa1[:j] -= R[:j, j] * wa1[j]
    x = np.zeros(n)
    x[ipvt] = wa1

    dxnorm = enorm(diag * x)
    fp = dxnorm - delta
    if fp <= 0.1 * delta:
        return 0.0, x

    # lower bound on par from the Newton step of phi at par = 0
    parl = 0.0
    if nsing >= n:
        wa1 = diag[ipvt] * (diag[ipvt] * x[ipvt]) / dxnorm
        # solve R^T w = wa1 (forward substitution)
        w = wa1.copy()
        for j in range(n):
            w[j] /= R[j, j]
            w[j + 1:] -= R[j, j + 1:] * w[j]
        temp = enorm(w)
        parl = (fp / delta) / temp / temp

    # upper bound: ||(R^T qtb) / D|| / delta (the gradient direction)
    wa1 = np.array([float(R[: j + 1, j] @ qtb[: j + 1]) / diag[ipvt[j]]
                    for j in range(n)])
    gnorm = enorm(wa1)
    paru = gnorm / delta
    if paru == 0.0:
        paru = _DWARF / min(delta, 0.1)

    par = min(max(par0, parl), paru)
    if par == 0.0:
        par = gnorm / dxnorm

    for _it in range(10):
        if par == 0.0:
            par = max(_DWARF, 0.001 * paru)
        x, sdiag, S = qrsolv(r, ipvt, np.sqrt(par) * diag, qtb)
        dxnorm = enorm(diag * x)
        temp = fp
        fp = dxnorm - delta
        if (abs(fp) <= 0.1 * delta
                or (parl == 0.0 and fp <= temp and temp < 0.0)):
            return par, x
        # Newton correction on phi(par): forward substitution on S^T
        # (lmpar.f:199-211; S is nonsingular for par > 0 with diag > 0, but
        # zero Jacobian columns give diag == 0 in mode 1 -- treat those rows
        # as rank-deficient like qrsolv's own solve does)
        wa1 = diag[ipvt] * (diag[ipvt] * x[ipvt]) / dxnorm
        for j in range(n):
            wa1[j] = wa1[j] / sdiag[j] if sdiag[j] != 0.0 else 0.0
            if j + 1 < n:
                wa1[j + 1:] -= S[j, j + 1:] * wa1[j]
        temp = enorm(wa1)
        parc = (fp / delta) / temp / temp
        if fp > 0.0:
            parl = max(parl, par)
        elif fp < 0.0:
            paru = min(paru, par)
        par = max(parl, par + parc)
    return par, x


def lmdif(fcn_batch, x0, ftol, xtol, gtol=0.0, maxfev=None, epsfcn=0.0,
          factor=100.0, diag=None):
    """Minimize sum of squares of fcn(x) with a batched forward model.

    fcn_batch: X[k, n] -> F[k, m]; called with k = n + 1 rows every time
    (Jacobian probes, or a trial step padded with repeats).
    Returns (x, fvec, info, nfev) with lmdif.f's info codes:
    1 ftol, 2 xtol, 3 both, 4 gtol, 5 maxfev, 6/7/8 tolerance-too-small.
    """
    x = np.array(x0, dtype=np.float64)
    n = x.size
    if maxfev is None:
        maxfev = 200 * (n + 1)
    mode2 = diag is not None
    diag = np.array(diag, dtype=np.float64) if mode2 else np.ones(n)

    def call_rows(rows):
        """Evaluate a list of parameter vectors, padded to n + 1 rows."""
        k = len(rows)
        X = np.stack(rows + [rows[-1]] * (n + 1 - k))
        F = np.asarray(fcn_batch(X), dtype=np.float64)
        return [F[i] for i in range(k)]

    (fvec,) = call_rows([x])
    nfev = 1
    m = fvec.size
    fnorm = enorm(fvec)

    eps_j = np.sqrt(max(epsfcn, _EPS))
    par = 0.0
    it = 1
    info = 0

    while info == 0:
        # ---- forward-difference Jacobian (fdjac2.f), one batched call ----
        hs = np.where(np.abs(x) > 0, eps_j * np.abs(x), eps_j)
        probes = []
        for j in range(n):
            xp = x.copy()
            xp[j] += hs[j]
            probes.append(xp)
        fprobe = call_rows(probes)
        nfev += n
        fjac = np.stack([(fp - fvec) / hs[j] for j, fp in enumerate(fprobe)], axis=1)

        a, ipvt, rdiag, acnorm = qrfac(fjac)
        if it == 1:
            if not mode2:
                diag = np.where(acnorm == 0.0, 1.0, acnorm)
            xnorm = enorm(diag * x)
            delta = factor * xnorm if xnorm != 0.0 else factor

        # qtf = first n components of Q^T fvec (apply Householders)
        wa4 = fvec.copy()
        for j in range(min(m, n)):
            if a[j, j] != 0.0:
                temp = float(a[j:, j] @ wa4[j:]) / a[j, j]
                wa4[j:] -= temp * a[j:, j]
        qtf = wa4[:n].copy()
        R = np.zeros((n, n))
        for j in range(n):
            R[: j, j] = a[: j, j] if j <= m else 0.0
            R[j, j] = rdiag[j] if j < min(m, n) else 0.0

        # gradient norm test
        gnorm = 0.0
        if fnorm != 0.0:
            for j in range(n):
                l = ipvt[j]
                if acnorm[l] != 0.0:
                    s = float(R[: j + 1, j] @ (qtf[: j + 1] / fnorm))
                    gnorm = max(gnorm, abs(s / acnorm[l]))
        if gnorm <= gtol:
            info = 4
            break
        if not mode2:
            diag = np.maximum(diag, acnorm)

        # ---- inner loop: trial steps until one is accepted ----
        while True:
            par, p = lmpar(R, ipvt, diag, qtf, delta, par)
            p = -p
            wa2 = x + p
            pnorm = enorm(diag * p)
            if it == 1:
                delta = min(delta, pnorm)
            (trial,) = call_rows([wa2])
            nfev += 1
            fnorm1 = enorm(trial)

            actred = -1.0
            if 0.1 * fnorm1 < fnorm:
                actred = 1.0 - (fnorm1 / fnorm) ** 2
            # predicted reduction: ||R P^T p|| and sqrt(par)*pnorm
            pj = np.array([-p[ipvt[j]] for j in range(n)])
            Rp = np.triu(R) @ pj
            temp1 = enorm(Rp) / fnorm if fnorm != 0.0 else 0.0
            temp2 = (np.sqrt(par) * pnorm) / fnorm if fnorm != 0.0 else 0.0
            prered = temp1 * temp1 + temp2 * temp2 / 0.5
            dirder = -(temp1 * temp1 + temp2 * temp2)
            ratio = actred / prered if prered != 0.0 else 0.0

            if ratio <= 0.25:
                temp = 0.5 if actred >= 0.0 else 0.5 * dirder / (dirder + 0.5 * actred)
                if 0.1 * fnorm1 >= fnorm or temp < 0.1:
                    temp = 0.1
                delta = temp * min(delta, 10.0 * pnorm)
                par /= temp
            elif par == 0.0 or ratio >= 0.75:
                delta = 2.0 * pnorm
                par *= 0.5

            if ratio >= 1e-4:  # successful step
                x = wa2
                fvec = trial
                xnorm = enorm(diag * x)
                fnorm = fnorm1
                it += 1

            # convergence tests (lmdif.f:340-357)
            c_ftol = abs(actred) <= ftol and prered <= ftol and 0.5 * ratio <= 1.0
            c_xtol = delta <= xtol * xnorm
            if c_ftol and c_xtol:
                info = 3
            elif c_ftol:
                info = 1
            elif c_xtol:
                info = 2
            if info != 0:
                break
            if nfev >= maxfev:
                info = 5
            elif abs(actred) <= _EPS and prered <= _EPS and 0.5 * ratio <= 1.0:
                info = 6
            elif delta <= _EPS * xnorm:
                info = 7
            elif gnorm <= _EPS:
                info = 8
            if info != 0:
                break
            if ratio >= 1e-4:
                break  # accepted: back to outer loop for a fresh Jacobian
        # inner loop ended
    return x, fvec, info, nfev
