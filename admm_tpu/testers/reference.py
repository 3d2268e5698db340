"""Plain NumPy float64 references, independent of the JAX code under test.

``lasso_admm_f64`` is the reference's serial LASSO iteration
(solvers/lasso.m:160-177, getProxOps.m:1192-1206): a cached Cholesky
x-update (Woodbury for fat D), soft-threshold z-update and scaled dual
update, stopped by Boyd's primal/dual residual rule.
"""

from __future__ import annotations

import numpy as np


def lasso_admm_f64(D, s, lam, rho=1.0, abstol=1e-12, reltol=1e-10,
                   maxiters=100000):
    """Solve  min 1/2||D x - s||^2 + lam ||x||_1  in float64 on the host.

    Returns ``(z, iters)``: the sparse iterate and the iterations run.
    ``abstol = reltol = 0`` runs exactly ``maxiters`` iterations.
    """
    import scipy.linalg as sla

    D = np.asarray(D, np.float64)
    s = np.asarray(s, np.float64)
    m, n = D.shape
    Dts = D.T @ s
    fat = m < n
    G = D @ D.T / rho + np.eye(m) if fat else D.T @ D + rho * np.eye(n)
    cho = sla.cho_factor(G, lower=True)
    x = np.zeros(n)
    z = np.zeros(n)
    u = np.zeros(n)
    t = lam / rho
    k = 0
    while k < maxiters:
        k += 1
        y = Dts + rho * (z - u)
        if fat:
            # (D^T D + rho I)^-1 y by the matrix-inversion lemma.
            x = y / rho - D.T @ sla.cho_solve(cho, D @ y) / rho**2
        else:
            x = sla.cho_solve(cho, y)
        zold = z
        v = x + u
        z = np.sign(v) * np.maximum(np.abs(v) - t, 0.0)
        u = u + x - z
        pnorm = np.linalg.norm(x - z)
        dnorm = rho * np.linalg.norm(z - zold)
        perr = np.sqrt(n) * abstol + reltol * max(np.linalg.norm(x),
                                                  np.linalg.norm(z))
        derr = np.sqrt(n) * abstol + reltol * rho * np.linalg.norm(u)
        if pnorm <= perr and dnorm <= derr:
            break
    return z, k


def lasso_objective(D, s, lam, x):
    """1/2||D x - s||^2 + lam ||x||_1 in float64."""
    D = np.asarray(D, np.float64)
    x = np.asarray(x, np.float64)
    r = D @ x - np.asarray(s, np.float64)
    return 0.5 * float(r @ r) + lam * float(np.sum(np.abs(x)))


def qp_standard_admm_f64(P, Q, D, S, rho=1.0, abstol=1e-12, reltol=1e-10,
                         maxiters=100000):
    """Solve  min 1/2 x'Px + q'x  s.t.  D x = s, x >= 0  in float64 for
    every row (q, s) of (Q, S) at once.

    ADMM on the split x = z, z >= 0 (Boyd et al. 2011 §5.2): the
    x-update is the equality-constrained KKT solve, inverted once.
    Returns ``(Z, iters)`` with Z of shape (B, n).
    """
    P = np.asarray(P, np.float64)
    D = np.asarray(D, np.float64)
    Q = np.atleast_2d(np.asarray(Q, np.float64))
    S = np.atleast_2d(np.asarray(S, np.float64))
    n, m = P.shape[0], D.shape[0]
    K = np.block([[P + rho * np.eye(n), D.T], [D, np.zeros((m, m))]])
    Kinv = np.linalg.inv(K)[:n]
    Kx, Ks = Kinv[:, :n], Kinv[:, n:]
    offset = S @ Ks.T
    Z = np.zeros((Q.shape[0], n))
    U = np.zeros_like(Z)
    k = 0
    while k < maxiters:
        k += 1
        X = (rho * (Z - U) - Q) @ Kx.T + offset
        Zold = Z
        Z = np.maximum(X + U, 0.0)
        U = U + X - Z
        pnorm = np.linalg.norm(X - Z, axis=1)
        dnorm = rho * np.linalg.norm(Z - Zold, axis=1)
        perr = np.sqrt(n) * abstol + reltol * np.maximum(
            np.linalg.norm(X, axis=1), np.linalg.norm(Z, axis=1))
        derr = np.sqrt(n) * abstol + reltol * rho * np.linalg.norm(U, axis=1)
        if np.all(pnorm <= perr) and np.all(dnorm <= derr):
            break
    return Z, k


def covsel_gap_f64(S, lam, X):
    """Duality gap of the graphical lasso at X, in float64.

    Primal  tr(S X) - logdet X + lam ||X||_1  (every entry penalized, as in
    models/covarianceselection.py); dual  logdet W + n  over
    ||W - S||_max <= lam, with W built from X^-1 by clipping.  Weak
    duality makes the gap an upper bound on X's suboptimality.  Returns
    ``(gap, primal)``; the gap is inf when X or W is not positive definite.
    """
    S = np.asarray(S, np.float64)
    X = np.asarray(X, np.float64)
    X = 0.5 * (X + X.T)
    n = S.shape[0]
    sx, ldx = np.linalg.slogdet(X)
    if sx <= 0:
        return np.inf, np.inf
    primal = float(np.sum(S * X) - ldx + lam * np.sum(np.abs(X)))
    W = S + np.clip(np.linalg.inv(X) - S, -lam, lam)
    sw, ldw = np.linalg.slogdet(0.5 * (W + W.T))
    if sw <= 0:
        return np.inf, primal
    return primal - (ldw + n), primal


def maxcut_sdp_gap_f64(C, X):
    """Duality gap of  min <C, X>  s.t.  diag X = 1, X PSD  at X, in float64.

    X is first made exactly feasible: its PSD part, rescaled to a unit
    diagonal.  The dual point is y = diag(C X) (complementary slackness),
    shifted by the least eigenvalue of C - diag(y) so that the slack is
    PSD.  Returns ``(gap, primal)``.
    """
    C = np.asarray(C, np.float64)
    X = np.asarray(X, np.float64)
    w, V = np.linalg.eigh(0.5 * (X + X.T))
    X = (V * np.maximum(w, 0.0)) @ V.T
    d = np.sqrt(np.diag(X))
    if np.any(d <= 0):
        return np.inf, np.inf
    X = X / np.outer(d, d)
    primal = float(np.sum(C * X))
    y = np.diag(C @ X)
    y = y + np.linalg.eigvalsh(C - np.diag(y))[0]
    return primal - float(np.sum(y)), primal


def tv_gap_f64(s, lam, x):
    """Duality gap of 1-D total variation denoising at x, in float64.

    Primal  1/2||x - s||^2 + lam ||D x||_1  with the reference's square
    difference operator, (D x)_i = x_i - x_{i+1} and (D x)_n = x_n
    (solvers/totalvariation.m:127); dual  w'D s - 1/2||D'w||^2  over
    |w| <= lam.  The dual point solves the lower-bidiagonal system
    D'w = s - x (scipy.linalg.solve_banded) and is clipped to the box.
    The primal is 1-strongly convex, so ||x - x*|| <= sqrt(2 gap).
    Returns ``(gap, primal)``.
    """
    from scipy.linalg import solve_banded

    s = np.asarray(s, np.float64)
    x = np.asarray(x, np.float64)

    def D(v):
        return v - np.r_[v[1:], 0.0]

    def Dt(v):
        return v - np.r_[0.0, v[:-1]]

    primal = 0.5 * float(np.sum((x - s) ** 2)) + lam * float(
        np.sum(np.abs(D(x))))
    ab = np.zeros((2, s.shape[0]))
    ab[0] = 1.0
    ab[1, :-1] = -1.0
    w = np.clip(solve_banded((1, 0), ab, s - x), -lam, lam)
    Dtw = Dt(w)
    dual = float(w @ D(s)) - 0.5 * float(Dtw @ Dtw)
    return primal - dual, primal
