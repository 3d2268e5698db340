"""L1-regularized (sparse) logistic regression via ADMM:

    min  sum_i log(1 + exp(-ell_i d_i^T x)) + lam ||z||_1
    s.t. x - z = 0

The canonical consensus-ADMM application (Boyd et al. 2011, sec. 8.2
"Logistic regression") — BEYOND the reference library, which has no
logistic family; its nearest relatives are the SVM hinge solvers
(getProxOps.m:202-310).  Kept in the reference's L4 wrapper shape
(validate -> prox ops -> engine; e.g. solvers/lasso.m:77).

Design: the x-prox has no closed form — it minimizes the smooth,
rho-strongly-convex  f(x) + (rho/2)||x - (z - u)||^2  with a FIXED,
trace-time-static number of damped Newton steps inside the compiled
loop (a 'heavy' iteration body like covsel's eigh).  Each step builds
the Hessian  D^T diag(w) D + rho I  (one m x n GEMM pair)
and solves it densely; a single objective-gated halving keeps the step
safe without data-dependent control flow.  The z-prox is the shared
soft threshold, so lam = 0 gives plain ridge-less logistic regression
regularized only through the splitting.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, timed_solver

# Static inner Newton steps per x-prox evaluation.  The prox problem is
# rho-strongly convex with warm starts from the previous iterate, so a
# handful of damped steps reaches prox tolerance well below the ADMM
# iteration's own accuracy needs (oracle test: matches scipy's solver
# to 1e-5 relative objective).
_NEWTON_STEPS = 5


def _prox_objective(x, v, rho, d):
    t = d["ell"] * (d["D"] @ x)  # (m,) margins  y_i d_i^T x
    # log(1 + exp(-t)) computed stably as softplus(-t).
    return (jnp.sum(jnp.logaddexp(0.0, -t))
            + 0.5 * rho * jnp.sum((x - v) ** 2))


def _newton_xprox(x, v, rho, d, newton_steps: int = _NEWTON_STEPS):
    """Damped Newton for argmin_x sum softplus(-(Yx)_i) + rho/2 ||x-v||^2.

    The margins are ell_i * (D x) with ``D`` shared and ``ell`` a
    per-instance leaf — so logreg_batch maps only the (m,) labels and
    the whole one-vs-all batch shares one D (models/batch.py).  One
    objective-gated halving per step (select, not branch) keeps each
    update monotone without data-dependent control flow.
    """
    D, ell = d["D"], d["ell"]
    I = jnp.eye(D.shape[1], dtype=D.dtype)
    for _ in range(newton_steps):
        t = ell * (D @ x)
        sig = jax.nn.sigmoid(-t)           # = 1 - sigmoid(t)
        grad = -(D.T @ (ell * sig)) + rho * (x - v)
        w = sig * (1.0 - sig)              # logistic curvature weights
        H = (D * w[:, None]).T @ D + rho * I
        step = jnp.linalg.solve(H, grad)
        f0 = _prox_objective(x, v, rho, d)
        x1 = x - step
        x_half = x - 0.5 * step
        f1 = _prox_objective(x1, v, rho, d)
        # Take the full step when it descends, else the half step (which
        # descends whenever the quadratic model is sane; a second refusal
        # just leaves more work to later steps/iterations).
        x = jnp.where(f1 <= f0, x1, x_half)
    return x


def _pcg_solve(matvec, b, diag, iters: int):
    """Fixed-iteration Jacobi-preconditioned CG for the SPD Newton
    system — matrix-free, no data-dependent control flow (trace-time
    unrolled).  The tiny-guards make a fully-converged system a no-op
    (r = 0 propagates zero updates) instead of 0/0 NaNs."""
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)
    x = jnp.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz = jnp.sum(r * z)
    for _ in range(int(iters)):
        hp = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * hp), tiny)
        x = x + alpha * p
        r = r - alpha * hp
        z = r / diag
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, tiny)
        p = z + beta * p
        rz = rz_new
    return x


def _newton_cg_xprox(x, v, rho, d, newton_steps: int, cg_steps: int):
    """Matrix-free damped Newton: each step solves the Hessian system
    (D^T diag(w) D + rho I) s = grad by Jacobi-preconditioned CG whose
    matvec is two (m, n) GEMV/GEMM passes — NO (n, n) Hessian is ever
    formed.  This is what makes lane batching pay: under vmap the B
    lanes' matvecs fuse into (B, m) x (m, n) GEMMs, where the dense
    path batches (B, n, n) LU factorizations.
    The Jacobi diagonal D2^T w + rho costs one extra GEMV per Newton
    step (D2 = D*D cached at setup).  Same 3-level objective-gated
    damping as the consensus local prox (parallel/consensus.py)."""
    D, ell, D2 = d["D"], d["ell"], d["D2"]
    for _ in range(newton_steps):
        t = ell * (D @ x)
        sig = jax.nn.sigmoid(-t)
        grad = -(D.T @ (ell * sig)) + rho * (x - v)
        w = sig * (1.0 - sig)
        diag = D2.T @ w + rho

        def hv(s, w=w):
            return D.T @ (w * (D @ s)) + rho * s

        step = _pcg_solve(hv, grad, diag, cg_steps)
        f0 = _prox_objective(x, v, rho, d)
        x1 = x - step
        x2 = x - 0.5 * step
        f1 = _prox_objective(x1, v, rho, d)
        f2 = _prox_objective(x2, v, rho, d)
        x = jnp.where(f1 <= f0, x1,
                      jnp.where(f2 <= f0, x2, x - 0.25 * step))
    return x


def _prox_f(x, z, u, rho, d):
    return _newton_xprox(x, z - u, rho, d)


# maxsize=None: see _cg_prox_f_fn.  This factory exists so the dense
# path HONORS newton_steps (a review pass found the knob silently
# ignored: _prox_f hardwired the module default, so e.g.
# newton_steps=30 for ill-conditioned data ran 5 steps — the inexact
# prox can stall convergence exactly as documented for the 5-step
# consensus case).
@functools.lru_cache(maxsize=None)
def _dense_prox_f_fn(newton_steps: int):
    if newton_steps == _NEWTON_STEPS:
        return _prox_f  # stable identity for the default (cache warm)

    def prox_f(x, z, u, rho, d):
        return _newton_xprox(x, z - u, rho, d, newton_steps)

    return prox_f


# maxsize=None: tiny bounded key space; an eviction would mint a new
# function object and defeat the engine's function-identity runner cache.
@functools.lru_cache(maxsize=None)
def _cg_prox_f_fn(newton_steps: int, cg_steps: int):
    """Module-level-cached Newton-CG x-prox (engine caching contract)."""

    def prox_f(x, z, u, rho, d):
        return _newton_cg_xprox(x, z - u, rho, d, newton_steps, cg_steps)

    return prox_f


def _prox_g(x, z, u, rho, d):
    return soft_threshold(u + x, d["lam"] / rho)


def _obj(x, z, d):
    t = d["ell"] * (d["D"] @ x)
    return jnp.sum(jnp.logaddexp(0.0, -t)) + d["lam"] * jnp.sum(jnp.abs(z))


def make_prox_ops(D, ell, lam, config: ADMMConfig = ADMMConfig(), *,
                  inner: str = "newton", newton_steps: int = _NEWTON_STEPS,
                  cg_steps: int = 20):
    """Build (prox_f, prox_g, obj, data): data carries D, the +/-1
    labels, and the l1 weight (labels separate so batched one-vs-all
    lanes share one D).

    ``inner`` selects the x-prox solver: ``'newton'`` forms and densely
    solves the (n, n) Hessian (the accuracy reference); ``'newton_cg'``
    is the matrix-free Jacobi-PCG Newton (two GEMV passes per CG step,
    no Hessian) — the default for batched lanes, where the dense path
    runs (B, n, n) factorizations (_newton_cg_xprox).
    """
    if inner not in ("newton", "newton_cg"):
        raise ValueError(
            f"inner must be 'newton' or 'newton_cg', got {inner!r}")
    D = jnp.asarray(D)
    ell = jnp.asarray(ell, D.dtype)
    data = {"D": D, "ell": ell, "lam": jnp.asarray(lam, D.dtype)}
    if inner == "newton_cg":
        data["D2"] = D * D  # Jacobi diagonal stream (shared across lanes)
        return (_cg_prox_f_fn(int(newton_steps), int(cg_steps)),
                _prox_g, _obj, data)
    return _dense_prox_f_fn(int(newton_steps)), _prox_g, _obj, data


@register("logreg")
def _registry_entry(D, ell, lam, config=ADMMConfig(), **_):
    return bind_data(*make_prox_ops(D, ell, lam, config))


@timed_solver
def logreg(D=None, ell=None, lam=0.1, config: ADMMConfig = ADMMConfig(), *,
           inner: str = "newton", newton_steps: int = _NEWTON_STEPS,
           cg_steps: int = 20,
           x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Sparse logistic regression.  ``D`` (m, n) data rows, ``ell`` (m,)
    labels in {-1, +1}, ``lam`` the l1 weight (0 disables shrinkage).

    The returned ``zopt`` is the sparse iterate; ``xopt`` the smooth one
    (they coincide at convergence).  ``inner='newton_cg'`` swaps the
    dense-Hessian Newton x-prox for the matrix-free Jacobi-PCG one
    (make_prox_ops) — the batched performance mode, also useful
    serially at large n.
    """
    if D is None:
        from ..testers.problems import logregtest

        res, _test = logregtest(quiet=False)
        return res

    config = merge_config(config, overrides, body="heavy")
    check_data_vector(D, ell, "D", "ell")
    import numpy as np

    ellv = np.asarray(ell)
    if not np.all(np.isin(ellv, (-1.0, 1.0))):
        raise ValueError("ell must be +/-1 labels")
    if not float(lam) >= 0:
        raise ValueError(f"lam must be nonnegative, got {lam}")

    prox_f, prox_g, obj, data = make_prox_ops(
        D, ell, lam, config, inner=inner, newton_steps=newton_steps,
        cg_steps=cg_steps)
    n = data["D"].shape[1]
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=data["D"].dtype, data=data,
    )
