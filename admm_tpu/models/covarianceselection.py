"""Sparse inverse covariance selection (graphical lasso):

    min tr(S X) - logdet(X) + lambda ||Z||_1   s.t.   X - Z = 0

over symmetric positive-definite matrices X — the library's matrix-valued
iterate problem (exercises the engine's N-d state support,
reference admm.m:478-492).

Reference: solvers/covarianceselection.m (wrapper; S = cov(D) at :145,
matrix-valued zero initial state :164-166) and getProxOps.m case
'covarianceselection' (:669-750) with x-prox xminCovarianceSelection
(getProxOps.m:1487-1496).

x-update:  eigendecompose rho (Z - U) - S = Q diag(e) Q^T,
           X = Q diag((e + sqrt(e^2 + 4 rho)) / (2 rho)) Q^T
z-update:  soft_threshold(U + X, lambda / rho)   (matrix-elementwise)

Design: two x-prox evaluation strategies, selected by ``prox_method``:

- ``'eigh'`` (default, exact): per-iteration symmetric eigh; batches
  under vmap, with the reconstruction as matmuls.
- ``'ns'`` (matmul-only mode): the same spectral function evaluated
  as (W + sqrt(W^2 + 4 rho I)) / (2 rho) with a Newton-Schulz matrix
  square root (ops/matfun.py) — pure n^3 matmul work, no eigh inside
  the loop.  ``ns_iters`` (static, default 20) covers kappa(W^2+4rho I)
  up to ~1e7 at machine precision.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.matfun import covsel_ns_prox
from ..ops.prox import covsel_eig_prox, soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f(X, Z, U, rho, d):
    return covsel_eig_prox(rho * (Z - U) - d["S"], rho)


@functools.lru_cache(maxsize=32)
def _ns_prox_f(ns_iters: int, ns_coarse: int = 0, ns_correct: int = 0):
    """Module-level-cached NS x-prox so repeat solves with the same
    ``(ns_iters, ns_coarse)`` reuse the engine's compiled runner (the
    caching contract keys on function identity — see
    engine._cached_runner)."""

    def prox(X, Z, U, rho, d):
        return covsel_ns_prox(rho * (Z - U) - d["S"], rho, ns_iters,
                              ns_coarse, ns_correct)

    return prox


def _prox_g(X, Z, U, rho, d):
    return soft_threshold(U + X, d["lam"] / rho)


def _obj(X, Z, d):
    sign, logdet = jnp.linalg.slogdet(X)
    return jnp.trace(d["S"] @ X) - logdet + d["lam"] * jnp.sum(jnp.abs(Z))


def make_prox_ops(S, lam, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "eigh", ns_iters: int = 20,
                  ns_coarse: int = 0, ns_correct: int = 0):
    """Build (prox_f, prox_g, obj, data) from the empirical covariance S
    (getProxOps.m:669-750).

    ``prox_method='ns'`` swaps the eigh x-prox for the Newton-Schulz
    matmul-only evaluation (``ns_iters`` square-root steps, static).
    ``ns_coarse`` runs that many leading NS steps at the default matmul
    precision (TF32 on the GPU) and ``ns_correct`` appends that many
    full-precision residual corrections (ops/matfun.ns_sqrtm): the fast
    recipe is ns_coarse=ns_iters, ns_correct=2.
    """
    if prox_method not in ("eigh", "ns", "ns_fast"):
        raise ValueError(
            f"prox_method must be 'eigh', 'ns' or 'ns_fast', got {prox_method!r}")
    if prox_method == "ns_fast":
        # ALL square-root steps at the default matmul precision + 2
        # full-precision residual corrections: the final accuracy of the
        # all-full-precision NS (chip_smoke.py holds it to eigh's bar).
        ns_coarse, ns_correct = ns_iters, max(int(ns_correct), 2)
    S = jnp.asarray(S)
    data = {"S": S, "lam": jnp.asarray(lam, S.dtype)}
    pf = (_prox_f if prox_method == "eigh"
          else _ns_prox_f(int(ns_iters), int(ns_coarse), int(ns_correct)))
    return pf, _prox_g, _obj, data


@register("covarianceselection")
def _registry_entry(S, lam, config=ADMMConfig(), prox_method="eigh", ns_iters=20,
                    ns_coarse=0, ns_correct=0, **_):
    pf, pg, obj, data = make_prox_ops(S, lam, config,
                                      prox_method=prox_method, ns_iters=ns_iters,
                                      ns_coarse=ns_coarse, ns_correct=ns_correct)
    return bind_data(pf, pg, obj, data)


def empirical_covariance(D):
    """cov(D) with rows = samples, matching MATLAB's cov
    (covarianceselection.m:145): unbiased, mean-removed."""
    D = jnp.asarray(D)
    mu = jnp.mean(D, axis=0, keepdims=True)
    Dc = D - mu
    return (Dc.T @ Dc) / (D.shape[0] - 1)


@timed_solver
def covarianceselection(D=None, lam=None, config: ADMMConfig = ADMMConfig(), *,
                        prox_method: str = "eigh", ns_iters: int = 20,
                        ns_coarse: int = 0, ns_correct: int = 0,
                        x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve covariance selection (reference solvers/covarianceselection.m:80).

    ``D`` holds samples in rows; the empirical covariance is formed here
    (covarianceselection.m:145).  Iterates are n-by-n matrices with zero
    initial state (covarianceselection.m:164-166).

    ``prox_method='ns'`` selects the matmul-only Newton-Schulz x-prox
    (no eigh inside the compiled loop); ``'ns_fast'`` additionally runs
    the square-root steps at the default matmul precision (TF32 on the
    GPU) with 2 full-precision residual corrections — the same final
    accuracy (make_prox_ops).
    """
    if D is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import covarianceselectiontest

        res, _test = covarianceselectiontest(quiet=False)
        return res
    config = merge_config(config, overrides, body="heavy")
    D = jnp.asarray(D)
    S = empirical_covariance(D)
    n = S.shape[0]
    prox_f, prox_g, obj, data = make_prox_ops(S, lam, config,
                                              prox_method=prox_method,
                                              ns_iters=ns_iters,
                                              ns_coarse=ns_coarse,
                                              ns_correct=ns_correct)
    zero = jnp.zeros((n, n), dtype=S.dtype)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0,
        shape_x=(n, n), shape_z=(n, n),
        x0=zero if x0 is None else jnp.asarray(x0, S.dtype),
        z0=zero if z0 is None else jnp.asarray(z0, S.dtype),
        u0=zero if u0 is None else jnp.asarray(u0, S.dtype),
        hooks=Hooks(obj=obj), dtype=S.dtype, data=data,
    )
