"""Robust PCA (principal component pursuit):

    min ||L||_* + lam ||S||_1   s.t.   L + S = M

— decompose a matrix into low-rank + sparse (Candes, Li, Ma, Wright
2011).  Beyond the reference (its shrinkage family has no spectral
penalty); the classic ADMM splitting maps directly onto the engine's
matrix-iterate support (admm.m:478-492, the covsel pattern) with
A = B = +1 and c = M:

    L-step:  SVT(M - S - U, 1/rho)       (singular value thresholding)
    S-step:  soft_threshold(M - L - U, lam/rho)
    U     += L + S - M

Design: the SVT is one jnp.linalg.svd per iteration — a 'heavy'
body (no unrolling; like the covsel eigh prox).  Everything else is
fused elementwise work.  lam defaults to the theory value
1/sqrt(max(m, n)) under which exact recovery holds for incoherent
low-rank + random sparse inputs — the oracle test plants exactly that.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f(L, S, U, rho, d):
    # L-step: argmin ||L||_* + rho/2 ||L - (M - S - U)||_F^2 = SVT at 1/rho.
    V = d["M"] - S - U
    u_, s_, vt = jnp.linalg.svd(V, full_matrices=False)
    s_ = jnp.maximum(s_ - 1.0 / rho, 0.0)
    return (u_ * s_[None, :]) @ vt


@functools.lru_cache(maxsize=None)
def _rsvd_prox_f(k: int, power_iters: int, seed: int):
    """Randomized-SVD SVT (Halko-Martinsson-Tropp range finder): project
    onto a k-dimensional random range (matmuls), SVD only the
    small (k, n) sketch — O(m n k) instead of O(m n min(m, n)).  Exact
    when the thresholded matrix has rank <= k; PCP iterates converge to
    the planted low rank, so pick ``rank`` comfortably above it (the
    wrapper adds oversampling).  lru-cached so the engine's runner cache
    keys on a stable function identity per (k, power_iters, seed)."""

    def prox_f(L, S, U, rho, d):
        import jax

        V = d["M"] - S - U
        n = V.shape[1]
        G = jax.random.normal(jax.random.PRNGKey(seed), (n, k), V.dtype)
        Y = V @ G
        for _ in range(power_iters):
            # Subspace/power iteration sharpens the range estimate; QR
            # re-orthonormalization keeps it numerically sane.
            Y, _ = jnp.linalg.qr(Y)
            Y = V @ (V.T @ Y)
        Q, _ = jnp.linalg.qr(Y)          # (m, k) orthonormal range
        B = Q.T @ V                       # (k, n) small sketch
        ub, sb, vtb = jnp.linalg.svd(B, full_matrices=False)
        sb = jnp.maximum(sb - 1.0 / rho, 0.0)
        return (Q @ (ub * sb[None, :])) @ vtb

    return prox_f


def _prox_g(L, S, U, rho, d):
    # S-step: elementwise shrinkage toward M - L - U at lam/rho.
    return soft_threshold(d["M"] - L - U, d["lam"] / rho)


def _obj(L, S, d):
    return jnp.sum(jnp.linalg.svd(L, compute_uv=False)) + d["lam"] * jnp.sum(
        jnp.abs(S))


def make_prox_ops(M, lam=None, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "exact", rank=None, oversample: int = 10,
                  power_iters: int = 2, seed: int = 0):
    """Build (prox_f, prox_g, obj, data) for robust PCA.

    ``lam`` defaults to 1/sqrt(max(M.shape)) (the exact-recovery theory
    value); it rides in ``data`` so re-solves across lam share the
    compiled runner.  ``prox_method='rsvd'`` swaps the full per-iteration
    SVD for the randomized-range SVT (requires ``rank``: an upper bound
    on the expected rank of L; ``oversample`` columns are added)."""
    M = jnp.asarray(M)
    if M.ndim != 2:
        raise ValueError(f"M must be a matrix, got shape {M.shape}")
    if lam is None:
        lam = 1.0 / float(max(M.shape)) ** 0.5
    data = {"M": M, "lam": jnp.asarray(lam, M.dtype)}
    if prox_method == "exact":
        prox_f = _prox_f
    elif prox_method == "rsvd":
        if rank is None:
            raise ValueError("prox_method='rsvd' needs rank= (an upper "
                             "bound on rank(L))")
        k = min(int(rank) + int(oversample), min(M.shape))
        prox_f = _rsvd_prox_f(k, int(power_iters), int(seed))
    else:
        raise ValueError(
            f"prox_method must be 'exact' or 'rsvd', got {prox_method!r}")
    return prox_f, _prox_g, _obj, data


@register("rpca")
def _registry_entry(M, lam=None, config=ADMMConfig(), prox_method="exact",
                    rank=None, **_):
    pf, pg, obj, data = make_prox_ops(M, lam, config,
                                      prox_method=prox_method, rank=rank)
    return bind_data(pf, pg, obj, data)


@timed_solver
def rpca(M, lam=None, config: ADMMConfig = ADMMConfig(), *,
         prox_method: str = "exact", rank=None, oversample: int = 10,
         power_iters: int = 2, seed: int = 0,
         x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Decompose ``M`` into low-rank ``xopt`` (= L) + sparse ``zopt``
    (= S) by principal component pursuit.

    Constraint wiring: A = 1, B = +1, c = M over matrix iterates.  The
    default stopping often fires on the primal residual ||L + S - M||;
    ``results.xopt + results.zopt`` reproduces M to that tolerance.
    """
    config = merge_config(config, overrides, body="heavy")
    M = jnp.asarray(M)
    prox_f, prox_g, obj, data = make_prox_ops(
        M, lam, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=1.0, c=M,
        shape_x=M.shape, shape_z=M.shape,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=M.dtype, data=data,
    )
