"""Nuclear-norm matrix completion:

    exact form (mu=None):   min ||Z||_*   s.t.  P_Omega(Z) = P_Omega(M)
    noisy form (mu given):  min ||Z||_* + (mu/2) ||P_Omega(Z - M)||_F^2

— recover a low-rank matrix from a subset Omega of its entries (Candes
& Recht 2009; the SVT algorithm of Cai, Candes & Shen 2010 is this ADMM
up to stepsize choices).  Beyond the reference (its shrinkage family
has no spectral penalty); the natural sibling of `rpca` on the engine's
matrix-iterate support (admm.m:478-492, the covsel pattern) with
A = 1, B = -1, c = 0 over the splitting X = Z:

    X-step:  observed entries pinned to M, free entries copied from
             Z - U (projection onto the data-consistency set); in the
             noisy form the elementwise weighted average
             (rho (Z - U) + mu.mask.M) / (rho + mu.mask)
    Z-step:  SVT(X + U, 1/rho)          (singular value thresholding)
    U    +=  X - Z

Design: the X-step is one fused elementwise select/blend; the SVT
is the per-iteration heavy op — a full jnp.linalg.svd, or at
``prox_method='rsvd'`` the same randomized-range sketch as `rpca`
(Halko-Martinsson-Tropp): project onto a k-dimensional random range
with matmuls and svd only the small (k, n) sketch, exact
whenever the thresholded iterate has rank <= k.  The iterate converges
to the planted rank, so a `rank` bound comfortably above it (plus the
oversampling the wrapper adds) keeps the sketch exact while the cost
drops from O(m n min(m,n)) to O(m n k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f_exact(X, Z, U, rho, d):
    # Projection onto {X : X_Omega = M_Omega}: pin observed entries,
    # copy the free ones from the target Z - U.
    return jnp.where(d["mask"], d["M"], Z - U)


def _prox_f_noisy(X, Z, U, rho, d):
    # argmin (mu/2)||mask*(X - M)||_F^2 + (rho/2)||X - (Z - U)||_F^2:
    # elementwise weighted average (off Omega the mu term vanishes).
    w = d["mu"] * d["mask"]
    return (rho * (Z - U) + w * d["M"]) / (rho + w)


def svt(V, thresh):
    """Singular value thresholding: U max(s - thresh, 0) V^T."""
    u_, s_, vt = jnp.linalg.svd(V, full_matrices=False)
    s_ = jnp.maximum(s_ - thresh, 0.0)
    return (u_ * s_[None, :]) @ vt


def randomized_svt(V, thresh, k: int, power_iters: int, seed: int):
    """Randomized-range SVT (Halko-Martinsson-Tropp): sketch a
    k-dimensional range with matmuls + QR, svd only the (k, n)
    sketch.  Exact when rank(SVT(V)) <= k (the sketch captures the
    whole thresholded spectrum); shared by `rpca` and matrix
    completion."""
    n = V.shape[1]
    G = jax.random.normal(jax.random.PRNGKey(seed), (n, k), V.dtype)
    Y = V @ G
    for _ in range(power_iters):
        # Subspace iteration sharpens the range; QR keeps it sane.
        Y, _ = jnp.linalg.qr(Y)
        Y = V @ (V.T @ Y)
    Q, _ = jnp.linalg.qr(Y)               # (m, k) orthonormal range
    B = Q.T @ V                           # (k, n) small sketch
    ub, sb, vtb = jnp.linalg.svd(B, full_matrices=False)
    sb = jnp.maximum(sb - thresh, 0.0)
    return (Q @ (ub * sb[None, :])) @ vtb


def _prox_g(X, Z, U, rho, d):
    return svt(X + U, 1.0 / rho)


@functools.lru_cache(maxsize=None)
def _rsvd_prox_g(k: int, power_iters: int, seed: int):
    """lru-cached so the engine's runner cache keys on a stable function
    identity per (k, power_iters, seed) — the `rpca` pattern."""

    def prox_g(X, Z, U, rho, d):
        return randomized_svt(X + U, 1.0 / rho, k, power_iters, seed)

    return prox_g


def _obj_exact(X, Z, d):
    return jnp.sum(jnp.linalg.svd(Z, compute_uv=False))


def _obj_noisy(X, Z, d):
    fit = d["mask"] * (X - d["M"])
    return (jnp.sum(jnp.linalg.svd(Z, compute_uv=False))
            + 0.5 * d["mu"] * jnp.sum(fit * fit))


def make_prox_ops(M, mask, mu=None, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "exact", rank=None, oversample: int = 10,
                  power_iters: int = 2, seed: int = 0):
    """Build (prox_f, prox_g, obj, data) for matrix completion.

    ``mask`` is the 0/1 (or bool) observation indicator; entries of
    ``M`` outside the mask are ignored.  ``mu=None`` selects the
    exact-constraint form; a positive ``mu`` the noisy quadratic-fit
    form.  ``prox_method='rsvd'`` swaps the full per-iteration SVD for
    the randomized-range SVT (requires ``rank``: an upper bound on the
    expected rank; ``oversample`` columns are added)."""
    M = jnp.asarray(M)
    if M.ndim != 2:
        raise ValueError(f"M must be a matrix, got shape {M.shape}")
    mask = jnp.asarray(mask)
    if mask.shape != M.shape:
        raise ValueError(
            f"mask must match M's shape {M.shape}, got {mask.shape}")
    mask = mask.astype(M.dtype)
    # Zero the unobserved entries so the pinned values are well-defined
    # regardless of what the caller left there.
    data = {"M": M * mask, "mask": mask}
    if mu is None:
        prox_f, obj = _prox_f_exact, _obj_exact
    else:
        if float(mu) <= 0.0:
            raise ValueError(f"mu must be positive (or None), got {mu}")
        data["mu"] = jnp.asarray(mu, M.dtype)
        prox_f, obj = _prox_f_noisy, _obj_noisy
    if prox_method == "exact":
        prox_g = _prox_g
    elif prox_method == "rsvd":
        if rank is None:
            raise ValueError("prox_method='rsvd' needs rank= (an upper "
                             "bound on the completed rank)")
        k = min(int(rank) + int(oversample), min(M.shape))
        prox_g = _rsvd_prox_g(k, int(power_iters), int(seed))
    else:
        raise ValueError(
            f"prox_method must be 'exact' or 'rsvd', got {prox_method!r}")
    return prox_f, prox_g, obj, data


@register("matrixcompletion")
def _registry_entry(M, mask, mu=None, config=ADMMConfig(),
                    prox_method="exact", rank=None, **_):
    pf, pg, obj, data = make_prox_ops(M, mask, mu, config,
                                      prox_method=prox_method, rank=rank)
    return bind_data(pf, pg, obj, data)


@timed_solver
def matrixcompletion(M, mask, mu=None, config: ADMMConfig = ADMMConfig(), *,
                     prox_method: str = "exact", rank=None,
                     oversample: int = 10, power_iters: int = 2,
                     seed: int = 0, x0=None, z0=None, u0=None,
                     **overrides) -> ADMMResults:
    """Complete the partially observed matrix ``M`` (observation
    indicator ``mask``) by nuclear-norm minimization.

    ``results.zopt`` is the completed low-rank matrix (the Z iterate
    carries the spectral structure; X pins the observed entries).
    Constraint wiring: A = 1, B = -1, c = 0 over matrix iterates, the
    `rpca`/covsel engine pattern (admm.m:478-492).
    """
    config = merge_config(config, overrides, body="heavy")
    M = jnp.asarray(M)
    prox_f, prox_g, obj, data = make_prox_ops(
        M, mask, mu, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0,
        shape_x=M.shape, shape_z=M.shape,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=M.dtype, data=data,
    )
