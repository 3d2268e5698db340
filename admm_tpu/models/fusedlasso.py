"""Fused lasso signal approximator:

    min_x  1/2 ||x - s||^2 + lam1 ||x||_1 + lam2 ||D x||_1

— simultaneous sparsity AND piecewise-constancy (Tibshirani et al.
2005), the l1-trend-filtering cousin of the library's TV denoiser.
Beyond the reference (its shrinkage family penalizes one transform at a
time); the ADMM splitting STACKS both:

    z = [z1; z2],  A = [I; D],  B = -I,  c = 0,
    x-step:  (I + rho (I + D^T D))^{-1} (s + rho A^T (z - u))
             — the rho-shifted solve is eig-folded ONCE (the TV dense
             pattern), one n-by-n GEMV per iteration
    z-step:  soft-threshold with a per-row threshold vector
             [lam1/rho ... ; lam2/rho ...] — still one fused elementwise pass

Degenerate cases give exact oracles: lam2 = 0 reduces to elementwise
soft-thresholding of s (closed form), lam1 = 0 reduces to the TV
denoiser (same D convention, models/totalvariation.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..linop import DiffOp, StackIDiffOp
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["Minv"] @ (d["s"] + rho * d["A"].rmv(z - u))


def _prox_f_adaptive(x, z, u, rho, d):
    # rho-parameterized eigbasis solve (dynamic rho): M = I + rho(I+DtD).
    y = d["V"].T @ (d["s"] + rho * d["A"].rmv(z - u))
    return d["V"] @ (y / (1.0 + rho * (1.0 + d["w"])))


def _prox_g(x, z, u, rho, d):
    # The engine hands the RAW x; apply A = [I; D] here (the TV
    # z-prox convention, getProxOps.m:1044-1048) — matrix-free.
    return soft_threshold(d["A"].mv(x) + u, d["t"] / rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    # Relaxed path: the engine hands Axhat (already in the stacked 2n
    # space) as the first argument.
    return soft_threshold(Axhat + u, d["t"] / rho)


def _obj(x, z, d):
    # Evaluated at the split point z = [x; Dx] (exact at convergence).
    return 0.5 * jnp.sum((x - d["s"]) ** 2) + jnp.sum(d["t"] * jnp.abs(z))


def make_prox_ops(s, lam1, lam2, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data, A) for the fused lasso.

    lam1/lam2 ride in ``data`` as the stacked per-row threshold vector
    ``t`` (times rho at runtime), so re-solves across regularization
    strengths reuse the compiled runner; the eig-fold of D^T D is
    one-time."""
    s = jnp.asarray(s)
    n = s.shape[0]
    D = DiffOp(n).dense(s.dtype)  # dense ONLY for the one-time eig-fold
    A = StackIDiffOp(n)           # matrix-free [I; D] inside the loop
    t = jnp.concatenate([
        jnp.full((n,), lam1, s.dtype), jnp.full((n,), lam2, s.dtype)])
    data = {"s": s, "t": t, "A": A}
    DtD = D.T @ D
    DtD = 0.5 * (DtD + DtD.T)
    w, V = jnp.linalg.eigh(DtD)
    if config.dynamic_rho:
        data["V"], data["w"] = V, w
        prox_f = _prox_f_adaptive
    else:
        rho = config.rho
        data["Minv"] = (V / (1.0 + rho * (1.0 + w))[None, :]) @ V.T
        prox_f = _prox_f
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return prox_f, prox_g, _obj, data, A


@register("fusedlasso")
def _registry_entry(s, lam1, lam2, config=ADMMConfig(), **_):
    pf, pg, obj, data, _A = make_prox_ops(s, lam1, lam2, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def fusedlasso(s, lam1, lam2, config: ADMMConfig = ADMMConfig(), *,
               x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve the fused lasso signal approximator.

    ``xopt`` is the denoised signal; ``zopt`` carries the stacked
    [x; Dx] auxiliary.  Constraint wiring: A = [I; D] (2n, n), B = -1,
    c = 0.
    """
    config = merge_config(config, overrides, body="gemv")
    s = jnp.asarray(s)
    n = s.shape[0]
    prox_f, prox_g, obj, data, A = make_prox_ops(s, lam1, lam2, config)
    return admm(
        prox_f, prox_g, config,
        A=A, B=-1.0, c=0.0, m=2 * n, nA=n, nB=2 * n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=s.dtype, data=data,
    )
