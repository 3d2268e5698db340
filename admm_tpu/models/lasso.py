"""LASSO: min 1/2 ||D x - s||^2 + lambda ||z||_1  s.t.  x - z = 0.

Reference: solvers/lasso.m (wrapper; serial precompute at lasso.m:160-177)
and getProxOps.m case 'lasso' (:313-456) with proxes xminLASSO
(getProxOps.m:1192-1206) and soft-thresholding z-update (getProxOps.m:455,
933-938).

x-update:  (D^T D + rho I)^{-1} (D^T s + rho (z - u))
           fat-matrix (m < n) branch via the matrix-inversion lemma,
           matching the reference's swapped-roles LU solve
           (getProxOps.m:1198-1205).
z-update:  soft_threshold(x + u, lambda / rho)

Design: the reference's cached Cholesky + lazy rho refactorization
becomes a one-time symmetric eigendecomposition whose application is pure
matmul work and is valid for every runtime rho (ops/solve.py); with
static rho the inverse is materialized so each x-update is a single GEMV.
Prox operators are module-level functions over a ``data`` pytree, so the
compiled solver is cached across calls (engine caching contract).

The consensus (global-variable) parallel LASSO — the reference's
parfor-sliced variant (getProxOps.m:367-442, 1217-1343) — is a first-class
sharded engine in parallel/consensus.py, not a hook here.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..ops.solve import FatShiftSolver, SymShiftSolver, WoodburySolver
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["Minv"] @ (d["Dts"] + rho * (z - u))


def _prox_f_adaptive(x, z, u, rho, d):
    return d["sol"].solve(d["Dts"] + rho * (z - u), rho)


def _prox_f_fat(x, z, u, rho, d):
    return d["wood"].solve(d["Dts"] + rho * (z - u), rho)


def _prox_f_fat_static(x, z, u, rho, d):
    return d["fat"].solve(d["Dts"] + rho * (z - u))


def _prox_g(x, z, u, rho, d):
    # zminSoftThresholding(u + x, lambda/rho) (getProxOps.m:455, 933-938)
    return soft_threshold(u + x, d["lam"] / rho)


def _obj(x, z, d):
    # solvers/lasso.m objective: 1/2||Dx - s||^2 + lambda*||z||_1
    return 0.5 * jnp.sum((d["D"] @ x - d["s"]) ** 2) + d["lam"] * jnp.sum(jnp.abs(z))


def make_ls_xprox(D, s, config: ADMMConfig, stream_dtype=None):
    """Shared least-squares x-prox: ``argmin 0.5||Dx-s||^2 +
    rho/2||x-(z-u)||^2`` with the rho-shift folded analytically.

    Returns ``(prox_f, data)`` where ``data`` carries D, s, D^T s and the
    shape-appropriate solver: skinny/square works in the n-by-n Gram,
    fat (m < n) goes through Woodbury (matrix-inversion lemma, the
    reference's swapped-roles branch getProxOps.m:1198-1205); static rho
    materializes one GEMV stream, dynamic rho keeps the eigenbasis.
    Used by lasso, elastic net, and NNLS — they differ only in the
    z-prox.
    """
    D = jnp.asarray(D)
    s = jnp.asarray(s)
    m, n = D.shape
    data = {"D": D, "s": s, "Dts": D.T @ s}

    if m >= n:
        # Skinny/square: work with the n-by-n Gram (solvers/lasso.m:164-168).
        if config.dynamic_rho:
            data["sol"] = SymShiftSolver.from_matrix(D.T @ D)
            prox_f = _prox_f_adaptive
        else:
            data["Minv"] = SymShiftSolver.from_matrix(D.T @ D).materialize_inverse(
                config.rho
            )
            prox_f = _prox_f_static
    elif config.dynamic_rho:
        # Fat + adaptive rho: Woodbury through the m-by-m eigenbasis
        # (solvers/lasso.m:169-172; getProxOps.m:1198-1205).
        data["wood"] = WoodburySolver.from_matrix(D)
        prox_f = _prox_f_fat
    else:
        # Fat + static rho: fold the middle factor into one stream matrix
        # (two m-by-n HBM streams per iteration).
        data["fat"] = FatShiftSolver.from_matrix(D, config.rho, stream_dtype)
        prox_f = _prox_f_fat_static

    return prox_f, data


def make_prox_ops(D, s, lam, config: ADMMConfig = ADMMConfig(), stream_dtype=None):
    """Build (prox_f, prox_g, obj, data) for LASSO (getProxOps.m:313-456).

    ``stream_dtype`` (e.g. jnp.bfloat16) stores the fat-branch matvec
    stream matrices at reduced precision with f32 accumulation — a
    bandwidth optimization for the HBM-bound regime (see FatShiftSolver).
    """
    prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
    data["lam"] = jnp.asarray(lam, data["D"].dtype)
    return prox_f, _prox_g, _obj, data


@register("lasso")
def _registry_entry(D, s, lam, config=ADMMConfig(), **_):
    pf, pg, obj, data = make_prox_ops(D, s, lam, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def lasso(D=None, s=None, lam=None, config: ADMMConfig = ADMMConfig(), *, stream_dtype=None,
          x0=None, z0=None, u0=None, parallel=False,
          nshards=None, mesh=None, **overrides) -> ADMMResults:
    """Solve LASSO (reference solvers/lasso.m:77).

    Constraint wiring matches lasso.m:226-239: A = 1, B = -1, c = 0 in R^n.

    ``parallel=True`` mirrors the reference wrapper's options.parallel
    (lasso.m:148-150, 196-224): the solve runs as consensus ADMM with
    data rows sharded over the mesh (parallel.consensus_lasso).  The
    consensus state is per-shard, so warm-start there with
    consensus_lasso(xi0=, ui0=, z0=); only the global ``z0`` passes
    through here.
    """
    if D is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import lassotest

        res, _test = lassotest(quiet=False)
        return res
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    if parallel:
        if x0 is not None or u0 is not None:
            raise ValueError(
                "parallel=True runs consensus ADMM, whose x/u state is "
                "per-shard — use parallel.consensus_lasso(xi0=, ui0=, z0=) "
                "to warm-start it"
            )
        if stream_dtype is not None:
            raise ValueError(
                "stream_dtype is a serial-path option; the consensus "
                "solver does not consume it"
            )
        from ..parallel import consensus_lasso

        return consensus_lasso(D, s, lam, config, mesh=mesh,
                               nshards=nshards, z0=z0)
    D = jnp.asarray(D)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lam, config, stream_dtype)
    hooks = Hooks(obj=obj)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=hooks, dtype=D.dtype, data=data,
    )
