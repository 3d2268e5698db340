"""Batched regularization-path solves via vmap.

BASELINE.json's batched-scenario configuration ("batched over
regularization path via vmap"): solve one problem family for a whole
vector of regularization strengths in a SINGLE compiled program.  The
engine freezes converged lanes (engine.py done-mask), so the batch runs
until the slowest lane converges and every lane reports its own step
count — semantics impossible in the reference's interpreted loop.

The factorization caches (Gram eigendecompositions, projections) are
shared across the batch: only the scalar regularizer is mapped.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ADMMConfig, resolve_unroll
from ..engine import Hooks, _build_runner, _highest_precision
from ..linop import as_linop
from .lasso import make_prox_ops as _lasso_make_prox_ops
from .linearsvm import make_prox_ops as _svm_make_prox_ops
from ._common import merge_config


def _highest_precision_setup(fn):
    """Run the path's setup algebra (Grams, eigendecompositions,
    empirical covariances) under the library's full-f32-precision
    invariant, exactly as timed_solver does for the serial solvers
    (models/_common.py: a lower default f32 matmul precision corrupts
    setup algebra); _cached_path_runner pins the compiled loop the same
    way."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


@functools.lru_cache(maxsize=32)
def _cached_path_runner(prox_f, prox_g, obj, config: ADMMConfig,
                        mapped_keys: frozenset, data_keys: frozenset):
    """Compiled-vmap cache for path solves.  Without this, every path
    call would build a fresh runner lambda and jax.jit would recompile
    the whole batched program (a multi-second cost that once masqueraded
    as 5 ms/batch-iteration of steady-state time).  The constraint
    operators A/B flow through as call-time arguments (in_axes=None) so
    matrix constraints (SVM's A = D) don't poison the cache key."""
    run = _highest_precision(
        _build_runner(prox_f, prox_g, config, Hooks(obj=obj), has_data=True))
    axes = {k: (0 if k in mapped_keys else None) for k in data_keys}
    return jax.jit(jax.vmap(run, in_axes=(0, 0, 0, 0, None, None, axes)))


@dataclasses.dataclass
class PathResults:
    """Stacked per-lane results: leading axis = path position."""

    xopt: Any
    zopt: Any
    uopt: Any
    steps: Any       # (L,) iterations per lane
    lams: Any
    objopt: Any = None  # (L,) per-lane objective at the solution
    runtime: float = 0.0
    hist: dict = dataclasses.field(default_factory=dict)


@_highest_precision_setup
def lasso_path(D, s, lams, config: ADMMConfig = ADMMConfig(), **overrides) -> PathResults:
    """Solve LASSO for every lambda in ``lams`` in one vmapped program.

    Shares the one-time factorization across the path; maps only the
    scalar ``lam`` leaf of the data pytree.

    Follows the library's full-f32-precision invariant: the batched
    x-update GEMMs run at true f32.  (A TF32 loop missed the f32 lasso
    oracle on the H100 — x off by 2e-3 relative — so no lower precision
    is offered; ROADMAP §1.5.)
    """
    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    n = D.shape[1]
    lams = jnp.asarray(lams, D.dtype)
    prox_f, prox_g, obj, data = _lasso_make_prox_ops(D, s, float(lams[0]), config)
    data = dict(data)
    data["lam"] = lams  # mapped leaf

    vrun = _cached_path_runner(prox_f, prox_g, obj, config,
                               frozenset({"lam"}), frozenset(data))
    L = lams.shape[0]
    zeros = jnp.zeros((L, n), D.dtype)
    A, B = as_linop(1.0), as_linop(-1.0)

    jax.block_until_ready(data)
    t0 = time.perf_counter()  # loop-only wall clock (setup flushed)
    out = jax.block_until_ready(vrun(zeros, zeros, zeros, zeros, A, B, data))
    return PathResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], lams=lams,
        objopt=out.get("objopt"),
        runtime=time.perf_counter() - t0,
        hist={k: v for k, v in out["hist"].items() if not isinstance(v, tuple)},
    )


@_highest_precision_setup
def covsel_path(D, lams, config: ADMMConfig = ADMMConfig(), *,
                prox_method: str = "ns", ns_iters: int = 20,
                **overrides) -> PathResults:
    """Graphical-lasso regularization path: covariance selection for
    every lambda in ``lams`` in one vmapped program.

    The batched x-prox defaults to the Newton-Schulz evaluation
    (``prox_method='ns'``, ops/matfun.py): under vmap it is pure batched
    n^3 GEMM work, with no batched eigh inside the loop.  Matrix-valued
    iterates (L, n, n) exercise the engine's N-d state support
    lane-parallel.  ``D`` holds samples in rows (the
    empirical covariance is shared across the path — only the scalar
    lambda is mapped).
    """
    config = merge_config(config, overrides, body="batched")
    from .covarianceselection import empirical_covariance

    S = empirical_covariance(jnp.asarray(D))
    n = S.shape[0]
    lams = jnp.asarray(lams, S.dtype)
    from .covarianceselection import make_prox_ops as _covsel_make_prox_ops

    prox_f, prox_g, obj, data = _covsel_make_prox_ops(
        S, float(lams[0]), config, prox_method=prox_method, ns_iters=ns_iters)
    data = dict(data)
    data["lam"] = lams  # mapped leaf

    vrun = _cached_path_runner(prox_f, prox_g, obj, config,
                               frozenset({"lam"}), frozenset(data))
    L = lams.shape[0]
    zeros = jnp.zeros((L, n, n), S.dtype)
    A, B = as_linop(1.0), as_linop(-1.0)

    jax.block_until_ready(data)
    t0 = time.perf_counter()  # loop-only wall clock (setup flushed)
    out = jax.block_until_ready(vrun(zeros, zeros, zeros, zeros, A, B, data))
    return PathResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], lams=lams,
        objopt=out.get("objopt"),
        runtime=time.perf_counter() - t0,
        hist={k: v for k, v in out["hist"].items() if not isinstance(v, tuple)},
    )


@_highest_precision_setup
def tv_path(s, lams, config: ADMMConfig = ADMMConfig(), *,
            solver: str = "auto", **overrides) -> PathResults:
    """1-D TV denoising for every lambda in ``lams`` in one vmapped
    program (denoising-strength sweep).

    The TV x-prox cache — the diagonalized (or cyclic-reduction)
    (I + rho D^T D) solve — is lambda-independent, so the whole path
    shares one factorization and only the scalar threshold is mapped.
    """
    config = merge_config(config, overrides, body="batched")
    from .totalvariation import make_prox_ops as _tv_make_prox_ops

    s = jnp.asarray(s)
    n = s.shape[0]
    lams = jnp.asarray(lams, s.dtype)
    prox_f, prox_g, obj, data, D = _tv_make_prox_ops(
        s, float(lams[0]), config, solver)
    data = dict(data)
    data["lam"] = lams  # mapped leaf

    vrun = _cached_path_runner(prox_f, prox_g, obj, config,
                               frozenset({"lam"}), frozenset(data))
    L = lams.shape[0]
    zeros = jnp.zeros((L, n), s.dtype)
    A, B = as_linop(D), as_linop(-1.0)

    jax.block_until_ready(data)
    t0 = time.perf_counter()  # loop-only wall clock (setup flushed)
    out = jax.block_until_ready(vrun(zeros, zeros, zeros, zeros, A, B, data))
    return PathResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], lams=lams,
        objopt=out.get("objopt"),
        runtime=time.perf_counter() - t0,
        hist={k: v for k, v in out["hist"].items() if not isinstance(v, tuple)},
    )


@_highest_precision_setup
def linearsvm_c_path(D, ell, Cs, config: ADMMConfig = ADMMConfig(), *,
                     loss: str = "hinge", seed: int = 0, **overrides) -> PathResults:
    """Train the linear SVM for every C in ``Cs`` in one vmapped program
    (the reference's per-C re-solve loop, batched).  stopcond and
    nodualerror are FORCED to the unwrapped driver's values
    (unwrappedadmm.m:90-92) exactly as the serial linearsvm chain is,
    so each lane stops identically to a solo run."""
    overrides["stopcond"] = "both"
    overrides["nodualerror"] = True
    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    Cs = jnp.asarray(Cs, D.dtype)
    _, prox_g, obj, data = _svm_make_prox_ops(D, ell, float(Cs[0]), loss, config)
    data = dict(data)
    data["C"] = Cs
    data["Dplus"] = jnp.linalg.pinv(D)

    from .unwrapped import _prox_f

    vrun = _cached_path_runner(_prox_f, prox_g, obj, config,
                               frozenset({"C"}), frozenset(data))
    A, B = as_linop(D), as_linop(-1.0)
    L = Cs.shape[0]
    kx, kz, ku = jax.random.split(jax.random.PRNGKey(seed), 3)
    x0 = jnp.broadcast_to(jax.random.uniform(kx, (n,), dtype=D.dtype), (L, n))
    z0 = jnp.broadcast_to(jax.random.uniform(kz, (m,), dtype=D.dtype), (L, m))
    u0 = jnp.broadcast_to(jax.random.uniform(ku, (m,), dtype=D.dtype), (L, m))
    c0 = jnp.zeros((L, m), D.dtype)

    jax.block_until_ready(data)
    t0 = time.perf_counter()  # loop-only wall clock (setup flushed)
    out = jax.block_until_ready(vrun(x0, z0, u0, c0, A, B, data))
    return PathResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], lams=Cs,
        objopt=out.get("objopt"),
        runtime=time.perf_counter() - t0,
        hist={k: v for k, v in out["hist"].items() if not isinstance(v, tuple)},
    )
