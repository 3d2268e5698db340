"""Shared solver-wrapper plumbing.

The reference's solver boilerplate (path setup, option struct fill-in,
per-solver timing, e.g. solvers/model.m:76-142) reduces here to config
merging and a timing decorator.
"""

from __future__ import annotations

import dataclasses
import time
from functools import wraps

from ..config import ADMMConfig, resolve_unroll


def merge_config(config: ADMMConfig, overrides: dict,
                 body: str = "default") -> ADMMConfig:
    """Apply keyword overrides to a config (the reference's pattern of
    solvers mutating the options struct before calling admm), then
    resolve ``unroll='auto'`` for the wrapper's iteration-body class
    (config.resolve_unroll; a no-op for concrete unroll ints)."""
    if overrides:
        config = dataclasses.replace(config, **overrides)
    return resolve_unroll(config, body)


def bind_data(prox_f, prox_g, obj, data):
    """Close data-convention functions over concrete operands, recovering
    the reference's closure-style prox handles (getproxops returns
    closures over cached factorizations, getProxOps.m:13-31).  For the
    string registry / ad-hoc use only — solvers pass ``data`` through the
    engine so the compiled runner caches across calls."""
    pf = None if prox_f is None else (lambda x, z, u, rho: prox_f(x, z, u, rho, data))
    pg = None if prox_g is None else (lambda x, z, u, rho: prox_g(x, z, u, rho, data))
    ob = None if obj is None else (lambda x, z: obj(x, z, data))
    return pf, pg, ob


def check_data_vector(D, s, Dname="D", sname="s"):
    """Shape cross-check shared by the regression-style solvers (the
    reference's per-solver errorcheck subfunctions, e.g. lasso.m:132-141):
    D must be 2-D and s a vector of length rows(D)."""
    import numpy as np

    Dsh = np.shape(D)
    ssh = np.shape(s)
    if len(Dsh) != 2:
        raise ValueError(f"{Dname} must be 2-D, got shape {Dsh}")
    if len(ssh) != 1 or ssh[0] != Dsh[0]:
        raise ValueError(
            f"{sname} must be a vector of length {Dsh[0]} (rows of {Dname}), "
            f"got shape {ssh}"
        )


def normal_equations_data(D, s):
    """Shared LAD/Huber setup: validate skinny shape and materialize the
    normal-equations pseudo-inverse (D^T D)^{-1} D^T once (both problems
    share the f == 0 x-update through D; getProxOps.m:753-912)."""
    import jax.numpy as jnp
    import numpy as np

    check_data_vector(D, s)
    if np.shape(D)[0] < np.shape(D)[1]:
        raise ValueError(
            f"D must have at least as many rows as columns "
            f"(normal equations D^T D must be invertible), got {np.shape(D)}"
        )
    D = jnp.asarray(D)
    s = jnp.asarray(s)
    return {"D": D, "s": s, "Dplus": jnp.linalg.solve(D.T @ D, D.T)}


def timed_solver(fn):
    """Record whole-solver wall time as ``results.solverruntime``
    (reference: tic/toc around each solver, e.g. solvers/lasso.m:117,243).

    Also pins matmuls to full f32 precision for the solver's setup
    computations (Grams, factorizations): a lower default f32 matmul
    precision (bf16 passes on some accelerators, TF32 on the GPU)
    corrupts the solver algebra — the LP KKT projection diverges
    outright and the QP/BP oracles miss their f32 bars.  The setup GEMMs
    are one-time and the per-iteration applies are memory-bound GEMVs,
    so full precision costs little in wall-clock.  Explicitly
    bf16 inputs (FatShiftSolver streams) are unaffected — the precision
    flag only governs how f32 inputs are decomposed."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        import jax

        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            results = fn(*args, **kwargs)
        results.solverruntime = time.perf_counter() - t0
        return results

    return wrapper
