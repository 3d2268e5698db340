"""Total variation minimization (1-D denoising):

    min 1/2 ||x - s||^2 + lambda ||z||_1   s.t.   D x - z = 0

with D the bidiagonal difference operator (solvers/totalvariation.m:127).

Reference: solvers/totalvariation.m (wrapper; A = D, B = -1 at :151-156)
and getProxOps.m case 'totalvariation' (:145-199) with x-prox
xminTotalVariation (getProxOps.m:1044-1048).

x-update:  (I + rho D^T D)^{-1} (s + rho D^T (z - u))
z-update:  soft_threshold(u + D x, lambda / rho)

Design: D and D^T apply matrix-free in O(n) (linop.DiffOp); the
tridiagonal system (I + rho D^T D) is diagonalized once at setup (dense
eigh of the structured Gram), so each x-update is matmul work valid
for any runtime rho.  The reference instead sparse-backslashes the system
every iteration (getProxOps.m:1048).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..linop import DiffOp
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["Minv"] @ (d["s"] + rho * d["D"].rmv(z - u))


def _prox_f_cr(x, z, u, rho, d):
    # O(n log n) cyclic-reduction solve of the fixed tridiagonal system
    # (ops/tridiag.py) — replaces the O(n^2) dense apply at large n.
    return d["cr"].solve(d["s"] + rho * d["D"].rmv(z - u))


def _prox_f_adaptive(x, z, u, rho, d):
    b = d["s"] + rho * d["D"].rmv(z - u)
    return d["V"] @ ((d["V"].T @ b) / (1.0 + rho * d["w"]))


def _prox_g(x, z, u, rho, d):
    # The engine passes raw x; the reference z-prox applies D itself
    # (getProxOps.m case :145-199).
    return soft_threshold(u + d["D"].mv(x), d["lam"] / rho)


def _prox_g_relaxed(Axhat, z, u, rho, d):
    # Under relaxation the engine hands Axhat (already in D-space).
    return soft_threshold(u + Axhat, d["lam"] / rho)


def _obj(x, z, d):
    return 0.5 * jnp.sum((x - d["s"]) ** 2) + d["lam"] * jnp.sum(jnp.abs(z))


def make_prox_ops(s, lam, config: ADMMConfig = ADMMConfig(), solver: str = "auto",
                  batched: bool = False):
    """Build (prox_f, prox_g, obj, data, D) for TV (getProxOps.m:145-199).

    ``solver``: 'dense' diagonalizes D^T D once (O(n^2) apply per
    iteration); 'cr' precomputes a HYBRID cyclic-reduction elimination
    of the fixed tridiagonal system — masked full-length levels down to
    a <= 1023-size reduced system finished by one dense-inverse GEMV
    (ops/tridiag.CyclicReductionSolver dense_cutoff; the tail is gated
    on n > 16384 — below that 'cr' IS the masked form); 'cr_masked'
    runs every level masked; 'cr_packed' is the per-level packed layout
    (asymptotically fewer bytes); 'auto' picks 'cr' for n > 2048 with
    static rho.  Which of these wins on the GPU is not yet measured
    (ROADMAP §3.4).
    """
    s = jnp.asarray(s)
    n = s.shape[0]
    D = DiffOp(n)
    data = {"s": s, "lam": jnp.asarray(lam, s.dtype), "D": D}

    if solver == "auto":
        solver = "cr" if (n > 2048 and not config.dynamic_rho) else "dense"
    if solver in ("cr", "cr_masked", "cr_packed") and config.dynamic_rho:
        raise ValueError("cyclic-reduction TV requires static rho")

    if solver in ("cr", "cr_masked", "cr_packed"):
        import numpy as np

        from ..ops.tridiag import (CyclicReductionSolver,
                                   PackedCyclicReductionSolver)

        # I + rho D^T D is tridiag(-rho, 1 + rho*[1,2,...,2], -rho)
        # (D^T D = I + diag(0,1,..,1) - U - U^T for the DiffOp stencil).
        rho = config.rho
        diag = 1.0 + rho * np.r_[1.0, 2.0 * np.ones(n - 1)]
        off = -rho * np.ones(n)
        args = (np.r_[0.0, off[1:]], diag, np.r_[off[:-1], 0.0])
        if solver == "cr_packed":
            data["cr"] = PackedCyclicReductionSolver.from_tridiag(*args)
        elif solver == "cr_masked":
            data["cr"] = CyclicReductionSolver.from_tridiag(*args)
        else:
            # Hybrid dense tail only where the saved deep sweeps can
            # beat its fixed gather/scatter+GEMV cost: deep single
            # signals, and BATCHED lanes, which amortize the tail (the
            # gather feeds one (B, m) x (m, m) GEMM) and multiply the
            # per-level stream cost by B.  Exact to 7e-8 in f32.
            cutoff = 1023 if (batched or n > 16384) else None
            data["cr"] = CyclicReductionSolver.from_tridiag(
                *args, dense_cutoff=cutoff)
        prox_f = _prox_f_cr
    else:
        Dd = D.dense(s.dtype)
        DtD = Dd.T @ Dd  # dense D^T D (tridiagonal), built once at setup
        DtD = 0.5 * (DtD + DtD.T)
        w, V = jnp.linalg.eigh(DtD)
        if config.dynamic_rho:
            data["V"], data["w"] = V, w
            prox_f = _prox_f_adaptive
        else:
            data["Minv"] = (V / (1.0 + config.rho * w)[None, :]) @ V.T
            prox_f = _prox_f_static

    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return prox_f, prox_g, _obj, data, D


@register("totalvariation")
def _registry_entry(s, lam, config=ADMMConfig(), **_):
    pf, pg, obj, data, _D = make_prox_ops(s, lam, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def totalvariation(s=None, lam=None, config: ADMMConfig = ADMMConfig(), *,
                   solver: str = "auto", x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve 1-D TV denoising (reference solvers/totalvariation.m:62).

    Constraint wiring matches totalvariation.m:151-156: A = D, B = -1, c = 0.
    """
    if s is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import totalvariationtest

        res, _test = totalvariationtest(quiet=False)
        return res
    s = jnp.asarray(s)
    n = s.shape[0]
    # Apply overrides BEFORE resolving the solve path: an override like
    # adaptive=True flips dynamic_rho, which flips the auto dense/cr
    # choice.  merge_config would resolve unroll='auto' prematurely, so
    # replace directly and resolve once the path is known.
    if overrides:
        import dataclasses

        config = dataclasses.replace(config, **overrides)
    resolved = solver
    if resolved == "auto":
        resolved = "cr" if (n > 2048 and not config.dynamic_rho) else "dense"
    # The dense (eig-folded GEMV) body unrolls like any GEMV solver; the
    # cyclic-reduction body is a log(n) sweep of small kernels and keeps
    # the balanced default.
    config = merge_config(config, {},
                          body="gemv" if resolved == "dense" else "default")
    # Pass the RESOLVED path so this choice and make_prox_ops's cannot
    # disagree (its own auto branch remains for direct callers).
    prox_f, prox_g, obj, data, D = make_prox_ops(s, lam, config, resolved)
    return admm(
        prox_f, prox_g, config,
        A=D, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=s.dtype, data=data,
    )
