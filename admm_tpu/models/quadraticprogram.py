"""Quadratic program in two constraint forms (auto-detected like the
reference, solvers/quadraticprogram.m:259-364):

standard:   min 1/2 x^T P x + q^T x + r   s.t.  D x = s,  x >= 0
bounded:    min 1/2 x^T P x + q^T x + r   s.t.  lb <= x <= ub

Reference: solvers/quadraticprogram.m (wrapper; rho-keyed factor caches at
:188-219) and getProxOps.m case 'quadraticprogram' (:545-666) with proxes
xminQPStandard (getProxOps.m:1397-1412), xminQPBounded (:1441-1456) and
zminQPBounded (:1470-1474).

standard x-update:  KKT solve [P + rho I, D^T; D, 0][x;y] =
                    [rho (z - u) - q; s], keep x
standard z-update:  max(x + u, 0)
bounded  x-update:  (P + rho I)^{-1} (rho (z - u) - q)
bounded  z-update:  clip(x + u, lb, ub)   (user altproxg overrides,
                    getProxOps.m case :545-666)

Design: both re-factorization paths (the reference re-chol's whenever
rho changes, getProxOps.m:1400-1405, 1444-1453) are replaced by a one-time
eigendecomposition of P; per-iteration work is matmuls valid for any
runtime rho.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import project_box, project_nonneg
from ..ops.solve import SymShiftSolver, kkt_eq_solver
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f_standard(x, z, u, rho, d):
    return d["kkt"].solve(rho * (z - u) - d["q"], d["s"], rho)


def _prox_g_standard(x, z, u, rho, d):
    return project_nonneg(x + u)


def _prox_f_bounded_static(x, z, u, rho, d):
    return d["Minv"] @ (rho * (z - u) - d["q"])


def _prox_f_bounded_adaptive(x, z, u, rho, d):
    return d["sol"].solve(rho * (z - u) - d["q"], rho)


def _prox_g_bounded(x, z, u, rho, d):
    return project_box(x + u, d["lb"], d["ub"])


def _obj(x, z, d):
    return 0.5 * jnp.dot(x, d["P"] @ x) + jnp.dot(d["q"], x) + d["r"]


def make_prox_ops_standard(
    P, q, D, s, config: ADMMConfig = ADMMConfig(),
    altproxg: Optional[Callable] = None, kkt_mode: str = "affine",
):
    """Standard (equality + nonnegativity) form (getProxOps.m:1397-1412).
    Static rho folds the whole KKT solve once at setup into the affine
    map x = K1 b1 + x0 (one GEMV per iteration, unrollable — see
    kkt_eq_solver.materialize_affine); ``kkt_mode='chol'`` keeps the
    factored two-GEMV + triangular-pair apply.

    ``altproxg(x, z, u, rho, data) -> z`` replaces the nonnegativity
    projection (the reference's args.altproxg, getProxOps.m:664-666)."""
    if kkt_mode not in ("affine", "chol"):
        raise ValueError(f"kkt_mode must be 'affine' or 'chol', got {kkt_mode!r}")
    kkt = kkt_eq_solver.from_matrices(jnp.asarray(D), P=jnp.asarray(P))
    if not config.dynamic_rho:
        kkt = (kkt.materialize_affine(config.rho, jnp.asarray(s))
               if kkt_mode == "affine" else kkt.materialize(config.rho))
    data = {
        "q": jnp.asarray(q),
        "s": jnp.asarray(s),
        "kkt": kkt,
    }
    prox_g = altproxg if altproxg is not None else _prox_g_standard
    return _prox_f_standard, prox_g, data


def make_prox_ops_bounded(
    P, q, lb, ub, config: ADMMConfig = ADMMConfig(),
    altproxg: Optional[Callable] = None,
):
    """Bounded (box-constrained) form (getProxOps.m:1441-1474)."""
    P = jnp.asarray(P)
    data = {
        "q": jnp.asarray(q),
        "lb": jnp.asarray(lb),
        "ub": jnp.asarray(ub),
    }
    if config.dynamic_rho:
        data["sol"] = SymShiftSolver.from_matrix(P)
        prox_f = _prox_f_bounded_adaptive
    else:
        data["Minv"] = SymShiftSolver.from_matrix(P).materialize_inverse(config.rho)
        prox_f = _prox_f_bounded_static
    prox_g = altproxg if altproxg is not None else _prox_g_bounded
    return prox_f, prox_g, data


@register("quadraticprogram")
def _registry_entry(P, q, D=None, s=None, lb=None, ub=None, config=ADMMConfig(),
                    kkt_mode="affine", **_):
    if D is not None:
        pf, pg, data = make_prox_ops_standard(P, q, D, s, config,
                                              kkt_mode=kkt_mode)
    else:
        pf, pg, data = make_prox_ops_bounded(P, q, lb, ub, config)
    return bind_data(pf, pg, None, data)


@timed_solver
def quadraticprogram(
    P=None, q=None, r=None, cons1=None, cons2=None,
    config: ADMMConfig = ADMMConfig(), altproxg: Optional[Callable] = None,
    kkt_mode: str = "affine", *, precondition: bool = False,
    ruiz_iters: int = 15, x0=None, z0=None, u0=None, **overrides
) -> ADMMResults:
    """Solve a QP (reference solvers/quadraticprogram.m:99).

    Constraint-form auto-detection mirrors quadraticprogram.m:259-364:
    ``(cons1, cons2) = (D, s)`` with 2-D D selects the standard form;
    two vectors of length n select the bounded form (bounds are
    normalized so lb <= ub elementwise, quadraticprogram.m:340-350).
    ``altproxg`` replaces the z-prox in either form (getProxOps.m:664-666).
    ``kkt_mode`` ('affine' default / 'chol') applies to the standard form.

    ``precondition=True`` Ruiz-equilibrates the KKT structure
    [[P, Dᵀ], [D, 0]] (ops/scaling.py; bounded form: P alone, with the
    box bounds scaled along) and solves the equivalent scaled QP —
    identical optimum and objective value, far fewer iterations on
    badly scaled data.  xopt/zopt/uopt are unscaled back; residual
    traces and the Boyd stop act in the SCALED space (OSQP convention);
    ``results.extra`` carries the scales; altproxg/warm starts then
    live in the scaled space (x̃ = x / e).
    """
    if P is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import quadraticprogramtest

        res, _test = quadraticprogramtest(quiet=False)
        return res
    if not precondition:
        import numpy as _np

        from .linearprogram import _warn_if_badly_scaled

        # Gate on host-resident inputs (the helper also size-caps);
        # device-resident P/cons1 skip the check rather than paying a
        # transfer per solve.
        if isinstance(P, _np.ndarray):
            _c1 = cons1 if isinstance(cons1, _np.ndarray) else None
            _warn_if_badly_scaled(
                _c1 if (_c1 is not None and _c1.ndim == 2)
                else _np.zeros((0, P.shape[0])), P)
    if precondition:
        import numpy as np

        from ..ops.scaling import ruiz_equilibrate

        P_np = np.asarray(P)
        dtype = P_np.dtype
        P64 = np.asarray(P, np.float64)
        c1 = np.asarray(cons1)
        standard = c1.ndim == 2
        e, rr = ruiz_equilibrate(c1 if standard else None, P64,
                                 iters=ruiz_iters)
        Ps = ((e[:, None] * P64) * e[None, :]).astype(dtype)
        qs = (e * np.asarray(q, np.float64)).astype(dtype)
        if standard:
            c1s = ((rr[:, None] * np.asarray(c1, np.float64))
                   * e[None, :]).astype(dtype)
            c2s = (rr * np.asarray(cons2, np.float64)).astype(dtype)
        else:
            # Box bounds transform as x̃ = x / e (e > 0 keeps order).
            c1s = (np.asarray(cons1, np.float64) / e).astype(dtype)
            c2s = (np.asarray(cons2, np.float64) / e).astype(dtype)
        # Dual direction: ũ = e·u (see linearprogram's precondition
        # note) — warm-start duals scale up, the returned dual down.
        res = quadraticprogram(
            Ps, qs, r, c1s, c2s, config, altproxg, kkt_mode,
            x0=None if x0 is None else np.asarray(x0, np.float64) / e,
            z0=None if z0 is None else np.asarray(z0, np.float64) / e,
            u0=None if u0 is None else np.asarray(u0, np.float64) * e,
            **overrides)
        ev = jnp.asarray(e).astype(res.xopt.dtype)
        res.xopt = ev * res.xopt
        res.zopt = ev * res.zopt
        res.uopt = res.uopt / ev
        res.extra = {**(res.extra or {}), "ruiz_col": e,
                     "ruiz_row": rr if standard else None}
        return res
    # affine KKT fold = one-GEMV body ('gemv'); chol mode's triangular
    # sweeps are 'heavy'.
    config = merge_config(config, overrides,
                          body="gemv" if kkt_mode == "affine" else "heavy")
    P = jnp.asarray(P)
    q = jnp.asarray(q)
    n = P.shape[0]
    c1 = jnp.asarray(cons1)

    if c1.ndim == 2:
        prox_f, prox_g, data = make_prox_ops_standard(
            P, q, c1, cons2, config, altproxg=altproxg, kkt_mode=kkt_mode)
    else:
        u_ = jnp.asarray(cons2)
        lb, ub = jnp.minimum(c1, u_), jnp.maximum(c1, u_)
        prox_f, prox_g, data = make_prox_ops_bounded(
            P, q, lb, ub, config, altproxg=altproxg)

    data["P"] = P
    data["r"] = jnp.asarray(r, P.dtype)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=_obj), dtype=P.dtype, data=data,
    )
