"""The model problem: min 1/2||Px - r||^2 + 1/2||Qx - s||^2 via ADMM
splitting f(x) = 1/2||Px - r||^2, g(z) = 1/2||Qz - s||^2, x - z = 0.

Reference: solvers/model.m (wrapper, precompute at model.m:119-138) and
getProxOps.m case 'model' (:55-95) with proxes xminModel (:952-975) /
zminModel (:989-1012):

    x <- (P^T P + rho I)^{-1} (P^T r + rho (z - u))
    z <- (Q^T Q + rho I)^{-1} (Q^T s + rho (x + u))

Design: the reference's rho-keyed diagonal-perturbation cache
(getProxOps.m:968-971) becomes either a materialized inverse (static rho:
one GEMV per prox) or a cached eigendecomposition (adaptive rho; see
ops/solve.py).  Prox operators are module-level functions over a ``data``
pytree so the compiled solver is cached across calls.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.solve import SymShiftSolver
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def _prox_f_static(x, z, u, rho, d):
    return d["PtPinv"] @ (d["Ptr"] + rho * (z - u))


def _prox_g_static(x, z, u, rho, d):
    return d["QtQinv"] @ (d["Qts"] + rho * (x + u))


def _prox_f_adaptive(x, z, u, rho, d):
    return d["solP"].solve(d["Ptr"] + rho * (z - u), rho)


def _prox_g_adaptive(x, z, u, rho, d):
    return d["solQ"].solve(d["Qts"] + rho * (x + u), rho)


def _obj(x, z, d):
    return 0.5 * jnp.sum((d["P"] @ x - d["r"]) ** 2) + 0.5 * jnp.sum(
        (d["Q"] @ z - d["s"]) ** 2
    )


def make_prox_ops(P, Q, r, s, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data) for the model problem."""
    P = jnp.asarray(P)
    Q = jnp.asarray(Q)
    r = jnp.asarray(r)
    s = jnp.asarray(s)
    data = {"P": P, "Q": Q, "r": r, "s": s, "Ptr": P.T @ r, "Qts": Q.T @ s}

    if config.dynamic_rho:
        data["solP"] = SymShiftSolver.from_matrix(P.T @ P)
        data["solQ"] = SymShiftSolver.from_matrix(Q.T @ Q)
        return _prox_f_adaptive, _prox_g_adaptive, _obj, data

    rho0 = config.rho
    data["PtPinv"] = SymShiftSolver.from_matrix(P.T @ P).materialize_inverse(rho0)
    data["QtQinv"] = SymShiftSolver.from_matrix(Q.T @ Q).materialize_inverse(rho0)
    return _prox_f_static, _prox_g_static, _obj, data


@register("model")
def _registry_entry(P, Q, r, s, config=ADMMConfig(), **_):
    pf, pg, obj, data = make_prox_ops(P, Q, r, s, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def model(P=None, Q=None, r=None, s=None, config: ADMMConfig = ADMMConfig(), *,
          x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve the model problem (reference solvers/model.m:47).

    Constraint wiring matches model.m:129-134: A = 1, B = -1, c = 0 in R^n.
    """
    if P is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import modeltest

        res, _test = modeltest(quiet=False)
        return res
    config = merge_config(config, overrides, body="gemv")
    P = jnp.asarray(P)
    n = P.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(P, Q, r, s, config)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=P.dtype, data=data,
    )
