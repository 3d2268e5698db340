"""Standard-form linear program:

    min b^T x   s.t.   D x = s,  x >= 0

split as f(x) = b^T x + indicator{Dx = s}, g(z) = indicator{z >= 0},
x - z = 0.

Reference: solvers/linearprogram.m (wrapper; KKT caches at :146-157) and
getProxOps.m case 'linearprogram' (:459-542) with proxes xminLinearProgram
(getProxOps.m:1357-1365) and zminLinearProgram (getProxOps.m:1378-1382).

x-update:  KKT solve [rho I, D^T; D, 0] [x; y] = [rho (z - u) - b; s],
           keep the x block
z-update:  max(x + u, 0)

Design: instead of LU-factoring the (n+m)^2 KKT matrix per rho change
(the reference's approach), the Schur-complement solver in ops/solve.py
eliminates x analytically; per-iteration work is matmuls plus one
m-by-m Cholesky, valid for any runtime rho.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import project_nonneg
from ..ops.solve import kkt_eq_solver
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["kkt"].solve(rho * (z - u) - d["b"], d["s"], rho)


def _prox_g(x, z, u, rho, d):
    return project_nonneg(x + u)


def _obj(x, z, d):
    return jnp.dot(d["b"], x)


def make_prox_ops(b, D, s, config: ADMMConfig = ADMMConfig(), altproxg=None,
                  kkt_mode: str = "affine"):
    """Build (prox_f, prox_g, obj, data) for the LP (getProxOps.m:459-542).

    Static rho (the default) folds the whole KKT solve at setup into one
    affine map x = K1 b1 + x0 (kkt_eq_solver.materialize_affine) — a
    single n-by-n GEMV per iteration, no in-loop triangular solves, so
    the body unrolls like any GEMV solver.  ``kkt_mode='chol'`` keeps
    the factored apply (two GEMVs + triangular pair) for
    ill-conditioned constraint blocks; dynamic-rho configs use the
    rho-parameterized Schur path regardless.

    ``altproxg(x, z, u, rho, data) -> z`` replaces the nonnegativity
    projection (the reference's args.altproxg, linearprogram.m:162-171);
    pass a module-level function to keep the compile cache warm."""
    if kkt_mode not in ("affine", "chol"):
        raise ValueError(f"kkt_mode must be 'affine' or 'chol', got {kkt_mode!r}")
    b = jnp.asarray(b)
    D = jnp.asarray(D)
    s = jnp.asarray(s)
    kkt = kkt_eq_solver.from_matrices(D, P=None)
    if not config.dynamic_rho:
        kkt = (kkt.materialize_affine(config.rho, s) if kkt_mode == "affine"
               else kkt.materialize(config.rho))
    data = {"b": b, "s": s, "kkt": kkt}
    prox_g = altproxg if altproxg is not None else _prox_g
    return _prox_f, prox_g, _obj, data


def _warn_if_badly_scaled(D, P, bar: float = 1e5):
    """One-line steer toward precondition=True when the KKT row-norm
    spread says plain ADMM will struggle (no reference analog — its
    testers only generate well-scaled data).  Runs only for
    HOST-resident data of bounded size: device-resident operands would
    pay a device->host transfer per solve, and repeat solves at
    headline scales would bill an O(mn) f64 scan to solverruntime
    every call just to stay silent (review finding)."""
    import warnings

    import numpy as np

    if not isinstance(D, np.ndarray) or D.size > 4_000_000:
        return
    if P is not None and (not isinstance(P, np.ndarray)
                          or P.size > 4_000_000):
        return

    from ..ops.scaling import kkt_scale_quality

    q = kkt_scale_quality(np.asarray(D), P)
    if q > bar:
        warnings.warn(
            f"constraint data is badly scaled (KKT row-norm spread "
            f"{q:.1e}); plain ADMM may converge slowly or stall — "
            f"consider precondition=True (Ruiz equilibration)",
            RuntimeWarning, stacklevel=3)


@register("linearprogram")
def _registry_entry(b, D, s, config=ADMMConfig(), kkt_mode="affine", **_):
    pf, pg, obj, data = make_prox_ops(b, D, s, config, kkt_mode=kkt_mode)
    return bind_data(pf, pg, obj, data)


@timed_solver
def linearprogram(b=None, D=None, s=None, config: ADMMConfig = ADMMConfig(),
                  altproxg=None, kkt_mode: str = "affine", *,
                  precondition: bool = False, ruiz_iters: int = 15,
                  x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve the standard-form LP (reference solvers/linearprogram.m:81).

    Constraint wiring: A = 1, B = -1, c = 0 in R^n.  ``altproxg``
    replaces the z-prox (reference linearprogram.m:162-171).
    ``kkt_mode``: 'affine' (default — fully-folded one-GEMV x-prox) or
    'chol' (factored apply; see make_prox_ops).

    ``precondition=True`` Ruiz-equilibrates the constraint matrix first
    (ops/scaling.py; no reference analog) and solves the equivalent
    scaled LP — same optimum and objective value, far fewer iterations
    on badly scaled data.  Returned xopt/zopt/uopt are unscaled back;
    residual traces and the Boyd stop act in the SCALED space (the OSQP
    convention); ``results.extra`` carries the scales.  ``altproxg``
    and warm starts then also live in the scaled space (x̃ = x / e).
    """
    if b is None:
        # Zero-arg demo mode (reference solvers, e.g. lasso.m:122-129).
        from ..testers.problems import linearprogramtest

        res, _test = linearprogramtest(quiet=False)
        return res
    check_data_vector(D, s)
    if not precondition:
        _warn_if_badly_scaled(D, None)
    if precondition:
        import numpy as np

        from ..ops.scaling import ruiz_equilibrate

        D_np = np.asarray(D)
        dtype = D_np.dtype
        e, rr = ruiz_equilibrate(D_np, iters=ruiz_iters)
        Ds = ((rr[:, None] * np.asarray(D, np.float64)) * e[None, :]).astype(dtype)
        bs = (e * np.asarray(b, np.float64)).astype(dtype)
        ss = (rr * np.asarray(s, np.float64)).astype(dtype)
        # Iterates transform as x̃ = x / e; the SCALED DUAL transforms
        # the other way: ∂g̃(x̃) = E ∂g(x), so rho·ũ = E·(rho·u) and
        # ũ = e·u — warm-start duals scale UP by e and the returned
        # dual scales DOWN (a review pass measured the inverted
        # direction off by e² per coordinate).
        res = linearprogram(
            bs, Ds, ss, config, altproxg, kkt_mode,
            x0=None if x0 is None else np.asarray(x0, np.float64) / e,
            z0=None if z0 is None else np.asarray(z0, np.float64) / e,
            u0=None if u0 is None else np.asarray(u0, np.float64) * e,
            **overrides)
        ev = jnp.asarray(e).astype(res.xopt.dtype)
        res.xopt = ev * res.xopt
        res.zopt = ev * res.zopt
        res.uopt = res.uopt / ev
        res.extra = {**(res.extra or {}), "ruiz_col": e, "ruiz_row": rr}
        return res
    # affine mode is a one-GEMV body ('gemv'); the factored chol apply is
    # triangular-sweep dominated ('heavy').
    config = merge_config(config, overrides,
                          body="gemv" if kkt_mode == "affine" else "heavy")
    D = jnp.asarray(D)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(b, D, s, config,
                                              altproxg=altproxg,
                                              kkt_mode=kkt_mode)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data,
    )
