"""Standard-form semidefinite programming via ADMM:

    min <C, X>   s.t.   A(X) = b,   X in the PSD cone

with A(X)_i = <A_i, X> for symmetric data matrices A_i (i = 1..m).

Beyond-reference family: the reference has no SDP solver, but this is
the canonical matrix-valued conic program of the ADMM literature (Boyd
et al. 2011 section 6; Wen, Goldfarb & Yin 2010) and slots straight
into the engine machinery the reference's covariance selection already
exercises (matrix iterates, admm.m:478-492; spectral z-prox shape,
getProxOps.m:1487-1496).

Splitting (X - Z = 0):

    f(X) = <C, X> + indicator{A(X) = b}
    g(Z) = indicator{Z >= 0 (PSD)}

x-prox:  affine projection.  With V = Z - U - C/rho,
             X = V - A^T (G^{-1} (A(V) - b)),   G = A A^T  (m x m Gram)
         G is factorized ONCE at setup (Cholesky) and the rho-dependence
         is the elementwise C/rho shift — no refactorization inside the
         loop, valid for any runtime rho (library invariant, CLAUDE.md).
z-prox:  PSD-cone projection of X + U — exact eigh (ops/prox.py
         psd_project) or the Newton-Schulz matmul-only evaluation
         (ops/matfun.py psd_project_ns), the same eigh->NS swap as
         covariance selection's matmul-only mode.

Constraint forms:

- dense: ``A`` is an (m, n, n) stack of symmetric matrices (A(V) is one
  einsum).
- ``A='diag'``: the diagonal constraint diag(X) = b (m = n), the
  max-cut / Goemans-Williamson relaxation.  Then G = I and the affine
  projection is "overwrite the diagonal with b" — O(n) per iteration
  instead of O(m n^2), and no (n, n, n) tensor is ever formed.

At a KKT point the scaled dual recovers the dual slack matrix:
S = C - A^T y = -rho * U  (up to sign conventions), so -rho * uopt
must be PSD and complementary to X — the oracle tests assert this.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import cho_factor, cho_solve

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.matfun import psd_project_ns
from ..ops.prox import psd_project
from ..results import ADMMResults
from . import register
from ._common import bind_data, merge_config, timed_solver


def check_gram_conditioning(L, bar_frac: float = 0.01):
    """Reject (near-)linearly dependent constraint stacks at setup.

    JAX's cho_factor fails SILENTLY on a singular Gram (NaNs, or a
    rounding-noise pivot for exactly dependent rows) and the solve
    would degrade to a garbage/diverged run.  The factor is concrete
    at setup — estimate cond(G) from the Cholesky pivots
    ((dmax/dmin)^2 bounds it below) and fail clearly.  Shared by the
    serial sdp setup and parallel/sdp.sdp_sharded (one rule, one
    threshold)."""
    piv = jnp.abs(jnp.diagonal(L))
    eps = float(jnp.finfo(L.dtype).eps)
    cond_est = float(jnp.max(piv) / jnp.maximum(jnp.min(piv), 0.0)) ** 2
    if not np.isfinite(cond_est) or cond_est > bar_frac / eps:
        raise ValueError(
            "constraint matrices A_i are (near-)linearly dependent: the "
            f"Gram G = A A^T has condition estimate {cond_est:.2e}; "
            "remove redundant constraints")


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def _prox_f_dense(X, Z, U, rho, d):
    V = Z - U - d["C"] / rho
    r = jnp.einsum("mij,ij->m", d["A"], V) - d["b"]
    y = cho_solve((d["L"], True), r)
    return V - jnp.einsum("m,mij->ij", y, d["A"])


def _prox_f_diag(X, Z, U, rho, d):
    # G = A A^T = I for the diagonal constraint: the affine projection
    # just overwrites diag(V) with b.
    V = Z - U - d["C"] / rho
    return V - jnp.diag(jnp.diagonal(V) - d["b"])


def _prox_g(X, Z, U, rho, d):
    return psd_project(U + X)


# maxsize=None: the key space is a handful of user knob tuples, and an
# eviction would silently mint a new function object, defeating the
# engine's function-identity compiled-runner cache (recompile).
@functools.lru_cache(maxsize=None)
def _ns_prox_g(ns_iters: int, ns_coarse: int, ns_correct: int,
               ns_delta: float):
    """Module-level-cached NS z-prox (caching contract: the engine's
    compiled-runner cache keys on function identity)."""

    def prox(X, Z, U, rho, d):
        return psd_project_ns(U + X, ns_iters, ns_coarse, ns_correct,
                              ns_delta)

    return prox


def _obj(X, Z, d):
    return jnp.sum(d["C"] * X)


def make_prox_ops(C, A, b, config: ADMMConfig = ADMMConfig(), *,
                  prox_method: str = "eigh", ns_iters: int = 24,
                  ns_coarse: int = 0, ns_correct: int = 0,
                  ns_delta: float = 0.0):
    """Build (prox_f, prox_g, obj, data) for the standard-form SDP.

    ``A`` is an (m, n, n) stack (symmetrized here) or the string
    ``'diag'`` for diag(X) = b.  ``prox_method='ns'`` swaps the eigh
    PSD projection for the Newton-Schulz matmul-only evaluation
    (``ns_*`` knobs as in ops/matfun.psd_project_ns — see its
    conditioning caveat; 'eigh' is the accuracy reference)."""
    if prox_method not in ("eigh", "ns"):
        raise ValueError(f"prox_method must be 'eigh' or 'ns', got {prox_method!r}")
    if prox_method == "ns" and int(ns_correct) > 0 and float(ns_delta) == 0.0:
        # Measured hard rule (docs/RESULTS.md round 4): the residual
        # correction applies the coupled inverse root, which blows up on
        # the near-singular W^2 of a PSD projection — corrections need a
        # regularized root.  Fail at setup instead of NaNs at runtime.
        raise ValueError(
            "prox_method='ns' with ns_correct > 0 requires ns_delta > 0: "
            "the residual correction's inverse root diverges on the "
            "near-singular projection argument (ops/matfun.psd_project_ns)")
    C = _sym(jnp.asarray(C))
    n = C.shape[-1]
    if C.shape != (n, n):
        raise ValueError(f"C must be square, got {C.shape}")
    b = jnp.atleast_1d(jnp.asarray(b, C.dtype))
    data = {"C": C, "b": b}
    if isinstance(A, str):
        if A != "diag":
            raise ValueError(f"string A must be 'diag', got {A!r}")
        if b.shape != (n,):
            raise ValueError(f"diag constraint needs b of shape {(n,)}, got {b.shape}")
        pf = _prox_f_diag
    else:
        A = _sym(jnp.asarray(A, C.dtype))
        if A.ndim != 3 or A.shape[1:] != (n, n):
            raise ValueError(f"A must be (m, {n}, {n}) or 'diag', got {A.shape}")
        m = A.shape[0]
        if b.shape != (m,):
            raise ValueError(f"b must have shape {(m,)}, got {b.shape}")
        G = jnp.einsum("mij,kij->mk", A, A)
        L, _ = cho_factor(G, lower=True)
        check_gram_conditioning(L)
        data.update({"A": A, "L": L})
        pf = _prox_f_dense
    pg = (_prox_g if prox_method == "eigh"
          else _ns_prox_g(int(ns_iters), int(ns_coarse), int(ns_correct),
                          float(ns_delta)))
    return pf, pg, _obj, data


@register("sdp")
def _registry_entry(C, A, b, config=ADMMConfig(), prox_method="eigh",
                    ns_iters=24, ns_coarse=0, ns_correct=0, ns_delta=0.0,
                    **_):
    pf, pg, obj, data = make_prox_ops(C, A, b, config,
                                      prox_method=prox_method,
                                      ns_iters=ns_iters, ns_coarse=ns_coarse,
                                      ns_correct=ns_correct, ns_delta=ns_delta)
    return bind_data(pf, pg, obj, data)


@timed_solver
def sdp(C=None, A=None, b=None, config: ADMMConfig = ADMMConfig(), *,
        prox_method: str = "eigh", ns_iters: int = 24, ns_coarse: int = 0,
        ns_correct: int = 0, ns_delta: float = 0.0,
        x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve min <C, X> s.t. A(X) = b, X PSD (standard-form SDP).

    Iterates are n-by-n matrices with zero initial state (the
    covariance-selection convention, covarianceselection.m:164-166).
    ``results.zopt`` is the PSD-feasible iterate, ``results.xopt`` the
    affine-feasible one; ``-rho * results.uopt`` estimates the dual
    slack matrix S = C - A^T y.

    ``A='diag'`` selects the diag(X) = b constraint (max-cut
    relaxation) with an O(n)-per-iteration affine projection.
    """
    if C is None or A is None or b is None:
        raise ValueError("sdp requires C, A, b (no demo dataset is defined)")
    config = merge_config(config, overrides, body="heavy")
    prox_f, prox_g, obj, data = make_prox_ops(
        C, A, b, config, prox_method=prox_method, ns_iters=ns_iters,
        ns_coarse=ns_coarse, ns_correct=ns_correct, ns_delta=ns_delta)
    n = data["C"].shape[-1]
    dt = data["C"].dtype
    zero = jnp.zeros((n, n), dtype=dt)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0,
        shape_x=(n, n), shape_z=(n, n),
        x0=zero if x0 is None else jnp.asarray(x0, dt),
        z0=zero if z0 is None else jnp.asarray(z0, dt),
        u0=zero if u0 is None else jnp.asarray(u0, dt),
        hooks=Hooks(obj=obj), dtype=dt, data=data,
    )


def random_sdp_instance(n: int, m: int, r: int, rng=None, dtype=np.float64):
    """Seeded SDP instance with a KNOWN primal-dual optimal pair, for
    oracle tests (the reference testers' constructible-truth strategy,
    SURVEY.md section 4).

    Construction: draw an orthonormal Q; split its columns into a rank-r
    primal block and a rank-(n-r) dual block.  Set
        X* = Q_1 diag(p) Q_1^T  (p > 0),    S* = Q_2 diag(q) Q_2^T  (q > 0)
    so X* S* = 0 with X* + S* strictly complementary.  Draw symmetric
    A_i and y*, then  C = S* + sum_i y*_i A_i  and  b = A(X*)  make
    (X*, y*, S*) satisfy the full KKT system, hence optimal with zero
    duality gap.  Returns (C, A, b, Xstar, ystar, Sstar).
    """
    rng = np.random.default_rng(0) if rng is None else rng
    M = rng.standard_normal((n, n))
    Q, _ = np.linalg.qr(M)
    p = rng.uniform(0.5, 2.0, size=r)
    q = rng.uniform(0.5, 2.0, size=n - r)
    Xstar = (Q[:, :r] * p) @ Q[:, :r].T
    Sstar = (Q[:, r:] * q) @ Q[:, r:].T
    A = rng.standard_normal((m, n, n))
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    ystar = rng.standard_normal(m)
    C = Sstar + np.einsum("m,mij->ij", ystar, A)
    b = np.einsum("mij,ij->m", A, Xstar)
    return (C.astype(dtype), A.astype(dtype), b.astype(dtype),
            Xstar.astype(dtype), ystar.astype(dtype), Sstar.astype(dtype))
