"""rho-parameterized linear-solve caches.

The reference caches Cholesky/LU factorizations keyed on "has rho changed"
(getProxOps.m:968-971 model; 1400-1405, 1444-1453 QP; solvers/lasso.m:160-177)
and lazily re-factorizes inside the iteration.  Under jit that pattern is
hostile (data-dependent refactorization, serial triangular solves).  This
design folds rho analytically:

    (M + rho I)^{-1} b  =  V ((V^T b) / (w + rho)),   M = V diag(w) V^T

with the symmetric eigendecomposition computed ONCE at setup.  Each
per-iteration application is two dense matmuls plus an elementwise
scale, is valid for *any* runtime rho (so adaptive-rho
needs no refactorization), batches under vmap, and shards cleanly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class SymShiftSolver:
    """Solves (M + rho*I) x = b for symmetric PSD M via cached eigh."""

    def __init__(self, V, w):
        self.V = V
        self.w = w

    @classmethod
    def from_matrix(cls, M) -> "SymShiftSolver":
        M = jnp.asarray(M)
        M = 0.5 * (M + M.T)  # enforce symmetry for eigh stability
        w, V = jnp.linalg.eigh(M)
        return cls(V, w)

    def solve(self, b, rho):
        y = self.V.T @ b
        y = y / (self.w + rho)
        return self.V @ y

    def solve_shifted(self, b, shift):
        """(M + shift*I)^{-1} b with arbitrary scalar shift."""
        return self.solve(b, shift)

    def materialize_inverse(self, rho):
        """Dense (M + rho I)^{-1} for the static-rho fast path: one GEMV per
        iteration instead of two (used when config.adaptive is False)."""
        return (self.V / (self.w + rho)[None, :]) @ self.V.T

    def tree_flatten(self):
        return (self.V, self.w), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class WoodburySolver:
    """Fat-matrix solve of (D^T D + rho I) x = b via the matrix-inversion
    lemma, matching the reference's fat-lasso branch
    (solvers/lasso.m:169-172; xminLASSO getProxOps.m:1198-1205):

        x = b/rho - (1/rho^2) D^T (D D^T/rho + I)^{-1} D b

    with the m-by-m Gram D D^T eigendecomposed once.
    """

    def __init__(self, D, V, w):
        self.D = D
        self.V = V  # eigvectors of D D^T
        self.w = w  # eigvalues of D D^T

    @classmethod
    def from_matrix(cls, D) -> "WoodburySolver":
        D = jnp.asarray(D)
        G = D @ D.T
        G = 0.5 * (G + G.T)
        w, V = jnp.linalg.eigh(G)
        return cls(D, V, w)

    def solve(self, b, rho):
        Db = self.D @ b
        # (D D^T / rho + I)^{-1} Db  ==  V ((V^T Db) / (w/rho + 1))
        y = self.V.T @ Db
        y = y / (self.w / rho + 1.0)
        y = self.V @ y
        return b / rho - (self.D.T @ y) / (rho * rho)

    def tree_flatten(self):
        return (self.D, self.V, self.w), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class FatShiftSolver:
    """Static-rho fat-matrix solve of (D^T D + rho0 I) x = b.

    Folds the Woodbury middle factor into a single precomputed m-by-n
    stream matrix E = (D D^T / rho0 + I)^{-1} D, so each application is

        x = b / rho0 - D^T (E b) / rho0^2

    i.e. exactly two m-by-n matvec streams from HBM per iteration —
    25% less HBM traffic than the factored WoodburySolver (which also
    streams the m-by-m eigenvector basis twice).  ``stream_dtype``
    optionally stores D and E in bfloat16 (f32 accumulation via
    preferred_element_type): half the bytes, for the bandwidth-bound
    regime where the matvec streams dominate the iteration.
    Valid only for the fixed rho0 captured at construction.
    """

    def __init__(self, D, E, rho0):
        self.D = D
        self.E = E
        self.rho0 = rho0

    @classmethod
    def from_matrix(cls, D, rho0, stream_dtype=None) -> "FatShiftSolver":
        D = jnp.asarray(D)
        rho0_arr = jnp.asarray(rho0, D.dtype)  # full precision, pre-downcast
        G = D @ D.T / rho0 + jnp.eye(D.shape[0], dtype=D.dtype)
        E = jnp.linalg.solve(0.5 * (G + G.T), D)
        if stream_dtype is not None:
            D = D.astype(stream_dtype)
            E = E.astype(stream_dtype)
        return cls(D, E, rho0_arr)

    def solve(self, b, rho=None):
        acc = jnp.float32 if self.D.dtype == jnp.bfloat16 else self.D.dtype
        bb = b.astype(self.D.dtype)
        Eb = jnp.matmul(self.E, bb, preferred_element_type=acc)
        DtEb = jnp.matmul(self.D.T, Eb.astype(self.D.dtype),
                          preferred_element_type=acc)
        rho0 = self.rho0.astype(b.dtype)
        return b / rho0 - DtEb.astype(b.dtype) / (rho0 * rho0)

    def tree_flatten(self):
        return (self.D, self.E, self.rho0), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class kkt_eq_solver:
    """Equality-constrained quadratic KKT solve via Schur complement.

    Solves   [ P + rho*I  D^T ] [x]   [ b1 ]
             [     D       0  ] [y] = [ b2 ]
    returning x — the LP/QP-standard x-prox system
    (reference xminLinearProgram getProxOps.m:1357-1365 with P = 0,
    xminQuadraticProgramStandard getProxOps.m:1397-1412).

    Instead of assembling and LU-factoring the (n+m)^2 KKT matrix per rho
    change like the reference, eliminate x:

        x = Minv (b1 - D^T y),  Minv = (P + rho I)^{-1}  (eigh of P, cached)
        S(rho) y = D Minv b1 - b2,  S(rho) = D Minv D^T

    With G = D V cached, S(rho) = G diag(1/(w+rho)) G^T is formed by one
    m-by-n matmul pair and factorized with an m-by-m Cholesky per
    call.  For LP (P = 0), S(rho) = (D D^T)/... still depends on rho only
    elementwise through diag, so the same path applies.
    """

    def __init__(self, D, V, w, G):
        self.D = D
        self.V = V  # eigvectors of P, or None when P = 0 (LP identity basis)
        self.w = w  # eigvalues of P (zeros for LP)
        self.G = G  # D @ V (== D when V is None)

    @classmethod
    def from_matrices(cls, D, P=None) -> "kkt_eq_solver":
        D = jnp.asarray(D)
        n = D.shape[1]
        if P is None:
            # LP: P = 0 -> identity eigenbasis, represented as V = None so
            # solve() skips the two identity matmuls. Avoids an n^3 eigh.
            V = None
            w = jnp.zeros((n,), dtype=D.dtype)
            G = D
        else:
            P = jnp.asarray(P)
            P = 0.5 * (P + P.T)
            w, V = jnp.linalg.eigh(P)
            G = D @ V
        return cls(D, V, w, G)

    def solve(self, b1, b2, rho):
        inv_diag = 1.0 / (self.w + rho)
        # Minv b1 in the eigenbasis (identity basis for LP).
        t1 = inv_diag * (b1 if self.V is None else self.V.T @ b1)
        rhs = self.G @ t1 - b2
        S = (self.G * inv_diag[None, :]) @ self.G.T
        S = 0.5 * (S + S.T)
        cf = jax.scipy.linalg.cho_factor(S)
        y = jax.scipy.linalg.cho_solve(cf, rhs)
        t2 = t1 - inv_diag * (self.G.T @ y)
        return t2 if self.V is None else self.V @ t2

    def materialize(self, rho) -> "StaticKKTSolver":
        """Fold the fixed-rho factorization ONCE at setup: per-iteration
        work becomes two n-sized GEMVs + one triangular pair — no
        refactorization inside the loop (CLAUDE.md invariant)."""
        inv_diag = 1.0 / (self.w + rho)
        S = (self.G * inv_diag[None, :]) @ self.G.T
        S = 0.5 * (S + S.T)
        cf, lower = jax.scipy.linalg.cho_factor(S)
        if self.V is None:
            Minv = jnp.diag(inv_diag)
        else:
            Minv = (self.V * inv_diag[None, :]) @ self.V.T
        # x = Minv b1 - MinvDt y;  y = cho_solve(S, D Minv b1 - b2)
        return StaticKKTSolver(Minv, Minv @ self.D.T, self.D, cf, lower)

    def materialize_affine(self, rho, b2) -> "AffineKKTSolver":
        """Fold the ENTIRE fixed-rho KKT solve into one affine map.

        The constraint right-hand side b2 is a per-problem constant (the
        engine calls the x-prox with the same s every iteration), so

            x = Minv b1 - MinvDt S^{-1} (D Minv b1 - b2)
              = K1 b1 + x0,
            K1 = Minv - MinvDt S^{-1} D Minv,   x0 = MinvDt S^{-1} b2

        — the upper-left block of the KKT inverse applied by ONE n-by-n
        GEMV per iteration.  No triangular solves inside the loop, so the
        body unrolls as well as any GEMV solver (LP/QP-standard
        previously preferred unroll=1 because the triangular pair does
        not amortize).  For the LP (V=None), K1 is (1/rho) times the
        orthogonal projector onto null(D) — the same structure as the
        basis-pursuit prox.  Forward error of the explicit-inverse apply
        is O(kappa(KKT) eps), same order as the factored solve's forward
        error; the f64 oracle bar (LP 1e-10) holds — see
        tests/test_linearprogram.py.
        """
        K1, W = self.materialize_affine_map(rho)
        return AffineKKTSolver(K1, W @ jnp.asarray(b2))

    def materialize_affine_map(self, rho):
        """Shared pieces of the fixed-rho affine fold, for callers with
        MANY constraint right-hand sides (models/batch.py lp/qp):

            x = K1 b1 + W b2,   W = MinvDt S^{-1}   (n-by-m)

        K1 and W depend only on (D, P, rho), so a batch of b2 vectors
        folds into per-lane offsets with one setup GEMM (B, m) @ W^T."""
        inv_diag = 1.0 / (self.w + rho)
        S = (self.G * inv_diag[None, :]) @ self.G.T
        S = 0.5 * (S + S.T)
        cf = jax.scipy.linalg.cho_factor(S)
        if self.V is None:
            Minv = jnp.diag(inv_diag)
        else:
            Minv = (self.V * inv_diag[None, :]) @ self.V.T
        MinvDt = Minv @ self.D.T
        K1 = Minv - MinvDt @ jax.scipy.linalg.cho_solve(cf, self.D @ Minv)
        K1 = 0.5 * (K1 + K1.T)  # exact symmetry of the KKT inverse block
        W = jax.scipy.linalg.cho_solve(cf, MinvDt.T).T
        return K1, W

    def tree_flatten(self):
        return (self.D, self.V, self.w, self.G), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class AffineKKTSolver:
    """Fully-folded fixed-rho KKT apply (see
    kkt_eq_solver.materialize_affine): x = K1 @ b1 + x0.

    ``solve`` keeps the (b1, b2, rho) signature of the other KKT solvers
    for drop-in use by the LP/QP x-prox; b2 and rho are ignored — both
    were folded into (K1, x0) at setup.
    """

    def __init__(self, K1, x0):
        self.K1 = K1
        self.x0 = x0

    def solve(self, b1, b2=None, rho=None):
        return self.K1 @ b1 + self.x0

    def tree_flatten(self):
        return (self.K1, self.x0), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
class StaticKKTSolver:
    """Fixed-rho KKT apply: all factors precomputed (see
    kkt_eq_solver.materialize)."""

    def __init__(self, Minv, MinvDt, D, cf, lower):
        self.Minv = Minv
        self.MinvDt = MinvDt
        self.D = D
        self.cf = cf
        self.lower = lower

    def solve(self, b1, b2, rho=None):
        t1 = self.Minv @ b1
        y = jax.scipy.linalg.cho_solve((self.cf, self.lower), self.D @ t1 - b2)
        return t1 - self.MinvDt @ y

    def tree_flatten(self):
        return (self.Minv, self.MinvDt, self.D, self.cf), self.lower

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)
