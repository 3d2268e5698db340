"""Matmul-only matrix functions.

The covariance-selection x-prox is a spectral function of the symmetric
matrix W = rho*(Z - U) - S (reference xminCovarianceSelection,
getProxOps.m:1487-1496):

    X = f(W),   f(e) = (e + sqrt(e^2 + 4 rho)) / (2 rho)
              = (W + sqrt(W^2 + 4 rho I)) / (2 rho)

The reference (and our default path, ops/prox.py:covsel_eig_prox)
evaluates it by full eigendecomposition.  `eigh` of a modest n-by-n
matrix is latency-bound, scalar-heavy work, while the equivalent matrix
square root is computable with *nothing but n^3 matmuls* via the
coupled Newton-Schulz iteration — what matrix units are built for:

    A = W^2 + 4 rho I   (SPD: every eigenvalue >= 4 rho)
    Y_0 = A / c, Z_0 = I         with  c >= lambda_max(A)
    T_k = (3 I - Z_k Y_k) / 2
    Y_{k+1} = Y_k T_k,  Z_{k+1} = T_k Z_k
    Y_k -> sqrt(A / c),  Z_k -> (A / c)^{-1/2}

The two update products ride one batched GEMM via the exact transpose
identity T Z = (Z^T T^T)^T.  (Do NOT "simplify" to Z T by
commutativity: the iterates commute only in exact arithmetic, and that
rearrangement is numerically unstable — it diverges in f64 by
kappa ~1e4, a classic coupled-Newton-Schulz stability trap.)
Convergence is globally monotone then quadratic; the
linear phase contracts the smallest-eigenvalue error by ~2.25x per
step, so the iteration count needed is ~log(kappa)/log(2.25) + ~5.
Measured accuracy (CPU f64): K=20 reaches machine precision for
kappa(A) up to 1e7; kappa(A) <= 1 + lambda_max(W)^2 / (4 rho) is
moderate in practice because rho is the ADMM step size, not a small
regularizer.
"""

from __future__ import annotations

import jax.numpy as jnp


def _spectral_upper_bound(A):
    """Cheap safe upper bound on lambda_max(A) for symmetric A:
    min(Frobenius norm, max absolute row sum).  Both dominate the
    spectral radius; the min is tight enough that it costs at most
    ~log_2.25(sqrt(n)) extra Newton-Schulz steps."""
    fro = jnp.linalg.norm(A, axis=(-2, -1))
    row = jnp.max(jnp.sum(jnp.abs(A), axis=-1), axis=-1)
    return jnp.minimum(fro, row)


def ns_sqrtm(A, iters: int = 20, coarse: int = 0, correct: int = 0):
    """sqrt(A) for symmetric positive-definite A via coupled
    Newton-Schulz — matmuls only, no factorization.

    Supports leading batch dimensions.  ``iters`` is static (the loop is
    unrolled at trace time into 2 GEMMs + 1 batched GEMM per step).  Use iters ~ log(kappa(A))/log(2.25) + 5; the default 20
    covers kappa up to ~1e7 at f64 machine precision.

    ``coarse``: run the FIRST ``coarse`` iterations at the default
    matmul precision (TF32 on the GPU) and only the remaining ones at the
    ambient (full) precision.  CAVEAT (n = 512-1024): trailing
    full-precision NS steps do NOT square the coarse noise away (they
    left rel-F at the all-coarse level) — coarse noise drifts the coupled
    (Y, Z) pair off its invariant manifold, in exactly the directions
    the iteration does not contract (the same instability that forbids
    the Z <- ZT rearrangement).  Use ``correct`` to recover accuracy.

    ``correct``: after the iteration, apply that many residual
    corrections at the ambient precision — the first-order Sylvester
    update dS S + S dS = A - S^2 approximated via the computed inverse
    root, S += 0.5 (A - S^2) Z/sqrt(c).  Unlike trailing NS steps this
    contracts the actual residual regardless of manifold drift: coarse NS
    noise drops by orders of magnitude per correction step at a cost of
    ~3 matmuls.  The fast covsel recipe is coarse=iters, correct=2.
    """
    n = A.shape[-1]
    I = jnp.eye(n, dtype=A.dtype)
    c = _spectral_upper_bound(A)[..., None, None]
    Y = A / c
    Z = jnp.broadcast_to(I, A.shape)
    tr = lambda M: jnp.swapaxes(M, -1, -2)

    def step(Y, Z):
        T = 1.5 * I - 0.5 * (Z @ Y)
        # Stable coupled update Y <- Y T, Z <- T Z, with T Z computed as
        # (Z^T T^T)^T so both products form one batched GEMM.
        P = jnp.stack([Y, tr(Z)], axis=0) @ jnp.stack([T, tr(T)], axis=0)
        return P[0], tr(P[1])

    import jax

    coarse = min(int(coarse), int(iters))
    if coarse:
        with jax.default_matmul_precision("default"):
            for _ in range(coarse):
                Y, Z = step(Y, Z)
    for _ in range(iters - coarse):
        Y, Z = step(Y, Z)
    S = jnp.sqrt(c) * Y
    S = 0.5 * (S + tr(S))
    if correct:
        Zs = Z / jnp.sqrt(c)  # ~ S^{-1} from the coupled iteration
        for _ in range(int(correct)):
            E = A - S @ S
            S = S + 0.5 * (E @ Zs)
            S = 0.5 * (S + tr(S))
    return S


def covsel_ns_prox(W, rho, iters: int = 20, coarse: int = 0,
                   correct: int = 0, weight=1.0):
    """Covariance-selection x-prox via Newton-Schulz square root.

    Exact same spectral function as ops/prox.py:covsel_eig_prox
    (reference getProxOps.m:1487-1496) but evaluated as
    (W + sqrt(W^2 + 4 rho w I)) / (2 rho) with ns_sqrtm — pure matmul
    work, no eigendecomposition inside the ADMM loop.  ``coarse`` (see
    ns_sqrtm) runs that many leading square-root steps at the default
    matmul precision (TF32 on the GPU); the W^2 forming A stays at the
    ambient full precision — a coarse A would bound the result's
    accuracy no matter how the iteration refines.  ``correct``
    residual-correction steps at full precision recover the accuracy the
    coarse phase loses (see ns_sqrtm; the fast recipe is coarse=iters,
    correct=2).

    ``weight`` (w above, default 1) is the logdet coefficient — the
    consensus covsel split's per-shard prox of tr(S_i X) - w logdet X
    (ops/prox.covsel_eig_prox docstring).  The square-root argument
    stays bounded below by 4 rho w > 0, so the NS iteration keeps its
    conditioning guarantee (kappa <= 1 + lambda_max(W)^2/(4 rho w)).
    """
    n = W.shape[-1]
    I = jnp.eye(n, dtype=W.dtype)
    A = W @ W + ((4.0 * weight) * rho) * I
    return (W + ns_sqrtm(A, iters, coarse, correct)) / (2.0 * rho)


def psd_project_ns(W, iters: int = 24, coarse: int = 0, correct: int = 0,
                   delta: float = 0.0):
    """PSD-cone projection via Newton-Schulz — matmuls only, no eigh.

    Evaluates max(W, 0) spectrally as (W + |W|) / 2 with
    |W| = sqrt(W^2 + delta^2 I) (ns_sqrtm).  Matmul-only mode for
    the SDP z-prox (models/sdp.py), the same swap covsel makes with
    covsel_ns_prox.

    CONDITIONING CAVEAT (unlike covsel): covsel's square-root argument
    is bounded below by 4 rho, but a projection argument can have
    eigenvalues arbitrarily close to zero, where the NS square root
    converges slowly.  The absolute spectral error on a mode of
    magnitude |lambda| is bounded by ~|lambda| (NS underestimates small
    roots toward 0, and max(W,0) built from an underestimated |W|
    interpolates between the exact projection and W/2 on that mode), so
    near-null modes contribute small ABSOLUTE error; set ``delta`` > 0
    to regularize the root at an O(delta) accuracy floor, or raise
    ``iters`` (cost: 2 GEMMs + 1 batched GEMM each).  Use the exact
    eigh path (ops/prox.py:psd_project) when the active spectrum
    crosses zero slowly.

    Batched diag-constrained SDP: ``correct`` > 0 with
    ``delta`` = 0 DIVERGES — the residual correction applies the
    coupled inverse root Z ~ S^{-1}, which blows up on the
    near-singular W^2 (covsel never sees this: its argument is bounded
    below by 4 rho).  With corrections the root must be regularized
    (``delta`` > 0); the plain full-precision NS needs neither and is
    the default SDP matmul-only mode.
    """
    Ws = 0.5 * (W + jnp.swapaxes(W, -1, -2))
    n = Ws.shape[-1]
    A = Ws @ Ws
    if delta:
        A = A + (delta * delta) * jnp.eye(n, dtype=Ws.dtype)
    return 0.5 * (Ws + ns_sqrtm(A, iters, coarse, correct))
