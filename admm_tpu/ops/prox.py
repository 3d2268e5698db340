"""Elementwise proximal operators (fully fusable by XLA).

Each function cites the reference construction it reproduces.  All are pure
jnp: XLA fuses the soft-threshold + dual-update tail of an iteration with
the residual norms next to it (a hand-written kernel for that tail measured
no faster end to end on the H100; PERF.md).
"""

from __future__ import annotations

import jax.numpy as jnp


def soft_threshold(v, t):
    """sign(v) * max(|v| - t, 0).

    The reference's zminSoftThresholding (getProxOps.m:933-938), shared by
    basis pursuit, TV, lasso, covariance selection and LAD.  Written as a
    single where-free expression so XLA fuses it into neighbouring ops.
    """
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - t, 0.0)


def asymmetric_soft_threshold(v, t_pos, t_neg):
    """Two-sided shrinkage with different thresholds per sign:

        v - t_pos   if v >  t_pos
        v + t_neg   if v < -t_neg
        0           otherwise

    — the prox of the pinball (quantile) loss ``tau*max(v,0) +
    (1-tau)*max(-v,0)`` at thresholds ``(tau/rho, (1-tau)/rho)``.
    ``t_pos = t_neg`` recovers :func:`soft_threshold`.  Written
    where-free (two maxima) so XLA fuses it like the symmetric form.
    Beyond the reference (its shrinkage family is symmetric,
    getProxOps.m:933-938).
    """
    return jnp.maximum(v - t_pos, 0.0) - jnp.maximum(-v - t_neg, 0.0)


def block_soft_threshold(v, t, gid, num_groups):
    """Group-wise shrinkage: each group g of ``v`` (membership ``gid``, a
    static int array) scales by max(0, 1 - t_g / ||v_g||_2).

    The prox of ``sum_g t_g ||v_g||_2`` (group lasso).  ``t`` is scalar or
    per-group.  Segment reductions keep the shapes static, so the whole op
    stays one fused elementwise pass under jit.  Beyond the reference (its
    shrinkage family stops at elementwise soft-thresholding,
    getProxOps.m:933-938).
    """
    import jax

    norm2 = jax.ops.segment_sum(v * v, gid, num_segments=num_groups)
    norm = jnp.sqrt(norm2)
    t = jnp.broadcast_to(jnp.asarray(t, v.dtype), (num_groups,))
    # where-guard: a zero-norm group must scale by 0, not NaN.
    scale = jnp.maximum(0.0, 1.0 - t / jnp.where(norm > 0, norm, 1.0))
    scale = jnp.where(norm > 0, scale, 0.0)
    return scale[gid] * v


def hinge_prox(Dx_plus_u, ell, C, rho):
    """Hinge-loss z-prox for the linear SVM.

    z = (Dx+u) + ell * max(min(1 - ell*(Dx+u), C/rho), 0)
    (reference zminLinearSVM, getProxOps.m:1084-1103).
    """
    v = ell * Dx_plus_u
    return Dx_plus_u + ell * jnp.maximum(jnp.minimum(1.0 - v, C / rho), 0.0)


def zero_one_prox(Dx_plus_u, ell, C, rho):
    """0-1-loss z-prox for unwrapped-ADMM linear SVM.

    y_i = s_i where s_i >= 1 or s_i < 1 - sqrt(2/t) (t = rho/C), else 1;
    returns ell * y for s = ell*(Dx+u)
    (reference minz01, getProxOps.m:1158-1180 via zminLinearSVM:1100).
    Note: nonconvex; valid only with the transpose-reduction x-update.
    """
    s = ell * Dx_plus_u
    t = rho / C
    keep = (s >= 1.0) | (s < 1.0 - jnp.sqrt(2.0 / t))
    y = jnp.where(keep, s, 1.0)
    return ell * y


def huber_prox(Ax, u, s, rho):
    """Huber-fitting z-prox.

    z = 1/(1+rho) * (rho*v + S(v, 1 + 1/rho)), v = Ax + u - s
    (reference zminHuberSoftThresholding, getProxOps.m:1529-1539).
    """
    v = Ax + u - s
    return (rho * v + soft_threshold(v, 1.0 + 1.0 / rho)) / (1.0 + rho)


def project_nonneg(v):
    """Projection onto the nonnegative orthant — LP/QP-standard z-prox
    (reference zminLinearProgram, getProxOps.m:1378-1382)."""
    return jnp.maximum(v, 0.0)


def project_box(v, lb, ub):
    """Projection onto {lb <= z <= ub} — bounded-QP z-prox
    (reference zminQuadraticProgramBounded, getProxOps.m:1470-1474)."""
    return jnp.minimum(ub, jnp.maximum(lb, v))


def psd_project(W):
    """Projection onto the positive-semidefinite cone: symmetrize, then
    clamp the spectrum at zero (Higham 1988).  SDP z-prox; batched-
    friendly and differentiable (eigh).  Beyond-reference family — the
    reference's closest analog is the covariance-selection spectral
    prox (getProxOps.m:1487-1496), which uses the same eigh+reconstruct
    shape."""
    W = 0.5 * (W + jnp.swapaxes(W, -1, -2))
    e, Q = jnp.linalg.eigh(W)
    return (Q * jnp.maximum(e, 0.0)[..., None, :]) @ jnp.swapaxes(Q, -1, -2)


def covsel_eig_prox(ZU_minus_S_scaled, rho, weight=1.0):
    """Covariance-selection x-prox.

    Given W = rho*(Z - U) - S, eigendecompose W = Q diag(e) Q^T and return
    X = Q diag((e + sqrt(e^2 + 4 rho w)) / (2 rho)) Q^T
    (reference xminCovarianceSelection, getProxOps.m:1487-1496; w = 1).
    Uses symmetric eigh — batched-friendly and differentiable.

    ``weight`` scales the logdet term: the prox of
    tr(S X) - w logdet X solves rho X - w X^{-1} = W, whose spectral
    root swaps 4 rho for 4 rho w.  Used by the consensus covsel split
    (parallel/consensus.py), where each of N shards carries logdet/N.
    """
    e, Q = jnp.linalg.eigh(ZU_minus_S_scaled)
    diag = (e + jnp.sqrt(e * e + (4.0 * weight) * rho)) / (2.0 * rho)
    return (Q * diag[..., None, :]) @ jnp.swapaxes(Q, -1, -2)
