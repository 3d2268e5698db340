"""Oracle test for covariance selection, mirroring reference
testers/covarianceselectiontest.m:112-154: build a sparse SPD inverse
covariance, sample Gaussians, and require the ADMM objective to beat the
true inverse covariance's objective.  Exercises matrix-valued iterates."""

import jax
import jax.numpy as jnp
import numpy as np

from admm_tpu import ADMMConfig, covarianceselection
from admm_tpu.ops.matfun import covsel_ns_prox, ns_sqrtm
from admm_tpu.ops.prox import covsel_eig_prox


def _make_instance(seed, rows, cols):
    rng = np.random.default_rng(seed)
    Sinv = np.diag(np.ones(cols))
    k = int(np.ceil(0.001 * cols * cols)) + 2
    idx = rng.choice(cols * cols, size=k, replace=False)
    Sinv.flat[idx] = 1.0
    Sinv = Sinv + Sinv.T
    w = np.linalg.eigvalsh(Sinv)
    if w.min() < 0:
        Sinv = Sinv + 1.1 * abs(w.min()) * np.eye(cols)
    S = np.linalg.inv(Sinv)
    D = rng.multivariate_normal(np.zeros(cols), S, size=rows)
    return D, Sinv, S


def _obj(S, X, Z, lam):
    sign, logdet = np.linalg.slogdet(X)
    return np.trace(S @ X) - logdet + lam * np.sum(np.abs(Z))


def test_covsel_beats_truth_objective():
    lam = 1.0
    D, Sinv, _ = _make_instance(0, 256, 32)
    # Objective uses the empirical covariance, as the reference does
    # (covarianceselectiontest.m:129 with S = cov(D) from the solver).
    from admm_tpu.models.covarianceselection import empirical_covariance

    S = np.asarray(empirical_covariance(D))
    res = covarianceselection(
        D, lam, ADMMConfig(objevals=True, maxiters=1000, convtest=True)
    )
    assert not res.diverged
    X = np.asarray(res.xopt)
    assert X.shape == (32, 32)
    assert _obj(S, X, X, lam) < _obj(S, Sinv, Sinv, lam)
    # X must be symmetric positive definite.
    np.testing.assert_allclose(X, X.T, atol=1e-8)
    assert np.linalg.eigvalsh(X).min() > 0


def test_ns_sqrtm_matches_eigh_sqrt():
    rng = np.random.default_rng(7)
    for n, scale in [(16, 1.0), (64, 10.0), (96, 100.0)]:
        M = rng.standard_normal((n, n))
        W = (M + M.T) / 2 * scale
        A = W @ W + 4.0 * np.eye(n)  # SPD, kappa up to ~1e6 at scale=100
        e, Q = np.linalg.eigh(A)
        ref = (Q * np.sqrt(e)) @ Q.T
        got = np.asarray(ns_sqrtm(jnp.asarray(A)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.linalg.norm(ref))


def test_ns_sqrtm_batched():
    rng = np.random.default_rng(8)
    M = rng.standard_normal((3, 24, 24))
    A = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(24)
    got = np.asarray(ns_sqrtm(jnp.asarray(A)))
    for i in range(3):
        e, Q = np.linalg.eigh(A[i])
        ref = (Q * np.sqrt(e)) @ Q.T
        np.testing.assert_allclose(got[i], ref, atol=1e-10 * np.linalg.norm(ref))


def test_covsel_ns_prox_matches_eig_prox():
    rng = np.random.default_rng(9)
    for rho in (0.1, 1.0, 10.0):
        M = rng.standard_normal((48, 48)) * 10.0
        W = jnp.asarray((M + M.T) / 2)
        ref = np.asarray(covsel_eig_prox(W, rho))
        got = np.asarray(covsel_ns_prox(W, rho))
        np.testing.assert_allclose(got, ref, atol=1e-9 * np.linalg.norm(ref))


def test_covsel_solver_ns_matches_eigh():
    """Full solve with prox_method='ns' tracks the eigh path: same step
    count and matching optimum (the NS prox is exact to machine
    precision at the default iteration count)."""
    lam = 1.0
    D, _, _ = _make_instance(3, 256, 24)
    cfg = ADMMConfig(maxiters=400, convtest=True)
    res_eig = covarianceselection(D, lam, cfg)
    res_ns = covarianceselection(D, lam, cfg, prox_method="ns")
    assert not res_ns.diverged
    assert int(res_ns.steps) == int(res_eig.steps)
    np.testing.assert_allclose(
        np.asarray(res_ns.xopt), np.asarray(res_eig.xopt), atol=1e-7
    )


def test_covsel_ns_prox_f32_accuracy():
    """f32 NS prox stays within f32-eigh-level accuracy of the f64
    reference — the precision story of the matmul-only mode."""
    rng = np.random.default_rng(11)
    M = rng.standard_normal((64, 64)) * 5.0
    W64 = jnp.asarray((M + M.T) / 2, dtype=jnp.float64)
    ref = np.asarray(covsel_eig_prox(W64, 1.0))
    with jax.default_matmul_precision("highest"):
        got32 = np.asarray(covsel_ns_prox(W64.astype(jnp.float32), 1.0))
    rel = np.linalg.norm(got32 - ref) / np.linalg.norm(ref)
    assert rel < 5e-6, rel


def test_ns_fast_mode_matches_eigh():
    """prox_method='ns_fast' (coarse NS + residual corrections) must
    land on the eigh path's solution; on CPU the coarse phase is
    numerically a no-op, so this pins the plumbing and the correction's
    exactness at convergence."""
    rng = np.random.default_rng(4)
    D = rng.standard_normal((160, 24))
    cfg = ADMMConfig(maxiters=400)
    r_e = covarianceselection(D, 0.3, cfg)
    r_f = covarianceselection(D, 0.3, cfg, prox_method="ns_fast")
    np.testing.assert_allclose(np.asarray(r_f.xopt), np.asarray(r_e.xopt),
                               rtol=1e-6, atol=1e-8)
    import pytest

    with pytest.raises(ValueError, match="prox_method"):
        covarianceselection(D, 0.3, cfg, prox_method="bogus")
