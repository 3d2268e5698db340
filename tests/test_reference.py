"""The float64 host references (admm_tpu/testers/reference.py) against the
library in float64 on the CPU, at small sizes."""

import numpy as np

from admm_tpu import ADMMConfig
from admm_tpu.testers import reference as ref

TIGHT = ADMMConfig(maxiters=20000, abstol=1e-10, reltol=1e-9)


def test_lasso_reference_matches_lasso():
    from admm_tpu import lasso
    from admm_tpu.benchmarks.headline import fat_lasso_instance

    D, s, lam = fat_lasso_instance(40, 120, seed=3)
    D, s = D.astype(np.float64), s.astype(np.float64)
    zref, k = ref.lasso_admm_f64(D, s, lam)
    assert 1 < k < 100000
    res = lasso(D, s, lam, TIGHT)
    np.testing.assert_allclose(np.asarray(res.zopt), zref, atol=1e-6)
    assert abs(ref.lasso_objective(D, s, lam, res.zopt)
               - ref.lasso_objective(D, s, lam, zref)) < 1e-9


def test_qp_reference_matches_qp_batch(rng):
    from admm_tpu.models.batch import qp_batch

    n, m, B = 24, 6, 3
    R = rng.standard_normal((n, 2 * n))
    P = R @ R.T / (2 * n) + 0.1 * np.eye(n)
    D = rng.standard_normal((m, n))
    S = np.abs(rng.standard_normal((B, n))) @ D.T
    Q = rng.standard_normal((B, n))
    Zref, _ = ref.qp_standard_admm_f64(P, Q, D, S)
    np.testing.assert_allclose(D @ Zref.T, S.T, atol=1e-7)
    assert np.all(Zref >= 0)
    res = qp_batch(P, Q, 0.0, D, S, TIGHT)
    np.testing.assert_allclose(np.asarray(res.zopt), Zref, atol=1e-6)


def test_covsel_gap_certifies_solution(rng):
    from admm_tpu import covarianceselection

    A = rng.standard_normal((80, 10))
    S = np.cov(A, rowvar=False)
    res = covarianceselection(A, 0.1, TIGHT)
    gap, primal = ref.covsel_gap_f64(S, 0.1, res.xopt)
    assert 0 <= gap <= 1e-7 * abs(primal)
    # A poor point has a visible gap.
    gap_bad, _ = ref.covsel_gap_f64(S, 0.1, np.eye(10))
    assert gap_bad > 1e-3


def test_maxcut_gap_certifies_solution(rng):
    from admm_tpu import sdp

    n = 10
    W = np.triu((rng.random((n, n)) < 0.4).astype(float), 1)
    W = W + W.T
    C = -0.25 * (np.diag(W.sum(1)) - W)
    res = sdp(C, "diag", np.ones(n), config=TIGHT)
    gap, primal = ref.maxcut_sdp_gap_f64(C, res.zopt)
    assert 0 <= gap <= 1e-6 * (1 + abs(primal))
    gap_bad, _ = ref.maxcut_sdp_gap_f64(C, np.eye(n))
    assert gap_bad > 1e-3


def test_tv_gap_certifies_solution(rng):
    from admm_tpu import totalvariation

    sig = np.repeat(rng.standard_normal(6), 20) + 0.3 * rng.standard_normal(120)
    res = totalvariation(sig, 0.5, TIGHT)
    gap, primal = ref.tv_gap_f64(sig, 0.5, res.xopt)
    assert 0 <= gap <= 1e-8 * abs(primal)
    gap_bad, _ = ref.tv_gap_f64(sig, 0.5, sig)
    assert gap_bad > 1e-3
