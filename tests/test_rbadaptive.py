"""Residual-balancing adaptive rho (ADMMConfig.rbadaptive): an
addition beyond the reference — Boyd et al. 2011 section 3.4.1 with the
scaled-dual rescale the reference's experimental mode omits."""

import numpy as np
import pytest

from admm_tpu import ADMMConfig, lasso
from admm_tpu.models.model import model


def _model_instance(seed=0, m=96, n=64):
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    return P, Q, r, s, truex


def test_rb_recovers_from_bad_rho():
    """With a badly scaled initial rho, residual balancing must converge
    dramatically faster than the fixed-rho run."""
    P, Q, r, s, truex = _model_instance()
    bad_rho = 1e-4
    fixed = model(P, Q, r, s, ADMMConfig(rho=bad_rho, maxiters=20000))
    rb = model(P, Q, r, s, ADMMConfig(rho=bad_rho, maxiters=20000, rbadaptive=True))
    assert np.linalg.norm(np.asarray(rb.xopt) - truex) < 1e-2
    assert rb.steps < fixed.steps / 3
    # rho actually moved.
    assert rb.rho_final != pytest.approx(bad_rho)


def test_rb_matches_fixed_solution_quality():
    rng = np.random.default_rng(1)
    D = rng.standard_normal((256, 64))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    tx = rng.standard_normal(64) * (rng.random(64) < 0.5)
    s = D @ tx + 0.03 * rng.standard_normal(256)
    lam = 0.1 * np.max(np.abs(D.T @ s))

    def obj(x):
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))

    fixed = lasso(D, s, lam, ADMMConfig(maxiters=5000))
    rb = lasso(D, s, lam, ADMMConfig(maxiters=5000, rbadaptive=True))
    f_fixed = obj(np.asarray(fixed.xopt))
    f_rb = obj(np.asarray(rb.xopt))
    assert abs(f_rb - f_fixed) <= 1e-3 * abs(f_fixed) + 1e-9


def test_rb_consensus_recovers_from_bad_rho():
    """Adaptive consensus ADMM (Xu et al. 2017 idea): residual balancing
    on the consensus residuals must recover from a badly scaled rho."""
    from admm_tpu.parallel import consensus_lasso

    rng = np.random.default_rng(2)
    D = rng.standard_normal((512, 32))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    tx = rng.standard_normal(32) * (rng.random(32) < 0.5)
    s = D @ tx + 0.03 * rng.standard_normal(512)
    lam = 0.1 * np.max(np.abs(D.T @ s))

    def obj(x):
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))

    bad_rho = 1e-3
    fixed = consensus_lasso(D, s, lam, ADMMConfig(rho=bad_rho, maxiters=20000))
    rb = consensus_lasso(
        D, s, lam, ADMMConfig(rho=bad_rho, maxiters=20000, rbadaptive=True)
    )
    ref = lasso(D, s, lam, ADMMConfig(maxiters=5000))
    f_ref = obj(np.asarray(ref.xopt))
    assert abs(obj(np.asarray(rb.zopt)) - f_ref) <= 1e-2 * abs(f_ref)
    assert rb.steps < fixed.steps
    assert rb.rho_final != pytest.approx(bad_rho)


def test_rb_config_validation():
    with pytest.raises(ValueError):
        ADMMConfig(rbadaptive=True, nodualerror=True)
    with pytest.raises(ValueError):
        ADMMConfig(rbadaptive=True, adaptive=True)
    with pytest.raises(ValueError):
        ADMMConfig(rbadaptive=True, fast=True)
