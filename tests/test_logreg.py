"""Sparse logistic regression (beyond reference; Boyd et al. 2011 sec.
8.2 is the construction's source) — serial KKT oracle, smooth-case
scipy agreement, and the consensus instantiation."""

import numpy as np
import pytest

from admm_tpu import ADMMConfig, logreg
from admm_tpu.testers.problems import logregtest


def test_logreg_kkt_oracle():
    res, test = logregtest(seed=1, rows=200, cols=16)
    assert not test["failed"], test["failreason"]
    assert test["kkt"] <= 1e-3
    assert res.steps < 2000
    # The sparse iterate actually is sparse at this lam.
    z = np.asarray(res.zopt)
    assert np.sum(np.abs(z) < 1e-8) > 0


def test_logreg_lam0_matches_scipy_smooth_optimum():
    """lam = 0: the problem is smooth; scipy BFGS on the same objective
    is an exact oracle."""
    from scipy.optimize import minimize

    rng = np.random.default_rng(3)
    m, n = 300, 10
    D = rng.standard_normal((m, n))
    w = rng.standard_normal(n)
    p = 1.0 / (1.0 + np.exp(-(D @ w)))
    ell = np.where(rng.random(m) < p, 1.0, -1.0)
    Y = D * ell[:, None]

    def f(x):
        return np.sum(np.logaddexp(0.0, -(Y @ x)))

    def g(x):
        return -Y.T @ (1.0 / (1.0 + np.exp(Y @ x)))

    ref = minimize(f, np.zeros(n), jac=g, method="BFGS",
                   options={"gtol": 1e-10})
    res = logreg(D, ell, 0.0,
                 ADMMConfig(maxiters=3000, abstol=1e-9, reltol=1e-8))
    x = np.asarray(res.xopt, np.float64)
    assert abs(f(x) - ref.fun) <= 1e-5 * (1.0 + abs(ref.fun)), (f(x), ref.fun)
    np.testing.assert_allclose(x, ref.x, rtol=1e-3, atol=1e-4)


def test_logreg_validation_and_demo_registry():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((40, 6))
    with pytest.raises(ValueError, match="labels"):
        logreg(D, rng.standard_normal(40), 0.1)
    with pytest.raises(ValueError, match="nonnegative"):
        logreg(D, np.sign(rng.standard_normal(40)), -0.5)
    from admm_tpu.models import get_prox_ops

    ell = np.sign(rng.standard_normal(40))
    pf, pg, obj = get_prox_ops("logreg", {"D": D, "ell": ell, "lam": 0.1})
    x = pf(np.zeros(6), np.zeros(6), np.zeros(6), 1.0)
    assert np.isfinite(np.asarray(x)).all()


def test_consensus_logreg_matches_serial():
    """The sharded Newton local prox + global soft threshold must reach
    the serial solver's objective (8-virtual-device mesh, uneven rows)."""
    from admm_tpu.parallel import consensus_logreg

    rng = np.random.default_rng(5)
    m, n = 403, 12  # not divisible by 8 -> zero-pad rows
    D = rng.standard_normal((m, n))
    w = rng.standard_normal(n) * (rng.random(n) < 0.5)
    p = 1.0 / (1.0 + np.exp(-(D @ w)))
    ell = np.where(rng.random(m) < p, 1.0, -1.0)
    Y = D * ell[:, None]
    lam = 0.05 * float(np.max(np.abs(-Y.T @ np.full(m, 0.5))))

    def obj(z):
        return (np.sum(np.logaddexp(0.0, -(Y @ z)))
                + lam * np.sum(np.abs(z)))

    tight = ADMMConfig(maxiters=4000, abstol=1e-9, reltol=1e-9)
    ser = logreg(D, ell, lam, ADMMConfig(maxiters=3000, abstol=1e-8,
                                         reltol=1e-7))
    par = consensus_logreg(D, ell, lam, tight, nshards=8)
    assert not par.diverged and par.steps < 4000
    f_ser, f_par = obj(np.asarray(ser.zopt)), obj(np.asarray(par.zopt))
    assert abs(f_par - f_ser) <= 1e-4 * (1.0 + abs(f_ser)), (f_par, f_ser)

    # The matrix-free Newton-PCG local prox (round-5 perf mode) must
    # track the dense-Newton consensus run — at the conservative knobs
    # it solves the prox to the same tolerance, so the trajectories
    # agree to solver precision.
    cg = consensus_logreg(D, ell, lam, tight, nshards=8,
                          inner="newton_cg")
    assert int(cg.steps) == int(par.steps)
    np.testing.assert_allclose(np.asarray(cg.zopt), np.asarray(par.zopt),
                               atol=1e-9)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="inner"):
        consensus_logreg(D, ell, lam, tight, nshards=8, inner="lbfgs")


def test_logreg_batch_matches_solo_lanes():
    """One-vs-all multiclass logistic via logreg_batch: each lane must
    match the solo logreg solve on its label vector bit-for-bit (same
    engine, same prox, mapped labels) — for BOTH inner solvers."""
    from admm_tpu import logreg_batch

    rng = np.random.default_rng(7)
    m, n, K = 160, 8, 3
    D = rng.standard_normal((m, n))
    y = rng.integers(0, K, size=m)
    ells = np.stack([np.where(y == k, 1.0, -1.0) for k in range(K)])
    lam = 0.1
    cfg = ADMMConfig(maxiters=800)
    for inner in ("newton_cg", "newton"):
        batch = logreg_batch(D, ells, lam, cfg, inner=inner)
        for k in range(K):
            # Match the batch default's inner-solver knobs so the lane
            # comparison is like-for-like (batch defaults to the tuned
            # 4x12 recipe; solo to the conservative 5x20).
            solo = logreg(D, ells[k], lam, cfg, inner=inner,
                          newton_steps=4, cg_steps=12)
            if inner == "newton":
                # Dense path: bit-for-bit (same prox, mapped labels).
                assert int(np.asarray(batch.steps)[k]) == int(solo.steps)
                np.testing.assert_allclose(np.asarray(batch.zopt)[k],
                                           np.asarray(solo.zopt),
                                           rtol=1e-10, atol=1e-12)
            else:
                # CG path: vmap's GEMM reduction order differs from the
                # serial GEMV's, and the iterated CG recurrence amplifies
                # the ulp difference — same fixed point, not same bits.
                assert abs(int(np.asarray(batch.steps)[k])
                           - int(solo.steps)) <= 2
                np.testing.assert_allclose(np.asarray(batch.zopt)[k],
                                           np.asarray(solo.zopt),
                                           atol=1e-7)

    import pytest as _pytest

    with _pytest.raises(ValueError, match="label lanes"):
        logreg_batch(D, ells * 0.5, lam, cfg)
    with _pytest.raises(ValueError, match="inner"):
        logreg(D, ells[0], lam, cfg, inner="lbfgs")


def test_logreg_newton_cg_matches_dense_newton():
    """The matrix-free Jacobi-PCG Newton x-prox (the batched lanes'
    default) must land on the dense-Hessian path's optimum —
    same ADMM trajectory to solver tolerance, including the step
    count (the CG solve reaches Newton-direction accuracy at the
    default 20 iterations on this conditioning)."""
    rng = np.random.default_rng(3)
    m, n = 300, 40
    D = rng.standard_normal((m, n))
    wtrue = rng.standard_normal(n)
    p = 1.0 / (1.0 + np.exp(-(D @ wtrue)))
    ell = np.where(rng.random(m) < p, 1.0, -1.0)
    cfg = ADMMConfig(maxiters=3000, abstol=1e-9, reltol=1e-9)
    dense = logreg(D, ell, 0.1, cfg)
    cg = logreg(D, ell, 0.1, cfg, inner="newton_cg")
    assert int(cg.steps) == int(dense.steps)
    np.testing.assert_allclose(np.asarray(cg.zopt), np.asarray(dense.zopt),
                               atol=1e-7)
