"""Solver-cache numerics (ops/solve.py)."""

import numpy as np


def test_fat_shift_solver_matches_direct():
    import jax.numpy as jnp

    from admm_tpu.ops.solve import FatShiftSolver

    rng = np.random.default_rng(1)
    D = rng.standard_normal((48, 160))
    b = rng.standard_normal(160)
    rho = 1.3
    sol = FatShiftSolver.from_matrix(jnp.asarray(D), rho)
    x = np.asarray(sol.solve(jnp.asarray(b)))
    x_direct = np.linalg.solve(D.T @ D + rho * np.eye(160), b)
    np.testing.assert_allclose(x, x_direct, rtol=1e-8, atol=1e-9)


def test_fat_shift_solver_bf16_streams_close():
    import jax.numpy as jnp

    from admm_tpu.ops.solve import FatShiftSolver

    rng = np.random.default_rng(2)
    D = (rng.standard_normal((48, 160)) / 7).astype(np.float32)
    b = rng.standard_normal(160).astype(np.float32)
    rho = 1.0
    sol = FatShiftSolver.from_matrix(jnp.asarray(D), rho, stream_dtype=jnp.bfloat16)
    x = np.asarray(sol.solve(jnp.asarray(b)))
    x_direct = np.linalg.solve(
        D.astype(np.float64).T @ D.astype(np.float64) + rho * np.eye(160),
        b.astype(np.float64),
    )
    # bf16 streams: ~2-3 decimal digits.
    assert np.linalg.norm(x - x_direct) / np.linalg.norm(x_direct) < 2e-2


def test_lasso_fat_static_matches_woodbury_path():
    """The static-rho fat path (FatShiftSolver) and the adaptive fat path
    (WoodburySolver) must produce the same LASSO solution."""
    import jax.numpy as jnp

    from admm_tpu import ADMMConfig, lasso

    rng = np.random.default_rng(3)
    D = rng.standard_normal((32, 96))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    testx = rng.standard_normal(96) * (rng.random(96) < 0.3)
    s = D @ testx + 0.01 * rng.standard_normal(32)
    lam = 0.1 * np.max(np.abs(D.T @ s))

    r_static = lasso(D, s, lam, ADMMConfig(maxiters=2000))
    r_adaptive_off = lasso(D, s, lam, ADMMConfig(maxiters=2000, adaptive=True,
                                                 convtest=True, domaxiters=False))
    # Static path solves the problem (oracle: beats planted objective).
    def obj(x):
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))

    x1 = np.asarray(r_static.xopt)
    assert obj(x1) < obj(testx)
