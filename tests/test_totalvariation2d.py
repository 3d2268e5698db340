"""2-D TV denoising (extension; models/totalvariation2d.py)."""

import numpy as np

from admm_tpu import ADMMConfig
from admm_tpu.models.totalvariation2d import (
    TV2DOp,
    _dense_1d,
    totalvariation2d,
)


def test_tv2d_operator_adjoint():
    """<A X, V> == <X, A^T V> for the stacked pure-difference operator."""
    rng = np.random.default_rng(0)
    import jax.numpy as jnp

    m, n = 13, 17
    A = TV2DOp(m, n)
    X = jnp.asarray(rng.standard_normal((m, n)))
    V = jnp.asarray(rng.standard_normal((2, m, n)))
    lhs = float(np.sum(np.asarray(A.mv(X)) * np.asarray(V)))
    rhs = float(np.sum(np.asarray(X) * np.asarray(A.rmv(V))))
    assert abs(lhs - rhs) < 1e-10


def test_tv2d_stencil_is_pure_difference():
    """Constant inputs map to zero (no boundary-identity rows), and the
    dense builder matches the operator stencil exactly."""
    import jax.numpy as jnp

    n = 9
    Dd = np.asarray(_dense_1d(n, np.float64))
    assert np.allclose(Dd @ np.ones(n), 0.0)
    expected = np.zeros((n, n))
    for i in range(n - 1):
        expected[i, i] = 1.0
        expected[i, i + 1] = -1.0
    np.testing.assert_array_equal(Dd, expected)


def test_tv2d_prox_solves_sylvester_system():
    """The separable-eigenbasis x-prox must satisfy
    (I + rho (Dr^T Dr (+) Dc^T Dc)) X = B."""
    import jax.numpy as jnp

    from admm_tpu.models.totalvariation2d import _prox_f, make_prox_ops

    rng = np.random.default_rng(1)
    m, n = 12, 9
    S = rng.standard_normal((m, n))
    pf, pg, obj, data, A = make_prox_ops(S, 0.7, ADMMConfig())
    rho = 1.3
    Z = jnp.asarray(rng.standard_normal((2, m, n)))
    U = jnp.asarray(rng.standard_normal((2, m, n)))
    X = np.asarray(_prox_f(None, Z, U, rho, data))

    Dr = np.asarray(_dense_1d(m, np.float64))
    Dc = np.asarray(_dense_1d(n, np.float64))
    B = np.asarray(S) + rho * np.asarray(A.rmv(Z - U))
    lhs = X + rho * (Dr.T @ Dr @ X + X @ Dc.T @ Dc)
    np.testing.assert_allclose(lhs, B, atol=1e-9)


def test_tv2d_constant_image_is_fixed_point():
    """A constant image has TV 0, so denoising must return it exactly."""
    S = 5.0 * np.ones((16, 16))
    res = totalvariation2d(S, 1.0, ADMMConfig(maxiters=500))
    np.testing.assert_allclose(np.asarray(res.xopt), S, atol=1e-8)


def test_tv2d_denoises_blocky_image():
    rng = np.random.default_rng(2)
    m = n = 48
    truth = np.ones((m, n))
    truth[10:30, 15:40] = 5.0
    truth[35:45, 5:20] = 3.0
    S = truth + rng.standard_normal((m, n))
    lam = 1.0
    res = totalvariation2d(S, lam, ADMMConfig(maxiters=3000))
    X = np.asarray(res.xopt)

    def objective(V):
        tv = np.abs(np.diff(V, axis=0)).sum() + np.abs(np.diff(V, axis=1)).sum()
        return 0.5 * np.sum((V - S) ** 2) + lam * tv

    assert objective(X) < objective(truth)
    assert objective(X) < objective(S)
    # Interior of the flat region should be nearly constant.
    assert np.std(X[15:25, 20:35]) < 0.25


def test_tv2d_relaxed_runs():
    """Relaxation path (the engine hands Axhat to the z-prox)."""
    rng = np.random.default_rng(3)
    truth = np.ones((24, 24))
    truth[6:18, 8:20] = 4.0
    S = truth + rng.standard_normal((24, 24))
    res = totalvariation2d(S, 1.0, ADMMConfig(maxiters=2000, relax=1.5))
    X = np.asarray(res.xopt)
    assert np.all(np.isfinite(X))
    assert np.abs(X - truth).mean() < 0.6


def test_tv2d_registry_entry():
    from admm_tpu import get_prox_ops

    S = np.ones((8, 8))
    pf, pg, obj = get_prox_ops("totalvariation2d", S=S, lam=1.0)
    assert callable(pf) and callable(pg)


def test_as_linop_rejects_unregistered_operator():
    import pytest

    from admm_tpu.linop import as_linop

    class Bad:
        def mv(self, v):
            return v

        def rmv(self, v):
            return v

        def out_shape(self, s):
            return s

    with pytest.raises(TypeError, match="registered as a jax pytree"):
        as_linop(Bad())

    class NoShape:
        def mv(self, v):
            return v

        rmv = mv

    with pytest.raises(TypeError, match="out_shape"):
        as_linop(NoShape())
