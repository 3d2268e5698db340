"""Mixed-precision recipe: a fast bf16-stream solve warm-starting a short
f32/f64 polish recovers full accuracy at near-bf16 cost (the pattern
documented in README)."""

import numpy as np

from admm_tpu import ADMMConfig, lasso


def test_bf16_warmstart_plus_polish_recovers_accuracy():
    import jax.numpy as jnp

    from admm_tpu.engine import Hooks, admm
    from admm_tpu.models.lasso import make_prox_ops

    rng = np.random.default_rng(0)
    m, n = 48, 160  # fat branch (where bf16 streams apply)
    D = (rng.standard_normal((m, n)) / 7).astype(np.float32)
    tx = (rng.standard_normal(n) * (rng.random(n) < 0.2)).astype(np.float32)
    s = (D @ tx + 0.01 * rng.standard_normal(m)).astype(np.float32)
    lam = float(0.1 * np.max(np.abs(D.T @ s)))

    def obj(x):
        return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))

    exact = lasso(D, s, lam, ADMMConfig(maxiters=5000))
    f_exact = obj(np.asarray(exact.xopt))

    # Stage 1: cheap bf16-stream solve (lands near the solution).
    coarse = lasso(D, s, lam, ADMMConfig(maxiters=5000),
                   stream_dtype=jnp.bfloat16)
    f_coarse = obj(np.asarray(coarse.xopt))

    # Stage 2: short f32 polish from the bf16 state.
    pf, pg, objfn, data = make_prox_ops(D, s, lam, ADMMConfig())
    polished = admm(
        pf, pg, ADMMConfig(maxiters=200),
        A=1.0, B=-1.0, c=0.0, m=n,
        x0=coarse.xopt, z0=coarse.zopt, u0=coarse.uopt,
        hooks=Hooks(obj=objfn), data=data,
    )
    f_polished = obj(np.asarray(polished.xopt))

    # Polish must close (most of) the bf16 accuracy gap quickly.
    gap_coarse = abs(f_coarse - f_exact)
    gap_polished = abs(f_polished - f_exact)
    assert polished.steps <= 200
    assert gap_polished <= max(0.2 * gap_coarse, 1e-7)


def test_loop_pins_highest_precision():
    """The compiled loop runs f32 matmuls at full precision even under an
    ambient lower setting: the engine's wrapper sets 'highest'
    innermost."""
    from admm_tpu.engine import _highest_precision

    seen = []

    def probe(x):
        import jax

        # At trace time the ambient precision reflects the innermost
        # context manager.
        seen.append(jax.config.jax_default_matmul_precision)
        return x

    import jax

    with jax.default_matmul_precision("default"):
        _highest_precision(probe)(1.0)
    assert seen and str(seen[0]) == "highest"
