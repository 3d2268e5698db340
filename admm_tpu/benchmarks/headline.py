"""Benchmark: ADMM iterations/s on LASSO with a dense fat D (1500 x 5000).

The reference publishes no numbers (BASELINE.md), so ``vs_baseline``
compares against the same iteration in float64 NumPy on this host
(testers/reference.py) — a stand-in for the reference's single-process
MATLAB loop (admm.m:496-743), which uses the same BLAS-bound operations.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "iter/s", "vs_baseline": N, ...}
with the platform, ``device_kind``, device count and the card's name and
power limit beside the numbers.
"""

import json
import time

import numpy as np


def fat_lasso_instance(m, n, seed=0):
    """The headline's fat LASSO: unit-norm columns, a 10%-sparse planted
    signal, small noise, lam = 0.1 * lam_max.  Returns f32 (D, s, lam)."""
    rng = np.random.default_rng(seed)
    testx = rng.standard_normal(n) * (rng.random(n) < 0.1)
    D = rng.standard_normal((m, n)).astype(np.float32)
    D /= np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = (D @ testx + np.sqrt(0.001) * rng.standard_normal(m)).astype(np.float32)
    lam = float(0.1 * np.max(np.abs(D.T @ s)))
    return D, s, lam


def _numpy_lasso_iters_per_sec(D, s, lam, rho, iters=50):
    from ..testers.reference import lasso_admm_f64

    t0 = time.perf_counter()
    lasso_admm_f64(D, s, lam, rho, abstol=0.0, reltol=0.0, maxiters=iters)
    return iters / (time.perf_counter() - t0)


def main(smoke: bool = False, cpu: bool = False):
    import jax

    from .device import card_info, setup

    platform = setup(cpu)

    from admm_tpu import ADMMConfig
    from admm_tpu.models.lasso import lasso

    m, n = (96, 320) if smoke else (1500, 5000)
    D, s, lam = fat_lasso_instance(m, n)

    # 16,384 iterations in one dispatch, so the per-solve launch and
    # host read-back are a small share of the reading.
    iters = 100 if smoke else 16384
    # unroll=64: K iterations per device loop step.  Semantics are
    # bit-exact (ADMMConfig.unroll); the depth itself is not yet
    # re-derived for the GPU (chip_smoke.py prints the headline at
    # unroll 1, 16 and 64 on the card).
    cfg = ADMMConfig(maxiters=iters, domaxiters=True, unroll=64)

    # Warm-up (compile), then best-of-3 timed passes — symmetric with the
    # best-of-3 NumPy baseline below.
    np.asarray(lasso(D, s, lam, cfg).steps)
    results = [lasso(D, s, lam, cfg) for _ in range(3)]
    res = min(results, key=lambda r: r.runtime)
    iters_per_sec = iters / res.runtime

    # bf16-stream mode (FatShiftSolver stream_dtype) — reported
    # separately, not the headline.
    import jax.numpy as jnp

    np.asarray(lasso(D, s, lam, cfg, stream_dtype=jnp.bfloat16).steps)
    res_bf16 = min((lasso(D, s, lam, cfg, stream_dtype=jnp.bfloat16)
                    for _ in range(3)), key=lambda r: r.runtime)
    bf16_iters_per_sec = iters / res_bf16.runtime

    baseline = max(
        _numpy_lasso_iters_per_sec(
            D.astype(np.float64), s.astype(np.float64), lam, cfg.rho,
            iters=20 if smoke else 50,
        )
        for _ in range(3)
    )

    # Secondary target (BASELINE.json): time-to-1e-6 residual, taken
    # per-element (RMS): pnorm <= 1e-6 * sqrt(n).  (The absolute 1e-6
    # 2-norm is below the f32 floor at n=5000.)  Both implementations run
    # the identical update sequence, so the trajectory and step count
    # match; only seconds/step differ.
    pnorm = np.asarray(res.pnorm)
    thresh = 1e-6 * np.sqrt(D.shape[1])
    hit = np.nonzero(pnorm <= thresh)[0]
    steps_1e6 = int(hit[0]) + 1 if len(hit) else None
    t_1e6 = None if steps_1e6 is None else steps_1e6 / iters_per_sec
    t_1e6_np = None if steps_1e6 is None else steps_1e6 / baseline

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "lasso_n5000_admm_iterations_per_sec_per_chip",
                "platform": platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "card": card_info() if platform == "gpu" else None,
                "value": iters_per_sec,
                "unit": "iter/s",
                "vs_baseline": iters_per_sec / baseline,
                "maxiters_per_dispatch": iters,
                "numpy_baseline_iters_per_sec": baseline,
                "bf16_stream_iters_per_sec": bf16_iters_per_sec,
                "steps_to_rms_residual_1e-6": steps_1e6,
                "time_to_rms_residual_1e-6_s": t_1e6,
                "baseline_time_to_rms_residual_1e-6_s": t_1e6_np,
            }
        )
    )
