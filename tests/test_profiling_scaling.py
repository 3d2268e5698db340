"""Smoke tests for the profiling helpers and the weak-scaling harness."""

import numpy as np
import pytest


def test_iteration_rate():
    import jax.numpy as jnp

    from admm_tpu.utils.profiling import iteration_rate

    x = jnp.ones(64)
    rate = iteration_rate(lambda: x * 2.0, warmup=1, repeats=3)
    assert rate > 0


def test_profiler_trace(tmp_path):
    import jax
    import jax.numpy as jnp

    from admm_tpu.utils.profiling import trace

    try:
        with trace(str(tmp_path)):
            jax.block_until_ready(jnp.ones(128) * 3.0)
    except Exception as e:  # profiler backends vary by platform
        pytest.skip(f"profiler unavailable: {e}")
    assert any(tmp_path.rglob("*")), "no trace artifacts written"


def test_weak_scaling_harness_runs():
    from admm_tpu.benchmarks.scaling import weak_scaling

    results, effs = weak_scaling(
        device_counts=(1, 2), rows_per_shard=64, cols=16, iters=20, quiet=True
    )
    assert set(results) == {1, 2}
    assert all(v > 0 for v in results.values())
    assert effs[1] == 1.0


def test_collective_microbench_and_cost_model():
    """The collective microbench runs on the available mesh and reports
    per-collective times with the device it ran on."""
    from admm_tpu.benchmarks.scaling import collective_microbench

    rows = collective_microbench(payload_cols=(64, 256), inner=8, quiet=True)
    assert [r["payload_floats"] for r in rows] == [64, 256]
    for r in rows:
        assert r["us_per_collective"] > 0
        assert r["devices"] == 8 and r["platform"] == "cpu"
        assert r["device_kind"] == "cpu"
