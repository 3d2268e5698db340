"""Profiling helpers.

The reference's 'profiler' is tic/toc plus the full per-iteration history
(SURVEY.md section 5).  Those are preserved in ADMMResults; this module
adds the device-level equivalent: jax.profiler traces viewable in
TensorBoard/Perfetto, and a simple steady-state iteration timer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace around a block.

    View with: tensorboard --logdir <logdir>  (or upload the .trace to
    Perfetto).
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def iteration_rate(solve: Callable, *, warmup: int = 1, repeats: int = 3) -> float:
    """Steady-state solves/second of a zero-arg solve callable: runs
    ``warmup`` untimed calls (compile + caches), then averages."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(solve())
    t0 = time.perf_counter()
    for _ in range(repeats):
        jax.block_until_ready(solve())
    return repeats / (time.perf_counter() - t0)
