"""Receding-horizon (MPC-style) batched QP with warm starts —
EXTENSION.

No reference analog (the reference solves one program per call); this
demonstrates the framework pattern the `qp_batch` solver exists for:

- A fleet of B controllers shares ONE QP structure (Hessian P from the
  stage costs, equality matrix D from the dynamics) whose KKT system
  is folded once at setup.
- At every control step t the linear terms change (fresh state
  measurements enter q_t and the constraint offsets s_t), so the whole
  fleet re-solves in one (B, n) x (n, n) GEMM-per-iteration program.
- Each re-solve warm-starts from the previous step's solution
  (x0/z0/u0 = previous BatchResults), cutting iterations several-fold
  versus cold starts.

Usage:  python examples/mpc_qp.py [B] [n] [steps]
"""

from __future__ import annotations

import sys

import numpy as np


def mpc_qp(B=16, n=64, m=16, steps=8, seed=0, maxiters=2000, quiet=False):
    from admm_tpu import ADMMConfig, qp_batch, qp_structure

    if m >= n:
        raise ValueError(
            f"the equality system must be underdetermined (m < n); "
            f"got m={m}, n={n}"
        )
    rng = np.random.default_rng(seed)
    # Shared structure: one strongly-convex Hessian, one dynamics/
    # equality matrix for the whole fleet and the whole horizon —
    # folded ONCE; the per-step re-solves do no eigh/Cholesky work.
    R = rng.standard_normal((n, 2 * n))
    P = R @ R.T / (2 * n) + 0.1 * np.eye(n)
    D = rng.standard_normal((m, n))
    struct = qp_structure(P, D)

    # Tight Boyd tolerances so the warm and cold stopping points land on
    # (numerically) the same solution and the agreement check below is
    # meaningful.
    cfg = ADMMConfig(maxiters=maxiters, abstol=1e-8, reltol=1e-7)
    cold_iters, warm_iters = [], []
    prev = None
    Qs = rng.standard_normal((B, n))
    Ss = np.abs(rng.standard_normal((B, n))) @ D.T
    for t in range(steps):
        # Fresh measurements drift the linear terms between steps
        # (small relative drift — consecutive MPC problems are close).
        Qs = Qs + 0.01 * rng.standard_normal((B, n))
        Ss = Ss + 0.01 * np.abs(rng.standard_normal((B, n))) @ D.T

        cold = qp_batch(P, Qs, 0.0, D, Ss, cfg, structure=struct)
        cold_iters.append(int(np.max(np.asarray(cold.steps))))
        if prev is None:
            warm = cold
        else:
            warm = qp_batch(P, Qs, 0.0, D, Ss, cfg, structure=struct,
                            x0=prev.xopt, z0=prev.zopt, u0=prev.uopt)
        warm_iters.append(int(np.max(np.asarray(warm.steps))))
        np.testing.assert_allclose(  # warm and cold land on the same QP
            np.asarray(warm.xopt), np.asarray(cold.xopt), atol=1e-3
        )
        prev = warm

    if not quiet:
        print(f"{'step':>4} {'cold iters':>11} {'warm iters':>11}")
        for t, (c, w) in enumerate(zip(cold_iters, warm_iters)):
            print(f"{t:>4} {c:>11} {w:>11}")
        sc, sw = sum(cold_iters[1:]), sum(warm_iters[1:])
        print(f"total re-solve iterations: cold {sc}, warm {sw} "
              f"({sc / max(sw, 1):.1f}x fewer warm)")
    return cold_iters, warm_iters


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    names = ("B", "n", "steps")
    mpc_qp(**dict(zip(names, args)))
