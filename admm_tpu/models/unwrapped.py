"""Unwrapped ADMM with transpose reduction.

Generic driver for problems of the form  min_x g(D x)  "unwrapped" as

    f(x) = 0,  g(z),   s.t.   D x - z = 0

so the x-update is a least-squares pull-back of z - u through D:

serial:     x = D^+ (z - u)                       (unwrappedadmm.m:76-78)
distributed:x = (sum_i D_i^T D_i)^{-1} sum_i D_i^T (z_i - u_i)
            — per-shard local matvecs, a global reduce-sum, and a
            replicated solve (unwrappedadmm.m:96-141).  The sharded
            version lives in parallel/transpose_reduction.py.

Reference: solvers/unwrappedadmm.m.  Driver defaults preserved from
unwrappedadmm.m:81-92: A = D, B = -1, c = 0, random x0/z0/u0,
stopcond = 'both', nodualerror = 1.

Design: D^+ is materialized once (pinv at setup, as the reference
does); every x-update is then a single n-by-m GEMV.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..results import ADMMResults
from ._common import merge_config, timed_solver


def _prox_f(x, z, u, rho, d):
    return d["Dplus"] @ (z - u)


@timed_solver
def unwrappedadmm(
    prox_g: Callable,
    D,
    config: ADMMConfig = ADMMConfig(),
    *,
    obj: Optional[Callable] = None,
    seed: int = 0,
    data: Optional[dict] = None,
    x0=None,
    z0=None,
    u0=None,
    **overrides,
) -> ADMMResults:
    """Run unwrapped ADMM (reference solvers/unwrappedadmm.m:1).

    ``prox_g`` receives the raw x and is expected to apply D itself (as
    the reference's zminLinearSVM does, getProxOps.m:1084-1103).  When
    ``data`` is given, prox_g/obj follow the engine's data convention
    (module-level functions taking a trailing data pytree; ``Dplus`` and
    ``D`` are added to it here).
    """
    # The reference forces stopcond='both' and nodualerror=1 (and clamps
    # maxiters to 1000, unwrappedadmm.m:90-92); we preserve the stopping
    # semantics but respect the caller's iteration budget.
    overrides.setdefault("stopcond", "both")
    overrides.setdefault("nodualerror", True)
    config = merge_config(config, overrides, body="gemv")

    D = jnp.asarray(D)
    m, n = D.shape
    Dplus = jnp.linalg.pinv(D)

    # Random start (unwrappedadmm.m:89-91) — uniform [0, 1); explicit
    # x0/z0/u0 warm starts override it (reference options.x0/z0/u0,
    # admm.m:252-254).
    kx, kz, ku = jax.random.split(jax.random.PRNGKey(seed), 3)
    if x0 is None:
        x0 = jax.random.uniform(kx, (n,), dtype=D.dtype)
    if z0 is None:
        z0 = jax.random.uniform(kz, (m,), dtype=D.dtype)
    if u0 is None:
        u0 = jax.random.uniform(ku, (m,), dtype=D.dtype)

    if data is not None:
        data = dict(data)
        data["Dplus"] = Dplus
        data["D"] = D
        prox_f = _prox_f
    else:
        prox_f = lambda x, z, u, rho: Dplus @ (z - u)

    return admm(
        prox_f, prox_g, config,
        A=D, B=-1.0, c=0.0, m=m, nA=n, nB=m,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data,
    )
