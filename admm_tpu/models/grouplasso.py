"""Group lasso: min 1/2 ||D x - s||^2 + lam sum_g w_g ||z_g||_2
s.t.  x - z = 0, where the coordinates of z are partitioned into groups.

Beyond the reference (its shrinkage family stops at elementwise
soft-thresholding, getProxOps.m:933-938); standard ADMM formulation per
Boyd et al. §6.4.  The x-update is the shared least-squares prox
(lasso.make_ls_xprox); the z-update is group-wise block soft-thresholding
(ops/prox.py:block_soft_threshold) computed with static-shape segment
reductions, so uneven groups cost the same fused elementwise pass as even ones.

``groups`` accepts any of
  - an int g: g equal consecutive groups (n must divide),
  - a sequence of group lengths shorter than n (consecutive groups,
    uneven ok),
  - an int array of EXACTLY length n: per-coordinate group ids in
    [0, num_groups) (need not be consecutive).
``weights`` defaults to 1 per group; pass e.g. sqrt(group sizes) for the
size-adjusted convention.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import block_soft_threshold
from ..results import ADMMResults
from . import register
from ._common import bind_data, check_data_vector, merge_config, timed_solver
from .lasso import make_ls_xprox


def resolve_groups(groups, n):
    """Normalize a groups spec to ``(gid, num_groups)`` with ``gid`` an
    int32 array of length n (static — it is part of the traced program's
    constants, not runtime data)."""
    if isinstance(groups, (int, np.integer)):
        g = int(groups)
        if g <= 0 or n % g:
            raise ValueError(f"{g} equal groups do not tile n={n}")
        gid = np.repeat(np.arange(g), n // g)
        return jnp.asarray(gid, jnp.int32), g
    arr = np.asarray(groups)
    if arr.ndim != 1:
        raise ValueError(f"groups must be 1-D, got shape {arr.shape}")
    if arr.shape[0] == n:
        # A length-n array is ALWAYS group ids (shorter arrays are group
        # lengths); ids must cover 0..max contiguously.
        ids = arr.astype(np.int64)
        num = int(ids.max()) + 1
        if ids.min() != 0 or len(np.unique(ids)) != num:
            if np.all(ids > 0) and ids.sum() == n:
                # The natural spelling of lengths happens to have length n
                # (e.g. np.ones(n) for n singleton groups) — it is being
                # read as ids.  Name the ambiguity instead of the cryptic
                # contiguity error.
                raise ValueError(
                    f"groups has length n={n}, so it is interpreted as "
                    "per-coordinate group IDS, but its entries look like "
                    "group LENGTHS (positive, summing to n). For singleton "
                    "groups pass np.arange(n) (ids) or the int n; for "
                    "lengths, a length-n lengths vector is ambiguous — "
                    "pass the equivalent id array instead."
                )
            raise ValueError("group ids must cover 0..max contiguously")
        return jnp.asarray(ids, jnp.int32), num
    lengths = arr.astype(np.int64)
    if np.any(lengths <= 0) or lengths.sum() != n:
        raise ValueError(
            f"group lengths must be positive and sum to n={n}, got {lengths}"
        )
    gid = np.repeat(np.arange(len(lengths)), lengths)
    return jnp.asarray(gid, jnp.int32), len(lengths)


@functools.lru_cache(maxsize=None)
def _group_fns(num_groups):
    """Per-group-count prox/objective pair.

    Only ``num_segments`` must be a static Python int; the membership
    array rides in ``data`` as a traced operand.  lru-caching on the
    count keeps the functions' identities stable across calls, so the
    engine's compiled-runner cache (keyed on functions + config) hits on
    re-solves — even with a different group assignment of the same
    count.
    """
    import jax

    def prox_g(x, z, u, rho, d):
        return block_soft_threshold(x + u, d["lam"] * d["w"] / rho,
                                    d["gid"], num_groups)

    def obj(x, z, d):
        fit = 0.5 * jnp.sum((d["D"] @ x - d["s"]) ** 2)
        norm2 = jax.ops.segment_sum(z * z, d["gid"], num_segments=num_groups)
        return fit + d["lam"] * jnp.sum(d["w"] * jnp.sqrt(norm2))

    return prox_g, obj


def make_prox_ops(D, s, lam, groups, weights=None,
                  config: ADMMConfig = ADMMConfig(), stream_dtype=None):
    """Build (prox_f, prox_g, obj, data) for the group lasso.

    The group structure is static (baked into the traced program); lam
    and the per-group weights stay runtime data, so re-solves across
    regularization strengths reuse the compiled runner.
    """
    prox_f, data = make_ls_xprox(D, s, config, stream_dtype)
    n = data["D"].shape[1]
    gid, num_groups = resolve_groups(groups, n)
    dt = data["D"].dtype
    w = jnp.ones(num_groups, dt) if weights is None else jnp.asarray(weights, dt)
    if w.shape != (num_groups,):
        raise ValueError(f"weights must have shape ({num_groups},), got {w.shape}")
    data["lam"] = jnp.asarray(lam, dt)
    data["w"] = w
    data["gid"] = gid
    prox_g, obj = _group_fns(num_groups)
    return prox_f, prox_g, obj, data


@register("grouplasso")
def _registry_entry(D, s, lam, groups, weights=None, config=ADMMConfig(), **_):
    pf, pg, obj, data = make_prox_ops(D, s, lam, groups, weights, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def grouplasso(D, s, lam, groups, weights=None,
               config: ADMMConfig = ADMMConfig(), *, stream_dtype=None,
               x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Solve the group lasso over the given coordinate groups.

    NOTE: only the group COUNT is static (the prox pair is lru-cached on
    ``num_groups``, the membership array rides in ``data`` as a traced
    operand), so the engine's compiled-runner cache is keyed per group
    count — re-solving with a different assignment of the SAME count hits
    the cache; changing the count (or shapes/config) recompiles.
    """
    check_data_vector(D, s)
    config = merge_config(config, overrides, body="gemv")
    D = jnp.asarray(D)
    n = D.shape[1]
    prox_f, prox_g, obj, data = make_prox_ops(D, s, lam, groups, weights,
                                              config, stream_dtype)
    return admm(
        prox_f, prox_g, config,
        A=1.0, B=-1.0, c=0.0, m=n, nA=n, nB=n,
        x0=x0, z0=z0, u0=u0,
        hooks=Hooks(obj=obj), dtype=D.dtype, data=data,
    )
