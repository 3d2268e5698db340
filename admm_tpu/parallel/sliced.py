"""Engine-generic sliced proximal updates.

The reference's `options.parallel in {'xminf','zming','both'}` wraps the
user prox in parproxf/parproxg, parfor-ing over user-declared slices of
the variable with the full (x, z, u) broadcast to each worker and the
slice results gathered via cell2mat (admm.m:343-467); slice vectors are
validated and worker-balanced by errorcheck('slices') -> slicemaker
(errorcheck.m:216-267), and 'both' takes a 2-element cell
(slicesx, slicesz) (admm.m:360-383).

Design: the same contract — a per-slice prox
``prox_slice(x, z, u, rho, k) -> slice_k of the result`` — is compiled
into a single shard_map over a 1-D mesh: every device holds the full
replicated iterates (the reference's broadcast, now free: state already
lives on-device), computes its own slice, and the stacked out-spec is the
reference's cell2mat gather with no host round-trip.

UNEVEN slices are supported by internal padding: each device computes a
max-length block, and a static index map reassembles the valid entries
into the flat result (the padding lanes are dead work, bounded by
(maxlen - minlen) per device — the same imbalance a parfor pool would
idle on).  The resulting prox is a plain ``prox(x, z, u, rho)`` usable
directly with the core engine — slicing composes with every engine
feature.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
try:  # jax >= 0.8 promotes shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.validate import slicemaker
from .mesh import make_mesh


def _shard_mapped(fn, mesh, axis):
    kwargs = dict(mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=P(axis))
    try:  # new API (jax.shard_map): replication check renamed
        return shard_map(fn, check_vma=False, **kwargs)
    except TypeError:  # pragma: no cover — older jax
        return shard_map(fn, check_rep=False, **kwargs)


def make_sliced_prox(
    prox_slice: Callable,
    slices: Union[int, Sequence[int]],
    mesh: Optional[Mesh] = None,
) -> Callable:
    """Build an engine-compatible prox from a per-slice prox.

    Cached on (prox_slice, slices, mesh): repeat calls return the SAME
    wrapper object, so the engine's compiled-runner cache stays warm
    across solves (the module-level-function caching contract).

    ``prox_slice(x, z, u, rho, k)`` receives the FULL iterates plus the
    slice index k (the reference's xminfi(x, z, u, rho, k) contract,
    admm.m:416-436).

    ``slices`` is either an int — every slice has that length (the
    per-slice result must have shape ``(slices,)``) — or a sequence of
    per-slice lengths (possibly uneven, e.g. from ``slicemaker``); the
    per-slice result must then have shape ``(max(slices),)`` with only
    the first ``lengths[k]`` entries meaningful (the rest are masked
    out).  A per-slice prox needing its start offset indexes a static
    array with k, e.g. ``start = jnp.asarray(starts)[k]``.  Fewer slices
    than devices is fine — the trailing devices compute dead lanes.
    """
    if mesh is None:
        mesh = make_mesh()
    if np.ndim(slices) != 0:
        slices = tuple(int(v) for v in slices)
    return _cached_sliced_prox(prox_slice, slices, mesh)


@functools.lru_cache(maxsize=128)
def _cached_sliced_prox(prox_slice, slices, mesh):
    axis = mesh.axis_names[0]
    W = mesh.devices.size

    if np.ndim(slices) == 0:
        if int(slices) <= 0:
            # 0 means 'even split' only where slicemaker resolves it
            # first (make_parallel_proxes / admm(parallel=)); here a
            # scalar is the per-slice LENGTH and must be positive.
            raise ValueError(
                "make_sliced_prox scalar slices is the per-slice length "
                "and must be positive; for an even split pass "
                "slicemaker(0, n, W) lengths or use make_parallel_proxes"
            )
        lengths = [int(slices)] * W
    else:
        lengths = [int(v) for v in slices]
        if len(lengths) > W:
            # Static-shape divergence from the reference: its parfor path
            # queues any slice count over the pool (admm.m:430-434); here
            # one device computes one slice, so the count must fit the
            # mesh.  slices=0 (even split) always fits.
            raise ValueError(
                f"{len(lengths)} slices > {W} mesh devices: each "
                "device computes exactly one slice per step. Pass a "
                f"vector of at most {W} lengths (slicemaker(0, n, {W}) "
                "builds a mesh-balanced even split)"
            )
        lengths = lengths + [0] * (W - len(lengths))
    L = max(lengths)
    n = sum(lengths)

    # Static gather map: flat position j lives at stacked[(w, o)] ->
    # w*L + o in the flattened (W, L) block — the cell2mat reassembly.
    idx = np.concatenate(
        [w * L + np.arange(lengths[w]) for w in range(W) if lengths[w]]
    ).astype(np.int32)
    uneven = any(l != L for l in lengths)

    def sharded(x, z, u, rho):
        k = jax.lax.axis_index(axis)
        out = prox_slice(x, z, u, rho, k)
        return out.reshape(1, L)

    fn = _shard_mapped(sharded, mesh, axis)

    if not uneven:
        def prox(x, z, u, rho):
            return fn(x, z, u, jnp.asarray(rho)).reshape(-1)
        return prox

    idx_dev = jnp.asarray(idx)

    def prox(x, z, u, rho):
        stacked = fn(x, z, u, jnp.asarray(rho))
        return jnp.take(stacked.reshape(-1), idx_dev)

    return prox


def make_parallel_proxes(
    prox_f: Callable,
    prox_g: Callable,
    parallel: str,
    slices,
    nx: Optional[int] = None,
    nz: Optional[int] = None,
    mesh: Optional[Mesh] = None,
):
    """Wire the reference's ``options.parallel`` modes (admm.m:343-467).

    - ``parallel='xminf'``: ``prox_f`` is the per-slice xminfi; returns
      (wrapped_f, prox_g).  ``slices`` is a slicemaker spec (scalar k,
      0 for an even split, or a vector of lengths) over ``nx``.
    - ``parallel='zming'``: symmetric, over ``nz``.
    - ``parallel='both'``: ``slices`` is a 2-tuple (slicesx, slicesz)
      (the reference's 2-element cell, admm.m:360-365); both proxes are
      per-slice.

    Returns ``(prox_f, prox_g)`` ready for ``admm(...)``.  Slice specs
    go through ``slicemaker`` (errorcheck.m:216-267): 0 balances evenly
    over the mesh device count; a scalar block size k or an explicit
    length vector is used as-is and must yield at most one slice per
    device (each device computes exactly one slice — unlike the
    reference's parfor queue, which accepts any slice count).
    """
    if parallel not in ("xminf", "zming", "both"):
        raise ValueError(
            f"parallel must be 'xminf'|'zming'|'both', got {parallel!r}")
    if mesh is None:
        mesh = make_mesh()
    W = mesh.devices.size

    if parallel == "both":
        if not (isinstance(slices, (tuple, list)) and len(slices) == 2):
            raise ValueError(
                "parallel='both' needs slices=(slicesx, slicesz) — the "
                "reference's 2-element cell (admm.m:360-365)")
        slicesx, slicesz = slices
    elif isinstance(slices, (tuple, list)) and len(slices) == 2 and all(
            np.ndim(s) != 0 for s in slices):
        raise ValueError(
            "a 2-element slices pair is only valid with parallel='both' "
            "(admm.m:365-368)")
    else:
        slicesx = slices if parallel == "xminf" else None
        slicesz = slices if parallel == "zming" else None

    if parallel in ("xminf", "both"):
        if nx is None:
            raise ValueError("nx (length of x) is required to slice xminf")
        lengths = slicemaker(0 if slicesx is None else slicesx, nx, W)
        prox_f = make_sliced_prox(prox_f, lengths, mesh)
    if parallel in ("zming", "both"):
        if nz is None:
            raise ValueError("nz (length of z) is required to slice zming")
        lengths = slicemaker(0 if slicesz is None else slicesz, nz, W)
        prox_g = make_sliced_prox(prox_g, lengths, mesh)
    return prox_f, prox_g
