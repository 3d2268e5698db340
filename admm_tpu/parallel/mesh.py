"""Device-mesh helpers and static row sharding.

The reference balances work with `slicemaker` (errorcheck.m:216-267):
N rows over W workers, remainder spread over the first slices.  Under jit
the shards must be equal-sized (static shapes), so rows are zero-padded up
to the next multiple of W — zero rows are exact no-ops for every
Gram/matvec used by the distributed solvers (D^T D, D^T s, D^T(z-u)).

On a GPU host every card reaches every other over NVLink at the same
rate, so the mesh follows the algorithm alone: ``make_mesh`` for row
shards, ``make_mesh2d`` for instance lanes x row shards."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shards") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh2d(lanes: int, shards: int,
                axis_names: Tuple[str, str] = ("lanes", "shards"),
                devices=None) -> Mesh:
    """A 2-D (lanes x shards) mesh: instance lanes on axis 0, consensus /
    transpose-reduction row shards on axis 1.  Several cards run both
    axes at once — batched instances, each row-sharded (VERDICT r3 #7)."""
    devs = jax.devices() if devices is None else list(devices)
    need = lanes * shards
    if need > len(devs):
        raise ValueError(
            f"mesh {lanes}x{shards} needs {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(lanes, shards), axis_names)


def pad_rows(M: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Zero-pad axis 0 of ``M`` to a multiple; returns (padded, n_pad)."""
    m = M.shape[0]
    target = math.ceil(m / multiple) * multiple
    n_pad = target - m
    if n_pad == 0:
        return M, 0
    pad_width = [(0, n_pad)] + [(0, 0)] * (M.ndim - 1)
    return np.pad(M, pad_width), n_pad


def shard_rows(M, W: int):
    """Reshape rows into W equal contiguous blocks: (m, ...) -> (W, m/W, ...).

    The static-shape analog of slicemaker's contiguous balanced slices
    (errorcheck.m:240-265); combine with ``pad_rows`` first."""
    M = np.asarray(M)
    m = M.shape[0]
    if m % W:
        raise ValueError(f"rows {m} not divisible by {W}; pad_rows first")
    return M.reshape((W, m // W) + M.shape[1:])
