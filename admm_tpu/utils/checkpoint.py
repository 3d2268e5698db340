"""Checkpoint / resume of ADMM solver state.

The reference has no disk checkpointing; its warm-start options x0/z0/u0
(admm.m:252-254, docs admm.m:948-963) are the analog.  Here the ADMM
state tuple (x, z, u, rho, steps) is serialized to a .npz and restored
into the engine's warm-start arguments (SURVEY.md section 5
'Checkpoint / resume').
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from ..results import ADMMResults


def _npz_path(path: Union[str, Path]) -> Path:
    """np.savez appends '.npz' when missing; normalize both sides so a
    save/load round-trip with the same extensionless path works."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def save_state(results: ADMMResults, path: Union[str, Path]) -> None:
    """Persist the resumable state of a solve (as <path>.npz if the
    suffix is missing — np.savez semantics)."""
    path = Path(path)
    np.savez(
        path,
        x=np.asarray(results.xopt),
        z=np.asarray(results.zopt),
        u=np.asarray(results.uopt),
        rho=np.asarray(results.rho_final),
        steps=np.asarray(results.steps),
    )


def load_state(path: Union[str, Path]) -> dict:
    """Load a saved state as warm-start kwargs for ``admm`` (x0/z0/u0)
    plus the rho and step count at save time."""
    with np.load(_npz_path(path)) as f:
        return {
            "x0": f["x"],
            "z0": f["z"],
            "u0": f["u"],
            "rho": float(f["rho"]),
            "steps": int(f["steps"]),
        }


def save_state_orbax(results: ADMMResults, path: Union[str, Path]) -> None:
    """Orbax backend: async-capable and SHARDED-array aware — the right
    choice for distributed solver state (e.g. consensus xi/ui living
    sharded across several devices; the npz backend would force a host gather).
    Saves the same fields as ``save_state`` plus any sharded per-shard
    state found in ``results.extra``."""
    import orbax.checkpoint as ocp

    # Works for ADMMResults and for stacked per-lane BatchResults (the
    # 2-D lanes x shards programs): rho_final may be None (static-rho
    # batch runs) and steps may be a (B,) vector.
    rho = results.rho_final
    state = {
        "x": results.xopt,
        "z": results.zopt,
        "u": results.uopt,
        "rho": np.asarray(1.0 if rho is None else rho),
        "steps": np.asarray(results.steps),
    }
    for key in ("xi", "ui"):
        if key in results.extra:
            state[key] = results.extra[key]
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(Path(path).absolute(), state)
    ckptr.wait_until_finished()


def load_state_orbax(path: Union[str, Path]) -> dict:
    """Restore an orbax checkpoint written by ``save_state_orbax``;
    returns warm-start kwargs like ``load_state`` (plus xi/ui when
    present)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    state = ckptr.restore(Path(path).absolute())
    steps = np.asarray(state["steps"])
    rho = np.asarray(state["rho"])
    out = {
        "x0": state["x"],
        "z0": state["z"],
        "u0": state["u"],
        # Scalars for single solves; per-lane vectors for batched state.
        "rho": float(rho) if rho.ndim == 0 else rho,
        "steps": int(steps) if steps.ndim == 0 else steps,
    }
    for key in ("xi", "ui"):
        if key in state:
            out[key] = state[key]
    return out
