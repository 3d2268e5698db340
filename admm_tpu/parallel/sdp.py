"""Sharded standard-form SDP: the transpose-reduction pattern at
matrix-iterate scale.

    min <C, X>   s.t.   A(X) = b,  X PSD

with the m dense constraint matrices A_i — the memory- and FLOP-
dominant operand, m x n^2 floats — SHARDED over the mesh
(models/sdp.py carries the serial twin; the reference's analogous
distributed form is unwrapped ADMM's transpose reduction,
solvers/unwrappedadmm.m:96-141: local contractions + global reduce +
replicated small solve).

Per x-prox (the affine projection onto {A(X) = b}):

    r_i  = A_i(V) - b_i            per-shard einsum  [local, sharded]
    r    = concat_i r_i            all-gather of m scalars
    y    = G^{-1} r                replicated (m, m) Cholesky solve
    corr = sum_i A_i^T y_i         per-shard einsum + psum over shards

so the per-iteration collective payload is m + n^2 floats —
independent of the sharded stack's m n^2 size.  The (n, n) iterates
X/Z/U stay replicated and the solve runs through the CORE engine
(engine.admm) unchanged: the sharding of the data leaves alone turns
the compiled program into a GSPMD program (collectives inserted by
XLA), so every engine variant (fast/relax/rbadaptive/unroll/stall)
works sharded for free.

The z-prox (PSD projection) is replicated — eigh or the Newton-Schulz
matmul-only tier exactly as in models/sdp.py.

Setup cost note: the Gram G = A A^T needs all constraint pairs, so the
one-time setup all-gathers the stack (transient m n^2 per device); the
steady-state HBM footprint is the sharded m n^2 / W + the (m, m)
factor.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import cho_factor, cho_solve
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..models._common import merge_config
from ..models.sdp import _ns_prox_g, _obj, _prox_g, _sym
from ..results import ADMMResults
from .mesh import make_mesh


def _prox_f_sharded(X, Z, U, rho, d):
    # Affine projection with the constraint stack sharded (W, mw, n, n):
    # local contractions per shard, one all-gather of the m residuals,
    # replicated Cholesky, psum of the per-shard correction.
    V = Z - U - d["C"] / rho
    ri = jnp.einsum("wkij,ij->wk", d["A"], V)          # local
    r = ri.reshape(-1) - d["bpad"]                     # all-gather (m,)
    y = cho_solve((d["L"], True), r)                   # replicated
    corr = jnp.einsum("wk,wkij->ij", y.reshape(ri.shape), d["A"])  # psum
    return V - corr


@functools.lru_cache(maxsize=16)
def _cached_gram_setup(shard_spec):
    """Replicated Gram Cholesky of the sharded stack, jitted once per
    sharding.  ``pad_diag`` carries 1.0 on padded (all-zero) constraint
    rows so G stays SPD; their residuals are identically 0, so the
    padded multipliers are 0 and the correction is exact."""

    def body(A4, pad_diag):
        with jax.default_matmul_precision("highest"):
            W, mw, n, _ = A4.shape
            Af = A4.reshape(W * mw, n * n)
            G = Af @ Af.T + jnp.diag(pad_diag)
            L, _ = cho_factor(G, lower=True)
            return L

    rep = NamedSharding(shard_spec.mesh, P())
    return jax.jit(body, out_shardings=rep)


def sdp_sharded(
    C,
    A,
    b,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    prox_method: str = "eigh",
    ns_iters: int = 24,
    ns_coarse: int = 0,
    ns_correct: int = 0,
    ns_delta: float = 0.0,
    x0=None,
    z0=None,
    u0=None,
    **overrides,
) -> ADMMResults:
    """Standard-form SDP with the (m, n, n) constraint stack sharded
    over the mesh — bitwise the same algebra as ``models.sdp.sdp`` on
    dense constraints (exactness oracle in tests/test_parallel_sdp.py),
    with A's HBM and the per-iteration A-contractions divided W ways.

    ``prox_method``/``ns_*`` select the PSD projection exactly as in
    the serial wrapper ('ns' = the matmul-only Newton-Schulz tier).  ``nshards``
    defaults to the mesh size; m is zero-padded up to a shard multiple
    (padded constraints are exact no-ops).
    """
    if prox_method not in ("eigh", "ns"):
        raise ValueError(
            f"prox_method must be 'eigh' or 'ns', got {prox_method!r}")
    if prox_method == "ns" and int(ns_correct) > 0 and float(ns_delta) == 0.0:
        raise ValueError(
            "prox_method='ns' with ns_correct > 0 requires ns_delta > 0 "
            "(models/sdp.py setup rule)")
    if isinstance(A, str):
        raise ValueError(
            "sdp_sharded shards a dense (m, n, n) constraint stack; the "
            "'diag' constraint is O(n) per iteration — use models.sdp.sdp")
    config = merge_config(config, overrides, body="heavy")

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    W = nshards if nshards is not None else mesh.devices.size
    if W < mesh.devices.size:
        mesh = make_mesh(W, axis)
    elif W % mesh.devices.size:
        raise ValueError(f"nshards={W} must be a multiple of the mesh size "
                         f"{mesh.devices.size}")

    C = _sym(jnp.asarray(C))
    n = C.shape[-1]
    if C.shape != (n, n):
        raise ValueError(f"C must be square, got {C.shape}")
    A = np.asarray(A, dtype=np.asarray(C).dtype)
    if A.ndim != 3 or A.shape[1:] != (n, n):
        raise ValueError(f"A must be (m, {n}, {n}), got {A.shape}")
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    m = A.shape[0]
    b = np.atleast_1d(np.asarray(b, A.dtype))
    if b.shape != (m,):
        raise ValueError(f"b must have shape {(m,)}, got {b.shape}")

    mw = -(-m // W)  # ceil
    m_pad = mw * W
    A4 = np.zeros((m_pad, n, n), A.dtype)
    A4[:m] = A
    A4 = A4.reshape(W, mw, n, n)
    bpad = np.zeros((m_pad,), A.dtype)
    bpad[:m] = b
    pad_diag = np.zeros((m_pad,), A.dtype)
    pad_diag[m:] = 1.0

    spec = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    A4_dev = jax.device_put(jnp.asarray(A4), spec)
    L = _cached_gram_setup(spec)(A4_dev, jax.device_put(
        jnp.asarray(pad_diag), rep))
    # Dependent-constraint guard — the pivots of the replicated factor
    # are concrete at setup; same rule and threshold as the serial sdp.
    from ..models.sdp import check_gram_conditioning

    check_gram_conditioning(L)

    data = {
        "C": jax.device_put(C, rep),
        "A": A4_dev,
        "bpad": jax.device_put(jnp.asarray(bpad), rep),
        "L": L,
    }
    pg = (_prox_g if prox_method == "eigh"
          else _ns_prox_g(int(ns_iters), int(ns_coarse), int(ns_correct),
                          float(ns_delta)))
    dt = C.dtype
    zero = jnp.zeros((n, n), dtype=dt)
    res = admm(
        _prox_f_sharded, pg, config,
        A=1.0, B=-1.0, c=0.0,
        shape_x=(n, n), shape_z=(n, n),
        x0=zero if x0 is None else jnp.asarray(x0, dt),
        z0=zero if z0 is None else jnp.asarray(z0, dt),
        u0=zero if u0 is None else jnp.asarray(u0, dt),
        hooks=Hooks(obj=_obj), dtype=dt, data=data,
    )
    res.extra["nshards"] = W
    res.extra["mesh"] = mesh
    return res
