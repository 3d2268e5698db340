"""Instance-batched solvers: B independent problem INSTANCES in one
vmapped, jit-cached program.

Complements models/paths.py — a path sweeps a hyperparameter on one
fixed instance, whereas here the DATA varies per lane and every
factorization that does not depend on it is shared:

- ``lasso_batch``: sparse-code a batch of signals against ONE shared
  dictionary (one Gram/Woodbury factorization; the per-lane x-update
  GEMVs become (B, m) x (m, n) GEMMs).  This is the classic
  dictionary-coding workload — e.g. encoding image patches.
- ``tv_batch``: denoise a batch of 1-D signals (the (I + rho D^T D)
  factorization is signal-independent, so all lanes share it).
- ``lad_batch`` / ``huberfit_batch``: robust regression of many
  right-hand sides against one design matrix (one normal-equations
  pseudo-inverse shared).
- ``svm_batch``: B one-vs-all classifiers against one design matrix
  (one pseudo-inverse shared; per-lane labels/penalty mapped).
- ``lp_batch`` / ``qp_batch``: B LPs / QPs sharing one constraint
  matrix / Hessian with per-lane linear terms — the MPC pattern (one
  KKT fold shared, offsets batched in one setup GEMM).
- ``model_batch`` / ``tv2d_batch``: multi-RHS model problem and batch
  image denoising — with these, every solver family in the library has
  an instance-batched variant.

The reference library solves instances one at a time in a MATLAB loop
(e.g. solvers/lasso.m:77 called per signal); there is no batched
equivalent to cite — this module is the batched replacement for
that outer loop.  Lanes converge independently: under vmap the engine's
while_loop freezes finished lanes (per-lane predicate select), and
``steps`` reports each lane's own iteration count.

Engine caching contract: prox operators stay module-level functions
over a ``data`` pytree; the vmapped runner is compiled once per
(functions, config, mapped-leaf set) via paths._cached_path_runner and
reused across calls, so steady-state timing contains no retracing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ADMMConfig, resolve_unroll
from ..linop import as_linop
from ._common import merge_config
from .huberfit import make_prox_ops as _huber_make_prox_ops
from .lad import make_prox_ops as _lad_make_prox_ops
from .lasso import make_prox_ops as _lasso_make_prox_ops
from .paths import _cached_path_runner, _highest_precision_setup
from .totalvariation import make_prox_ops as _tv_make_prox_ops


@dataclasses.dataclass
class BatchResults:
    """Stacked per-lane results: leading axis = instance index."""

    xopt: Any
    zopt: Any
    uopt: Any
    steps: Any       # (B,) iterations per instance
    objopt: Any = None  # (B,) per-instance objective at the solution
    rho_final: Any = None  # (B,) final rho per lane (rbadaptive/adaptive)
    runtime: float = 0.0
    hist: dict = dataclasses.field(default_factory=dict)
    # Solver-specific extras (e.g. consensus_lasso_batch's per-lane
    # sharded xi/ui for warm-start resume), like ADMMResults.extra.
    extra: dict = dataclasses.field(default_factory=dict)


def _check_batch(S, m, what):
    S = jnp.asarray(S)
    if S.ndim != 2 or S.shape[1] != m:
        raise ValueError(
            f"{what} must be a (B, {m}) batch of row instances, got {S.shape}"
        )
    return S


def _shard_lanes(mesh, mapped, data, state, A, B):
    """Distribute the lane (instance) axis over a 1-D device mesh.

    Lanes are independent, so GSPMD partitions the whole vmapped
    program lane-wise with no inter-device collectives beyond the
    while_loop's scalar continue-predicate reduction: per-lane state
    and mapped data leaves are sharded on axis 0, shared factorizations
    and constraint operators replicated.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"batch solvers take a 1-axis mesh, got axes {mesh.axis_names}"
        )
    nb = state[0].shape[0]
    if nb % mesh.size != 0:
        raise ValueError(
            f"batch size {nb} must divide evenly over the {mesh.size}-device "
            f"mesh (pad the instance batch to a multiple)"
        )
    sh_b = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    sh_r = NamedSharding(mesh, PartitionSpec())
    state = tuple(jax.device_put(v, sh_b) for v in state)
    data = {k: jax.device_put(v, sh_b if k in mapped else sh_r)
            for k, v in data.items()}
    return state, data, jax.device_put(A, sh_r), jax.device_put(B, sh_r)


def _run(prox_f, prox_g, obj, config, mapped, data, x0, z0, u0, c0, A, B,
         mesh=None, warm=None):
    if warm is not None:
        # Warm start (receding-horizon re-solves: seed from the previous
        # BatchResults).  Each entry may be None (keep the solver's
        # default), one instance (broadcast), or a (B, ...) stack.
        x0, z0, u0 = (
            d if w is None else _broadcast_lane(
                w, d.shape[0], d.shape[1:], d.dtype, name)
            for w, d, name in zip(warm, (x0, z0, u0), ("x0", "z0", "u0"))
        )
    vrun = _cached_path_runner(prox_f, prox_g, obj, config,
                               frozenset(mapped), frozenset(data))
    if mesh is not None:
        (x0, z0, u0, c0), data, A, B = _shard_lanes(
            mesh, mapped, data, (x0, z0, u0, c0), A, B)
    jax.block_until_ready(data)
    t0 = time.perf_counter()  # loop-only wall clock (setup flushed)
    out = jax.block_until_ready(vrun(x0, z0, u0, c0, A, B, data))
    return BatchResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], objopt=out.get("objopt"),
        rho_final=out.get("rho_final"),
        runtime=time.perf_counter() - t0,
        hist={k: v for k, v in out["hist"].items() if not isinstance(v, tuple)},
        # (B,) per-lane plateau flags when ADMMConfig.stallwindow is on.
        extra={"stalled": out["stalled"]} if "stalled" in out else {},
    )


@_highest_precision_setup
def lasso_batch(D, S, lams, config: ADMMConfig = ADMMConfig(), *,
                stream_dtype=None, x0=None, z0=None, u0=None,
                mesh=None, **overrides) -> BatchResults:
    """Solve LASSO for every signal row of ``S`` (shape (B, m)) against
    the shared dictionary ``D`` (shape (m, n)) in one vmapped program.

    ``lams`` is a scalar (shared) or a (B,) vector (per-instance
    regularization).  The x-update factorization depends only on
    (D, rho), so all lanes share it; only the right-hand-side leaves
    (s, D^T s, lam) are mapped.  ``stream_dtype`` applies to the shared
    fat-branch stream matrices exactly as in ``lasso``.
    """
    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    S = _check_batch(S, m, "S").astype(D.dtype)
    Bn = S.shape[0]
    prox_f, prox_g, obj, data = _lasso_make_prox_ops(
        D, S[0], 1.0, config, stream_dtype)
    data = dict(data)
    data["s"] = S
    data["Dts"] = S @ D  # (B, n): per-lane D^T s in one GEMM
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, D.dtype), (Bn,))

    zeros = jnp.zeros((Bn, n), D.dtype)
    return _run(prox_f, prox_g, obj, config, {"s", "Dts", "lam"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def elasticnet_batch(D, S, lams, alphas=0.5, config: ADMMConfig = ADMMConfig(), *,
                     stream_dtype=None, x0=None, z0=None, u0=None,
                     mesh=None, **overrides) -> BatchResults:
    """Elastic net for every signal row of ``S`` (shape (B, m)) against
    the shared dictionary ``D``; ``lams``/``alphas`` are scalars or (B,)
    per-instance vectors.  Same shared-factorization structure as
    ``lasso_batch`` (the x-update depends only on (D, rho))."""
    from .elasticnet import _obj, _prox_g
    from .lasso import make_ls_xprox

    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    S = _check_batch(S, m, "S").astype(D.dtype)
    Bn = S.shape[0]
    a = np.asarray(alphas, float)
    if np.any(a < 0) or np.any(a > 1):
        raise ValueError(f"alpha must be in [0, 1], got {alphas}")
    prox_f, data = make_ls_xprox(D, S[0], config, stream_dtype)
    data["s"] = S
    data["Dts"] = S @ D  # (B, n): per-lane D^T s in one GEMM
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, D.dtype), (Bn,))
    data["alpha"] = jnp.broadcast_to(jnp.asarray(alphas, D.dtype), (Bn,))

    zeros = jnp.zeros((Bn, n), D.dtype)
    return _run(prox_f, _prox_g, _obj, config,
                {"s", "Dts", "lam", "alpha"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def grouplasso_batch(D, S, lams, groups, weights=None,
                     config: ADMMConfig = ADMMConfig(), *,
                     stream_dtype=None, x0=None, z0=None, u0=None,
                     mesh=None, **overrides) -> BatchResults:
    """Group lasso for every signal row of ``S`` (shape (B, m)); the
    group structure (and optional per-group weights) is shared across
    lanes, ``lams`` is a scalar or (B,) vector."""
    from .grouplasso import _group_fns, resolve_groups
    from .lasso import make_ls_xprox

    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    S = _check_batch(S, m, "S").astype(D.dtype)
    Bn = S.shape[0]
    gid, num_groups = resolve_groups(groups, n)
    w = (jnp.ones(num_groups, D.dtype) if weights is None
         else jnp.asarray(weights, D.dtype))
    if w.shape != (num_groups,):
        raise ValueError(f"weights must have shape ({num_groups},), got {w.shape}")
    prox_f, data = make_ls_xprox(D, S[0], config, stream_dtype)
    data["s"] = S
    data["Dts"] = S @ D
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, D.dtype), (Bn,))
    data["w"] = w
    data["gid"] = gid
    prox_g, obj = _group_fns(num_groups)

    zeros = jnp.zeros((Bn, n), D.dtype)
    return _run(prox_f, prox_g, obj, config, {"s", "Dts", "lam"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def nnls_batch(D, S, config: ADMMConfig = ADMMConfig(), *,
               stream_dtype=None, x0=None, z0=None, u0=None,
               mesh=None, **overrides) -> BatchResults:
    """Nonnegative least squares for every row of ``S`` (shape (B, m))
    against the shared ``D`` — one shared factorization, a projection
    z-update per lane."""
    from .nnls import _obj, _prox_g
    from .lasso import make_ls_xprox

    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    S = _check_batch(S, m, "S").astype(D.dtype)
    Bn = S.shape[0]
    prox_f, data = make_ls_xprox(D, S[0], config, stream_dtype)
    data["s"] = S
    data["Dts"] = S @ D

    zeros = jnp.zeros((Bn, n), D.dtype)
    return _run(prox_f, _prox_g, _obj, config, {"s", "Dts"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def basispursuit_batch(D, S, config: ADMMConfig = ADMMConfig(), *,
                       x0=None, z0=None, u0=None,
                       mesh=None, **overrides) -> BatchResults:
    """Basis pursuit for every measurement row of ``S`` (shape (B, m))
    against the shared underdetermined sensing matrix ``D`` (m, n) —
    batched compressed-sensing decoding.

    The projection matrix P = I - D^T (D D^T)^{-1} D is measurement-
    independent and shared; only the projection offset
    q = D^T (D D^T)^{-1} s is per-lane (computed for all lanes in one
    GEMM).  Same projection algebra as models/basispursuit.py
    (reference basispursuit.m:116-120).
    """
    import jax.scipy.linalg as jsla

    from .basispursuit import _obj, _prox_f, _prox_g

    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    if m >= n:
        raise ValueError(
            "basis pursuit requires an underdetermined system (m < n); "
            f"got D of shape {(m, n)} (reference basispursuit.m:192-203)"
        )
    S = _check_batch(S, m, "S").astype(D.dtype)
    Bn = S.shape[0]

    G = D @ D.T
    cf = jsla.cho_factor(0.5 * (G + G.T))
    GinvD = jsla.cho_solve(cf, D)
    data = {
        "P": jnp.eye(n, dtype=D.dtype) - D.T @ GinvD,
        "q": S @ GinvD,  # (B, n): per-lane D^T (D D^T)^{-1} s
    }

    zeros = jnp.zeros((Bn, n), D.dtype)
    return _run(_prox_f, _prox_g, _obj, config, {"q"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def tv_batch(S, lams, config: ADMMConfig = ADMMConfig(), *,
             solver: str = "auto", x0=None, z0=None, u0=None,
             mesh=None, **overrides) -> BatchResults:
    """1-D TV denoising of every signal row of ``S`` (shape (B, n)) in
    one vmapped program.

    The diagonalized (or cyclic-reduction) (I + rho D^T D) solve is
    signal-independent and shared across lanes; ``lams`` is a scalar or
    (B,) per-signal denoising strength.
    """
    config = merge_config(config, overrides, body="batched")
    S = jnp.asarray(S)
    if S.ndim != 2:
        raise ValueError(f"S must be a (B, n) batch of signals, got {S.shape}")
    Bn, n = S.shape
    prox_f, prox_g, obj, data, D = _tv_make_prox_ops(S[0], 1.0, config,
                                                     solver, batched=True)
    data = dict(data)
    data["s"] = S
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, S.dtype), (Bn,))

    zeros = jnp.zeros((Bn, n), S.dtype)
    return _run(prox_f, prox_g, obj, config, {"s", "lam"}, data,
                zeros, zeros, zeros, zeros, as_linop(D), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def covsel_batch(Ss, lams, config: ADMMConfig = ADMMConfig(), *,
                 prox_method: str = "ns", ns_iters: int = 20,
                 ns_coarse: int = 0, ns_correct: int = 0,
                 x0=None, z0=None, u0=None, mesh=None, **overrides) -> BatchResults:
    """Graphical lasso for every covariance matrix in ``Ss`` (shape
    (B, n, n)) in one vmapped program — e.g. per-subject sparse
    precision estimation over a cohort.

    Build each lane's empirical covariance first
    (models.covarianceselection.empirical_covariance, vmappable).
    The default x-prox is the Newton-Schulz evaluation
    (``prox_method='ns'``, ops/matfun.py): under vmap it is pure
    batched n^3 GEMM work, with no batched eigh inside the loop.
    ``prox_method='ns_fast'`` (or explicit ``ns_coarse``/``ns_correct``)
    runs the square-root steps at the default matmul precision (TF32 on
    the GPU) with full-precision residual corrections — see
    covarianceselection.  ``lams`` is a scalar or (B,) vector.
    """
    config = merge_config(config, overrides, body="batched")
    from .covarianceselection import make_prox_ops as _covsel_make_prox_ops

    Ss = jnp.asarray(Ss)
    if Ss.ndim != 3 or Ss.shape[1] != Ss.shape[2]:
        raise ValueError(
            f"Ss must be a (B, n, n) stack of covariance matrices, "
            f"got {Ss.shape}"
        )
    Bn, n = Ss.shape[0], Ss.shape[1]
    prox_f, prox_g, obj, data = _covsel_make_prox_ops(
        Ss[0], 1.0, config, prox_method=prox_method, ns_iters=ns_iters,
        ns_coarse=ns_coarse, ns_correct=ns_correct)
    data = dict(data)
    data["S"] = Ss
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, Ss.dtype), (Bn,))

    zeros = jnp.zeros((Bn, n, n), Ss.dtype)
    return _run(prox_f, prox_g, obj, config, {"S", "lam"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def sdp_batch(Cs, A, bs, config: ADMMConfig = ADMMConfig(), *,
              prox_method: str = "eigh", ns_iters: int = 24,
              ns_coarse: int = 0, ns_correct: int = 0, ns_delta: float = 0.0,
              x0=None, z0=None, u0=None, mesh=None,
              **overrides) -> BatchResults:
    """Standard-form SDP for every cost matrix in ``Cs`` (shape
    (B, n, n)) against a SHARED constraint operator ``A`` — an
    (m, n, n) stack or ``'diag'`` (models/sdp.py) — in one vmapped
    program, e.g. max-cut relaxations over a batch of graphs
    (``A='diag'``, per-lane Laplacian costs).

    ``bs`` is an (m,) vector (shared) or a (B, m) stack.  The Gram
    factorization of A is built once and broadcast; only (C, b) are
    mapped.  ``prox_method='ns'`` swaps the eigh PSD projection for
    the Newton-Schulz matmul-only one — batched n^3 GEMMs
    (see ops/matfun.psd_project_ns conditioning caveat).
    """
    config = merge_config(config, overrides, body="batched")
    from .sdp import make_prox_ops as _sdp_make_prox_ops

    Cs = jnp.asarray(Cs)
    if Cs.ndim != 3 or Cs.shape[1] != Cs.shape[2]:
        raise ValueError(f"Cs must be a (B, n, n) stack, got {Cs.shape}")
    Bn, n = Cs.shape[0], Cs.shape[1]
    bs = jnp.asarray(bs, Cs.dtype)
    m = bs.shape[-1]
    prox_f, prox_g, obj, data = _sdp_make_prox_ops(
        Cs[0], A, bs if bs.ndim == 1 else bs[0], config,
        prox_method=prox_method, ns_iters=ns_iters, ns_coarse=ns_coarse,
        ns_correct=ns_correct, ns_delta=ns_delta)
    data = dict(data)
    data["C"] = 0.5 * (Cs + jnp.swapaxes(Cs, -1, -2))
    data["b"] = jnp.broadcast_to(bs, (Bn, m))

    zeros = jnp.zeros((Bn, n, n), Cs.dtype)
    return _run(prox_f, prox_g, obj, config, {"C", "b"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def fusedlasso_batch(S, lam1s, lam2s, config: ADMMConfig = ADMMConfig(), *,
                     x0=None, z0=None, u0=None, mesh=None,
                     **overrides) -> BatchResults:
    """Fused lasso for every signal row of ``S`` (shape (B, n)) in one
    vmapped program: the eig-folded (I + rho(I + D^T D)) solve is shared
    across lanes, each lane carries its own signal and its own
    (lam1, lam2) pair via the stacked per-row threshold vector."""
    config = merge_config(config, overrides, body="batched")
    from .fusedlasso import make_prox_ops as _fl_make_prox_ops

    S = jnp.asarray(S)
    if S.ndim != 2:
        raise ValueError(f"S must be a (B, n) stack of signals, got {S.shape}")
    Bn, n = S.shape
    prox_f, prox_g, obj, data, A = _fl_make_prox_ops(S[0], 1.0, 1.0, config)
    data = dict(data)
    data["s"] = S
    l1 = jnp.broadcast_to(jnp.asarray(lam1s, S.dtype), (Bn,))
    l2 = jnp.broadcast_to(jnp.asarray(lam2s, S.dtype), (Bn,))
    data["t"] = jnp.concatenate(
        [jnp.repeat(l1[:, None], n, axis=1),
         jnp.repeat(l2[:, None], n, axis=1)], axis=1)  # (B, 2n)
    xz = jnp.zeros((Bn, n), S.dtype)
    zz = jnp.zeros((Bn, 2 * n), S.dtype)
    return _run(prox_f, prox_g, obj, config, {"s", "t"}, data,
                xz, zz, zz, zz, A, as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def rpca_batch(Ms, lams=None, config: ADMMConfig = ADMMConfig(), *,
               prox_method: str = "exact", rank=None, oversample: int = 10,
               power_iters: int = 2, seed: int = 0,
               x0=None, z0=None, u0=None, mesh=None,
               **overrides) -> BatchResults:
    """Robust PCA for every matrix in ``Ms`` (shape (B, m, n)) in one
    vmapped program — e.g. per-frame background/foreground separation.
    The SVT L-step becomes one batched svd per iteration — or, at
    ``prox_method='rsvd'`` with a ``rank`` bound, a batched
    randomized-range sketch (matmul-only + small svds).  ``lams`` is a
    scalar or (B,) vector
    (default: the per-shape 1/sqrt(max(m, n)) exact-recovery value)."""
    config = merge_config(config, overrides, body="batched")
    from .rpca import make_prox_ops as _rpca_make_prox_ops

    Ms = jnp.asarray(Ms)
    if Ms.ndim != 3:
        raise ValueError(f"Ms must be a (B, m, n) stack, got {Ms.shape}")
    Bn, m, n = Ms.shape
    prox_f, prox_g, obj, data = _rpca_make_prox_ops(
        Ms[0], lams, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    data = dict(data)
    data["M"] = Ms
    data["lam"] = jnp.broadcast_to(data["lam"], (Bn,))
    zeros = jnp.zeros((Bn, m, n), Ms.dtype)
    return _run(prox_f, prox_g, obj, config, {"M", "lam"}, data,
                zeros, zeros, zeros, Ms, as_linop(1.0), as_linop(1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def matrixcompletion_batch(Ms, masks, mu=None,
                           config: ADMMConfig = ADMMConfig(), *,
                           prox_method: str = "exact", rank=None,
                           oversample: int = 10, power_iters: int = 2,
                           seed: int = 0, x0=None, z0=None, u0=None,
                           mesh=None, **overrides) -> BatchResults:
    """Nuclear-norm matrix completion for every (M, mask) pair in the
    (B, m, n) stacks in one vmapped program — e.g. per-user or
    per-window completion sweeps.  The SVT Z-step becomes one batched
    svd per iteration (or the batched randomized-range sketch at
    ``prox_method='rsvd'`` with a ``rank`` bound — the `rpca_batch`
    treatment).  ``mu`` is None (exact constraint), a scalar, or a (B,)
    per-lane fit weight.  The completed matrices are ``zopt``."""
    config = merge_config(config, overrides, body="batched")
    from .matrixcompletion import make_prox_ops as _mc_make_prox_ops

    Ms = jnp.asarray(Ms)
    if Ms.ndim != 3:
        raise ValueError(f"Ms must be a (B, m, n) stack, got {Ms.shape}")
    masks = jnp.asarray(masks)
    if masks.shape != Ms.shape:
        raise ValueError(
            f"masks must match Ms's shape {Ms.shape}, got {masks.shape}")
    Bn, m, n = Ms.shape
    mu0 = None if mu is None else jnp.asarray(mu).reshape(-1)[0]
    prox_f, prox_g, obj, data = _mc_make_prox_ops(
        Ms[0], masks[0], mu0, config, prox_method=prox_method, rank=rank,
        oversample=oversample, power_iters=power_iters, seed=seed)
    data = dict(data)
    data["M"] = Ms * masks.astype(Ms.dtype)
    data["mask"] = masks.astype(Ms.dtype)
    mapped = {"M", "mask"}
    if mu is not None:
        data["mu"] = jnp.broadcast_to(jnp.asarray(mu, Ms.dtype), (Bn,))
        mapped.add("mu")
    zeros = jnp.zeros((Bn, m, n), Ms.dtype)
    return _run(prox_f, prox_g, obj, config, mapped, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def model_batch(P, Q, Rs, Ss, config: ADMMConfig = ADMMConfig(), *,
                x0=None, z0=None, u0=None, mesh=None,
                **overrides) -> BatchResults:
    """Solve the model problem  min 1/2||P x - r_i||^2 + 1/2||Q x - s_i||^2
    for every right-hand-side pair (r_i, s_i) against the SHARED
    operators ``P`` (mP, n) and ``Q`` (mQ, n) in one vmapped program.

    ``Rs`` is (mP,) shared or (B, mP); ``Ss`` is (mQ,) shared or
    (B, mQ) (at least one stacked).  Both regularized inverses depend
    only on (P, Q, rho) and are shared; the per-lane normal-equation
    right-hand sides P^T r_i / Q^T s_i fold in one setup GEMM each.
    """
    from .model import make_prox_ops as _model_make_prox_ops

    config = merge_config(config, overrides, body="batched")
    P = jnp.asarray(P)
    Q = jnp.asarray(Q)
    n = P.shape[1]
    Bn = _lane_count((Rs, 1), (Ss, 1))
    Rs = _broadcast_lane(Rs, Bn, (P.shape[0],), P.dtype, "Rs")
    Ss = _broadcast_lane(Ss, Bn, (Q.shape[0],), P.dtype, "Ss")
    prox_f, prox_g, obj, data = _model_make_prox_ops(P, Q, Rs[0], Ss[0],
                                                     config)
    data = dict(data)
    data["r"] = Rs
    data["s"] = Ss
    data["Ptr"] = Rs @ P  # (B, n): per-lane P^T r in one GEMM
    data["Qts"] = Ss @ Q

    zeros = jnp.zeros((Bn, n), P.dtype)
    return _run(prox_f, prox_g, obj, config, {"r", "s", "Ptr", "Qts"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def tv2d_batch(Ss, lams, config: ADMMConfig = ADMMConfig(), *,
               x0=None, z0=None, u0=None, mesh=None,
               **overrides) -> BatchResults:
    """Anisotropic 2-D TV denoising of every image in ``Ss`` (shape
    (B, m, n)) in one vmapped program — batch image denoising.

    The two small 1-D difference eigenbases diagonalizing the
    Sylvester-structured x-solve depend only on (m, n) and are shared;
    per-lane leaves are the image and its denoising strength
    (``lams`` scalar or (B,)).  The four per-lane (m,m)x(m,n) /
    (m,n)x(n,n) matmuls batch into GEMMs.
    """
    from .totalvariation2d import make_prox_ops as _tv2d_make_prox_ops

    config = merge_config(config, overrides, body="batched")
    Ss = jnp.asarray(Ss)
    if Ss.ndim != 3:
        raise ValueError(
            f"Ss must be a (B, m, n) stack of images, got {Ss.shape}"
        )
    Bn, m, n = Ss.shape
    prox_f, prox_g, obj, data, A = _tv2d_make_prox_ops(Ss[0], 1.0, config)
    data = dict(data)
    data["S"] = Ss
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, Ss.dtype), (Bn,))

    zx = jnp.zeros((Bn, m, n), Ss.dtype)
    zz = jnp.zeros((Bn, 2, m, n), Ss.dtype)
    return _run(prox_f, prox_g, obj, config, {"S", "lam"}, data,
                zx, zz, zz, zz, A, as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


def _rhs_batch(make_prox_ops, D, S, config):
    """Shared LAD/Huber multi-RHS setup: one normal-equations
    pseudo-inverse, per-lane right-hand sides (constraint offset c = s
    is mapped through the runner's c argument)."""
    D = jnp.asarray(D)
    m, n = D.shape
    S = _check_batch(S, m, "S").astype(D.dtype)
    prox_f, prox_g, obj, data = make_prox_ops(D, S[0], config)
    data = dict(data)
    data["s"] = S
    Bn = S.shape[0]
    xz = jnp.zeros((Bn, n), D.dtype)
    zz = jnp.zeros((Bn, m), D.dtype)
    return prox_f, prox_g, obj, data, D, xz, zz, S


@_highest_precision_setup
def lad_batch(D, S, config: ADMMConfig = ADMMConfig(), *,
              x0=None, z0=None, u0=None, mesh=None, **overrides) -> BatchResults:
    """Least absolute deviations for every right-hand side row of ``S``
    (shape (B, m)) against the shared design matrix ``D`` (m, n)."""
    config = merge_config(config, overrides, body="batched")
    prox_f, prox_g, obj, data, Dj, xz, zz, S = _rhs_batch(
        _lad_make_prox_ops, D, S, config)
    return _run(prox_f, prox_g, obj, config, {"s"}, data,
                xz, zz, zz, S, as_linop(Dj), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def huberfit_batch(D, S, config: ADMMConfig = ADMMConfig(), *,
                   x0=None, z0=None, u0=None, mesh=None, **overrides) -> BatchResults:
    """Huber fitting for every right-hand side row of ``S`` (shape
    (B, m)) against the shared design matrix ``D`` (m, n)."""
    config = merge_config(config, overrides, body="batched")
    prox_f, prox_g, obj, data, Dj, xz, zz, S = _rhs_batch(
        _huber_make_prox_ops, D, S, config)
    return _run(prox_f, prox_g, obj, config, {"s"}, data,
                xz, zz, zz, S, as_linop(Dj), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def quantile_batch(D, S, taus, config: ADMMConfig = ADMMConfig(), *,
                   x0=None, z0=None, u0=None, mesh=None,
                   **overrides) -> BatchResults:
    """Quantile regression lanes against the shared design ``D`` (m, n):
    each lane has its own right-hand side row of ``S`` ((B, m), or one
    shared (m,) vector broadcast) AND its own quantile level (``taus``
    scalar or (B,)) — the classic multi-quantile estimate (a tau grid
    over one dataset) is one vmapped program sharing the single
    normal-equations factorization."""
    from .quantile import make_prox_ops as _quantile_make_prox_ops

    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    S = jnp.asarray(S, D.dtype)
    Bn = _lane_count((S, 1), (taus, 0))
    S = _broadcast_lane(S, Bn, (m,), D.dtype, "S")
    taus_arr = jnp.broadcast_to(jnp.asarray(taus, D.dtype), (Bn,))
    if not (jnp.all(taus_arr > 0) and jnp.all(taus_arr < 1)):
        raise ValueError("every tau must be in (0, 1)")
    prox_f, prox_g, obj, data = _quantile_make_prox_ops(
        D, S[0], float(taus_arr[0]), config)
    data = dict(data)
    data["s"] = S
    data["tau"] = taus_arr
    xz = jnp.zeros((Bn, n), D.dtype)
    zz = jnp.zeros((Bn, m), D.dtype)
    return _run(prox_f, prox_g, obj, config, {"s", "tau"}, data,
                xz, zz, zz, S, as_linop(D), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


def _broadcast_lane(v, Bn, shape1, dtype, what):
    """Coerce ``v`` to a (Bn, *shape1) per-lane stack (broadcasting a
    shared 1-instance value across lanes)."""
    v = jnp.asarray(v, dtype)
    if v.shape == tuple(shape1):
        return jnp.broadcast_to(v, (Bn, *shape1))
    if v.shape == (Bn, *shape1):
        return v
    raise ValueError(
        f"{what} must have shape {tuple(shape1)} (shared) or "
        f"{(Bn, *shape1)} (per-lane), got {v.shape}"
    )


def _lane_count(*cands):
    """Infer the batch size from the first stacked (2-D-over-lane)
    candidate: each entry is (value, instance_ndim)."""
    for v, nd1 in cands:
        v = jnp.asarray(v)
        if v.ndim == nd1 + 1:
            return v.shape[0]
    raise ValueError(
        "at least one argument must carry a leading batch axis "
        "(all inputs are single-instance; use the serial solver)"
    )


def _prox_f_affine_kkt_batch(x, z, u, rho, d):
    # Fully-folded fixed-rho KKT x-prox with a per-lane offset:
    # x = K1 (rho (z - u) - b) + x0 (ops/solve.py:materialize_affine_map).
    return d["K1"] @ (rho * (z - u) - d["b"]) + d["x0"]


@_highest_precision_setup
def logreg_batch(D, ells, lams, config: ADMMConfig = ADMMConfig(), *,
                 inner: str = "newton_cg", newton_steps: int = 4,
                 cg_steps: int = 12,
                 x0=None, z0=None, u0=None, mesh=None,
                 **overrides) -> BatchResults:
    """B sparse logistic regressions against one shared data matrix —
    one-vs-all MULTICLASS logistic training in a single vmapped program
    (the logistic counterpart of svm_batch): ``ells`` is (B, m) lanes of
    +/-1 labels, ``lams`` a scalar or (B,) l1 weights.  Only the labels
    and penalties are lane-mapped; D is shared.

    The default x-prox is the matrix-free Newton-CG
    (``inner='newton_cg'``, models/logreg.py): every CG matvec batches
    into (B, m) x (m, n) GEMMs with no (B, n, n) Hessian stack — the
    dense path (``inner='newton'``, the accuracy reference) batches
    (B, n, n) LU factorizations.  The default (newton_steps=4,
    cg_steps=12) is one safety notch above the knee: a sweep found 3x12
    through 5x20
    all produce IDENTICAL convergence trajectories and final accuracy
    (relF 2.3e-7 vs dense) on the matrix shape — the engine warm-starts
    the prox from the previous iterate, so a few damped steps reach
    prox tolerance; raise the knobs for very ill-conditioned data.
    """
    from .logreg import make_prox_ops as _logreg_make_prox_ops

    config = merge_config(config, overrides, body="batched")
    D = jnp.asarray(D)
    m, n = D.shape
    ells = _check_batch(ells, m, "ells").astype(D.dtype)
    if not bool(jnp.all(jnp.abs(ells) == 1.0)):
        raise ValueError("ells must be +/-1 label lanes")
    Bn = ells.shape[0]
    prox_f, prox_g, obj, data = _logreg_make_prox_ops(
        D, ells[0], 1.0, config, inner=inner, newton_steps=newton_steps,
        cg_steps=cg_steps)
    data = dict(data)
    data["ell"] = ells
    data["lam"] = jnp.broadcast_to(jnp.asarray(lams, D.dtype), (Bn,))

    zeros = jnp.zeros((Bn, n), D.dtype)
    return _run(prox_f, prox_g, obj, config, {"ell", "lam"}, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def lp_batch(bs, D, Ss, config: ADMMConfig = ADMMConfig(), *,
             x0=None, z0=None, u0=None, mesh=None, **overrides) -> BatchResults:
    """Solve B standard-form LPs  min b_i^T x  s.t. D x = s_i, x >= 0
    sharing ONE constraint matrix ``D`` (m, n) in one vmapped program.

    ``bs`` is (n,) shared or (B, n) per-lane cost; ``Ss`` is (m,)
    shared or (B, m) per-lane equality right-hand side (at least one
    must carry the batch axis).  The KKT solve is folded once into
    x = K1 b1 + x0 (models/linearprogram.py algebra): K1 depends only
    on (D, rho) and is shared, while the whole batch of offsets
    x0_i = W s_i is one setup GEMM.  Per-iteration work is a single
    (B, n) x (n, n) GEMM — the same shape as lasso_batch.
    """
    from ..ops.solve import kkt_eq_solver

    config = merge_config(config, overrides, body="batched")
    if config.dynamic_rho:
        raise ValueError(
            "lp_batch folds the KKT solve at a fixed rho; adaptive/"
            "dynamic-rho configs are not supported (solve lanes serially)"
        )
    D = jnp.asarray(D)
    m, n = D.shape
    Bn = _lane_count((bs, 1), (Ss, 1))
    bs = _broadcast_lane(bs, Bn, (n,), D.dtype, "bs")
    Ss = _broadcast_lane(Ss, Bn, (m,), D.dtype, "Ss")
    K1, W = kkt_eq_solver.from_matrices(D, P=None).materialize_affine_map(
        config.rho)
    data = {"K1": K1, "b": bs, "x0": Ss @ W.T}

    zeros = jnp.zeros((Bn, n), D.dtype)
    from .linearprogram import _obj as _lp_obj
    from .linearprogram import _prox_g as _lp_prox_g

    return _run(_prox_f_affine_kkt_batch, _lp_prox_g, _lp_obj, config,
                {"b", "x0"}, data, zeros, zeros, zeros, zeros,
                as_linop(1.0), as_linop(-1.0), mesh=mesh,
                warm=(x0, z0, u0))


def _prox_f_qp_standard_batch(x, z, u, rho, d):
    # Same affine fold as _prox_f_affine_kkt_batch, with the QP's
    # linear-cost key (q) so the objective shares the leaf.
    return d["K1"] @ (rho * (z - u) - d["q"]) + d["x0"]


@dataclasses.dataclass(frozen=True)
class QPStructure:
    """The (P, D, rho)-only pieces of qp_batch's x-update, folded once.

    Receding-horizon callers build this ONE time via ``qp_structure``
    and pass it to every ``qp_batch`` re-solve — the per-step cost then
    contains no eigh/Cholesky/dense-fold work, only the per-lane offset
    GEMM and the compiled iteration loop."""

    P: Any
    rho: float
    D: Any = None      # standard form only
    K1: Any = None     # standard fold (ops/solve.py:materialize_affine_map)
    W: Any = None
    Minv: Any = None   # bounded fold

    @property
    def form(self):
        return "bounded" if self.D is None else "standard"


@_highest_precision_setup
def qp_structure(P, D=None, rho: float = 1.0) -> QPStructure:
    """Fold the shared QP structure once (see QPStructure).  ``D``
    given selects the standard (equality + nonnegativity) form; ``D``
    omitted the bounded (box) form.  ``rho`` must match the config the
    structure is later used with."""
    from ..ops.solve import SymShiftSolver, kkt_eq_solver

    P = jnp.asarray(P)
    P = 0.5 * (P + P.T)
    if D is None:
        Minv = SymShiftSolver.from_matrix(P).materialize_inverse(rho)
        return QPStructure(P=P, rho=float(rho), Minv=Minv)
    D = jnp.asarray(D)
    K1, W = kkt_eq_solver.from_matrices(D, P=P).materialize_affine_map(rho)
    return QPStructure(P=P, rho=float(rho), D=D, K1=K1, W=W)


@_highest_precision_setup
def qp_batch(P, Qs, rs, cons1, cons2, config: ADMMConfig = ADMMConfig(), *,
             form: str = None, structure: QPStructure = None,
             x0=None, z0=None, u0=None,
             mesh=None, **overrides) -> BatchResults:
    """Solve B quadratic programs sharing ONE Hessian ``P`` (n, n) in
    one vmapped program — the model-predictive-control pattern, where
    every step solves the same QP structure with fresh linear terms.

    Forms (auto-detected like the serial wrapper,
    models/quadraticprogram.py):

    - standard: ``(cons1, cons2) = (D, Ss)`` with D the shared (m, n)
      equality matrix and Ss (m,) or (B, m) per-lane right-hand sides.
      One eigh of P + one KKT fold shared; per-lane offsets are one
      setup GEMM (ops/solve.py:materialize_affine_map).
    - bounded: ``(cons1, cons2) = (lb, ub)``, each (n,) shared or
      (B, n) per-lane.

    Detection: a 2-D cons1 selects the standard form, EXCEPT that a
    shape-matched 2-D (cons1, cons2) pair reads as per-lane (B, n)
    lb/ub stacks (an equality matrix only shape-matches its RHS stack
    when B == m == n).  Mixed per-lane/shared bound pairs with a 2-D
    lb are the one ambiguous case left — pass ``form='bounded'``.

    ``Qs`` is (n,) or (B, n); ``rs`` is a scalar or (B,).  For
    repeated re-solves against the same (P, D/bounds-shape, rho), fold
    the structure once with ``qp_structure`` and pass ``structure=``
    (cons1 is then ignored for the standard form).
    """
    from ..ops.solve import SymShiftSolver, kkt_eq_solver

    config = merge_config(config, overrides, body="batched")
    if config.dynamic_rho:
        raise ValueError(
            "qp_batch folds the x-update at a fixed rho; adaptive/"
            "dynamic-rho configs are not supported (solve lanes serially)"
        )
    if form not in (None, "standard", "bounded"):
        raise ValueError(f"form must be 'standard' or 'bounded', got {form!r}")
    P = jnp.asarray(P)
    P = 0.5 * (P + P.T)
    n = P.shape[0]
    c1 = jnp.asarray(cons1)
    if structure is not None:
        if structure.rho != config.rho:
            raise ValueError(
                f"structure was folded at rho={structure.rho} but the "
                f"config uses rho={config.rho}"
            )
        if form is not None and form != structure.form:
            raise ValueError(
                f"form={form!r} conflicts with the {structure.form!r} "
                f"structure"
            )
        form = structure.form
    elif form is None:
        c2 = jnp.asarray(cons2)
        if c1.ndim != 2:
            form = "bounded"
        elif c2.ndim == 2 and c1.shape == c2.shape and c1.shape[1] == n:
            # Per-lane (B, n) lb/ub stacks always shape-match each
            # other; an equality matrix D (m, n) shape-matches its RHS
            # stack (B, m) only in the degenerate B == m == n case.
            form = "bounded"
        else:
            form = "standard"

    if form == "standard":
        D = structure.D if structure is not None else c1
        m = D.shape[0]
        Bn = _lane_count((Qs, 1), (cons2, 1), (rs, 0))
        Qs_ = _broadcast_lane(Qs, Bn, (n,), P.dtype, "Qs")
        try:
            Ss = _broadcast_lane(cons2, Bn, (m,), P.dtype, "Ss")
        except ValueError as e:
            raise ValueError(
                f"{e} — if cons1/cons2 are per-lane bound stacks rather "
                f"than an equality system, pass form='bounded'"
            ) from None
        if structure is not None:
            K1, W = structure.K1, structure.W
        else:
            K1, W = kkt_eq_solver.from_matrices(
                D, P=P).materialize_affine_map(config.rho)
        data = {"K1": K1, "x0": Ss @ W.T, "q": Qs_}
        from .quadraticprogram import _prox_g_standard

        prox_f, prox_g, mapped = (
            _prox_f_qp_standard_batch, _prox_g_standard, {"x0", "q", "r"})
    else:
        Bn = _lane_count((Qs, 1), (cons1, 1), (cons2, 1), (rs, 0))
        Qs_ = _broadcast_lane(Qs, Bn, (n,), P.dtype, "Qs")
        lb = _broadcast_lane(cons1, Bn, (n,), P.dtype, "lb")
        ub = _broadcast_lane(cons2, Bn, (n,), P.dtype, "ub")
        lb, ub = jnp.minimum(lb, ub), jnp.maximum(lb, ub)
        if structure is not None:
            Minv = structure.Minv
        else:
            Minv = SymShiftSolver.from_matrix(P).materialize_inverse(
                config.rho)
        data = {"Minv": Minv, "q": Qs_, "lb": lb, "ub": ub}
        from .quadraticprogram import _prox_f_bounded_static, _prox_g_bounded

        prox_f, prox_g, mapped = (
            _prox_f_bounded_static, _prox_g_bounded, {"q", "lb", "ub", "r"})

    from .quadraticprogram import _obj as _qp_obj

    data["P"] = P
    data["r"] = jnp.broadcast_to(jnp.asarray(rs, P.dtype), (Bn,))
    zeros = jnp.zeros((Bn, n), P.dtype)
    return _run(prox_f, prox_g, _qp_obj, config, mapped, data,
                zeros, zeros, zeros, zeros, as_linop(1.0), as_linop(-1.0),
                mesh=mesh, warm=(x0, z0, u0))


@_highest_precision_setup
def svm_batch(D, ells, C, config: ADMMConfig = ADMMConfig(), *,
              loss: str = "hinge", seed: int = 0,
              x0=None, z0=None, u0=None, mesh=None,
              **overrides) -> BatchResults:
    """Train B linear SVMs against ONE shared design matrix ``D``
    (m, n) in one vmapped unwrapped-ADMM program — the one-vs-all
    multiclass pattern (e.g. mnistsvm's per-digit loop,
    reference examples/mnistsvm.m:121-156, trains 10 classifiers that
    differ only in their +/-1 label vector).

    ``ells`` is the (B, m) stack of per-classifier +/-1 labels; ``C``
    is a scalar (shared) or (B,) per-classifier penalty.  The
    pseudo-inverse x-update matrix depends only on D and is shared, so
    the per-lane x/z-update GEMVs fuse into (B, m) x (m, n) GEMMs on
    the card.  Warm start and stopping semantics match the serial
    driver (models/unwrapped.py: random x0/z0/u0 from ``seed``,
    stopcond='both', nodualerror) so each lane reproduces
    ``linearsvm(D, ells[i], C)`` run alone.
    """
    # FORCED, not defaulted: the serial chain (linearsvm ->
    # unwrappedadmm) overwrites any caller stopcond/nodualerror with the
    # reference driver's values (unwrappedadmm.m:90-92), so the batch
    # path must do the same or lanes stop differently from solo runs.
    overrides["stopcond"] = "both"
    overrides["nodualerror"] = True
    config = merge_config(config, overrides, body="batched")
    from .linearsvm import make_prox_ops as _svm_make_prox_ops
    from .unwrapped import _prox_f as _unwrapped_prox_f

    D = jnp.asarray(D)
    m, n = D.shape
    ells = _check_batch(ells, m, "ells").astype(D.dtype)
    Bn = ells.shape[0]
    _, prox_g, obj, data = _svm_make_prox_ops(D, ells[0], 1.0, loss, config)
    data = dict(data)
    data["ell"] = ells
    data["C"] = jnp.broadcast_to(jnp.asarray(C, D.dtype), (Bn,))
    data["Dplus"] = jnp.linalg.pinv(D)

    # Same per-lane random start as the serial unwrapped driver
    # (unwrapped.py:70-74) so lane i is bit-comparable to a solo run;
    # explicit x0/z0/u0 warm starts override it.
    kx, kz, ku = jax.random.split(jax.random.PRNGKey(seed), 3)
    xr = jnp.broadcast_to(jax.random.uniform(kx, (n,), dtype=D.dtype), (Bn, n))
    zr = jnp.broadcast_to(jax.random.uniform(kz, (m,), dtype=D.dtype), (Bn, m))
    ur = jnp.broadcast_to(jax.random.uniform(ku, (m,), dtype=D.dtype), (Bn, m))
    c0 = jnp.zeros((Bn, m), D.dtype)
    return _run(_unwrapped_prox_f, prox_g, obj, config, {"ell", "C"}, data,
                xr, zr, ur, c0, as_linop(D), as_linop(-1.0), mesh=mesh,
                warm=(x0, z0, u0))
