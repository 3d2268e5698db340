"""The core ADMM engine: a single jitted ``lax.while_loop`` program.

A compiled re-design of the reference's interpreted main loop
(reference: admm.m:496-743).  The whole solve — x-prox, relaxation, z-prox,
dual update, fast/accelerated momentum + restart, residual norms, Boyd and
H-norm stopping rules, divergence monitor, adaptive rho — is traced once and
compiled to one XLA program.  Per-iteration history (pnorm/dnorm/perr/derr/
objective/H-norm/d-values/restarts, reference admm.m:596-658) is recorded
into fixed-size preallocated buffers written by iteration index.

Semantics preserved from the reference:
  * update order and momentum algebra for alg 0/1/2 (admm.m:501-600)
  * Boyd stopping:  pnorm < perr  and (nodualerror or dnorm < derr)
    with perr = sqrt(M1)*ABSTOL + RELTOL*max(||Ax||,||Bz||,||c||),
    derr = sqrt(M2)*ABSTOL + RELTOL*||rho*At(u)|| (admm.m:639-658, 705-715)
  * H-norm squared H(wdiff) = rho*||B(dz)||^2 + rho*||d(rho*u)||^2 over
    w = [x; z; rho*u], stop when Hnormsq <= HNORMTOL at i > 2
    (admm.m:302-313, 676-682, 719-722).  As in the reference, the rho used
    *inside* H is captured at setup time (MATLAB closures capture by value),
    while the rho scaling u inside w is the current one.
  * divergence monitor: abort when H-norms stop decreasing to relative
    tolerance convtol (admm.m:686-703) — surfaced as ``results.diverged``
  * accelerated restart rule d >= restart*dprev, restart state rollback,
    d-value stop |d - dprev| <= dvaltol*dprev (admm.m:570-599, 706-707)
  * experimental adaptive rho with growth clamp 5 (admm.m:724-741)
  * hooks: altu (admm.m:553-560), specialnorms (admm.m:612-616),
    obj/objevals (admm.m:602-605).

Compiled-program details:
  * Every state update is masked by the per-lane ``done`` flag, so the loop
    is correct under ``jax.vmap`` over problem instances (batched solves run
    until all lanes converge; finished lanes freeze).
  * No data-dependent Python control flow: alg / relax / stopcond /
    hooks select traced branches at *trace* time from the static config.
  * Histories use ``.at[k].set`` (in-place dynamic-update-slice under XLA).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .config import ADMMConfig, resolve_unroll
from .linop import as_linop
from .results import ADMMResults


def _fro2(v):
    """Squared Frobenius norm of an arbitrary-shape array."""
    return jnp.sum(jnp.real(v * jnp.conj(v))) if jnp.iscomplexobj(v) else jnp.sum(v * v)


def _fro(v):
    return jnp.sqrt(_fro2(v))


class Constraint(NamedTuple):
    """The constraint A x + B z = c (reference admm.m:79-245)."""

    A: Any  # LinOp
    B: Any  # LinOp
    c: Any  # array, same shape as A@x


class Hooks(NamedTuple):
    """Optional user hooks (reference admm.m:473-476, 553-560, 602-616)."""

    obj: Optional[Callable] = None          # obj(x, z) -> scalar
    altu: Optional[Callable] = None         # altu(u, Ax, Bz, c) -> u
    specialnorms: Optional[Callable] = None  # f(x,z,u,rho) -> (pnorm, dnorm)
    preprocess: Optional[Callable] = None   # run once host-side before solve


class _Carry(NamedTuple):
    k: Any            # int32: completed iterations (== reference's i at exit)
    x: Any
    z: Any
    u: Any
    rho: Any
    # fast / accelerated state (zeros/dummies when alg == 0)
    v: Any
    uhat: Any
    a: Any
    d: Any
    # H-norm machinery: previous w's z-part and (rho*u)-part + previous Hsq
    wz: Any
    wu: Any
    Hprev: Any
    # plateau detector (ADMMConfig.stallwindow): best pnorm seen + number
    # of consecutive iterations without relative progress
    best_p: Any
    since: Any
    # Anderson acceleration (ADMMConfig.anderson): ring buffers of the
    # last m+1 fixed-point residuals / map outputs over the flattened
    # state s = (x, z, u), entries written since the last restart, and
    # the best residual norm² since the last restart
    aF: Any
    aT: Any
    acnt: Any
    abest: Any
    # flags
    done: Any
    diverged: Any
    stalled: Any
    hist: Any


class _Hist(NamedTuple):
    pnorm: Any
    dnorm: Any
    perr: Any
    derr: Any
    objvals: Any
    Hnormsq: Any
    dvals: Any
    avals: Any
    restarted: Any
    xvals: Any  # () placeholder unless record_iterates
    zvals: Any
    uvals: Any
    vvals: Any     # accelerated predictor traces (admm.m:596-599);
    uhatvals: Any  # recorded when record_iterates and alg != 0
    wvals: Any     # stacked w = [x; z; rho*u] per iteration (admm.m:680-682)


def admm(
    prox_f: Callable,
    prox_g: Callable,
    config: ADMMConfig = ADMMConfig(),
    *,
    A=1.0,
    B=-1.0,
    c=0.0,
    m: Optional[int] = None,
    nA: Optional[int] = None,
    nB: Optional[int] = None,
    shape_x=None,
    shape_z=None,
    x0=None,
    z0=None,
    u0=None,
    hooks: Hooks = Hooks(),
    dtype=None,
    data=None,
    parallel: Optional[str] = None,
    slices=None,
    mesh=None,
) -> ADMMResults:
    """Solve min f(x) + g(z) s.t. A x + B z = c with scaled-dual ADMM.

    ``prox_f(xhat, z, u, rho) -> x`` and ``prox_g(xhat, z, u, rho) -> z``
    are the user proximal operators (reference admm.m:24-31).  Under
    relaxation (config.relax != 1) ``prox_g``'s first argument is the
    relaxed Axhat, exactly as in the reference (admm.m:515-532).

    ``parallel`` in {'xminf', 'zming', 'both'} mirrors the reference's
    options.parallel (admm.m:343-467): the corresponding prox argument is
    then a PER-SLICE prox ``prox_slice(x, z, u, rho, k)`` and is wrapped
    into a shard_map over a device mesh; ``slices`` is a slicemaker spec
    (scalar block size, 0 for an even split, a vector of lengths, or a
    (slicesx, slicesz) pair for 'both' — errorcheck.m:216-267).  Sliced
    proxes do not take the ``data`` argument (wrap it in a closure).

    ``shape_x`` / ``shape_z`` generalize nA/nB to matrix-valued iterates
    (covariance selection; reference admm.m:478-492).

    Caching contract: when ``data`` (a pytree of problem
    operands) is given, every callable — prox_f, prox_g and the hooks —
    takes it as an extra trailing argument and must be a *module-level
    function*, not a per-call closure.  The compiled runner is then cached
    across solves keyed on (functions, config, shapes): repeat solves of
    the same problem family pay zero retracing (the reference's analog is
    its per-call closure cache, getProxOps.m:968-971 — but interpreted
    MATLAB re-dispatches every call; XLA compiles once per family).
    """
    A = as_linop(A)
    B = as_linop(B)
    # unroll='auto' from a direct engine call: the engine cannot classify
    # a user prox body, so resolve to the balanced default (wrappers
    # resolve to their body class before calling here).
    config = resolve_unroll(config, "default")

    # --- shape/initial-state resolution (reference admm.m:79-259).
    # For scaled-identity A/B the variable size equals m (the reference
    # requires explicit nA/nB there, admm.m:145-148; we infer).
    from .linop import ScaledIdentityOp

    if nA is None and isinstance(A, ScaledIdentityOp) and m is not None:
        nA = m
    if nB is None and isinstance(B, ScaledIdentityOp) and m is not None:
        nB = m
    if shape_x is None:
        if nA is None and x0 is None:
            raise ValueError("must provide nA, shape_x, or x0")
        shape_x = (nA,) if x0 is None else jnp.shape(x0)
    if shape_z is None:
        if nB is None and z0 is None:
            raise ValueError("must provide nB, shape_z, or z0")
        shape_z = (nB,) if z0 is None else jnp.shape(z0)

    if dtype is None:
        for cand in (x0, z0, u0, c):
            if cand is not None and hasattr(cand, "dtype"):
                dtype = jnp.asarray(cand).dtype
                break
        else:
            dtype = jnp.zeros(0).dtype  # follow jax default (f64 under x64)

    x0 = jnp.zeros(shape_x, dtype) if x0 is None else jnp.asarray(x0, dtype)
    z0 = jnp.zeros(shape_z, dtype) if z0 is None else jnp.asarray(z0, dtype)

    # c: scalar 0 means zeros of the constraint-output shape (admm.m:99-110)
    c_arr = jnp.asarray(c, dtype)
    if c_arr.ndim == 0:
        shape_c = A.out_shape(shape_x)
        if shape_c is None:
            if m is None:
                raise ValueError("c is scalar and A is matrix-free: provide m")
            shape_c = (m,)
        c_arr = jnp.broadcast_to(c_arr, shape_c)
    u0 = jnp.zeros(c_arr.shape, dtype) if u0 is None else jnp.asarray(u0, dtype)

    if parallel is not None:
        # Engine-level sliced prox parity (admm.m:343-467); sizes come
        # from the resolved iterate shapes.
        from .parallel.sliced import make_parallel_proxes

        if data is not None:
            raise ValueError(
                "parallel= sliced proxes do not take the data argument; "
                "close over problem data in the per-slice prox instead"
            )
        if len(shape_x) != 1 or len(shape_z) != 1:
            # The sliced gather reassembles a FLAT vector; matrix-valued
            # iterates (covariance selection) would come back flattened
            # and break the loop's shapes — the reference slices vectors
            # only (admm.m:343-467).
            raise ValueError(
                "parallel= supports 1-D (vector) iterates only; got "
                f"shape_x={tuple(shape_x)}, shape_z={tuple(shape_z)}"
            )
        nx, nz = shape_x[0], shape_z[0]
        prox_f, prox_g = make_parallel_proxes(
            prox_f, prox_g, parallel, slices, nx=nx, nz=nz, mesh=mesh
        )

    if hooks.preprocess is not None:
        # Hooks follow the data convention (trailing data arg when given).
        hooks.preprocess(data) if data is not None else hooks.preprocess()

    runner = _cached_runner(
        prox_f, prox_g, config, hooks, bool(config.jit), data is not None
    )
    call = lambda: runner(x0, z0, u0, c_arr, A, B, data if data is not None else ())

    # Wall-clock for the solve loop only (reference tic/toc inside admm,
    # admm.m:315, 756).  Async-dispatched setup work (factorizations built
    # in make_prox_ops) is flushed first so it isn't billed to the loop.
    import time

    # A/B are pytrees of arrays (DenseOp.M etc.) whose construction may
    # still be queued on the device stream — flush them too.
    jax.block_until_ready((x0, z0, u0, c_arr, data, A, B))
    t0 = time.perf_counter()
    out = jax.block_until_ready(call())
    runtime = time.perf_counter() - t0
    res = ADMMResults.from_raw(out, config, x0=x0, z0=z0, u0=u0)
    res.runtime = runtime
    if not config.quiet:
        # Final summary line (reference admm.m:759-765).
        print(f"ADMM finished: {res.steps} steps in {res.runtime:.4f}s"
              + (", DIVERGED" if res.diverged else ""))
    return res


def _highest_precision(fn):
    """Pin f32 matmuls to full f32 inside the traced program: a lower
    default (TF32 on the GPU's tensor cores) corrupts the solver algebra
    (see timed_solver's rationale in models/_common.py) and failed the
    f32 lasso oracle on the H100.  Explicitly-bf16 streams are
    unaffected."""

    @functools.wraps(fn)
    def wrapper(*args):
        with jax.default_matmul_precision("highest"):
            return fn(*args)
    return wrapper


def fast_update(alg: int, cfg: ADMMConfig, *, aprev, dprev, z, zprev, u,
                uprev, v, dval=None):
    """Shared Nesterov momentum / restart algebra (admm.m:563-600), used
    by the core engine and the consensus/transpose-reduction runners so
    a fix lands in one place.

    ``z``/``u`` are the POST-update iterates, ``zprev``/``uprev`` their
    values at iteration start, ``v`` the current z-predictor.  For
    alg == 2 the caller supplies ``dval``, the accelerated residual
    d = (1/rho)||u - uhat||^2 + rho||B(z - v)||^2 evaluated with ITS
    norms (stacked/sharded reductions differ per runner).

    Returns ``(v_new, uhat_new, a_new, d_new, restarted_i)`` with
    ``d_new``/``restarted_i`` = () unless alg == 2.
    """
    a_nr = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * aprev**2))
    if alg == 1:
        mom = (aprev - 1.0) / a_nr
        return (z + mom * (z - zprev), u + mom * (u - uprev), a_nr, (), ())
    # alg == 2: restart rule d >= restart*dprev rolls the predictors back
    # (admm.m:570-599).
    no_restart = dval < cfg.restart * dprev
    mom = (aprev - 1.0) / a_nr
    v_new = jnp.where(no_restart, z + mom * (z - zprev), zprev)
    uhat_new = jnp.where(no_restart, u + mom * (u - uprev), uprev)
    a_new = jnp.where(no_restart, a_nr, 1.0)
    d_new = jnp.where(no_restart, dval, dprev / cfg.restart)
    restarted_i = jnp.where(no_restart, 0, 1).astype(jnp.int32)
    return v_new, uhat_new, a_new, d_new, restarted_i


def adaptive_rho_update(cfg: ADMMConfig, *, Hprev, Hsq, rho, i, done, eps):
    """The reference's experimental adaptive-rho step (admm.m:724-741),
    scalar wdiff = Hprev - Hsq with growth clamp 5 — shared by all three
    runners.  Faithful including its sign behavior: if the H-norm rises
    within convtol (no divergence trip), wdiff < 0 makes the step size
    negative there too; use rbadaptive for a sign-safe scheme."""
    wdiff = Hprev - Hsq
    rhoprev = rho
    safe = jnp.abs(wdiff) > eps
    rho_c = jnp.where(safe, rho * rhoprev / jnp.where(safe, wdiff, 1.0), rho)
    rhodiff = jnp.abs(rho_c - rhoprev)
    growth = 5.0
    rho_c = jnp.where(rhodiff >= rhoprev * growth, rho_c / growth, rho_c)
    rho_c = jnp.where(rhodiff <= rhoprev / growth, rho_c * growth, rho_c)
    return jnp.where((i > 2) & jnp.logical_not(done), rho_c, rho)


def residual_balance_factor(cfg: ADMMConfig, *, pnorm, dnorm, done, dtype):
    """Residual-balancing rho factor (Boyd sec. 3.4.1; see
    ADMMConfig.rbadaptive): grow by rbtau when pnorm > rbmu*dnorm,
    shrink when dnorm > rbmu*pnorm, hold once done.  The caller applies
    rho *= factor and u /= factor (the scaled-dual rescale)."""
    grow = pnorm > cfg.rbmu * dnorm
    shrink = dnorm > cfg.rbmu * pnorm
    factor = jnp.where(grow, cfg.rbtau,
                       jnp.where(shrink, 1.0 / cfg.rbtau, 1.0))
    return jnp.where(done, 1.0, factor).astype(dtype)


def freeze_helpers(frozen):
    """Masked-select helpers for the unroll freeze (see unrolled_body).

    Returns ``(sel, sel_slot)``: ``sel(old, new)`` keeps the old value on
    frozen sub-steps; ``sel_slot(buf, k, val)`` is the history write
    ``buf.at[k].set(val)`` gated the same way — implemented by redirecting
    the write index OUT OF BOUNDS and dropping it (``mode='drop'``), so a
    frozen sub-step costs one scalar index select and no gather.  (The
    alternatives — re-selecting whole (N,) buffers per sub-step, or a
    per-slot gather+select — add a gather to every sub-step of the GEMV
    pipeline.)  When ``frozen`` is the literal
    Python bool False (the K=1 path), both helpers are statically
    transparent, so the K=1 trace is unchanged.
    """
    if frozen is False:
        return (lambda old, new: new), (lambda buf, k, val: buf.at[k].set(val))

    def sel(old, new):
        return jnp.where(frozen, old, new)

    def sel_slot(buf, k, val):
        k_write = jnp.where(frozen, jnp.asarray(buf.shape[0], k.dtype), k)
        return buf.at[k_write].set(val, mode="drop")

    return sel, sel_slot


def unrolled_body(step, K: int, N: int, flags):
    """Wrap a single-iteration ``step(carry, frozen)`` into a while_loop
    body running K freeze-masked sub-steps (ADMMConfig.unroll; shared by
    the core engine and the consensus/transpose-reduction runners).

    ``flags(carry) -> (k, done)`` extracts the iteration counter and the
    stop flag.  Sub-steps past ``done`` OR past the iteration cap are
    frozen — k >= N must freeze too, else the clamped history write at
    k = N would corrupt the last slot when N % K != 0 — so results, step
    counts, and histories match K=1 bit-for-bit.  The step applies the
    freeze itself via ``freeze_helpers(frozen)``: state updates become
    element-wise selects (fused into the producing kernels) and history
    writes scalar-gated scatters, rather than this wrapper re-selecting
    the whole carry (which paid several full-(N,)-buffer select kernels
    per sub-step)."""
    if K <= 1:
        return lambda carry: step(carry, False)

    def body(carry):
        for _ in range(K):
            k, done = flags(carry)
            frozen = jnp.logical_or(done, k >= N)
            carry = step(carry, frozen)
        return carry

    return body


@functools.lru_cache(maxsize=128)
def _cached_runner(prox_f, prox_g, config: ADMMConfig, hooks: Hooks, jit: bool,
                   has_data: bool = True):
    """Cross-call runner cache (see the caching contract in ``admm``).
    Also covers the closure path: repeat solves with the SAME prox
    callables and config reuse the compiled program."""
    runner = _highest_precision(
        _build_runner(prox_f, prox_g, config, hooks, has_data=has_data))
    return jax.jit(runner) if jit else runner


def make_admm_runner(prox_f, prox_g, config, A, B, hooks=Hooks(),
                     dtype=None, has_data=False):
    """Functional core for advanced use (vmap over instances, shard_map).

    Returns ``run(x0, z0, u0, c) -> raw dict``; data must flow through the
    prox closures or be closed over by the caller.  ``dtype`` is accepted
    for backward compatibility and ignored — the runner takes its dtype
    from x0 at trace time.
    """
    del dtype
    config = resolve_unroll(config, "default")
    A = as_linop(A)
    B = as_linop(B)
    run = _highest_precision(
        _build_runner(prox_f, prox_g, config, hooks, has_data=has_data))
    if has_data:
        return lambda x0, z0, u0, c, data: run(x0, z0, u0, c, A, B, data)
    return lambda x0, z0, u0, c: run(x0, z0, u0, c, A, B, ())


def _build_runner(prox_f, prox_g, cfg: ADMMConfig, hooks: Hooks, has_data: bool):
    alg = cfg.alg
    N = int(cfg.maxiters)
    relax = float(cfg.relax)
    use_relax = relax != 1.0
    needs_h = cfg.needs_hnorm
    std_stop = cfg.stopcond in ("standard", "both")
    h_stop = cfg.stopcond in ("hnorm", "both")
    use_stall = cfg.use_stall
    # Anderson acceleration (ADMMConfig.anderson); config validation
    # already restricts it to alg == 0 / fixed rho / standard stop.
    use_aa = cfg.anderson > 0
    m_aa = int(cfg.anderson)

    def run(x0, z0, u0, c, A, B, data):
        if has_data:
            pf = lambda *a: prox_f(*a, data)
            pg = lambda *a: prox_g(*a, data)
            obj_fn = (lambda x, z: hooks.obj(x, z, data)) if hooks.obj else None
            altu_fn = (
                (lambda u, Ax, Bz, cc: hooks.altu(u, Ax, Bz, cc, data))
                if hooks.altu else None
            )
            norms_fn = (
                (lambda x, z, u, rho: hooks.specialnorms(x, z, u, rho, data))
                if hooks.specialnorms else None
            )
        else:
            pf, pg = prox_f, prox_g
            obj_fn, altu_fn, norms_fn = hooks.obj, hooks.altu, hooks.specialnorms
        rdtype = x0.dtype
        rho0 = jnp.asarray(cfg.rho, rdtype)
        eps = jnp.finfo(rdtype).eps
        cnorm = _fro(c)
        # Static element counts M1/M2 for Boyd errors (admm.m:644-645).
        M1 = float(c.size)

        sc = lambda v=jnp.nan: jnp.asarray(v, rdtype)
        zeros = lambda: jnp.full((N,), jnp.nan, rdtype)

        hist = _Hist(
            pnorm=zeros(), dnorm=zeros(), perr=zeros(), derr=zeros(),
            objvals=zeros() if (cfg.objevals and obj_fn is not None) else (),
            Hnormsq=zeros() if needs_h else (),
            dvals=zeros() if alg == 2 else (),
            avals=zeros() if alg in (1, 2) else (),
            restarted=jnp.zeros((N,), jnp.int32) if alg == 2 else (),
            xvals=jnp.zeros((N,) + x0.shape, rdtype) if cfg.record_iterates else (),
            zvals=jnp.zeros((N,) + z0.shape, rdtype) if cfg.record_iterates else (),
            uvals=jnp.zeros((N,) + u0.shape, rdtype) if cfg.record_iterates else (),
            vvals=jnp.zeros((N,) + z0.shape, rdtype)
            if (cfg.record_iterates and alg) else (),
            uhatvals=jnp.zeros((N,) + u0.shape, rdtype)
            if (cfg.record_iterates and alg) else (),
            wvals=jnp.zeros((N, x0.size + z0.size + u0.size), rdtype)
            if cfg.record_iterates else (),
        )

        carry0 = _Carry(
            k=jnp.asarray(0, jnp.int32),
            x=x0, z=z0, u=u0, rho=rho0,
            v=z0 if alg else (), uhat=u0 if alg else (),
            a=sc(1.0) if alg else (),
            d=sc(jnp.inf) if alg == 2 else (),
            wz=z0 if needs_h else (), wu=rho0 * u0 if needs_h else (),
            Hprev=sc(jnp.inf) if needs_h else (),
            best_p=sc(jnp.inf) if use_stall else (),
            since=jnp.asarray(0, jnp.int32) if use_stall else (),
            aF=jnp.zeros((m_aa + 1, x0.size + z0.size + u0.size), rdtype)
            if use_aa else (),
            aT=jnp.zeros((m_aa + 1, x0.size + z0.size + u0.size), rdtype)
            if use_aa else (),
            acnt=jnp.asarray(0, jnp.int32) if use_aa else (),
            abest=sc(jnp.inf) if use_aa else (),
            done=jnp.asarray(False), diverged=jnp.asarray(False),
            stalled=jnp.asarray(False),
            hist=hist,
        )

        def cond(carry: _Carry):
            return jnp.logical_and(carry.k < N, jnp.logical_not(carry.done))

        def step(carry: _Carry, frozen):
            # ``frozen`` gates this sub-step (unrolled_body): literal
            # False at K=1 (helpers compile away), a traced scalar under
            # unroll.  State updates select against it element-wise and
            # history writes per-slot (freeze_helpers docstring).
            sel, sel_slot = freeze_helpers(frozen)
            k = carry.k            # 0-based index of this iteration
            i = k + 1              # reference's 1-based iteration counter
            rho = carry.rho
            x, z, u = carry.x, carry.z, carry.u
            zprev = z

            # ---- x-update (admm.m:501-511) ------------------------------
            if alg == 0:
                x = pf(x, z, u, rho)
                uhat = u
                dprev = ()
            else:
                aprev = carry.a
                uprev = u
                uhat = carry.uhat
                x = pf(x, carry.v, uhat, rho)
                dprev = carry.d if alg == 2 else ()

            # ---- relaxation + z-update (admm.m:515-532) ------------------
            Ax_for_g = x
            Axhat = None
            if use_relax:
                Axhat = relax * A.mv(x) - (1.0 - relax) * (B.mv(zprev) - c)
                Ax_for_g = Axhat
            u_for_g = u if alg == 0 else uhat
            z = pg(Ax_for_g, z, u_for_g, rho)

            Ax = A.mv(x)
            Bz = B.mv(z)
            Axr = Axhat if use_relax else Ax

            # ---- dual update (admm.m:538-560) ----------------------------
            if altu_fn is not None:
                u = altu_fn(u, Axr, Bz, c)
            else:
                base = u if alg == 0 else uhat
                u = base + (Axr + Bz - c)

            # ---- fast / accelerated updates (admm.m:563-600) -------------
            v_new, uhat_new, a_new = carry.v, carry.uhat, carry.a
            d_new = carry.d
            restarted_i = ()
            if alg:
                dval = (
                    (1.0 / rho) * _fro2(u - uhat)
                    + rho * _fro2(B.mv(z - carry.v))
                ) if alg == 2 else None
                v_new, uhat_new, a_new, d2, r2 = fast_update(
                    alg, cfg, aprev=aprev, dprev=dprev, z=z, zprev=zprev,
                    u=u, uprev=uprev, v=carry.v, dval=dval)
                if alg == 2:
                    d_new, restarted_i = d2, r2

            # ---- norms (admm.m:612-637) ----------------------------------
            if norms_fn is not None:
                pnorm, dnorm = norms_fn(x, z, u, rho)
            else:
                pnorm = _fro(Ax + Bz - c)
                if cfg.nodualerror:
                    dnorm = sc(jnp.nan)
                elif alg == 1:
                    dnorm = rho * _fro(A.rmv(B.mv(z - v_new)))
                else:  # alg 0 (and alg 2, recorded for observability)
                    dnorm = _fro(rho * A.rmv(B.mv(z - zprev)))

            # ---- Boyd errors (admm.m:639-658) ----------------------------
            M2 = float(Bz.size)
            perr = jnp.sqrt(M1) * cfg.abstol + cfg.reltol * jnp.maximum(
                jnp.maximum(_fro(Ax), _fro(Bz)), cnorm
            )
            if cfg.nodualerror:
                derr = sc(jnp.nan)
            else:
                derr = jnp.sqrt(M2) * cfg.abstol + cfg.reltol * _fro(rho * A.rmv(u))

            # ---- H-norm / divergence monitor (admm.m:676-703) ------------
            Hsq = ()
            diverged_i = jnp.asarray(False)
            if cfg.nanguard:
                # Abort on non-finite residuals (ADMMConfig.nanguard).
                diverged_i = diverged_i | jnp.logical_not(jnp.isfinite(pnorm))
            if needs_h:
                wz_new, wu_new = z, rho * u
                # H uses the setup-time rho (MATLAB closure capture,
                # admm.m:305-306), while w itself carries the current rho.
                Hsq = rho0 * _fro2(B.mv(carry.wz - wz_new)) + rho0 * _fro2(carry.wu - wu_new)
                if cfg.convtest and alg == 0:
                    H1, H2 = carry.Hprev, Hsq
                    diverged_i = diverged_i | (
                        (i >= 2) & (H1 > eps) & (H2 > H1) & ((H2 - H1) > H1 * cfg.convtol)
                    )
            else:
                wz_new = wu_new = ()

            # ---- plateau detector (ADMMConfig.stallwindow) -----------------
            stall_i = jnp.asarray(False)
            if use_stall:
                # Progress = the best-seen pnorm improves by a relative
                # stalltol.  NaN pnorm never counts as progress (the
                # comparison is False), so a NaN plateau also trips the
                # window even with nanguard off.
                improved = pnorm < carry.best_p * (1.0 - cfg.stalltol)
                best_new = jnp.minimum(carry.best_p, pnorm)
                since_new = jnp.where(improved, 0, carry.since + 1).astype(
                    jnp.int32)
                stall_i = since_new >= cfg.stallwindow
            else:
                best_new, since_new = (), ()

            # ---- stopping (admm.m:705-722) --------------------------------
            stop = jnp.asarray(False)
            if alg == 2:
                # Deliberately NOT gated on domaxiters: the reference's
                # accelerated d-value stop ignores it (admm.m:706-707 —
                # only the standard and hnorm stops check domaxiters).
                stop = (i >= 2) & (jnp.abs(d_new - dprev) <= cfg.dvaltol * dprev)
            elif std_stop and not cfg.domaxiters:
                dual_ok = (
                    jnp.asarray(True) if cfg.nodualerror else (dnorm < derr)
                )
                stop = (pnorm < perr) & dual_ok
            if h_stop and not cfg.domaxiters and needs_h:
                stop = stop | ((i > 2) & (Hsq <= cfg.hnormtol))
            done = stop | diverged_i | stall_i

            # ---- adaptive rho (admm.m:724-741) ----------------------------
            rho_new = rho
            if cfg.adaptive and cfg.convtest and needs_h:
                rho_new = adaptive_rho_update(
                    cfg, Hprev=carry.Hprev, Hsq=Hsq, rho=rho, i=i,
                    done=done, eps=eps)
            elif cfg.rbadaptive and alg == 0:
                # Residual balancing with the scaled-dual rescale
                # u <- u * rho/rho_new (see ADMMConfig.rbadaptive).
                factor = residual_balance_factor(
                    cfg, pnorm=pnorm, dnorm=dnorm, done=done,
                    dtype=rho.dtype)
                rho_new = rho * factor
                u = u / factor

            # ---- Anderson acceleration (ADMMConfig.anderson) --------------
            # NOTE: the consensus/exchange/TR runners carry their own
            # copies of this window algebra over their (differently
            # sharded) state leaves — a safeguard change here must be
            # mirrored there (each copy is pinned by a gated-fallback
            # bit-exactness test in tests/test_anderson.py).
            # Type-II AA on the flattened state s = (x, z, u): the plain
            # sweep above IS the fixed-point map evaluation t = T(s_k);
            # extrapolate the next iterate from the last m residual /
            # output differences.  Residuals, stopping, and history all
            # use the plain sweep (computed above), so a converged run
            # reports the un-extrapolated iterate; the candidate only
            # replaces the NEXT iteration's starting state.  (Runs after
            # the adaptive-rho block, whose rbadaptive branch rescales u
            # — AA excludes the adaptive modes, but the plain path must
            # carry that rescaled u.)
            x_next, z_next, u_next = x, z, u
            if use_aa:
                R = m_aa + 1
                s_in = jnp.concatenate(
                    [carry.x.ravel(), carry.z.ravel(), carry.u.ravel()])
                t_out = jnp.concatenate([x.ravel(), z.ravel(), u.ravel()])
                f_k = t_out - s_in
                fn2 = jnp.sum(f_k * f_k)
                # Restart (stale window) when the residual grew past
                # aa_restart x the best seen since the last restart.
                grew = fn2 > (cfg.aa_restart ** 2) * carry.abest
                cnt = jnp.where(grew, 0, carry.acnt)
                abest_new = jnp.where(grew, fn2,
                                      jnp.minimum(carry.abest, fn2))
                slot = (cnt % R).astype(jnp.int32)
                aF_new = sel_slot(carry.aF, slot, f_k)
                aT_new = sel_slot(carry.aT, slot, t_out)
                # Chronological gather of the window; differences older
                # than the restart are masked to zero columns, whose
                # gammas the regularized solve pins to zero.
                js = (cnt - m_aa + jnp.arange(R, dtype=jnp.int32)) % R
                Fw = aF_new[js]
                Tw = aT_new[js]
                dF = Fw[1:] - Fw[:-1]
                dT = Tw[1:] - Tw[:-1]
                mk = jnp.minimum(cnt, m_aa)
                vmask = jnp.arange(m_aa) >= (m_aa - mk)
                dF = jnp.where(vmask[:, None], dF, 0.0)
                dT = jnp.where(vmask[:, None], dT, 0.0)
                G = dF @ dF.T
                lam = cfg.aa_reg * jnp.trace(G) + eps
                gamma = jnp.linalg.solve(
                    G + lam * jnp.eye(m_aa, dtype=rdtype), dF @ f_k)
                cand = t_out - gamma @ dT
                ok = (
                    jnp.all(jnp.isfinite(cand))
                    & (jnp.sum(jnp.abs(gamma)) <= cfg.aa_gmax)
                    & (mk >= 1) & jnp.logical_not(done)
                )
                s_next = jnp.where(ok, cand, t_out)
                nx_, nz_ = x.size, z.size
                x_next = s_next[:nx_].reshape(x.shape)
                z_next = s_next[nx_:nx_ + nz_].reshape(z.shape)
                u_next = s_next[nx_ + nz_:].reshape(u.shape)
                acnt_new = cnt + 1
            else:
                aF_new = aT_new = acnt_new = abest_new = ()

            # ---- history (admm.m:596-610) ---------------------------------
            h = carry.hist
            h = h._replace(
                pnorm=sel_slot(h.pnorm, k, pnorm),
                dnorm=sel_slot(h.dnorm, k, dnorm),
                perr=sel_slot(h.perr, k, perr),
                derr=sel_slot(h.derr, k, derr),
            )
            if cfg.objevals and obj_fn is not None:
                h = h._replace(objvals=sel_slot(h.objvals, k, obj_fn(x, z)))
            if needs_h:
                h = h._replace(Hnormsq=sel_slot(h.Hnormsq, k, Hsq))
            if alg == 2:
                h = h._replace(
                    dvals=sel_slot(h.dvals, k, d_new),
                    restarted=sel_slot(h.restarted, k, restarted_i),
                )
            if alg in (1, 2):
                h = h._replace(avals=sel_slot(h.avals, k, a_new))
            if cfg.record_iterates:
                h = h._replace(
                    xvals=sel_slot(h.xvals, k, x),
                    zvals=sel_slot(h.zvals, k, z),
                    uvals=sel_slot(h.uvals, k, u),
                    # Under rbadaptive u was rescaled above (u/factor)
                    # and rho_new = rho*factor, so rho_new*u preserves the
                    # scaled-dual product rho*u_pre; elsewhere the
                    # reference records with the CURRENT rho (adaptation
                    # happens after recording, admm.m:596-610 vs 724).
                    wvals=sel_slot(h.wvals, k, jnp.concatenate(
                        [x.ravel(), z.ravel(),
                         ((rho_new if cfg.rbadaptive else rho) * u).ravel()]
                    )),
                )
                if alg:
                    h = h._replace(
                        vvals=sel_slot(h.vvals, k, v_new),
                        uhatvals=sel_slot(h.uhatvals, k, uhat_new),
                    )

            # ---- per-iteration console table (admm.m:318-330, 661-673) ----
            if not cfg.quiet:
                # Gate on the live mask: under unroll > 1 the discarded
                # sub-steps past done/maxiters still EXECUTE (their
                # results are masked away) and must not print phantom
                # rows that disagree with the recorded history.
                active = jnp.logical_and(carry.k < N,
                                         jnp.logical_not(carry.done))
                lax.cond(
                    active,
                    lambda: jax.debug.print(
                        "{i}\tpnorm {p:.4e}\tperr {pe:.4e}\tdnorm {d:.4e}"
                        "\tderr {de:.4e}",
                        i=i, p=pnorm, pe=perr, d=dnorm, de=derr,
                    ),
                    lambda: None,
                )

            new = _Carry(
                k=sel(k, k + 1),
                x=sel(carry.x, x_next), z=sel(carry.z, z_next),
                u=sel(carry.u, u_next),
                rho=sel(carry.rho, rho_new),
                v=sel(carry.v, v_new) if alg else (),
                uhat=sel(carry.uhat, uhat_new) if alg else (),
                a=sel(carry.a, a_new) if alg else (),
                d=sel(carry.d, d_new) if alg == 2 else (),
                wz=sel(carry.wz, wz_new) if needs_h else (),
                wu=sel(carry.wu, wu_new) if needs_h else (),
                Hprev=sel(carry.Hprev, Hsq) if needs_h else (),
                best_p=sel(carry.best_p, best_new) if use_stall else (),
                since=sel(carry.since, since_new) if use_stall else (),
                aF=aF_new if use_aa else (),
                aT=aT_new if use_aa else (),
                acnt=sel(carry.acnt, acnt_new) if use_aa else (),
                abest=sel(carry.abest, abest_new) if use_aa else (),
                done=sel(carry.done, done),
                diverged=sel(carry.diverged, carry.diverged | diverged_i),
                stalled=sel(carry.stalled, carry.stalled | stall_i),
                hist=h,
            )
            # No explicit done-freeze needed at unroll=1 (frozen=False,
            # every sel above is statically transparent): unbatched runs
            # never enter the body once cond is false, and under vmap
            # JAX's while_loop batching rule already per-lane-selects the
            # ENTIRE carry against the lane predicate (the done flag in
            # cond), so converged lanes freeze automatically — verified
            # by the exact path-vs-solo agreement test in test_paths.py.
            return new

        body = unrolled_body(step, int(cfg.unroll), N,
                             lambda c: (c.k, c.done))
        final = lax.while_loop(cond, body, carry0)
        return {
            "steps": final.k,
            "xopt": final.x,
            "zopt": final.z,
            "uopt": final.u,
            "rho_final": final.rho,
            "diverged": final.diverged,
            "stalled": final.stalled,
            "hist": final.hist._asdict(),
            "objopt": obj_fn(final.x, final.z) if obj_fn is not None else (),
        }

    return run
