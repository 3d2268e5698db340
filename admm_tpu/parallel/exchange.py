"""Exchange ADMM: N agents trading a shared resource vector.

    min   sum_i f_i(x_i)    s.t.    sum_i x_i = 0

(Boyd et al. 2011, section 7.3.2 — the dual of consensus sharing.)
Beyond-reference distributed form: the reference ships consensus and
transpose-reduction (SURVEY.md section 2.7); exchange is the third
classical distributed-ADMM paradigm, with a DIFFERENT coupling (a sum
constraint instead of equality to a global variable), so it exercises
the collectives in a new direction: the only cross-agent quantity is
the mean allocation x̄.

Derivation (general-form consensus with g = indicator{sum z_i = 0}):
the z-update is the projection z_i = x_i + u_i - mean(x + u), under
equal dual initialization all u_i collapse to ONE shared dual price
vector u, and the iteration reduces to

    x_i <- prox_{f_i/rho}( x_i - x̄ - u )      (all agents, local)
    x̄  <- mean_i x_i                           (the one collective)
    u   <- u + x̄                               (replicated, O(n))

Residuals on the underlying splitting (A = I, B = -I, z_i = x_i - x̄):
r_i = x̄ for every agent (pnorm = sqrt(W)||x̄||) and
s_i = -rho * ((x_i - x̄) - (x_i^prev - x̄^prev)).

At a fixed point the dual price satisfies grad f_i(x_i*) = -rho u* for
every i, i.e. rho*u is (minus) the market-clearing price nu* of the
exchange economy — the oracle tests assert this against the KKT system
(tests/test_exchange.py).

Variants (engine parity; the other two paradigms already carry them):

  * relaxation (config.relax != 1): x̂_i = relax*x_i + (1-relax)*z_i
    on the stacked splitting (Boyd sec. 3.4.3 / admm.m:515-532 with
    A = I, B = -I).  The dual collapse SURVIVES relaxation: the
    projection z = Pi(x̂ + u) still equalizes all duals, so the price
    update becomes u <- u + mean(x̂) and only the mean-free z stack is
    extra carried state.
  * fast/accelerated momentum (config.fast, both fasttypes): the
    engine's predictor algebra (engine.fast_update) on the stack — v
    lives in the mean-free z-space (W, n), and because shared dual
    predictors stay shared (uhat_i = u + mom*(u - u_prev) is
    agent-independent), uhat is ONE price vector.  The accelerated
    d-value tiles the price W ways:
    d = (W/rho)||u - uhat||^2 + rho||z - v||_F^2.
  * Anderson acceleration (config.anderson, round 5 late): AA window
    on the map state (mean-free z stack, price u) — the stack sharded
    over agents, the price replicated; window dot products contract
    over the agent axis and the (m, m) solve is replicated.  The
    extrapolation is a linear combination of mean-free stacks, so the
    z-subspace invariant survives.  Measured: the quadratic market
    equilibrium in 33 vs 344 plain iterations at 1e-8 tolerances
    (tests/test_anderson.py).
  * exactness oracle: the core engine on the stacked formulation
    (shape_x = (W, n), prox_g = mean-removal projection) reproduces
    every variant trajectory bit-for-bit up to reduction order
    (tests/test_exchange.py::TestExchangeVariants).

Design: per-agent proxes are stacked (W, n) arrays sharded over the
mesh axis (GSPMD, like parallel/consensus.py); the per-iteration
collective payload is the n floats of x̄ — independent of each agent's
data size.  The whole solve is one jitted lax.while_loop with the
engine's done-masked deep unroll (ADMMConfig.unroll) and plateau
detector (ADMMConfig.stallwindow).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ADMMConfig, resolve_unroll
from ..engine import (_highest_precision, fast_update, freeze_helpers,
                      residual_balance_factor, unrolled_body)
from ..results import ADMMResults
from .mesh import make_mesh


def _make_exchange_run(local_prox, config: ADMMConfig, W: int, n: int):
    """Build the (unjitted) exchange iteration
    ``run(data, xi0, u0) -> raw dict`` (jitted by the cached runner).

    Variant parity with the core engine / consensus runner: relaxation
    (config.relax != 1) and fast/accelerated momentum (config.fast, both
    fasttypes) apply to the stacked splitting x_i - z_i = 0 with
    g = indicator{sum z_i = 0} (see module docstring "Variants") — the
    exactness oracle is the core engine run on that stacked formulation
    (tests/test_exchange.py).  The lean alg-0/relax-1 path keeps its
    measured-floor body: z = x_i - x̄ stays implicit (never carried) and
    the residual norms collapse to the x̄-only forms."""
    # Anderson acceleration (ADMMConfig.anderson) on the exchange map:
    # the fixed-point state is (z stack, price u) — the mean-free z
    # stack is sharded over agents, the price replicated; window dot
    # products contract over the agent axis (GSPMD all-reduce) and the
    # (m, m) solve is replicated.  AA extrapolation is a linear
    # combination of mean-free stacks, so the z-subspace invariant
    # survives.  Config validation restricts AA to the plain iteration.
    use_aa = config.anderson > 0
    m_aa = int(config.anderson)
    N = int(config.maxiters)
    relax = float(config.relax)
    use_relax = relax != 1.0
    alg = config.alg
    # Variants carry the mean-free z stack explicitly; the lean path
    # derives it (z_i = x_i - xbar) and skips the extra state/selects.
    # AA needs the carried z too (the extrapolated stack must feed the
    # next sweep).
    needs_z = use_relax or bool(alg) or use_aa
    std_stop = config.stopcond in ("standard", "both")
    use_stall = config.use_stall

    def run(data, xi0, u0):
        rdtype = xi0.dtype
        rho_init = jnp.asarray(config.rho, rdtype)
        nan_hist = lambda: jnp.full((N,), jnp.nan, rdtype)
        sc = lambda v=jnp.nan: jnp.asarray(v, rdtype)

        xbar0 = jnp.mean(xi0, axis=0)
        z0 = xi0 - xbar0[None, :]
        hist0 = {
            "pnorm": nan_hist(), "dnorm": nan_hist(),
            "perr": nan_hist(), "derr": nan_hist(),
            "dvals": nan_hist() if alg == 2 else (),
            "avals": nan_hist() if alg else (),
            "restarted": jnp.zeros((N,), jnp.int32) if alg == 2 else (),
            # Aggregate traces (x̄ and the price u); per-agent xi stays
            # out of the trace (W x the HBM), as in consensus.
            "xvals": jnp.zeros((N, n), rdtype) if config.record_iterates else (),
            "uvals": jnp.zeros((N, n), rdtype) if config.record_iterates else (),
        }
        carry0 = {
            "k": jnp.asarray(0, jnp.int32),
            "xi": xi0, "u": u0,
            "xbar": xbar0,
            "z": z0 if needs_z else (),
            # fast/accelerated predictors: v in the stacked mean-free
            # z-space, uhat the shared price (the dual collapse survives
            # momentum — shared uhat_i stay shared; module docstring).
            "v": z0 if alg else (), "uhat": u0 if alg else (),
            "a": sc(1.0) if alg else (), "d": sc(jnp.inf) if alg == 2 else (),
            "rho": rho_init,
            "done": jnp.asarray(False), "diverged": jnp.asarray(False),
            "stalled": jnp.asarray(False),
            "best_p": sc(jnp.inf) if use_stall else (),
            "since": jnp.asarray(0, jnp.int32) if use_stall else (),
            "aFs": jnp.zeros((m_aa + 1, W, n), rdtype) if use_aa else (),
            "aTs": jnp.zeros((m_aa + 1, W, n), rdtype) if use_aa else (),
            "aFp": jnp.zeros((m_aa + 1, n), rdtype) if use_aa else (),
            "aTp": jnp.zeros((m_aa + 1, n), rdtype) if use_aa else (),
            "acnt": jnp.asarray(0, jnp.int32) if use_aa else (),
            "abest": sc(jnp.inf) if use_aa else (),
            "hist": hist0,
        }

        def cond(c):
            return jnp.logical_and(c["k"] < N, jnp.logical_not(c["done"]))

        def step(c, frozen):
            sel, sel_slot = freeze_helpers(frozen)
            k = c["k"]
            i = k + 1  # reference's 1-based counter (engine parity)
            rho = c["rho"]
            xi, u, xbar = c["xi"], c["u"], c["xbar"]
            zprev = c["z"] if needs_z else xi - xbar[None, :]

            # Local proxes on the stacked (W, n) state — sharded work.
            # Fast modes pull back the predictors v/uhat (engine
            # x = pf(x, v, uhat, rho) convention).
            if alg == 0:
                vi = zprev - u[None, :]
                xi_new = local_prox(vi, rho, data)
                u_base = u
                dprev = ()
            else:
                aprev, u_prev, uhat = c["a"], u, c["uhat"]
                vi = c["v"] - uhat[None, :]
                xi_new = local_prox(vi, rho, data)
                u_base = uhat
                dprev = c["d"] if alg == 2 else ()

            # The one collective: mean over the agent axis.
            xbar_new = jnp.mean(xi_new, axis=0)

            sqW = jnp.sqrt(jnp.asarray(float(W), rdtype))
            sqWn = jnp.sqrt(jnp.asarray(float(W * n), rdtype))
            if use_relax:
                # Over-relaxation on x_i - z_i = 0 (admm.m:515-532 with
                # A = I, B = -I): xhat feeds the z-projection and the
                # dual update.  mean(zprev) = 0, so the projection's
                # mean removal sees mean(xhat) = relax * xbar analytically
                # — computed directly for engine-trajectory exactness.
                xhat = relax * xi_new + (1.0 - relax) * zprev
                xhat_bar = jnp.mean(xhat, axis=0)
                z_new = xhat - xhat_bar[None, :]
                u_new = u_base + xhat_bar
                # Engine pnorm = ||x - z|| with the UNRELAXED x
                # (admm.m:618): no tiled-x̄ collapse under relaxation.
                pnorm = jnp.linalg.norm(xi_new - z_new)
            else:
                z_new = xi_new - xbar_new[None, :]
                u_new = u_base + xbar_new
                pnorm = sqW * jnp.linalg.norm(xbar_new)

            # ---- fast / accelerated updates (engine.fast_update over
            # the stacked splitting: z-space predictor v is the (W, n)
            # mean-free stack, the dual predictor the shared price).
            # Ordered BEFORE the norms, engine parity: the alg-1 dual
            # norm is evaluated against the NEW predictor.
            v_new, uhat_new, a_new = c["v"], c["uhat"], c["a"]
            d_new = c["d"]
            restarted_i = ()
            if alg:
                # d = (1/rho)||u - uhat||^2 + rho||B(z - v)||^2 on the
                # stack: the shared price tiles W ways.
                dval = ((float(W) / rho) * jnp.sum((u_new - uhat) ** 2)
                        + rho * jnp.sum((z_new - c["v"]) ** 2)
                        ) if alg == 2 else None
                v_new, uhat_new, a_new, d2, r2 = fast_update(
                    alg, config, aprev=aprev, dprev=dprev, z=z_new,
                    zprev=zprev, u=u_new, uprev=u_prev, v=c["v"], dval=dval)
                if alg == 2:
                    d_new, restarted_i = d2, r2

            if alg == 1:
                # Strong-convexity fast mode measures the dual residual
                # against the new z-predictor (engine.py norms block).
                dnorm = rho * jnp.linalg.norm(z_new - v_new)
            else:
                dnorm = rho * jnp.linalg.norm(z_new - zprev)
            perr = sqWn * config.abstol + config.reltol * jnp.maximum(
                jnp.linalg.norm(xi_new), jnp.linalg.norm(z_new))
            derr = (sqWn * config.abstol
                    + config.reltol * rho * sqW * jnp.linalg.norm(u_new))

            diverged_i = jnp.asarray(False)
            if config.nanguard:
                diverged_i = jnp.logical_not(jnp.isfinite(pnorm))

            stall_i = jnp.asarray(False)
            if use_stall:
                improved = pnorm < c["best_p"] * (1.0 - config.stalltol)
                best_new = jnp.minimum(c["best_p"], pnorm)
                since_new = jnp.where(improved, 0,
                                      c["since"] + 1).astype(jnp.int32)
                stall_i = since_new >= config.stallwindow
            else:
                best_new, since_new = (), ()

            stop = jnp.asarray(False)
            if alg == 2:
                # Accelerated d-value stop (admm.m:706-707) — engine and
                # consensus parity: not gated on domaxiters.
                stop = (i >= 2) & (jnp.abs(d_new - dprev)
                                   <= config.dvaltol * dprev)
            elif std_stop and not config.domaxiters:
                dual_ok = (jnp.asarray(True) if config.nodualerror
                           else (dnorm < derr))
                stop = (pnorm < perr) & dual_ok
            done = stop | diverged_i | stall_i

            rho_new = rho
            if config.rbadaptive and alg == 0:
                # Residual balancing with the scaled-dual rescale
                # (ADMMConfig.rbadaptive; consensus-parity treatment —
                # gated to the plain iteration, as in consensus).
                factor = residual_balance_factor(
                    config, pnorm=pnorm, dnorm=dnorm, done=done,
                    dtype=rho.dtype)
                rho_new = rho * factor
                u_new = u_new / factor

            # ---- Anderson acceleration (see use_aa note above): the
            # plain sweep is the map evaluation T(z, u); the candidate
            # only replaces the NEXT iteration's starting state, and
            # residuals/stopping/history stay plain-sweep (engine and
            # consensus parity).
            z_next, u_next = z_new, u_new
            if use_aa:
                R = m_aa + 1
                fs = z_new - zprev
                fp = u_new - c["u"]
                fn2 = jnp.sum(fs * fs) + jnp.sum(fp * fp)
                grew = fn2 > (config.aa_restart ** 2) * c["abest"]
                cnt = jnp.where(grew, 0, c["acnt"])
                abest_new = jnp.where(grew, fn2,
                                      jnp.minimum(c["abest"], fn2))
                slot = (cnt % R).astype(jnp.int32)
                aFs = sel_slot(c["aFs"], slot, fs)
                aTs = sel_slot(c["aTs"], slot, z_new)
                aFp = sel_slot(c["aFp"], slot, fp)
                aTp = sel_slot(c["aTp"], slot, u_new)
                js = (cnt - m_aa + jnp.arange(R, dtype=jnp.int32)) % R
                dFs = aFs[js][1:] - aFs[js][:-1]
                dTs = aTs[js][1:] - aTs[js][:-1]
                dFp = aFp[js][1:] - aFp[js][:-1]
                dTp = aTp[js][1:] - aTp[js][:-1]
                mk = jnp.minimum(cnt, m_aa)
                vmask = jnp.arange(m_aa) >= (m_aa - mk)
                dFs = jnp.where(vmask[:, None, None], dFs, 0.0)
                dTs = jnp.where(vmask[:, None, None], dTs, 0.0)
                dFp = jnp.where(vmask[:, None], dFp, 0.0)
                dTp = jnp.where(vmask[:, None], dTp, 0.0)
                G = jnp.einsum("awn,bwn->ab", dFs, dFs) + dFp @ dFp.T
                lam = config.aa_reg * jnp.trace(G) + jnp.finfo(rdtype).eps
                gamma = jnp.linalg.solve(
                    G + lam * jnp.eye(m_aa, dtype=rdtype),
                    jnp.einsum("awn,wn->a", dFs, fs) + dFp @ fp)
                cs = z_new - jnp.einsum("a,awn->wn", gamma, dTs)
                cp = u_new - gamma @ dTp
                ok = (jnp.all(jnp.isfinite(cs)) & jnp.all(jnp.isfinite(cp))
                      & (jnp.sum(jnp.abs(gamma)) <= config.aa_gmax)
                      & (mk >= 1) & jnp.logical_not(done))
                z_next = jnp.where(ok, cs, z_new)
                u_next = jnp.where(ok, cp, u_new)
                acnt_new = cnt + 1
            else:
                aFs = aTs = aFp = aTp = acnt_new = abest_new = ()

            h = dict(c["hist"])
            h["pnorm"] = sel_slot(h["pnorm"], k, pnorm)
            h["dnorm"] = sel_slot(h["dnorm"], k, dnorm)
            h["perr"] = sel_slot(h["perr"], k, perr)
            h["derr"] = sel_slot(h["derr"], k, derr)
            if alg == 2:
                h["dvals"] = sel_slot(h["dvals"], k, d_new)
                h["restarted"] = sel_slot(h["restarted"], k, restarted_i)
            if alg:
                h["avals"] = sel_slot(h["avals"], k, a_new)
            if config.record_iterates:
                h["xvals"] = sel_slot(h["xvals"], k, xbar_new)
                h["uvals"] = sel_slot(h["uvals"], k, u_new)

            return {
                "k": sel(k, k + 1),
                "xi": sel(c["xi"], xi_new), "u": sel(c["u"], u_next),
                "xbar": sel(c["xbar"], xbar_new),
                "z": sel(c["z"], z_next) if needs_z else (),
                "v": sel(c["v"], v_new) if alg else (),
                "uhat": sel(c["uhat"], uhat_new) if alg else (),
                "a": sel(c["a"], a_new) if alg else (),
                "d": sel(c["d"], d_new) if alg == 2 else (),
                "rho": sel(c["rho"], rho_new),
                "done": sel(c["done"], done),
                "diverged": sel(c["diverged"], c["diverged"] | diverged_i),
                "stalled": sel(c["stalled"], c["stalled"] | stall_i),
                "best_p": sel(c["best_p"], best_new) if use_stall else (),
                "since": sel(c["since"], since_new) if use_stall else (),
                "aFs": aFs if use_aa else (),
                "aTs": aTs if use_aa else (),
                "aFp": aFp if use_aa else (),
                "aTp": aTp if use_aa else (),
                "acnt": sel(c["acnt"], acnt_new) if use_aa else (),
                "abest": sel(c["abest"], abest_new) if use_aa else (),
                "hist": h,
            }

        body = unrolled_body(step, int(config.unroll), N,
                             lambda c: (c["k"], c["done"]))
        final = lax.while_loop(cond, body, carry0)
        return {
            "steps": final["k"],
            "xopt": final["xi"],                       # per-agent allocations
            "zopt": (final["z"] if needs_z
                     else final["xi"] - final["xbar"][None, :]),
            "uopt": final["u"],                        # the price vector
            "xbar": final["xbar"],
            "rho_final": final["rho"],
            "diverged": final["diverged"],
            "stalled": final["stalled"],
            "hist": final["hist"],
        }

    return run


@functools.lru_cache(maxsize=32)
def _cached_exchange_runner(local_prox, config: ADMMConfig, W: int, n: int):
    run = _make_exchange_run(local_prox, config, W, n)
    return jax.jit(_highest_precision(run))


def exchange_admm(
    local_prox: Callable,
    data,
    n: int,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nagents: Optional[int] = None,
    xi0=None,
    u0=None,
) -> ADMMResults:
    """Generic exchange ADMM over ``nagents`` agents.

    ``local_prox(vi, rho, data) -> xi`` evaluates ALL agents' proxes
    prox_{f_i/rho}(v_i) at once on a stacked (W, n) array whose leading
    axis is sharded over the mesh; it must be a module-level function
    (caching contract, CLAUDE.md) with per-agent operands carried in
    ``data`` as (W, ...) leaves already placed with the shard sharding.

    ``xi0`` (W, n) and ``u0`` (n,) warm-start the allocations and the
    price vector.  Results: ``xopt`` holds the stacked per-agent
    allocations, ``uopt`` the shared price (rho * uopt estimates the
    market-clearing dual nu*), ``extra['xbar']`` the residual mean.
    """
    if mesh is None:
        mesh = make_mesh()
    W = nagents if nagents is not None else mesh.devices.size

    leaves = jax.tree_util.tree_leaves(data)
    rdtype = leaves[0].dtype if leaves else jnp.float32
    xi0 = jnp.zeros((W, n), rdtype) if xi0 is None else jnp.asarray(xi0, rdtype)
    u0 = jnp.zeros((n,), rdtype) if u0 is None else jnp.asarray(u0, rdtype)
    if xi0.shape != (W, n):
        raise ValueError(f"xi0 must have shape {(W, n)}; got {xi0.shape}")
    if u0.shape != (n,):
        raise ValueError(f"u0 must have shape {(n,)}; got {u0.shape}")

    config = resolve_unroll(config, "gemv")
    runner = _cached_exchange_runner(local_prox, config, W, n)
    data, xi0, u0 = jax.block_until_ready((data, xi0, u0))
    t0 = time.perf_counter()  # loop-only wall clock
    out = jax.block_until_ready(runner(data, xi0, u0))
    runtime = time.perf_counter() - t0  # before from_raw's host scalars

    res = ADMMResults.from_raw(
        {k: v for k, v in out.items() if k != "xbar"}, config)
    res.runtime = runtime
    res.extra["xbar"] = out["xbar"]
    res.extra["nagents"] = W
    res.extra["mesh"] = mesh
    return res


# ---- quadratic-agents instantiation ---------------------------------------


def _quad_local_prox(vi, rho, d):
    # prox of f_i = 0.5||A_i x - b_i||^2: (A_i^T A_i + rho I)^{-1}
    # (A_i^T b_i + rho v_i), rho folded through the per-agent eigh
    # (dynamic-rho safe; library invariant: no refactorization in-loop).
    rhs = d["Atb"] + rho * vi
    y = jnp.einsum("wji,wj->wi", d["V"], rhs) / (d["w"] + rho)
    return jnp.einsum("wij,wj->wi", d["V"], y)


@functools.lru_cache(maxsize=16)
def _cached_quad_setup(shard_spec):
    """Per-agent Gram eigh + A^T b, jitted once per sharding."""

    def body(As, bs):
        with jax.default_matmul_precision("highest"):
            G = jnp.einsum("wmi,wmj->wij", As, As)
            w, V = jnp.linalg.eigh(G)
            Atb = jnp.einsum("wmi,wm->wi", As, bs)
            return w, V, Atb

    return jax.jit(body, out_shardings=(shard_spec, shard_spec, shard_spec))


def exchange_quadratic(
    As,
    bs,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    xi0=None,
    u0=None,
) -> ADMMResults:
    """Exchange ADMM with quadratic agents f_i(x) = 0.5||A_i x - b_i||^2.

    ``As`` is a (W, m, n) stack (agent i's operator) and ``bs`` (W, m);
    the agent axis is sharded over the mesh.  The market equilibrium has
    the closed form x_i* = (A_i^T A_i)^{-1}(A_i^T b_i - nu*) with the
    clearing price nu* = (sum_i (A_i^T A_i)^{-1})^{-1} sum_i
    (A_i^T A_i)^{-1} A_i^T b_i — the oracle in tests/test_exchange.py.
    """
    As = np.asarray(As)
    bs = np.asarray(bs)
    if As.ndim != 3:
        raise ValueError(f"As must be (W, m, n), got {As.shape}")
    if bs.shape != As.shape[:2]:
        raise ValueError(f"bs must be {As.shape[:2]}, got {bs.shape}")
    W, _, n = As.shape
    if mesh is None:
        mesh = make_mesh()
    if W < mesh.devices.size:
        mesh = make_mesh(W, mesh.axis_names[0])
    elif W % mesh.devices.size:
        raise ValueError(f"nagents={W} must be a multiple of the mesh size "
                         f"{mesh.devices.size}")
    shard_spec = NamedSharding(mesh, P(mesh.axis_names[0]))
    As_dev = jax.device_put(jnp.asarray(As), shard_spec)
    bs_dev = jax.device_put(jnp.asarray(bs), shard_spec)
    w, V, Atb = _cached_quad_setup(shard_spec)(As_dev, bs_dev)
    data = {"w": w, "V": V, "Atb": Atb}
    return exchange_admm(_quad_local_prox, data, n, config, mesh=mesh,
                         nagents=W, xi0=xi0, u0=u0)
