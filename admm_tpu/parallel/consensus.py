"""Consensus (global-variable) ADMM over a device mesh.

The reference's parallel LASSO (getProxOps.m:367-442 setup;
xminParallelLASSO :1217-1260; zminParallelLASSO :1272-1299; altuLASSO
:1312-1326; lassonorms :1335-1343) shards data rows into N slices, gives
each worker a local x_i/u_i, and keeps a single global z:

    x_i <- local_prox(z - u_i)                                  [local]
    xbar = mean_i x_i,  ubar = mean_i u_i                       [all-reduce]
    z    <- global_prox(xbar + ubar)                            [replicated]
    u_i  <- u_i + x_i - z                                       [local]

with consensus residuals (stored *squared*, exactly as the reference's
lassonorms feeds them to the engine via specialnorms, admm.m:612-616):

    pnorm = sum_i ||x_i - xbar||^2
    dnorm = N rho^2 ||xbar - xbar_prev||^2

and Boyd errors computed from the consensus aggregates (the reference's
engine sees x = xbar, u = ubar via altu; admm.m:639-658).

DELIBERATE reference parity quirk: the stopping test compares these
SQUARED residuals against the LINEAR Boyd tolerances perr/derr — that
is exactly what the reference does (lassonorms returns squares and the
engine's pnorm < perr test never unsquares them, admm.m:705-715), so a
consensus solve stops at a residual around sqrt(tolerance), i.e.
earlier in -log-residual terms than a serial solve with the same
abstol/reltol.  Matching the reference's observable behavior wins over
dimensional purity here; tighten abstol/reltol (or use stopcond
'hnorm'/'both') for a stricter consensus stop.  The rbadaptive
balancing rule DOES unsquare before comparing, so rbmu keeps its
engine meaning.

This module exposes the pattern as a GENERIC engine — ``consensus_admm``
takes pluggable per-shard and global proximal operators (module-level
functions over a data pytree, the same caching contract as the core
engine) — plus the LASSO instantiation matching the reference.

Feature parity with the core engine (round-2 growth; the reference's
consensus path runs through its engine, so nominally shares its
features, but altu/specialnorms overrides silently disable most of
them there — here each is wired into the consensus iteration itself):

  * relaxation (config.relax != 1): the textbook over-relaxed consensus
    step x̂_i = relax*x_i + (1-relax)*z_prev feeding the z-prox and the
    dual update (Boyd et al. 2011 sec. 3.4.3 applied to the per-slice
    constraint x_i - z = 0).  NOTE: in the reference, options.relax has
    NO effect on the consensus path — zminParallelLASSO ignores the
    engine's relaxed argument and uses its cached slice iterates
    (getProxOps.m:1272-1299) — so this is a strict feature extension.
  * H-norm stopping + divergence monitor (stopcond 'hnorm'/'both',
    convtest): H over the consensus aggregates w = [xbar; z; rho*ubar]
    with B = -I, exactly the engine's H (admm.m:302-313, 676-703).
  * adaptive rho (experimental, admm.m:724-741) and rbadaptive: both
    need rho-valid local proxes (consensus_lasso switches to the
    batched-eigh solve path under config.dynamic_rho).
  * warm start xi0/ui0/z0 — which also makes orbax checkpoints of
    sharded consensus state (utils/checkpoint.py) actually resumable.

  * fast/accelerated momentum (config.fast, both fasttypes): the
    consensus problem IS the core engine's splitting applied to the
    stacked variable x = [x_1; ...; x_W] with A = I and B = -[I;...;I]
    (each slice constrained x_i - z = 0), so the engine's momentum
    algebra (admm.m:563-600) transfers verbatim — the predictor v lives
    in z-space (n,), uhat_i is per-slice, and the accelerated d-value
    (1/rho)*sum_i||u_i - uhat_i||^2 + rho*W*||z - v||^2 is a global
    reduction the iteration already pays for the consensus norms.  The
    reference never runs fast modes through its consensus closures (the
    predictors would bypass altuLASSOs averaging), so like relax this
    is a strict feature extension; its exactness oracle is the core
    engine run on the stacked formulation (test_parallel.py).
  * Anderson acceleration (config.anderson, round 5 late): the AA
    window tracks the map state (z, {u_i}) — the replicated global
    plus the SHARDED dual stack; window dot products contract over the
    shard axis (one extra all-reduce class per iteration) and the
    (m, m) solve is replicated.  Same safeguards and plain-sweep
    stopping as the engine's AA; measured 3-4x fewer iterations on
    consensus lasso/covsel at tight tolerances (test_anderson.py).

Design: the reference pays a client->worker broadcast + gather per
prox per iteration (parfor); here the ENTIRE solve is one jitted program
over sharded state — per-shard solves are local matmuls on each device,
and the averages are psum/pmean collectives (NCCL between GPUs).  The per-iteration
collective payload is 2n floats (xbar, ubar) + 2 scalars, independent of
the data size: weak scaling in the number of rows is essentially free.

Implemented with sharding annotations (GSPMD) rather than shard_map: the
stacked per-shard arrays carry a NamedSharding over the mesh axis, means
over the shard axis compile to all-reduces, and the same program runs on
1..N devices (SURVEY.md section 7 "Distributed layer").
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
from ..engine import (_highest_precision, adaptive_rho_update,
                      fast_update, freeze_helpers, residual_balance_factor,
                      unrolled_body)
from ..ops.matfun import covsel_ns_prox
from ..ops.prox import covsel_eig_prox, soft_threshold
from ..results import ADMMResults
from .mesh import make_mesh, make_mesh2d, pad_rows, shard_rows


def _make_consensus_run(local_prox, global_prox, config: ADMMConfig,
                        W: int, n: int):
    """Build the (unjitted) consensus iteration program
    ``run(data, xi0, ui0, z0) -> raw dict``.  Jitted directly by
    ``_cached_consensus_runner``; vmapped over an instance-lane axis by
    ``_cached_consensus_batch_runner`` (the 2-D lanes x shards mesh)."""
    # Anderson acceleration (ADMMConfig.anderson) on the consensus map:
    # the fixed-point state is s = (z, {u_i}) — xi is DERIVED each sweep
    # (local proxes restart from z - u_i, consensus.py docstring), so
    # the window tracks the replicated z plus the sharded dual stack.
    # Window dot products contract over the sharded axis (GSPMD inserts
    # the all-reduce); the (m, m) solve is replicated.  Config
    # validation already restricts AA to the plain iteration with a
    # fixed rho and the standard stop.
    use_aa = config.anderson > 0
    m_aa = int(config.anderson)
    N = int(config.maxiters)
    relax = float(config.relax)
    use_relax = relax != 1.0
    needs_h = config.needs_hnorm
    alg = config.alg
    std_stop = config.stopcond in ("standard", "both")
    h_stop = config.stopcond in ("hnorm", "both")
    # Engine parity: adaptive requires convtest (admm.m:724 gate).
    use_adaptive = config.adaptive and config.convtest and needs_h
    # Plateau detector (ADMMConfig.stallwindow) — note the consensus
    # pnorm is SQUARED (lassonorms parity), so stalltol acts on squares:
    # a relative threshold t on squares ~ t/2 on linear norms, fine for
    # a plateau gate.
    use_stall = config.use_stall

    def run(data, xi0, ui0, z0):
        rdtype = xi0.dtype
        rho_init = jnp.asarray(config.rho, rdtype)
        rho0 = rho_init  # setup-time rho captured inside H (admm.m:305-306)
        eps = jnp.finfo(rdtype).eps
        nan_hist = lambda: jnp.full((N,), jnp.nan, rdtype)
        sc = lambda v=jnp.nan: jnp.asarray(v, rdtype)

        ubar0 = jnp.mean(ui0, axis=0)
        hist0 = {
            "pnorm": nan_hist(), "dnorm": nan_hist(),
            "perr": nan_hist(), "derr": nan_hist(),
            "Hnormsq": nan_hist() if needs_h else (),
            "dvals": nan_hist() if alg == 2 else (),
            "avals": nan_hist() if alg else (),
            "restarted": jnp.zeros((N,), jnp.int32) if alg == 2 else (),
            # Opt-in iterate traces of the consensus AGGREGATES
            # (xbar/z/ubar and w = [xbar; z; rho*ubar]): the reference's
            # parallel path records per-iteration state through its
            # engine (admm.m:607-610); per-shard xi/ui stay out of the
            # trace (W x the HBM) — the final ones return via extra.
            "xvals": jnp.zeros((N, n), rdtype) if config.record_iterates else (),
            "zvals": jnp.zeros((N, n), rdtype) if config.record_iterates else (),
            "uvals": jnp.zeros((N, n), rdtype) if config.record_iterates else (),
            "wvals": jnp.zeros((N, 3 * n), rdtype)
            if config.record_iterates else (),
            # The momentum predictor v is z-space (n,) — recorded like
            # the engine's vvals (admm.m:596-599).  The per-slice uhat
            # predictors stay out of the trace (a (W, n) buffer per
            # iteration), like xi/ui.
            "vvals": jnp.zeros((N, n), rdtype)
            if (config.record_iterates and alg) else (),
        }
        carry0 = {
            "k": jnp.asarray(0, jnp.int32),
            "xi": xi0, "z": z0, "ui": ui0,
            "xbar_prev": jnp.mean(xi0, axis=0),
            # fast / accelerated state (engine carry v/uhat/a/d over the
            # stacked splitting: v in z-space, uhat per slice)
            "v": z0 if alg else (), "uhat": ui0 if alg else (),
            "a": sc(1.0) if alg else (), "d": sc(jnp.inf) if alg == 2 else (),
            "wu_prev": rho0 * ubar0 if needs_h else (),  # H w-part (rho*ubar)
            "rho": rho_init,
            "done": jnp.asarray(False), "diverged": jnp.asarray(False),
            "stalled": jnp.asarray(False),
            "best_p": sc(jnp.inf) if use_stall else (),
            "since": jnp.asarray(0, jnp.int32) if use_stall else (),
            "aFz": jnp.zeros((m_aa + 1, n), rdtype) if use_aa else (),
            "aTz": jnp.zeros((m_aa + 1, n), rdtype) if use_aa else (),
            "aFu": jnp.zeros((m_aa + 1, W, n), rdtype) if use_aa else (),
            "aTu": jnp.zeros((m_aa + 1, W, n), rdtype) if use_aa else (),
            "acnt": jnp.asarray(0, jnp.int32) if use_aa else (),
            "abest": sc(jnp.inf) if use_aa else (),
            "Hprev": sc(jnp.inf),
            "hist": hist0,
        }

        def cond(c):
            return jnp.logical_and(c["k"] < N, jnp.logical_not(c["done"]))

        def step(c, frozen):
            # freeze gating (engine.freeze_helpers): literal False at
            # K=1, traced scalar under unroll — state selects fuse,
            # history writes gate per-slot.
            sel, sel_slot = freeze_helpers(frozen)
            k = c["k"]
            i = k + 1  # reference's 1-based counter
            rho = c["rho"]
            xi, z, ui = c["xi"], c["z"], c["ui"]
            zprev = z

            # Local x-solves (xminParallelLASSO, getProxOps.m:1217-1260):
            # batched (sharded) per-device work.  Fast modes pull back the
            # predictors v/uhat (engine x = pf(x, v, uhat, rho)).
            if alg == 0:
                xi = local_prox(z, ui, rho, data)
                u_base = ui
                dprev = ()
            else:
                aprev, ui_prev, uhat = c["a"], ui, c["uhat"]
                xi = local_prox(c["v"], uhat, rho, data)
                u_base = uhat
                dprev = c["d"] if alg == 2 else ()

            # Over-relaxation on the per-slice constraint x_i - z = 0
            # (Boyd sec. 3.4.3; see module docstring for reference delta).
            xhat = relax * xi + (1.0 - relax) * zprev[None, :] if use_relax else xi

            # Consensus aggregates: mean over the shard axis -> all-reduce.
            xbar = jnp.mean(xi, axis=0)
            xhat_bar = relax * xbar + (1.0 - relax) * zprev if use_relax else xbar
            ubar_base = jnp.mean(u_base, axis=0)

            # Global z (zminParallelLASSO, getProxOps.m:1290-1293); fast
            # modes hand the predicted dual (engine u_for_g = uhat).
            z = global_prox(xhat_bar, ubar_base, rho, W, data)

            # Immediate per-slice dual update (getProxOps.m:1296-1298);
            # base is uhat under fast (engine admm.m:547-552).
            ui = u_base + (xhat - z[None, :])
            # Post-update dual average, used by derr below: the reference
            # engine evaluates its dual error AFTER altuLASSO has updated
            # the averaged dual (admm.m:553-560 then :639-658).
            ubar = ubar_base + (xhat_bar - z)

            # ---- fast / accelerated updates (admm.m:563-600) over the
            # stacked splitting: momentum on z (predictor v) and on each
            # slice dual u_i (predictor uhat_i).
            v_new, uhat_new, a_new = c["v"], c["uhat"], c["a"]
            d_new = c["d"]
            restarted_i = ()
            if alg:
                # d = (1/rho)||u - uhat||^2 + rho||B(z - v)||^2 on the
                # stacked problem: B tiles z over W slices.  The z-space
                # predictor and the per-slice duals update with the
                # SHARED momentum algebra (engine.fast_update).
                dval = ((1.0 / rho) * jnp.sum((ui - uhat) ** 2)
                        + rho * W * jnp.sum((z - c["v"]) ** 2)
                        ) if alg == 2 else None
                v_new, uhat_new, a_new, d2, r2 = fast_update(
                    alg, config, aprev=aprev, dprev=dprev, z=z,
                    zprev=zprev, u=ui, uprev=ui_prev, v=c["v"], dval=dval)
                if alg == 2:
                    d_new, restarted_i = d2, r2

            # Consensus residuals, squared (lassonorms,
            # getProxOps.m:1335-1343).
            pnorm = jnp.sum((xi - xbar[None, :]) ** 2)
            dnorm = W * rho**2 * jnp.sum((xbar - c["xbar_prev"]) ** 2)

            # Boyd errors on the aggregates (engine sees x=xbar, u=ubar
            # through altu; admm.m:639-658 with A=1, B=-1, c=0).
            sqn = jnp.sqrt(jnp.asarray(float(n), rdtype))
            perr = sqn * config.abstol + config.reltol * jnp.maximum(
                jnp.linalg.norm(xbar), jnp.linalg.norm(z)
            )
            derr = sqn * config.abstol + config.reltol * rho * jnp.linalg.norm(ubar)

            # H-norm over the consensus aggregates w = [xbar; z; rho*ubar]
            # with B = -I (engine admm.m:302-313): the z-part difference
            # plus the scaled-dual difference, weighted by the setup rho.
            Hsq = ()
            diverged_i = jnp.asarray(False)
            if config.nanguard:
                # A NaN-aborted solve is DIVERGED, not converged.
                diverged_i = diverged_i | jnp.logical_not(jnp.isfinite(pnorm))
            if needs_h:
                wu_new = rho * ubar
                Hsq = rho0 * jnp.sum((zprev - z) ** 2) + rho0 * jnp.sum(
                    (c["wu_prev"] - wu_new) ** 2
                )
                if config.convtest and alg == 0:
                    # Monotonicity is a plain-iteration property; the
                    # engine gates the monitor on alg 0 too.
                    H1, H2 = c["Hprev"], Hsq
                    diverged_i = diverged_i | (
                        (i >= 2) & (H1 > eps) & (H2 > H1)
                        & ((H2 - H1) > H1 * config.convtol)
                    )
            else:
                wu_new = ()

            # Plateau detector (engine parity; ADMMConfig.stallwindow).
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
                # Accelerated d-value stop (admm.m:706-707), not gated on
                # domaxiters — engine parity.
                stop = (i >= 2) & (jnp.abs(d_new - dprev)
                                   <= config.dvaltol * dprev)
            elif std_stop and not config.domaxiters:
                dual_ok = (jnp.asarray(True) if config.nodualerror
                           else (dnorm < derr))
                stop = (pnorm < perr) & dual_ok
            if h_stop and not config.domaxiters and needs_h:
                stop = stop | ((i > 2) & (Hsq <= config.hnormtol))
            done = stop | diverged_i | stall_i

            rho_new = rho
            if use_adaptive:
                # Experimental adaptive rho (engine.adaptive_rho_update,
                # admm.m:724-741) applied to the consensus H.
                rho_new = adaptive_rho_update(
                    config, Hprev=c["Hprev"], Hsq=Hsq, rho=rho, i=i,
                    done=done, eps=eps)
            elif config.rbadaptive and alg == 0:
                # Residual balancing on the consensus residuals with the
                # scaled-dual rescale (ADMMConfig.rbadaptive; the
                # adaptive-consensus-ADMM idea of Xu et al. 2017).
                # pnorm/dnorm are stored SQUARED (reference lassonorms
                # parity); the balancing rule compares unsquared norms so
                # rbmu means the same imbalance ratio as in the engine.
                factor = residual_balance_factor(
                    config, pnorm=jnp.sqrt(pnorm), dnorm=jnp.sqrt(dnorm),
                    done=done, dtype=rho.dtype)
                rho_new = rho * factor
                ui = ui / factor
                # Keep the recorded/derr aggregate consistent with the
                # rescaled per-slice duals (the engine records u AFTER
                # this rescale, engine.py history block).
                ubar = ubar / factor

            # ---- Anderson acceleration (see use_aa note above).  The
            # plain sweep is the map evaluation T(z, ui); the candidate
            # replaces the NEXT iteration's starting state only —
            # residuals/stopping/history stay those of the plain sweep
            # (engine parity, engine.py AA block).
            z_next, ui_next = z, ui
            if use_aa:
                R = m_aa + 1
                fz = z - zprev
                fu = ui - c["ui"]
                fn2 = jnp.sum(fz * fz) + jnp.sum(fu * fu)
                grew = fn2 > (config.aa_restart ** 2) * c["abest"]
                cnt = jnp.where(grew, 0, c["acnt"])
                abest_new = jnp.where(grew, fn2,
                                      jnp.minimum(c["abest"], fn2))
                slot = (cnt % R).astype(jnp.int32)
                aFz = sel_slot(c["aFz"], slot, fz)
                aTz = sel_slot(c["aTz"], slot, z)
                aFu = sel_slot(c["aFu"], slot, fu)
                aTu = sel_slot(c["aTu"], slot, ui)
                js = (cnt - m_aa + jnp.arange(R, dtype=jnp.int32)) % R
                dFz = aFz[js][1:] - aFz[js][:-1]
                dTz = aTz[js][1:] - aTz[js][:-1]
                dFu = aFu[js][1:] - aFu[js][:-1]
                dTu = aTu[js][1:] - aTu[js][:-1]
                mk = jnp.minimum(cnt, m_aa)
                vmask = jnp.arange(m_aa) >= (m_aa - mk)
                dFz = jnp.where(vmask[:, None], dFz, 0.0)
                dTz = jnp.where(vmask[:, None], dTz, 0.0)
                dFu = jnp.where(vmask[:, None, None], dFu, 0.0)
                dTu = jnp.where(vmask[:, None, None], dTu, 0.0)
                G = dFz @ dFz.T + jnp.einsum("awn,bwn->ab", dFu, dFu)
                lam = config.aa_reg * jnp.trace(G) + eps
                gamma = jnp.linalg.solve(
                    G + lam * jnp.eye(m_aa, dtype=rdtype),
                    dFz @ fz + jnp.einsum("awn,wn->a", dFu, fu))
                cz = z - gamma @ dTz
                cu = ui - jnp.einsum("a,awn->wn", gamma, dTu)
                ok = (jnp.all(jnp.isfinite(cz)) & jnp.all(jnp.isfinite(cu))
                      & (jnp.sum(jnp.abs(gamma)) <= config.aa_gmax)
                      & (mk >= 1) & jnp.logical_not(done))
                z_next = jnp.where(ok, cz, z)
                ui_next = jnp.where(ok, cu, ui)
                acnt_new = cnt + 1
            else:
                aFz = aTz = aFu = aTu = acnt_new = abest_new = ()

            h = dict(c["hist"])
            h["pnorm"] = sel_slot(h["pnorm"], k, pnorm)
            h["dnorm"] = sel_slot(h["dnorm"], k, dnorm)
            h["perr"] = sel_slot(h["perr"], k, perr)
            h["derr"] = sel_slot(h["derr"], k, derr)
            if needs_h:
                h["Hnormsq"] = sel_slot(h["Hnormsq"], k, Hsq)
            if alg == 2:
                h["dvals"] = sel_slot(h["dvals"], k, d_new)
                h["restarted"] = sel_slot(h["restarted"], k, restarted_i)
            if alg:
                h["avals"] = sel_slot(h["avals"], k, a_new)
            if config.record_iterates:
                h["xvals"] = sel_slot(h["xvals"], k, xbar)
                h["zvals"] = sel_slot(h["zvals"], k, z)
                # ubar is post-rescale under rbadaptive (so uvals agrees
                # with uopt); rho_new * ubar then preserves the
                # scaled-dual product rho*ubar_pre — the engine's exact
                # wvals rule (engine.py history block).
                h["uvals"] = sel_slot(h["uvals"], k, ubar)
                h["wvals"] = sel_slot(h["wvals"], k, jnp.concatenate(
                    [xbar, z,
                     (rho_new if config.rbadaptive else rho) * ubar]))
                if alg:
                    h["vvals"] = sel_slot(h["vvals"], k, v_new)

            return {
                "k": sel(k, k + 1),
                "xi": sel(c["xi"], xi), "z": sel(c["z"], z_next),
                "ui": sel(c["ui"], ui_next),
                "xbar_prev": sel(c["xbar_prev"], xbar),
                "v": sel(c["v"], v_new) if alg else (),
                "uhat": sel(c["uhat"], uhat_new) if alg else (),
                "a": sel(c["a"], a_new) if alg else (),
                "d": sel(c["d"], d_new) if alg == 2 else (),
                "wu_prev": sel(c["wu_prev"], wu_new) if needs_h else (),
                "rho": sel(c["rho"], rho_new),
                "done": sel(c["done"], done),
                "diverged": sel(c["diverged"], c["diverged"] | diverged_i),
                "stalled": sel(c["stalled"], c["stalled"] | stall_i),
                "best_p": sel(c["best_p"], best_new) if use_stall else (),
                "since": sel(c["since"], since_new) if use_stall else (),
                "aFz": aFz if use_aa else (),
                "aTz": aTz if use_aa else (),
                "aFu": aFu if use_aa else (),
                "aTu": aTu if use_aa else (),
                "acnt": sel(c["acnt"], acnt_new) if use_aa else (),
                "abest": sel(c["abest"], abest_new) if use_aa else (),
                "Hprev": sel(c["Hprev"], Hsq) if needs_h else c["Hprev"],
                "hist": h,
            }

        body = unrolled_body(step, int(config.unroll), N,
                             lambda c: (c["k"], c["done"]))
        final = lax.while_loop(cond, body, carry0)
        ubar = jnp.mean(final["ui"], axis=0)
        return {
            "steps": final["k"],
            # the reference returns xbar as x (:1260)
            "xopt": jnp.mean(final["xi"], axis=0),
            "zopt": final["z"],
            "uopt": ubar,
            "xi": final["xi"],
            "ui": final["ui"],
            "rho_final": final["rho"],
            "diverged": final["diverged"],
            "stalled": final["stalled"],
            "hist": final["hist"],
        }

    return run


@functools.lru_cache(maxsize=64)
def _cached_consensus_runner(local_prox, global_prox, config: ADMMConfig,
                             W: int, n: int):
    """Cross-call compile cache: repeat consensus solves of the same
    (proxes, config, shard count, width) family reuse the compiled
    program."""
    run = _make_consensus_run(local_prox, global_prox, config, W, n)
    return jax.jit(_highest_precision(run))


@functools.lru_cache(maxsize=32)
def _cached_consensus_batch_runner(local_prox, global_prox,
                                   config: ADMMConfig, W: int, n: int,
                                   mapped: frozenset, data_keys: frozenset):
    """Instance-batched consensus runner: vmap the consensus program over
    a leading lane axis (one independent problem per lane), each lane
    still row-sharded W ways.  Data leaves named in ``mapped`` carry the
    lane axis; the rest (shared factorizations) are broadcast.  Under
    vmap, JAX's while_loop batching per-lane-selects the carry against
    each lane's done flag, so converged lanes freeze (engine.py note) —
    the program runs until the slowest lane."""
    run = _make_consensus_run(local_prox, global_prox, config, W, n)
    data_axes = {k: (0 if k in mapped else None) for k in data_keys}
    vrun = jax.vmap(run, in_axes=(data_axes, 0, 0, 0))
    return jax.jit(_highest_precision(vrun))


def consensus_admm(
    local_prox: Callable,
    global_prox: Callable,
    data,
    n: int,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
    body: str = "gemv",
) -> ADMMResults:
    """Generic consensus ADMM.

    ``local_prox(z, ui, rho, data) -> xi`` computes ALL per-shard local
    solves at once on stacked (W, n) arrays whose leading axis is sharded;
    ``global_prox(xbar, ubar, rho, W, data) -> z`` is the replicated
    global update (under relaxation its first argument is the relaxed
    aggregate x̂bar).  Both must be module-level functions (caching
    contract).  ``data`` is a pytree of operands; leaves with a leading
    shard axis should already be device_put with the shard sharding.

    ``xi0``/``ui0`` (shape (W, n)) and ``z0`` (shape (n,)) warm-start the
    consensus state — the sharded analog of the engine's x0/z0/u0
    (admm.m:252-259); pass the xi/ui from a previous solve's
    ``results.extra`` or an orbax checkpoint to resume.
    """
    if mesh is None:
        mesh = make_mesh()
    W = nshards if nshards is not None else mesh.devices.size

    leaves = jax.tree_util.tree_leaves(data)
    rdtype = leaves[0].dtype if leaves else jnp.float32
    xi0 = jnp.zeros((W, n), rdtype) if xi0 is None else jnp.asarray(xi0, rdtype)
    ui0 = jnp.zeros((W, n), rdtype) if ui0 is None else jnp.asarray(ui0, rdtype)
    z0 = jnp.zeros((n,), rdtype) if z0 is None else jnp.asarray(z0, rdtype)
    if xi0.shape != (W, n) or ui0.shape != (W, n):
        raise ValueError(
            f"xi0/ui0 must have shape {(W, n)}; got {xi0.shape}/{ui0.shape}"
        )
    if z0.shape != (n,):
        raise ValueError(f"z0 must have shape {(n,)}; got {z0.shape}")

    # Default consensus bodies are GEMV-class and take the deep unroll.
    # Matrix-iterate
    # instantiations (consensus_covsel) pass body='heavy' so the unroll
    # resolver keeps their eigh/NS bodies shallow (compile time).
    config = resolve_unroll(config, body)
    runner = _cached_consensus_runner(local_prox, global_prox, config, W, n)
    data, xi0, ui0, z0 = jax.block_until_ready((data, xi0, ui0, z0))
    t0 = time.perf_counter()  # loop-only wall clock
    out = jax.block_until_ready(runner(data, xi0, ui0, z0))
    # Stop the clock BEFORE from_raw: its scalar int()/float()/bool()
    # conversions are each a device->host round trip that is not part
    # of the solve (the engine and the transpose-reduction runner
    # measure in this order too).
    runtime = time.perf_counter() - t0

    res = ADMMResults.from_raw(
        {k: v for k, v in out.items() if k not in ("xi", "ui")}, config
    )
    res.runtime = runtime
    res.extra["xi"] = out["xi"]
    res.extra["ui"] = out["ui"]
    res.extra["nshards"] = W
    res.extra["mesh"] = mesh
    return res


# ---- LASSO instantiation (the reference's consensus problem) -------------


def _lasso_local_prox(z, ui, rho, d):
    rhs = d["Dtsi"] + rho * (z[None, :] - ui)
    return jnp.einsum("wij,wj->wi", d["Minv"], rhs)


def _lasso_local_prox_dynamic(z, ui, rho, d):
    # rho-parameterized per-shard solve via batched eigh of D_i^T D_i
    # (valid for any runtime rho — the adaptive/rbadaptive paths).
    rhs = d["Dtsi"] + rho * (z[None, :] - ui)
    y = jnp.einsum("wji,wj->wi", d["V"], rhs)
    y = y / (d["w"] + rho)
    return jnp.einsum("wij,wj->wi", d["V"], y)


def _lasso_global_prox(xbar, ubar, rho, W, d):
    # soft-threshold at lambda/(rho N) (zminParallelLASSO :1290-1293)
    return soft_threshold(xbar + ubar, d["lam"] / (rho * W))


def _elasticnet_global_prox(xbar, ubar, rho, W, d):
    # prox of lam*(alpha ||z||_1 + (1-alpha)/2 ||z||^2) at weight rho*W
    # (the consensus z-step averages W copies of the constraint):
    # shrinkage then a uniform rescale — models/elasticnet._prox_g with
    # rho -> rho*W, exactly as the lasso threshold gains the 1/W.
    t = d["lam"] * d["alpha"] / (rho * W)
    scale = 1.0 + d["lam"] * (1.0 - d["alpha"]) / (rho * W)
    return soft_threshold(xbar + ubar, t) / scale


@functools.lru_cache(maxsize=16)
def _cached_lasso_setup_dyn(shard_spec):
    """Batched per-shard Gram eigh + D^T s (dynamic rho), jitted once per
    sharding — NamedSharding is hashable, so repeat solves hit the cache."""

    def body(Di, si):
        with jax.default_matmul_precision("highest"):
            G = jnp.einsum("wij,wik->wjk", Di, Di)
            G = 0.5 * (G + jnp.swapaxes(G, -1, -2))
            w, V = jnp.linalg.eigh(G)
            Dtsi = jnp.einsum("wij,wi->wj", Di, si)
            return w, V, Dtsi

    return jax.jit(
        body, out_shardings=(shard_spec, shard_spec, shard_spec))


@functools.lru_cache(maxsize=16)
def _cached_lasso_setup(shard_spec, rho):
    """Batched per-shard rho-folded Gram inverse + D^T s (static rho),
    jitted once per (sharding, rho)."""

    def body(Di, si):
        with jax.default_matmul_precision("highest"):
            n = Di.shape[-1]
            G = jnp.einsum("wij,wik->wjk", Di, Di)
            G = G + rho * jnp.eye(n, dtype=Di.dtype)[None]
            Minv = jnp.linalg.inv(G)
            Dtsi = jnp.einsum("wij,wi->wj", Di, si)
            return Minv, Dtsi

    return jax.jit(body, out_shardings=(shard_spec, shard_spec))


def _sharded_ls_setup(D, s, config, mesh, nshards):
    """Shared consensus setup for least-squares local solves: resolve the
    mesh/shard count, shard the rows, and build the per-shard solve data
    (rho-folded inverse for static rho — the reference's per-slice
    Cholesky caches, getProxOps.m:404-442 — or a batched eigh for dynamic
    rho).  The jitted setups are lru-cached on (sharding, rho) so repeat
    solves (warm start, checkpoint resume) don't recompile setup.

    Returns ``(local_prox, data, n, mesh, W)``; callers add the penalty
    parameters to ``data`` and pick the global prox — the consensus
    x-step is penalty-independent (all shrinkage-family problems share
    the per-shard least-squares solve)."""
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    W = nshards if nshards is not None else mesh.devices.size
    if W < mesh.devices.size:
        # Fewer shards than devices: build a sub-mesh over the first W.
        mesh = make_mesh(W, axis)
    elif W % mesh.devices.size:
        # More shards than devices is fine (each device batches several
        # slices — e.g. benchmarking the 8-shard program on one chip),
        # as long as the stacked axis shards evenly.
        raise ValueError(
            f"nshards={W} must be a multiple of the mesh size "
            f"{mesh.devices.size}")

    D = np.asarray(D)
    s = np.asarray(s)
    m, n = D.shape
    Dp, _ = pad_rows(D, W)       # zero rows: exact no-ops for D^T D, D^T s
    sp, _ = pad_rows(s, W)
    Di = shard_rows(Dp, W)       # (W, m/W, n)
    si = shard_rows(sp, W)       # (W, m/W)

    shard_spec = NamedSharding(mesh, P(axis))
    Di_dev = jax.device_put(jnp.asarray(Di), shard_spec)
    si_dev = jax.device_put(jnp.asarray(si), shard_spec)

    if config.dynamic_rho:
        w, V, Dtsi = _cached_lasso_setup_dyn(shard_spec)(Di_dev, si_dev)
        return (_lasso_local_prox_dynamic,
                {"w": w, "V": V, "Dtsi": Dtsi}, n, mesh, W)
    Minv, Dtsi = _cached_lasso_setup(shard_spec, float(config.rho))(
        Di_dev, si_dev)
    return _lasso_local_prox, {"Minv": Minv, "Dtsi": Dtsi}, n, mesh, W


def consensus_lasso(
    D,
    s,
    lam,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
) -> ADMMResults:
    """Solve LASSO by consensus ADMM with data rows sharded over a mesh.

    Mirrors ``lasso(..., options.parallel)`` + the consensus closures
    (solvers/lasso.m:196-224, getProxOps.m:367-442).  ``nshards`` defaults
    to the mesh size (the reference defaults slices to the worker count,
    errorcheck.m:240-265).  ``xi0``/``ui0``/``z0`` warm-start (resume)
    the sharded state — see ``consensus_admm``.
    """
    local_prox, data, n, mesh, W = _sharded_ls_setup(D, s, config, mesh,
                                                     nshards)
    data["lam"] = jnp.asarray(lam, data["Dtsi"].dtype)
    return consensus_admm(
        local_prox, _lasso_global_prox, data, n, config,
        mesh=mesh, nshards=W, xi0=xi0, ui0=ui0, z0=z0,
    )


# ---- logistic regression instantiation (Boyd et al. 2011, sec. 8.2) -------


@functools.lru_cache(maxsize=8)
def _logreg_local_prox_fn(newton_steps: int):
    """Per-shard damped-Newton x-prox for sparse logistic regression,
    batched over the shard axis: argmin_x sum softplus(-(Y_i x)) +
    (rho/2)||x - (z - u_i)||^2.  The consensus iteration hands no
    previous xi, so Newton restarts from the target v = z - u_i every
    iteration — the prox must therefore be solved ACCURATELY (a fixed
    coarse prox error stalls ADMM: 5 steps left the consensus residual
    floored at ~1, 20 steps with 3-level damping converge in ~100
    iterations — round-4 diagnostic).  Zero pad rows are exact no-ops
    for gradient/Hessian (their Y rows are 0); they only add a constant
    to the line-search objective, which cancels in the comparisons.
    lru-cached on the step count so the compiled consensus runner is
    shared across calls (engine caching contract)."""

    def prox(z, ui, rho, d):
        Yi = d["Yi"]                           # (W, mw, n)
        n = Yi.shape[-1]
        I = jnp.eye(n, dtype=Yi.dtype)
        v = z[None, :] - ui                    # (W, n)

        def fobj(x):
            t = jnp.einsum("wmn,wn->wm", Yi, x)
            return (jnp.sum(jnp.logaddexp(0.0, -t), axis=-1)
                    + 0.5 * rho * jnp.sum((x - v) ** 2, axis=-1))

        x = v
        for _ in range(newton_steps):
            t = jnp.einsum("wmn,wn->wm", Yi, x)
            sig = jax.nn.sigmoid(-t)
            grad = -jnp.einsum("wmn,wm->wn", Yi, sig) + rho * (x - v)
            w = sig * (1.0 - sig)
            H = jnp.einsum("wmi,wmj->wij", Yi * w[..., None], Yi) + rho * I
            step = jnp.linalg.solve(H, grad[..., None])[..., 0]
            f0 = fobj(x)
            x1 = x - step
            x2 = x - 0.5 * step
            f1, f2 = fobj(x1), fobj(x2)
            x = jnp.where((f1 <= f0)[:, None], x1,
                          jnp.where((f2 <= f0)[:, None], x2,
                                    x - 0.25 * step))
        return x

    return prox


@functools.lru_cache(maxsize=None)
def _logreg_local_prox_cg_fn(newton_steps: int, cg_steps: int):
    """Matrix-free per-shard Newton-PCG local prox: the round-5 logreg
    CG recipe (models/logreg._newton_cg_xprox) batched over the shard
    axis — each CG matvec is two (W, mw, n) einsums (sharded GEMM
    work), no (W, n, n) Hessian stack.  UNLIKE the engine's serial
    path, the consensus iteration restarts the prox from z - u_i every
    iteration (no warm start), so the prox must be solved accurately
    (round-4 stall lesson: a fixed coarse prox error floors the
    consensus residual) — hence the conservative default knobs on
    consensus_logreg (20 Newton x 25 PCG; this is an opt-in perf mode,
    'newton' dense solves stay the accuracy default)."""

    def prox(z, ui, rho, d):
        Yi, Yi2 = d["Yi"], d["Yi2"]           # (W, mw, n)
        v = z[None, :] - ui                    # (W, n)
        tiny = jnp.finfo(v.dtype).tiny

        def fobj(x):
            t = jnp.einsum("wmn,wn->wm", Yi, x)
            return (jnp.sum(jnp.logaddexp(0.0, -t), axis=-1)
                    + 0.5 * rho * jnp.sum((x - v) ** 2, axis=-1))

        x = v
        for _ in range(newton_steps):
            t = jnp.einsum("wmn,wn->wm", Yi, x)
            sig = jax.nn.sigmoid(-t)
            grad = -jnp.einsum("wmn,wm->wn", Yi, sig) + rho * (x - v)
            w = sig * (1.0 - sig)
            diag = jnp.einsum("wmn,wm->wn", Yi2, w) + rho

            def hv(s, w=w):
                return (jnp.einsum("wmn,wm->wn", Yi,
                                   w * jnp.einsum("wmn,wn->wm", Yi, s))
                        + rho * s)

            # Per-shard Jacobi-PCG (reductions over the trailing axis).
            s = jnp.zeros_like(grad)
            r = grad
            zp = r / diag
            p = zp
            rz = jnp.sum(r * zp, axis=-1, keepdims=True)
            for _ in range(cg_steps):
                hp = hv(p)
                alpha = rz / jnp.maximum(
                    jnp.sum(p * hp, axis=-1, keepdims=True), tiny)
                s = s + alpha * p
                r = r - alpha * hp
                zp = r / diag
                rz_new = jnp.sum(r * zp, axis=-1, keepdims=True)
                beta = rz_new / jnp.maximum(rz, tiny)
                p = zp + beta * p
                rz = rz_new

            f0 = fobj(x)
            x1 = x - s
            x2 = x - 0.5 * s
            f1, f2 = fobj(x1), fobj(x2)
            x = jnp.where((f1 <= f0)[:, None], x1,
                          jnp.where((f2 <= f0)[:, None], x2,
                                    x - 0.25 * s))
        return x

    return prox


def consensus_logreg(
    D,
    ell,
    lam,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    inner: str = "newton",
    newton_steps: int = 20,
    cg_steps: int = 25,
    xi0=None,
    ui0=None,
    z0=None,
) -> ADMMResults:
    """Distributed sparse logistic regression by consensus ADMM — the
    canonical consensus application (Boyd et al. 2011, sec. 8.2): data
    rows sharded over the mesh, per-shard damped-Newton local solves,
    global soft-threshold z at lam/(rho W).  Beyond the reference
    (which has no logistic family); the third instantiation of the
    generic consensus engine, and the first with a non-closed-form
    local prox."""
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    W = nshards if nshards is not None else mesh.devices.size
    if W < mesh.devices.size:
        mesh = make_mesh(W, axis)
    elif W % mesh.devices.size:
        raise ValueError(
            f"nshards={W} must be a multiple of the mesh size "
            f"{mesh.devices.size}")

    D = np.asarray(D)
    ell = np.asarray(ell, D.dtype)
    m, n = D.shape
    if ell.shape != (m,):
        raise ValueError(f"ell must be ({m},) labels, got {ell.shape}")
    Y = D * ell[:, None]
    Yp, _ = pad_rows(Y, W)                 # zero rows: exact no-ops
    Yi = shard_rows(Yp, W)                 # (W, m/W, n)
    if inner not in ("newton", "newton_cg"):
        raise ValueError(
            f"inner must be 'newton' or 'newton_cg', got {inner!r}")
    spec = NamedSharding(mesh, P(axis))
    Yi_dev = jax.device_put(jnp.asarray(Yi), spec)
    data = {"Yi": Yi_dev, "lam": jnp.asarray(lam, Yi_dev.dtype)}
    if inner == "newton_cg":
        data["Yi2"] = jax.device_put(jnp.asarray(Yi * Yi), spec)
        local = _logreg_local_prox_cg_fn(int(newton_steps), int(cg_steps))
    else:
        local = _logreg_local_prox_fn(int(newton_steps))
    return consensus_admm(
        local, _lasso_global_prox,
        data, n, config, mesh=mesh, nshards=W, xi0=xi0, ui0=ui0, z0=z0,
    )


# ---- covariance selection (matrix-iterate consensus) ----------------------
#
# Boyd et al. 2011 ch. 7 general-form consensus applied to the graphical
# lasso (the reference's covarianceselection family, getProxOps.m:669-750,
# distributed over SAMPLES):
#
#     min sum_i [ tr(S_i X_i) - (1/N) logdet X_i ] + lam ||Z||_1
#     s.t. X_i = Z
#
# where S_i is shard i's contribution to the pooled empirical covariance
# (S = sum_i S_i with the GLOBAL mean and normalization, so the optimum
# equals the serial solve's).  The local prox solves
# rho X - (1/N) X^{-1} = rho V - S_i — the covsel spectral function with
# 4 rho -> 4 rho / N (ops/prox.covsel_eig_prox weight; NS twin keeps its
# conditioning floor at 4 rho/N > 0).  The global prox is the shared
# soft threshold at lam/(rho N).
#
# The consensus engine carries VECTOR state, so the (p, p) iterates ride
# flattened (p*p,) — a free layout-preserving reshape under XLA — which
# buys every engine variant (fast/relax/rbadaptive/stall/warm-start) for
# the matrix tier without touching the runner.


def _covsel_local_prox(z, ui, rho, d):
    Wn = ui.shape[0]
    p = d["Si"].shape[-1]
    V = (z[None, :] - ui).reshape(Wn, p, p)
    X = covsel_eig_prox(rho * V - d["Si"], rho, weight=d["wgt"])
    return X.reshape(Wn, p * p)


@functools.lru_cache(maxsize=None)
def _covsel_local_prox_ns_fn(ns_iters: int, ns_coarse: int, ns_correct: int):
    """Module-level-cached NS local prox (engine caching contract)."""

    def prox(z, ui, rho, d):
        Wn = ui.shape[0]
        p = d["Si"].shape[-1]
        V = (z[None, :] - ui).reshape(Wn, p, p)
        X = covsel_ns_prox(rho * V - d["Si"], rho, ns_iters, ns_coarse,
                           ns_correct, weight=d["wgt"])
        return X.reshape(Wn, p * p)

    return prox


def _flat_mat(v, shape, dtype, what):
    if v is None:
        return None
    v = jnp.asarray(v, dtype)
    if v.shape != shape:
        raise ValueError(f"{what} must have shape {shape}, got {v.shape}")
    return v.reshape(shape[:-2] + (shape[-1] * shape[-2],))


def consensus_covsel(
    D,
    lam,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    prox_method: str = "eigh",
    ns_iters: int = 20,
    ns_coarse: int = 0,
    ns_correct: int = 0,
    xi0=None,
    ui0=None,
    z0=None,
) -> ADMMResults:
    """Distributed covariance selection by consensus ADMM: sample rows
    of ``D`` (m, p) sharded over the mesh, per-shard SPECTRAL local
    proxes on (p, p) matrix iterates, global soft-threshold Z — the
    first matrix-iterate instantiation of the consensus engine (the
    families that strain a chip: covsel at large p).

    The optimum equals the serial ``covarianceselection(D, lam)`` (the
    shards' S_i sum to the pooled covariance about the global mean;
    exactness oracle in tests/test_parallel.py).  ``prox_method`` as in
    the serial wrapper: ``'eigh'`` exact, ``'ns'``/``'ns_fast'`` the
    matmul-only Newton-Schulz tier — under sharding the NS body is pure
    batched (W, p, p) GEMM work per device.  Warm starts ``xi0``/``ui0``
    take (W, p, p) stacks, ``z0`` a (p, p) matrix; results are reshaped
    back to matrices (``extra['xi']``/``['ui']`` as (W, p, p)).
    """
    if prox_method not in ("eigh", "ns", "ns_fast"):
        raise ValueError(
            f"prox_method must be 'eigh', 'ns' or 'ns_fast', got {prox_method!r}")
    if prox_method == "ns_fast":
        # The covsel recipe (models/covarianceselection.py): all
        # square-root steps at the default matmul precision + 2
        # full-precision corrections.
        ns_coarse, ns_correct = ns_iters, max(int(ns_correct), 2)
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    W = nshards if nshards is not None else mesh.devices.size
    if W < mesh.devices.size:
        mesh = make_mesh(W, axis)
    elif W % mesh.devices.size:
        raise ValueError(f"nshards={W} must be a multiple of the mesh size "
                         f"{mesh.devices.size}")

    D = np.asarray(D)
    m, p = D.shape
    # Global centering + normalization BEFORE sharding, so
    # sum_i S_i = empirical_covariance(D) exactly (zero pad rows are
    # exact no-ops for the per-shard Gram).
    Dc = D - D.mean(axis=0, keepdims=True)
    Dc = Dc / np.sqrt(m - 1)
    Dp, _ = pad_rows(Dc, W)
    Di = shard_rows(Dp, W)                      # (W, m/W, p)
    spec = NamedSharding(mesh, P(axis))
    Di_dev = jax.device_put(jnp.asarray(Di), spec)
    Si = _cached_covsel_setup(spec)(Di_dev)     # (W, p, p) local Grams
    dt = Si.dtype
    data = {"Si": Si, "lam": jnp.asarray(lam, dt),
            "wgt": jnp.asarray(1.0 / W, dt)}

    local = (_covsel_local_prox if prox_method == "eigh"
             else _covsel_local_prox_ns_fn(int(ns_iters), int(ns_coarse),
                                           int(ns_correct)))
    res = consensus_admm(
        local, _lasso_global_prox, data, p * p, config,
        mesh=mesh, nshards=W,
        xi0=_flat_mat(xi0, (W, p, p), dt, "xi0"),
        ui0=_flat_mat(ui0, (W, p, p), dt, "ui0"),
        z0=_flat_mat(z0, (p, p), dt, "z0"),
        body="heavy",
    )
    # Back to matrix-land for the caller.
    res.xopt = res.xopt.reshape(p, p)
    res.zopt = res.zopt.reshape(p, p)
    res.uopt = res.uopt.reshape(p, p)
    res.extra["xi"] = res.extra["xi"].reshape(W, p, p)
    res.extra["ui"] = res.extra["ui"].reshape(W, p, p)
    return res


@functools.lru_cache(maxsize=16)
def _cached_covsel_setup(shard_spec):
    """Per-shard covariance contributions S_i = D_i^T D_i (rows already
    globally centered and 1/sqrt(m-1)-scaled), jitted once per sharding."""

    def body(Di):
        with jax.default_matmul_precision("highest"):
            G = jnp.einsum("wmi,wmj->wij", Di, Di)
            return 0.5 * (G + jnp.swapaxes(G, -1, -2))

    return jax.jit(body, out_shardings=shard_spec)


def consensus_covsel_batch(
    Ds,
    lams,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    prox_method: str = "eigh",
    ns_iters: int = 20,
    ns_coarse: int = 0,
    ns_correct: int = 0,
    xi0=None,
    ui0=None,
    z0=None,
):
    """B independent covariance-selection instances — a COHORT of
    subjects, each with its own (m, p) sample matrix ``Ds[b]`` and
    penalty ``lams[b]`` — each solved by sample-sharded consensus ADMM,
    as ONE GSPMD program over a 2-D (lanes x shards) mesh: the
    matrix-iterate tier of the library's 2-D composition
    (consensus_lasso_batch's pattern with (p, p) spectral local
    proxes).  Per-lane per-shard covariance contributions are
    lane+shard sharded; converged lanes freeze via the vmapped
    while_loop rule.  Returns models.batch.BatchResults with matrix
    iterates reshaped to (B, p, p) (``extra['xi']``/``['ui']`` as
    (B, W, p, p) for resume)."""
    from jax.sharding import PartitionSpec

    if prox_method not in ("eigh", "ns", "ns_fast"):
        raise ValueError(
            f"prox_method must be 'eigh', 'ns' or 'ns_fast', got {prox_method!r}")
    if prox_method == "ns_fast":
        ns_coarse, ns_correct = ns_iters, max(int(ns_correct), 2)
    if mesh is None:
        mesh = make_mesh2d(1, jax.device_count())
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"consensus_covsel_batch needs a 2-D (lanes, shards) mesh; got "
            f"axes {mesh.axis_names}")
    lane_ax, shard_ax = mesh.axis_names
    L, Wdev = mesh.devices.shape
    W = nshards if nshards is not None else Wdev
    if W % Wdev:
        raise ValueError(f"nshards={W} must be a multiple of the mesh "
                         f"shard-axis size {Wdev}")

    Ds = np.asarray(Ds)
    if Ds.ndim != 3:
        raise ValueError(f"Ds must be (B, m, p) sample stacks, got {Ds.shape}")
    Bn, m, p = Ds.shape
    if Bn % L:
        raise ValueError(
            f"batch size {Bn} must divide over the {L}-device lane axis")
    # Per-lane global centering + normalization, then row-shard each lane.
    Dc = Ds - Ds.mean(axis=1, keepdims=True)
    Dc = Dc / np.sqrt(m - 1)
    mw = -(-m // W)
    Dp = np.zeros((Bn, mw * W, p), Dc.dtype)
    Dp[:, :m] = Dc
    Dib = Dp.reshape(Bn, W, mw, p)

    lane_spec = NamedSharding(mesh, PartitionSpec(lane_ax, shard_ax))
    Dib_dev = jax.device_put(jnp.asarray(Dib), lane_spec)
    Sib = _cached_covsel_batch_setup(lane_spec)(Dib_dev)  # (B, W, p, p)
    dt = Sib.dtype
    lam_spec = NamedSharding(mesh, PartitionSpec(lane_ax))
    data = {
        "Si": Sib,
        "lam": jax.device_put(
            jnp.broadcast_to(jnp.asarray(lams, dt), (Bn,)), lam_spec),
        "wgt": jnp.asarray(1.0 / W, dt),
    }
    local = (_covsel_local_prox if prox_method == "eigh"
             else _covsel_local_prox_ns_fn(int(ns_iters), int(ns_coarse),
                                           int(ns_correct)))

    nn = p * p
    xi0 = (jnp.zeros((Bn, W, nn), dt) if xi0 is None
           else jnp.asarray(xi0, dt).reshape(Bn, W, nn))
    ui0 = (jnp.zeros((Bn, W, nn), dt) if ui0 is None
           else jnp.asarray(ui0, dt).reshape(Bn, W, nn))
    z0 = (jnp.zeros((Bn, nn), dt) if z0 is None
          else jnp.asarray(z0, dt).reshape(Bn, nn))
    xi0 = jax.device_put(xi0, lane_spec)
    ui0 = jax.device_put(ui0, lane_spec)
    z0 = jax.device_put(z0, NamedSharding(mesh, PartitionSpec(lane_ax)))

    config = resolve_unroll(config, "heavy")
    runner = _cached_consensus_batch_runner(
        local, _lasso_global_prox, config, W, nn,
        frozenset({"Si", "lam"}), frozenset(data))

    from ..models.batch import BatchResults

    data, xi0, ui0, z0 = jax.block_until_ready((data, xi0, ui0, z0))
    t0 = time.perf_counter()  # loop-only wall clock
    out = jax.block_until_ready(runner(data, xi0, ui0, z0))
    runtime = time.perf_counter() - t0
    return BatchResults(
        xopt=out["xopt"].reshape(Bn, p, p),
        zopt=out["zopt"].reshape(Bn, p, p),
        uopt=out["uopt"].reshape(Bn, p, p),
        steps=out["steps"], rho_final=out.get("rho_final"),
        runtime=runtime,
        hist={k: v for k, v in out["hist"].items()
              if not isinstance(v, tuple)},
        extra={"xi": out["xi"].reshape(Bn, W, p, p),
               "ui": out["ui"].reshape(Bn, W, p, p),
               "nshards": W, "mesh": mesh,
               "stalled": out["stalled"]},
    )


@functools.lru_cache(maxsize=16)
def _cached_covsel_batch_setup(lane_spec):
    """Per-lane per-shard covariance contributions, jitted once per
    sharding."""

    def body(Dib):
        with jax.default_matmul_precision("highest"):
            G = jnp.einsum("bwmi,bwmj->bwij", Dib, Dib)
            return 0.5 * (G + jnp.swapaxes(G, -1, -2))

    return jax.jit(body, out_shardings=lane_spec)


# ---- 2-D mesh: instance lanes x consensus shards --------------------------


@functools.lru_cache(maxsize=16)
def _cached_lasso_batch_setup(shard_spec, lane_spec, rho):
    """Shared per-shard rho-folded Gram inverse (one dictionary D for the
    whole batch) + per-lane, per-shard D_i^T s_b,i — jitted once per
    (shardings, rho)."""

    def body(Di, Sib):
        with jax.default_matmul_precision("highest"):
            n = Di.shape[-1]
            G = jnp.einsum("wij,wik->wjk", Di, Di)
            G = G + rho * jnp.eye(n, dtype=Di.dtype)[None]
            Minv = jnp.linalg.inv(G)
            Dtsi = jnp.einsum("wij,bwi->bwj", Di, Sib)
            return Minv, Dtsi

    return jax.jit(body, out_shardings=(shard_spec, lane_spec))


@functools.lru_cache(maxsize=16)
def _cached_lasso_batch_setup_dyn(shard_spec, lane_spec):
    """Dynamic-rho variant: batched per-shard Gram eigh (shared) +
    per-lane D_i^T s_b,i."""

    def body(Di, Sib):
        with jax.default_matmul_precision("highest"):
            G = jnp.einsum("wij,wik->wjk", Di, Di)
            G = 0.5 * (G + jnp.swapaxes(G, -1, -2))
            w, V = jnp.linalg.eigh(G)
            Dtsi = jnp.einsum("wij,bwi->bwj", Di, Sib)
            return w, V, Dtsi

    return jax.jit(body, out_shardings=(shard_spec, shard_spec, lane_spec))


def _consensus_ls_batch(
    D, S, penalties, global_prox, config, *, mesh, nshards,
    xi0, ui0, z0, what,
):
    """Shared 2-D-mesh batched consensus core for the shrinkage family:
    per-shard least-squares local solves (shared dictionary D), a
    pluggable replicated global prox, B instance lanes x W row shards in
    one GSPMD program.  ``penalties`` is a dict of scalar-or-(B,) lane
    parameters added to the data pytree (lane-mapped)."""
    from jax.sharding import PartitionSpec

    if mesh is None:
        mesh = make_mesh2d(1, jax.device_count())
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"{what} needs a 2-D (lanes, shards) mesh; got "
            f"axes {mesh.axis_names}")
    lane_ax, shard_ax = mesh.axis_names
    L, Wdev = mesh.devices.shape
    W = nshards if nshards is not None else Wdev
    if W % Wdev:
        raise ValueError(
            f"nshards={W} must be a multiple of the mesh shard-axis size "
            f"{Wdev}")

    D = np.asarray(D)
    S = np.asarray(S)
    m, n = D.shape
    if S.ndim != 2 or S.shape[1] != m:
        raise ValueError(f"S must be (B, {m}) signal lanes, got {S.shape}")
    Bn = S.shape[0]
    if Bn % L:
        raise ValueError(
            f"batch size {Bn} must divide over the {L}-device lane axis")

    Dp, _ = pad_rows(D, W)
    Di = shard_rows(Dp, W)                       # (W, m/W, n)
    Sp = np.pad(S, ((0, 0), (0, Dp.shape[0] - m)))
    Sib = Sp.reshape(Bn, W, -1)                  # (B, W, m/W)

    shard_spec = NamedSharding(mesh, PartitionSpec(shard_ax))
    lane_spec = NamedSharding(mesh, PartitionSpec(lane_ax, shard_ax))
    Di_dev = jax.device_put(jnp.asarray(Di), shard_spec)
    Sib_dev = jax.device_put(jnp.asarray(Sib), lane_spec)

    rdtype = Di_dev.dtype
    if config.dynamic_rho:
        w, V, Dtsi = _cached_lasso_batch_setup_dyn(shard_spec, lane_spec)(
            Di_dev, Sib_dev)
        local_prox, data = _lasso_local_prox_dynamic, {"w": w, "V": V,
                                                       "Dtsi": Dtsi}
    else:
        Minv, Dtsi = _cached_lasso_batch_setup(
            shard_spec, lane_spec, float(config.rho))(Di_dev, Sib_dev)
        local_prox, data = _lasso_local_prox, {"Minv": Minv, "Dtsi": Dtsi}
    lam_spec = NamedSharding(mesh, PartitionSpec(lane_ax))
    mapped = {"Dtsi"}
    for key, val in penalties.items():
        data[key] = jax.device_put(
            jnp.broadcast_to(jnp.asarray(val, rdtype), (Bn,)), lam_spec)
        mapped.add(key)

    state_spec = lane_spec
    z_spec = NamedSharding(mesh, PartitionSpec(lane_ax))
    xi0 = (jnp.zeros((Bn, W, n), rdtype) if xi0 is None
           else jnp.asarray(xi0, rdtype))
    ui0 = (jnp.zeros((Bn, W, n), rdtype) if ui0 is None
           else jnp.asarray(ui0, rdtype))
    z0 = jnp.zeros((Bn, n), rdtype) if z0 is None else jnp.asarray(z0, rdtype)
    if xi0.shape != (Bn, W, n) or ui0.shape != (Bn, W, n):
        raise ValueError(
            f"xi0/ui0 must have shape {(Bn, W, n)}; got "
            f"{xi0.shape}/{ui0.shape}")
    if z0.shape != (Bn, n):
        raise ValueError(f"z0 must have shape {(Bn, n)}; got {z0.shape}")
    xi0 = jax.device_put(xi0, state_spec)
    ui0 = jax.device_put(ui0, state_spec)
    z0 = jax.device_put(z0, z_spec)

    # Same GEMV-class body as consensus_admm; lanes amortize some of the
    # loop turn on their own.
    config = resolve_unroll(config, "gemv")
    runner = _cached_consensus_batch_runner(
        local_prox, global_prox, config, W, n,
        frozenset(mapped), frozenset(data))

    from ..models.batch import BatchResults

    data, xi0, ui0, z0 = jax.block_until_ready((data, xi0, ui0, z0))
    t0 = time.perf_counter()  # loop-only wall clock
    out = jax.block_until_ready(runner(data, xi0, ui0, z0))
    return BatchResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], rho_final=out.get("rho_final"),
        runtime=time.perf_counter() - t0,
        hist={k: v for k, v in out["hist"].items()
              if not isinstance(v, tuple)},
        extra={"xi": out["xi"], "ui": out["ui"], "nshards": W, "mesh": mesh,
               "stalled": out["stalled"]},  # (B,) per-lane plateau flags
    )


def consensus_lasso_batch(
    D,
    S,
    lams,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
):
    """B independent LASSO instances — one shared dictionary ``D``, a
    per-lane signal ``S[b]`` and penalty ``lams[b]`` — each solved by
    consensus ADMM with its data rows sharded W ways, as ONE jitted
    GSPMD program over a 2-D (lanes x shards) mesh.

    This composes the library's two data-parallel axes (lane-sharded
    batches, models/batch.py, and row-sharded consensus, the reference's
    getProxOps.m:367-442): several cards run both at once — instance lanes
    spread over one mesh axis, each lane's consensus collectives riding
    the other.  The per-iteration collective payload stays 2n floats per
    lane (xbar/ubar means over the shard axis); the lane axis needs no
    communication at all beyond the while_loop's scalar continue-
    predicate.  Converged lanes freeze via JAX's while_loop batching
    rule, exactly as in the engine's vmapped paths.

    ``mesh`` must be 2-D (lanes, shards), e.g. ``make_mesh2d(2, 4)``;
    defaults to 1 lane x all devices.  B must divide over the lane axis
    and ``nshards`` (default: the shard-axis size) over the shard axis.
    ``xi0``/``ui0`` (B, W, n) and ``z0`` (B, n) warm-start the lanes.
    Returns stacked per-lane results (models.batch.BatchResults) with
    the final sharded per-lane xi/ui in ``extra`` for resume.
    """
    return _consensus_ls_batch(
        D, S, {"lam": lams}, _lasso_global_prox, config, mesh=mesh,
        nshards=nshards, xi0=xi0, ui0=ui0, z0=z0,
        what="consensus_lasso_batch")


def consensus_elasticnet_batch(
    D,
    S,
    lams,
    alphas=0.5,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
):
    """Elastic net over the 2-D (lanes x shards) mesh: the second
    instantiation of the batched consensus core — same per-shard
    least-squares local solves, global shrink-and-rescale prox at
    per-lane (lam, alpha) (see consensus_elasticnet).  ``alphas=1``
    recovers consensus_lasso_batch exactly."""
    a = np.asarray(alphas, dtype=np.float64)
    if np.any(a < 0.0) or np.any(a > 1.0):
        raise ValueError(f"alphas must be in [0, 1], got {alphas}")
    return _consensus_ls_batch(
        D, S, {"lam": lams, "alpha": alphas}, _elasticnet_global_prox,
        config, mesh=mesh, nshards=nshards, xi0=xi0, ui0=ui0, z0=z0,
        what="consensus_elasticnet_batch")


def consensus_elasticnet(
    D,
    s,
    lam,
    alpha=0.5,
    config: ADMMConfig = ADMMConfig(),
    *,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    xi0=None,
    ui0=None,
    z0=None,
) -> ADMMResults:
    """Elastic net by consensus ADMM — the second instantiation of the
    generic consensus engine (the reference's slice pattern,
    admm.m:343-467, applied beyond its lasso case): same per-shard
    least-squares x-solves as consensus_lasso, global z-prox the
    elastic-net shrink-and-rescale at threshold lam*alpha/(rho W)
    (models/elasticnet._prox_g with the consensus 1/W weighting).
    ``alpha=1`` recovers consensus_lasso exactly.
    """
    if not 0.0 <= float(alpha) <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    local_prox, data, n, mesh, W = _sharded_ls_setup(D, s, config, mesh,
                                                     nshards)
    dt = data["Dtsi"].dtype
    data["lam"] = jnp.asarray(lam, dt)
    data["alpha"] = jnp.asarray(alpha, dt)
    return consensus_admm(
        local_prox, _elasticnet_global_prox, data, n, config,
        mesh=mesh, nshards=W, xi0=xi0, ui0=ui0, z0=z0,
    )
