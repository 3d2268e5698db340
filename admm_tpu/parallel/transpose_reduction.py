"""Distributed unwrapped ADMM with transpose reduction.

The reference's clearest multi-node pattern (solvers/unwrappedadmm.m:96-141
+ zminParallelLinearSVM, getProxOps.m:1120-1143): rows of D are sliced
across workers; each iteration does

    d_i = D_i^T (z_i - u_i)        [local matvec]
    d   = sum_i d_i                [all-reduce]
    x   = W^{-1} d,  W = sum_i D_i^T D_i   [replicated solve]
    z_i = prox_g(D_i x + u_i, ...) [local]
    u_i = u_i + D_i x - z_i        [local]

Design: one jitted XLA program over row-sharded (W, m/W, ...) arrays;
the reduce-sum is a psum of an n-vector per iteration, and the
replicated solve is a single n-by-n GEMV against the precomputed W^{-1}
(the reference solves W \\ d every iteration, unwrappedadmm.m:139).

Stopping preserved from the unwrapped driver (unwrappedadmm.m:81-92):
stopcond='both' with nodualerror — primal Boyd test OR H-norm test.

Engine-variant parity: in the reference, unwrappedadmm passes the options
struct straight to admm (unwrappedadmm.m:94), so fast/accelerated
(admm.m:563-600), relaxation (admm.m:515-532), the dual Boyd test
(admm.m:639-658), the convtest divergence monitor (admm.m:686-703) and
adaptive rho (admm.m:724-741) all apply on its parallel path too.  The
sharded runner implements the same update algebra (momentum/restart state
is per-shard elementwise; the d-value and H-norm aggregates are global
sums XLA lowers to all-reduces).  The x-update x = W^+ (sum_i D_i^T s_i)
is rho-independent, so rho adaptation never triggers a refactorization.

Padding note: rows are zero-padded to equal shards.  Padded rows carry a
zero mask entry so prox/objective treat them as absent; their z/u start
at zero and stay zero-coupled (D_i x = 0 on zero rows).
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
from ..ops.prox import hinge_prox, zero_one_prox
from ..results import ADMMResults
from .mesh import make_mesh, pad_rows, shard_rows


@jax.jit
def _gram_pinv(Di):
    """One-time gram reduction: W_g = sum_i D_i^T D_i
    (unwrappedadmm.m:96-123) — psum of per-shard grams — then a
    replicated pseudo-inverse (pinv, matching the serial driver's
    pinv(D): rank-deficient or underdetermined D degrades gracefully).
    Module-level jit so repeat solves reuse the compiled setup."""
    with jax.default_matmul_precision("highest"):
        G = jnp.einsum("wij,wik->jk", Di, Di)
        return jnp.linalg.pinv(0.5 * (G + G.T))


def unwrapped_admm_sharded(
    prox_g_shard: Callable,
    D,
    config: ADMMConfig = ADMMConfig(),
    *,
    aux=None,
    obj_shard: Optional[Callable] = None,
    obj_global: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
    nshards: Optional[int] = None,
    seed: int = 0,
    x0=None,
    z0=None,
    u0=None,
) -> ADMMResults:
    """Row-sharded unwrapped ADMM.

    ``prox_g_shard(Dx_i, z_i, u_i, rho, aux_i)`` maps per-shard arrays of
    shape (W, m/W) -> new z_i; under relaxation the first argument is the
    relaxed Axhat_i, exactly as the serial engine hands prox_g
    (admm.m:515-532).  ``aux`` is a pytree of per-row arrays (shape
    (m, ...)) sharded alongside D (e.g. labels + pad mask).
    ``obj_shard(x, Dx_i, z_i, aux_i)`` returns a per-call scalar summed
    over shards; ``obj_global(x)`` adds the replicated term.

    ``x0`` (n,) / ``z0`` / ``u0`` (m,) warm-start the solve (reference
    options.x0/z0/u0, admm.m:252-254), overriding the driver's random
    start.
    """
    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    W = nshards if nshards is not None else mesh.devices.size
    if W < mesh.devices.size:
        mesh = make_mesh(W, axis)
    elif W % mesh.devices.size:
        # More shards than devices batches slices per device (see
        # consensus.py) — allowed when the stacked axis shards evenly.
        raise ValueError(
            f"nshards={W} must be a multiple of the mesh size "
            f"{mesh.devices.size}")

    D = np.asarray(D)
    m, n = D.shape
    Dp, n_pad = pad_rows(D, W)
    mp = Dp.shape[0]
    Di = shard_rows(Dp, W)  # (W, m/W, n)

    def _shard_aux(a):
        ap, _ = pad_rows(np.asarray(a), W)
        return shard_rows(ap, W)

    aux_i = jax.tree_util.tree_map(_shard_aux, aux) if aux is not None else ()

    shard_spec = NamedSharding(mesh, P(axis))
    Di_dev = jax.device_put(jnp.asarray(Di), shard_spec)
    aux_dev = jax.tree_util.tree_map(
        lambda a: jax.device_put(jnp.asarray(a), shard_spec), aux_i
    )

    Winv = _gram_pinv(Di_dev)

    # Random start in the valid region, zeros on padding
    # (unwrappedadmm.m:89-91); explicit x0/z0/u0 override (admm.m:252-254).
    kx, kz, ku = jax.random.split(jax.random.PRNGKey(seed), 3)
    dtype = Di.dtype
    if x0 is not None and np.shape(x0) != (n,):
        raise ValueError(f"x0 must have shape {(n,)}; got {np.shape(x0)}")
    x0 = (jax.random.uniform(kx, (n,), dtype=dtype) if x0 is None
          else jnp.asarray(x0, dtype))
    mrow = np.zeros((mp,), dtype=dtype)
    mrow[:m] = 1.0
    mask = jax.device_put(jnp.asarray(shard_rows(mrow, W)), shard_spec)

    def _row_state(v0, key, name):
        if v0 is None:
            return jax.random.uniform(key, (mp,), dtype=dtype).reshape(W, mp // W)
        if np.shape(v0) != (m,):
            # Silent zero-padding of a mis-sized warm start would run a
            # subtly wrong solve; validate like consensus_admm does.
            raise ValueError(f"{name} must have shape {(m,)}; got "
                             f"{np.shape(v0)}")
        vp, _ = pad_rows(np.asarray(v0, dtype), W)
        return jnp.asarray(shard_rows(vp, W))

    z0 = _row_state(z0, kz, "z0")
    u0 = _row_state(u0, ku, "u0")

    config = resolve_unroll(config, "gemv")  # per-shard matvec body
    runner = _cached_unwrapped_runner(prox_g_shard, obj_shard, obj_global, config, m)
    jax.block_until_ready((Winv, x0, z0, u0, mask, aux_dev))
    t0 = time.perf_counter()  # loop-only wall clock (setup flushed above)
    out = jax.block_until_ready(runner(Di_dev, Winv, x0, z0, u0, mask, aux_dev))
    runtime = time.perf_counter() - t0
    res = ADMMResults.from_raw(out, config)
    res.runtime = runtime
    res.extra["nshards"] = W
    res.extra["mesh"] = mesh
    res.extra["n_pad"] = n_pad
    return res


def _make_unwrapped_run(prox_g_shard, obj_shard, obj_global,
                        config: ADMMConfig, m: int):
    """Build the (unjitted) unwrapped-ADMM iteration program
    ``run(Di, Winv, x0, z0, u0, mask, aux_i) -> raw dict``.

    Implements the core engine's full variant set over the sharded state
    (see module docstring): update order and momentum algebra mirror
    engine._build_runner with A = D, B = -I, c = 0 specialized per shard
    (B.mv(z) = -z, so Axhat = relax*Dx + (1-relax)*zprev and the dual
    update is base + Axr - z)."""
    # Anderson acceleration (ADMMConfig.anderson) on the TR map: the
    # fixed-point state is the sharded row-space pair (z, u) — x is
    # DERIVED each sweep (x = Winv @ psum(Diᵀ(z - u))).  Window dot
    # products contract over the sharded rows (GSPMD all-reduce); the
    # (m, m) solve is replicated.  The padded-row mask survives AA
    # (linear combinations of masked vectors stay masked).  Note the
    # reference-parity SVM wrapper forces stopcond='both'
    # (unwrappedadmm.m:88), which config validation rejects under AA —
    # AA reaches this runner only through standard-stop configs on the
    # generic unwrapped_admm_sharded path.
    use_aa = config.anderson > 0
    m_aa = int(config.anderson)
    N = int(config.maxiters)
    rho0 = float(config.rho)
    needs_h = config.needs_hnorm
    alg = config.alg
    relax = float(config.relax)
    use_relax = relax != 1.0
    std_stop = config.stopcond in ("standard", "both")
    h_stop = config.stopcond in ("hnorm", "both")
    need_dual = not config.nodualerror
    use_stall = config.use_stall  # plateau detector (engine parity)

    def run(Di, Winv, x0, z0, u0, mask, aux_i):
        rdtype = x0.dtype
        rho_init = jnp.asarray(rho0, rdtype)
        eps = jnp.finfo(rdtype).eps
        z0 = z0 * mask
        u0 = u0 * mask
        nan_hist = lambda: jnp.full((N,), jnp.nan, rdtype)
        M1 = float(m)  # true row count (padding excluded from the error bar)
        M2 = float(m)  # Bz entries (B = -I over the m rows)
        sc = lambda v=jnp.nan: jnp.asarray(v, rdtype)

        hist0 = {
            "pnorm": nan_hist(), "perr": nan_hist(),
            # Always present (NaN under nodualerror), so the
            # ADMMResults.dnorm/.derr accessors behave exactly as on a
            # serial-engine result.
            "dnorm": nan_hist(), "derr": nan_hist(),
            "Hnormsq": nan_hist() if needs_h else (),
            "dvals": nan_hist() if alg == 2 else (),
            "avals": nan_hist() if alg else (),
            "restarted": jnp.zeros((N,), jnp.int32) if alg == 2 else (),
            # Opt-in x trace (the replicated iterate).  The row-space
            # z/u state is sharded (W, m/W) and would multiply the HBM
            # trace cost; the final zopt/uopt return as usual.
            "xvals": jnp.zeros((N, x0.shape[0]), rdtype)
            if config.record_iterates else (),
        }
        carry0 = {
            "k": jnp.asarray(0, jnp.int32),
            "x": x0, "z": z0, "u": u0, "rho": rho_init,
            # fast / accelerated state (engine carry v/uhat/a/d)
            "v": z0 if alg else (), "uhat": u0 if alg else (),
            "a": sc(1.0) if alg else (), "d": sc(jnp.inf) if alg == 2 else (),
            # H-norm w-parts + previous Hsq (admm.m:302-313)
            "wz": z0 if needs_h else (),
            "wu": rho_init * u0 if needs_h else (),
            "Hprev": sc(jnp.inf) if needs_h else (),
            "done": jnp.asarray(False), "diverged": jnp.asarray(False),
            "stalled": jnp.asarray(False),
            "best_p": sc(jnp.inf) if use_stall else (),
            "since": jnp.asarray(0, jnp.int32) if use_stall else (),
            "aFz": jnp.zeros((m_aa + 1,) + z0.shape, rdtype)
            if use_aa else (),
            "aTz": jnp.zeros((m_aa + 1,) + z0.shape, rdtype)
            if use_aa else (),
            "aFu": jnp.zeros((m_aa + 1,) + u0.shape, rdtype)
            if use_aa else (),
            "aTu": jnp.zeros((m_aa + 1,) + u0.shape, rdtype)
            if use_aa else (),
            "acnt": jnp.asarray(0, jnp.int32) if use_aa else (),
            "abest": sc(jnp.inf) if use_aa else (),
            "hist": hist0,
        }

        def cond(c):
            return jnp.logical_and(c["k"] < N, jnp.logical_not(c["done"]))

        def step(c, frozen):
            # freeze gating (engine.freeze_helpers): literal False at
            # K=1, traced scalar under unroll.
            sel, sel_slot = freeze_helpers(frozen)
            k = c["k"]
            i = k + 1
            rho = c["rho"]
            x, zi, ui = c["x"], c["z"], c["u"]
            zprev = zi

            # ---- x-update (admm.m:501-511): local matvec + all-reduce +
            # replicated GEMV; fast modes pull back the predictors v/uhat.
            if alg == 0:
                src = zi - ui
                u_base = ui
                dprev = ()
            else:
                aprev, uprev, uhat = c["a"], ui, c["uhat"]
                src = c["v"] - uhat
                u_base = uhat
                dprev = c["d"] if alg == 2 else ()
            di = jnp.einsum("wij,wi->j", Di, src)
            x = Winv @ di
            Dx = jnp.einsum("wij,j->wi", Di, x)

            # ---- relaxation + z-update (admm.m:515-532) ------------------
            if use_relax:
                # B = -I, c = 0: Axhat = relax*Dx - (1-relax)*(-zprev).
                Axr = relax * Dx + (1.0 - relax) * zprev
            else:
                Axr = Dx
            zi = prox_g_shard(Axr, zi, u_base, rho, aux_i) * mask

            # ---- dual update (admm.m:538-552) ----------------------------
            ui = u_base + (Axr - zi) * mask

            # ---- fast / accelerated updates (admm.m:563-600) -------------
            v_new, uhat_new, a_new = c["v"], c["uhat"], c["a"]
            d_new = c["d"]
            restarted_i = ()
            if alg:
                # d = (1/rho)||u - uhat||^2 + rho||B(z - v)||^2 with
                # B = -I over the sharded rows; momentum via the SHARED
                # algebra (engine.fast_update).
                dval = ((1.0 / rho) * jnp.sum((ui - uhat) ** 2)
                        + rho * jnp.sum((zi - c["v"]) ** 2)
                        ) if alg == 2 else None
                v_new, uhat_new, a_new, d2, r2 = fast_update(
                    alg, config, aprev=aprev, dprev=dprev, z=zi,
                    zprev=zprev, u=ui, uprev=uprev, v=c["v"], dval=dval)
                if alg == 2:
                    d_new, restarted_i = d2, r2

            # ---- norms + Boyd errors (admm.m:612-658).  pnorm uses the
            # true residual Dx - z (unrelaxed), exactly as the engine.
            r = (Dx - zi) * mask
            pnorm = jnp.sqrt(jnp.sum(r * r))
            perr = jnp.sqrt(M1) * config.abstol + config.reltol * jnp.maximum(
                jnp.sqrt(jnp.sum((Dx * mask) ** 2)), jnp.sqrt(jnp.sum(zi * zi))
            )
            if need_dual:
                # dnorm = ||rho * D^T(B(z - zref))||, zref = v_new under
                # alg 1 (admm.m:624-637); derr = sqrt(M2)*ABSTOL +
                # RELTOL*||rho * D^T u|| (admm.m:645-658).
                dz = zi - (v_new if alg == 1 else zprev)
                dnorm = rho * jnp.sqrt(jnp.sum(
                    jnp.einsum("wij,wi->j", Di, dz) ** 2))
                derr = (jnp.sqrt(M2) * config.abstol + config.reltol * rho
                        * jnp.sqrt(jnp.sum(jnp.einsum("wij,wi->j", Di, ui) ** 2)))
            else:
                dnorm = sc()
                derr = sc()

            # ---- H-norm / divergence monitor (admm.m:676-703) ------------
            Hsq = ()
            diverged_i = jnp.asarray(False)
            if config.nanguard:
                diverged_i = diverged_i | jnp.logical_not(jnp.isfinite(pnorm))
            wz_new = wu_new = ()
            if needs_h:
                # H uses the setup-time rho (MATLAB closure capture,
                # admm.m:305-306); w carries the current rho.
                wz_new, wu_new = zi, rho * ui
                Hsq = (rho0 * jnp.sum((c["wz"] - wz_new) ** 2)
                       + rho0 * jnp.sum((c["wu"] - wu_new) ** 2))
                if config.convtest and alg == 0:
                    H1 = c["Hprev"]
                    diverged_i = diverged_i | (
                        (i >= 2) & (H1 > eps) & (Hsq > H1)
                        & ((Hsq - H1) > H1 * config.convtol)
                    )

            # ---- plateau detector (ADMMConfig.stallwindow) ----------------
            stall_i = jnp.asarray(False)
            if use_stall:
                improved = pnorm < c["best_p"] * (1.0 - config.stalltol)
                best_new = jnp.minimum(c["best_p"], pnorm)
                since_new = jnp.where(improved, 0,
                                      c["since"] + 1).astype(jnp.int32)
                stall_i = since_new >= config.stallwindow
            else:
                best_new, since_new = (), ()

            # ---- stopping (admm.m:705-722) -------------------------------
            stop = jnp.asarray(False)
            if alg == 2:
                stop = (i >= 2) & (jnp.abs(d_new - dprev)
                                   <= config.dvaltol * dprev)
            elif std_stop and not config.domaxiters:
                dual_ok = (jnp.asarray(True) if not need_dual
                           else (dnorm < derr))
                stop = (pnorm < perr) & dual_ok
            if h_stop and not config.domaxiters and needs_h:
                stop = stop | ((i > 2) & (Hsq <= config.hnormtol))
            done = stop | diverged_i | stall_i

            # ---- adaptive rho (admm.m:724-741 / ADMMConfig.rbadaptive) ---
            rho_new = rho
            if config.adaptive and config.convtest and needs_h:
                rho_new = adaptive_rho_update(
                    config, Hprev=c["Hprev"], Hsq=Hsq, rho=rho, i=i,
                    done=done, eps=eps)
            elif config.rbadaptive and alg == 0:
                factor = residual_balance_factor(
                    config, pnorm=pnorm, dnorm=dnorm, done=done,
                    dtype=rho.dtype)
                rho_new = rho * factor
                ui = ui / factor

            # ---- Anderson acceleration (see use_aa note above): the
            # plain sweep is the map evaluation T(z, u); the candidate
            # only replaces the NEXT iteration's starting state —
            # residuals/stopping/history stay plain-sweep (engine,
            # consensus, and exchange parity).
            z_next, u_next = zi, ui
            if use_aa:
                R = m_aa + 1
                fz = zi - zprev
                fu = ui - c["u"]
                fn2 = jnp.sum(fz * fz) + jnp.sum(fu * fu)
                grew = fn2 > (config.aa_restart ** 2) * c["abest"]
                cnt = jnp.where(grew, 0, c["acnt"])
                abest_new = jnp.where(grew, fn2,
                                      jnp.minimum(c["abest"], fn2))
                slot = (cnt % R).astype(jnp.int32)
                aFz = sel_slot(c["aFz"], slot, fz)
                aTz = sel_slot(c["aTz"], slot, zi)
                aFu = sel_slot(c["aFu"], slot, fu)
                aTu = sel_slot(c["aTu"], slot, ui)
                js = (cnt - m_aa + jnp.arange(R, dtype=jnp.int32)) % R
                dFz = aFz[js][1:] - aFz[js][:-1]
                dTz = aTz[js][1:] - aTz[js][:-1]
                dFu = aFu[js][1:] - aFu[js][:-1]
                dTu = aTu[js][1:] - aTu[js][:-1]
                mk = jnp.minimum(cnt, m_aa)
                vmask = jnp.arange(m_aa) >= (m_aa - mk)
                dFz = jnp.where(vmask[:, None, None], dFz, 0.0)
                dTz = jnp.where(vmask[:, None, None], dTz, 0.0)
                dFu = jnp.where(vmask[:, None, None], dFu, 0.0)
                dTu = jnp.where(vmask[:, None, None], dTu, 0.0)
                G = (jnp.einsum("awi,bwi->ab", dFz, dFz)
                     + jnp.einsum("awi,bwi->ab", dFu, dFu))
                lam = config.aa_reg * jnp.trace(G) + eps
                gamma = jnp.linalg.solve(
                    G + lam * jnp.eye(m_aa, dtype=rdtype),
                    jnp.einsum("awi,wi->a", dFz, fz)
                    + jnp.einsum("awi,wi->a", dFu, fu))
                cz = zi - jnp.einsum("a,awi->wi", gamma, dTz)
                cu = ui - jnp.einsum("a,awi->wi", gamma, dTu)
                ok = (jnp.all(jnp.isfinite(cz)) & jnp.all(jnp.isfinite(cu))
                      & (jnp.sum(jnp.abs(gamma)) <= config.aa_gmax)
                      & (mk >= 1) & jnp.logical_not(done))
                z_next = jnp.where(ok, cz, zi)
                u_next = jnp.where(ok, cu, ui)
                acnt_new = cnt + 1
            else:
                aFz = aTz = aFu = aTu = acnt_new = abest_new = ()

            # ---- history ---------------------------------------------------
            h = dict(c["hist"])
            h["pnorm"] = sel_slot(h["pnorm"], k, pnorm)
            h["perr"] = sel_slot(h["perr"], k, perr)
            if need_dual:
                h["dnorm"] = sel_slot(h["dnorm"], k, dnorm)
                h["derr"] = sel_slot(h["derr"], k, derr)
            if needs_h:
                h["Hnormsq"] = sel_slot(h["Hnormsq"], k, Hsq)
            if alg == 2:
                h["dvals"] = sel_slot(h["dvals"], k, d_new)
                h["restarted"] = sel_slot(h["restarted"], k, restarted_i)
            if alg:
                h["avals"] = sel_slot(h["avals"], k, a_new)
            if config.record_iterates:
                h["xvals"] = sel_slot(h["xvals"], k, x)

            return {
                "k": sel(k, k + 1),
                "x": sel(c["x"], x), "z": sel(c["z"], z_next),
                "u": sel(c["u"], u_next), "rho": sel(c["rho"], rho_new),
                "v": sel(c["v"], v_new) if alg else (),
                "uhat": sel(c["uhat"], uhat_new) if alg else (),
                "a": sel(c["a"], a_new) if alg else (),
                "d": sel(c["d"], d_new) if alg == 2 else (),
                "wz": sel(c["wz"], wz_new) if needs_h else (),
                "wu": sel(c["wu"], wu_new) if needs_h else (),
                "Hprev": sel(c["Hprev"], Hsq) if needs_h else (),
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
                "hist": h,
            }

        body = unrolled_body(step, int(config.unroll), N,
                             lambda c: (c["k"], c["done"]))
        final = lax.while_loop(cond, body, carry0)
        k, x, zi, ui = final["k"], final["x"], final["z"], final["u"]
        diverged = final["diverged"]
        hist = final["hist"]

        objopt = ()
        if obj_shard is not None or obj_global is not None:
            Dx = jnp.einsum("wij,j->wi", Di, x)
            objopt = jnp.asarray(0.0, rdtype)
            if obj_shard is not None:
                objopt = objopt + obj_shard(x, Dx, zi, aux_i)
            if obj_global is not None:
                objopt = objopt + obj_global(x)

        return {
            "steps": k, "xopt": x, "zopt": zi, "uopt": ui,
            "rho_final": final["rho"],
            "diverged": diverged,
            "stalled": final["stalled"],
            "objopt": objopt,
            "hist": hist,
        }

    return run


@functools.lru_cache(maxsize=64)
def _cached_unwrapped_runner(prox_g_shard, obj_shard, obj_global,
                             config: ADMMConfig, m: int):
    """Cross-call compile cache keyed on (prox/objective functions, config,
    true row count) - the same caching contract as the core engine."""
    run = _make_unwrapped_run(prox_g_shard, obj_shard, obj_global, config, m)
    return jax.jit(_highest_precision(run))


@functools.lru_cache(maxsize=32)
def _cached_unwrapped_batch_runner(prox_g_shard, obj_shard, obj_global,
                                   config: ADMMConfig, m: int,
                                   aux_axes):
    """Lane-batched unwrapped runner: vmap the iteration over a leading
    instance axis (per-lane x/z/u state and lane-mapped aux leaves, e.g.
    one-vs-all label rows), shared D/Winv/mask.  Converged lanes freeze
    via the while_loop batching rule (engine.py note).  ``aux_axes`` is
    the hashable in_axes spec for the aux pytree (0 = lane-mapped leaf,
    None = shared)."""
    run = _make_unwrapped_run(prox_g_shard, obj_shard, obj_global, config, m)
    vrun = jax.vmap(run, in_axes=(None, None, 0, 0, 0, None, aux_axes))
    return jax.jit(_highest_precision(vrun))


# Module-level SVM shard functions (caching contract: per-row C rides in
# aux so the compiled runner is shared across calls and C values; per-row
# C also gives per-sample weighting for free).
def _svm_prox_hinge(Dx, zi, ui, rho, aux_i):
    ell_i, mask_i, C_i = aux_i
    return hinge_prox(Dx + ui, ell_i, C_i, rho)


def _svm_prox_01(Dx, zi, ui, rho, aux_i):
    ell_i, mask_i, C_i = aux_i
    # Guard padded rows (C_i = 0 there) against 0-division in rho/C.
    C_safe = jnp.where(C_i > 0, C_i, 1.0)
    return zero_one_prox(Dx + ui, ell_i, C_safe, rho)


def _svm_obj_hinge(x, Dx, zi, aux_i):
    ell_i, mask_i, C_i = aux_i
    return jnp.sum(C_i * jnp.maximum(1.0 - ell_i * Dx, 0.0) * mask_i)


def _svm_obj_01(x, Dx, zi, aux_i):
    ell_i, mask_i, C_i = aux_i
    return jnp.sum(C_i * jnp.maximum(jnp.sign(1.0 - ell_i * Dx), 0.0) * mask_i)


def _svm_obj_global(x):
    return 0.5 * jnp.sum(x * x)


def linearsvm_sharded(
    D, ell, C, config: ADMMConfig = ADMMConfig(), *, loss: str = "hinge",
    mesh: Optional[Mesh] = None, nshards: Optional[int] = None, seed: int = 0,
    x0=None, z0=None, u0=None,
) -> ADMMResults:
    """Distributed linear SVM: the reference's parallel path
    (linearsvm.m:169-206 -> unwrappedadmm parfor branch ->
    zminParallelLinearSVM, getProxOps.m:1120-1143)."""
    ell = np.asarray(ell, dtype=np.asarray(D).dtype)
    use_01 = str(loss).replace("-", "") in ("01", "zeroone")
    mask = np.ones_like(ell)
    Crow = np.full_like(ell, float(C))

    import dataclasses

    # stopping defaults preserved from the unwrapped driver
    cfg = dataclasses.replace(config, stopcond="both", nodualerror=True)
    return unwrapped_admm_sharded(
        _svm_prox_01 if use_01 else _svm_prox_hinge,
        D, cfg,
        aux=(ell, mask, Crow),
        obj_shard=_svm_obj_01 if use_01 else _svm_obj_hinge,
        obj_global=_svm_obj_global,
        mesh=mesh, nshards=nshards, seed=seed, x0=x0, z0=z0, u0=u0,
    )


def svm_batch_sharded(
    D, ells, C, config: ADMMConfig = ADMMConfig(), *, loss: str = "hinge",
    mesh=None, nshards: Optional[int] = None, seed: int = 0,
    x0=None, z0=None, u0=None,
):
    """One-vs-all SVM over a 2-D (lanes x shards) mesh: B classifiers
    (label rows ``ells`` of shape (B, m), shared data matrix ``D``) each
    trained by row-sharded transpose-reduction ADMM, in ONE GSPMD
    program — the other composition of the library's two data-parallel
    axes (mnistsvm's per-digit loop, examples/mnistsvm.m:89-102, over
    several cards; see parallel.consensus.consensus_lasso_batch for the
    consensus counterpart).

    Lanes differ only in labels and state: the per-shard data blocks
    D_i, the gram pseudo-inverse W^+, and the pad mask are shared
    (replicated over the lane axis); each lane's psum of D_i^T v_i rides
    the shard axis.  Per-lane random starts derive from
    fold_in(seed, lane); explicit ``x0`` (B, n) / ``z0``/``u0`` (B, m)
    override.  Returns models.batch.BatchResults with per-lane
    steps/stalled and the replicated xopt stack (B, n).
    """
    from jax.sharding import PartitionSpec
    import dataclasses

    from .mesh import make_mesh2d

    if mesh is None:
        mesh = make_mesh2d(1, jax.device_count())
    if len(mesh.axis_names) != 2:
        raise ValueError(
            f"svm_batch_sharded needs a 2-D (lanes, shards) mesh; got "
            f"axes {mesh.axis_names}")
    lane_ax, shard_ax = mesh.axis_names
    L, Wdev = mesh.devices.shape
    W = nshards if nshards is not None else Wdev
    if W % Wdev:
        raise ValueError(
            f"nshards={W} must be a multiple of the mesh shard-axis size "
            f"{Wdev}")

    D = np.asarray(D)
    m, n = D.shape
    ells = np.asarray(ells, dtype=D.dtype)
    if ells.ndim != 2 or ells.shape[1] != m:
        raise ValueError(f"ells must be (B, {m}) label lanes, got {ells.shape}")
    Bn = ells.shape[0]
    if Bn % L:
        raise ValueError(
            f"batch size {Bn} must divide over the {L}-device lane axis")

    use_01 = str(loss).replace("-", "") in ("01", "zeroone")
    cfg = dataclasses.replace(config, stopcond="both", nodualerror=True)
    cfg = resolve_unroll(cfg, "gemv")

    Dp, _ = pad_rows(D, W)
    mp = Dp.shape[0]
    mw = mp // W
    Di = shard_rows(Dp, W)
    shard_spec = NamedSharding(mesh, P(shard_ax))
    lane_spec = NamedSharding(mesh, P(lane_ax, shard_ax))
    Di_dev = jax.device_put(jnp.asarray(Di), shard_spec)
    Winv = _gram_pinv(Di_dev)

    mrow = np.zeros((mp,), dtype=D.dtype)
    mrow[:m] = 1.0
    mask = jax.device_put(jnp.asarray(shard_rows(mrow, W)), shard_spec)
    Crow = jax.device_put(
        jnp.asarray(shard_rows(np.full((mp,), float(C), D.dtype), W)),
        shard_spec)
    ellp = np.pad(ells, ((0, 0), (0, mp - m)))
    ell_dev = jax.device_put(jnp.asarray(ellp.reshape(Bn, W, mw)), lane_spec)

    dtype = D.dtype
    keys = jax.vmap(lambda b: jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), b), 3))(jnp.arange(Bn))
    if x0 is None:
        x0 = jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=dtype))(
            keys[:, 0])
    else:
        if np.shape(x0) != (Bn, n):
            raise ValueError(f"x0 must have shape {(Bn, n)}; got {np.shape(x0)}")
        x0 = jnp.asarray(x0, dtype)

    def _row_state(v0, kcol, name):
        if v0 is None:
            return jax.vmap(lambda k: jax.random.uniform(
                k, (mp,), dtype=dtype).reshape(W, mw))(kcol)
        if np.shape(v0) != (Bn, m):
            raise ValueError(f"{name} must have shape {(Bn, m)}; got "
                             f"{np.shape(v0)}")
        vp = np.pad(np.asarray(v0, dtype), ((0, 0), (0, mp - m)))
        return jnp.asarray(vp.reshape(Bn, W, mw))

    z0 = _row_state(z0, keys[:, 1], "z0")
    u0 = _row_state(u0, keys[:, 2], "u0")
    x0 = jax.device_put(x0, NamedSharding(mesh, PartitionSpec(lane_ax)))
    z0 = jax.device_put(z0, lane_spec)
    u0 = jax.device_put(u0, lane_spec)

    runner = _cached_unwrapped_batch_runner(
        _svm_prox_01 if use_01 else _svm_prox_hinge,
        _svm_obj_01 if use_01 else _svm_obj_hinge,
        _svm_obj_global, cfg, m, (0, None, None))
    aux_dev = (ell_dev, mask, Crow)
    jax.block_until_ready((Di_dev, Winv, x0, z0, u0, mask, aux_dev))
    t0 = time.perf_counter()  # loop-only wall clock
    out = jax.block_until_ready(
        runner(Di_dev, Winv, x0, z0, u0, mask, aux_dev))
    runtime = time.perf_counter() - t0

    from ..models.batch import BatchResults

    return BatchResults(
        xopt=out["xopt"], zopt=out["zopt"], uopt=out["uopt"],
        steps=out["steps"], objopt=out.get("objopt"),
        rho_final=out.get("rho_final"), runtime=runtime,
        hist={k: v for k, v in out["hist"].items()
              if not isinstance(v, tuple)},
        extra={"stalled": out["stalled"], "nshards": W, "mesh": mesh},
    )
