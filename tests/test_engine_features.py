"""Engine-variant coverage: relaxation, fast/accelerated + restart,
H-norm stopping, divergence monitor, adaptive rho, domaxiters, hooks
(reference admm.m:264-298, 473-600, 676-741)."""

import numpy as np
import pytest

from admm_tpu import ADMMConfig, Hooks, admm
from admm_tpu.models.model import make_prox_ops, model


def _instance(seed=7, m=64, n=48):
    rng = np.random.default_rng(seed)
    P, Q = rng.standard_normal((m, n)), rng.standard_normal((m, n))
    r, s = rng.standard_normal(m), rng.standard_normal(m)
    truex = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    return P, Q, r, s, truex


@pytest.mark.parametrize(
    "kw",
    [
        dict(fast=True, fasttype="strong"),
        dict(fast=True, fasttype="weak"),
        dict(relax=1.5),
        dict(relax=0.8),
        dict(stopcond="hnorm"),
    ],
)
def test_variants_converge(kw):
    P, Q, r, s, truex = _instance()
    res = model(P, Q, r, s, ADMMConfig(maxiters=5000, **kw))
    assert not res.diverged
    assert np.linalg.norm(np.asarray(res.xopt) - truex) < 1e-2


def test_accelerated_records_dvals_and_restarts():
    P, Q, r, s, truex = _instance()
    res = model(P, Q, r, s, ADMMConfig(maxiters=2000, fast=True, fasttype="weak"))
    assert res.dvals is not None and len(res.dvals) == res.steps
    assert res.restarted is not None
    # Momentum values recorded (reference avals, admm.m:596-599).
    assert "avals" in res.hist


def test_record_iterates_traces():
    """record_iterates captures x/z/u (and v/uhat in accelerated modes)
    per iteration (reference admm.m:596-610)."""
    P, Q, r, s, _ = _instance()
    cfg = ADMMConfig(maxiters=50, domaxiters=True, record_iterates=True,
                     fast=True, fasttype="strong")
    res = model(P, Q, r, s, cfg)
    for key in ("xvals", "zvals", "uvals", "vvals", "uhatvals"):
        assert key in res.hist, key
        assert res.hist[key].shape[0] == 50
    assert np.all(np.isfinite(np.asarray(res.hist["xvals"])))


def test_domaxiters_runs_exactly_n():
    P, Q, r, s, _ = _instance()
    res = model(P, Q, r, s, ADMMConfig(maxiters=37, domaxiters=True))
    assert res.steps == 37


def test_divergence_monitor_catches_broken_prox():
    """The fault-injection property (reference
    examples/convergencechecking.m:124-141): a sign-flipped prox must trip
    the H-norm monitor (admm.m:686-703)."""
    P, Q, r, s, _ = _instance()
    cfg = ADMMConfig(convtest=True, maxiters=100)
    from admm_tpu.models._common import bind_data

    pf, pg, obj = bind_data(*make_prox_ops(P, Q, r, s, cfg))

    def bad_pf(x, z, u, rho):
        return -pf(x, z, u, rho)

    res = admm(bad_pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=48)
    assert res.diverged
    assert res.steps < 100

    # Correct proxes must NOT trip it.
    res_ok = admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=48)
    assert not res_ok.diverged


def test_nanguard_aborts_on_nonfinite():
    """nanguard (no reference analog): a prox that detonates to NaN must
    flip results.diverged within a couple of steps instead of running the
    whole budget."""
    import jax.numpy as jnp

    P, Q, r, s, _ = _instance()
    from admm_tpu.models._common import bind_data
    from admm_tpu.models.model import make_prox_ops

    cfg = ADMMConfig(maxiters=500)
    pf, pg, obj = bind_data(*make_prox_ops(P, Q, r, s, cfg))

    def nan_pf(x, z, u, rho):
        return pf(x, z, u, rho) / 0.0 * 0.0  # NaN

    res = admm(nan_pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=48)
    assert res.diverged
    assert res.steps <= 3


def test_adaptive_rho_runs_and_changes_rho():
    """Adaptive rho is experimental in the reference (admm.m:724-741) —
    assert mechanical correctness (runs, changes rho, finite outputs),
    not accuracy."""
    P, Q, r, s, _ = _instance()
    res = model(P, Q, r, s, ADMMConfig(adaptive=True, convtest=True, maxiters=500))
    assert np.isfinite(np.asarray(res.xopt)).all()
    assert res.rho_final != 1.0


def test_altu_and_specialnorms_hooks():
    """altu replaces the dual update (admm.m:553-560); specialnorms
    replaces the residual norms (admm.m:612-616)."""
    P, Q, r, s, truex = _instance()
    # Fixed iteration count: the hooks change the *recorded norms* (and
    # hence stopping), so compare trajectories at identical step counts.
    cfg = ADMMConfig(maxiters=60, domaxiters=True)
    from admm_tpu.models._common import bind_data

    pf, pg, obj = bind_data(*make_prox_ops(P, Q, r, s, cfg))

    def altu(u, Ax, Bz, c):
        return u + (Ax + Bz - c)  # the standard update, via the hook

    def specialnorms(x, z, u, rho):
        import jax.numpy as jnp

        pn = 2.0 * jnp.linalg.norm(x - z)  # deliberately != standard pnorm
        dn = rho * jnp.linalg.norm(z)
        return pn, dn

    res = admm(
        pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=48,
        hooks=Hooks(altu=altu, specialnorms=specialnorms),
    )
    # altu == standard update, so the trajectory must match the plain solve.
    base = admm(pf, pg, cfg, A=1.0, B=-1.0, c=0.0, m=48)
    assert res.steps == base.steps == 60
    np.testing.assert_allclose(
        np.asarray(res.xopt), np.asarray(base.xopt), atol=1e-10
    )
    # The recorded norms must be the hook's values, not the standard ones.
    assert not np.allclose(res.pnorm, base.pnorm)


def test_vmap_batched_instances():
    """The engine is vmappable over problem instances (batched scenario
    solves, BASELINE.json); finished lanes freeze via the done mask."""
    import jax
    import jax.numpy as jnp

    from admm_tpu.engine import make_admm_runner
    from admm_tpu.ops.solve import SymShiftSolver

    rng = np.random.default_rng(0)
    B_, n = 4, 24
    Ps = rng.standard_normal((B_, 48, n))
    Qs = rng.standard_normal((B_, 48, n))
    rs = rng.standard_normal((B_, 48))
    ss = rng.standard_normal((B_, 48))

    cfg = ADMMConfig(maxiters=3000, jit=True)

    def solve_one(P, Q, r, s):
        PtP, QtQ = P.T @ P, Q.T @ Q
        Ptr, Qts = P.T @ r, Q.T @ s
        sP = SymShiftSolver.from_matrix(PtP)
        sQ = SymShiftSolver.from_matrix(QtQ)
        pf = lambda x, z, u, rho: sP.solve(Ptr + rho * (z - u), rho)
        pg = lambda x, z, u, rho: sQ.solve(Qts + rho * (x + u), rho)
        run = make_admm_runner(pf, pg, cfg, 1.0, -1.0)
        zeros = jnp.zeros(n)
        out = run(zeros, zeros, zeros, zeros)
        return out["xopt"], out["steps"]

    xs, steps = jax.jit(jax.vmap(solve_one))(Ps, Qs, rs, ss)
    for b in range(B_):
        truex = np.linalg.solve(
            Ps[b].T @ Ps[b] + Qs[b].T @ Qs[b], Ps[b].T @ rs[b] + Qs[b].T @ ss[b]
        )
        assert np.linalg.norm(np.asarray(xs[b]) - truex) < 1e-2
    # Lanes converge at different iteration counts.
    assert len(set(np.asarray(steps).tolist())) >= 1


def test_wvals_trace():
    """record_iterates must also record the stacked w = [x; z; rho*u]
    (reference admm.m:680-682)."""
    P, Q, r, s, truex = _instance()
    res = model(P, Q, r, s, ADMMConfig(maxiters=500, record_iterates=True))
    w = res.wvals
    n = len(truex)
    assert w is not None and w.shape == (res.steps, 3 * n)
    k = res.steps - 1
    expect = np.concatenate([
        res.trace("xvals")[k],
        res.trace("zvals")[k],
        res.rho_final * res.trace("uvals")[k],
    ])
    np.testing.assert_allclose(w[k], expect, rtol=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(fast=True, fasttype="weak"),
                                dict(relax=1.5), dict(stopcond="both",
                                                      convtest=True)])
def test_unroll_is_exact(kw):
    """unroll=K must reproduce unroll=1 bit-for-bit: same step count,
    same solution, same residual history (including when maxiters is
    not divisible by K and when the stop fires mid-unroll-group)."""
    P, Q, r, s, truex = _instance()
    base = model(P, Q, r, s, ADMMConfig(maxiters=1001, **kw))
    for K in (3, 8):
        res = model(P, Q, r, s, ADMMConfig(maxiters=1001, unroll=K, **kw))
        assert res.steps == base.steps, (K, res.steps, base.steps)
        np.testing.assert_array_equal(np.asarray(res.xopt),
                                      np.asarray(base.xopt))
        np.testing.assert_array_equal(res.pnorm, base.pnorm)
        np.testing.assert_array_equal(res.derr, base.derr)


def test_unroll_respects_maxiters_cap():
    """With N % K != 0 the unrolled loop must stop exactly at maxiters
    and leave the trailing history slots untouched."""
    P, Q, r, s, _ = _instance()
    res = model(P, Q, r, s, ADMMConfig(maxiters=10, domaxiters=True, unroll=4))
    assert res.steps == 10
    assert len(res.pnorm) == 10 and np.isfinite(res.pnorm).all()


def test_unroll_validation():
    with pytest.raises(ValueError, match="unroll"):
        ADMMConfig(unroll=0)
    with pytest.raises(ValueError, match="unroll"):
        ADMMConfig(unroll="fastest")


def test_unroll_auto_resolution():
    """unroll='auto' resolves per body class in the wrappers (gemv -> 16,
    heavy -> 1, engine-direct -> 4) and never reaches a runner cache
    unresolved; auto solves match explicit-unroll solves bit-for-bit."""
    from admm_tpu.config import _AUTO_UNROLL, resolve_unroll

    cfg = ADMMConfig(unroll="auto")
    assert not cfg.resolved
    assert resolve_unroll(cfg, "gemv").unroll == _AUTO_UNROLL["gemv"]
    assert resolve_unroll(cfg, "heavy").unroll == 1
    assert resolve_unroll(cfg, "batched").unroll == 1
    assert resolve_unroll(ADMMConfig(unroll=7), "gemv").unroll == 7  # no-op

    P, Q, r, s, _ = _instance()
    auto = model(P, Q, r, s, ADMMConfig(maxiters=400, unroll="auto"))
    explicit = model(P, Q, r, s,
                     ADMMConfig(maxiters=400, unroll=_AUTO_UNROLL["gemv"]))
    assert auto.steps == explicit.steps
    np.testing.assert_array_equal(np.asarray(auto.xopt),
                                  np.asarray(explicit.xopt))


def test_unroll_divergence_detection_exact():
    """A broken prox must be caught by the convtest monitor at the SAME
    step under unroll=K as under unroll=1 (the diverged flag freezes the
    remaining sub-steps of the group)."""
    P, Q, r, s, _ = _instance()
    from admm_tpu.models.model import make_prox_ops

    cfg1 = ADMMConfig(maxiters=200, convtest=True)
    cfgK = ADMMConfig(maxiters=200, convtest=True, unroll=4)
    prox_f, prox_g, obj, data = make_prox_ops(P, Q, r, s, cfg1)

    def broken_g(x, z, u, rho, d):
        return -prox_g(x, z, u, rho, d)  # sign error (convergencechecking.m)

    n = P.shape[1]
    r1 = admm(prox_f, broken_g, cfg1, A=1.0, B=-1.0, c=0.0,
              m=n, nA=n, nB=n, data=data)
    rK = admm(prox_f, broken_g, cfgK, A=1.0, B=-1.0, c=0.0,
              m=n, nA=n, nB=n, data=data)
    assert r1.diverged and rK.diverged
    assert r1.steps == rK.steps


def test_serial_wrappers_accept_warm_start():
    # Reference options.x0/z0/u0 (admm.m:252-254) reach every solver
    # through the options struct; the wrappers expose the same knobs.
    import numpy as np

    from admm_tpu import ADMMConfig, lasso, linearsvm

    rng = np.random.default_rng(61)
    m, n = 40, 80
    D = rng.standard_normal((m, n))
    D = D / np.sqrt(np.sum(D**2, axis=0, keepdims=True))
    s = rng.standard_normal(m)
    cfg = ADMMConfig(maxiters=2000)
    cold = lasso(D, s, 0.4, cfg)
    warm = lasso(D, s, 0.4, cfg,
                 x0=cold.xopt, z0=cold.zopt, u0=cold.uopt)
    assert warm.steps <= 3 < cold.steps

    ell = np.sign(rng.standard_normal(m))
    sv_cold = linearsvm(D, ell, 0.5, ADMMConfig(maxiters=300))
    sv_warm = linearsvm(D, ell, 0.5, ADMMConfig(maxiters=300),
                        x0=sv_cold.xopt, z0=sv_cold.zopt, u0=sv_cold.uopt)
    assert sv_warm.steps <= sv_cold.steps


def test_preprocess_hook_receives_data():
    # Hooks follow the data convention: trailing data arg when given.
    import numpy as np

    from admm_tpu import ADMMConfig
    from admm_tpu.engine import Hooks, admm

    seen = {}

    def pre(d):
        seen["keys"] = sorted(d)

    def pf(x, z, u, rho, d):
        return d["t"] * (z - u)

    def pg(x, z, u, rho, d):
        return x + u

    res = admm(pf, pg, ADMMConfig(maxiters=5, domaxiters=True),
               A=1.0, B=-1.0, c=0.0, m=4, nA=4, nB=4,
               hooks=Hooks(preprocess=pre),
               data={"t": np.float64(0.5)})
    assert seen["keys"] == ["t"]
    assert res.steps == 5


# ---- plateau / stall detector (ADMMConfig.stallwindow) --------------------


def _f32_stalling_instance(seed=3, m=24, n=96):
    """A basis-pursuit instance solved at f32 with an f64-grade stop:
    the primal residual floors above the Boyd gate, so without the
    detector the solve burns the whole iteration budget."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n)).astype(np.float32)
    x = np.zeros(n)
    x[rng.choice(n, size=8, replace=False)] = rng.standard_normal(8)
    s = (D @ x).astype(np.float32)
    return D, s


def test_stall_detector_stops_plateaued_f32_run():
    from admm_tpu import basispursuit

    D, s = _f32_stalling_instance()
    kw = dict(maxiters=4000, abstol=1e-12, reltol=1e-11)
    burn = basispursuit(D, s, ADMMConfig(**kw))
    assert burn.steps == 4000 and not burn.stalled  # the failure mode

    res = basispursuit(D, s, ADMMConfig(stallwindow=60, **kw))
    assert res.stalled and not res.diverged
    assert res.steps < 4000
    # Stopping at the plateau loses nothing: the solution quality equals
    # the full burn's (both sit at the f32 floor).
    q_stall = np.linalg.norm(D @ np.asarray(res.xopt, np.float64) - s)
    q_burn = np.linalg.norm(D @ np.asarray(burn.xopt, np.float64) - s)
    assert q_stall <= 2.0 * q_burn + 1e-6


def test_stall_detector_inert_on_converging_run():
    P, Q, r, s, truex = _instance()
    base = model(P, Q, r, s, ADMMConfig(maxiters=2000))
    res = model(P, Q, r, s, ADMMConfig(maxiters=2000, stallwindow=200))
    # A healthy solve converges long before any 200-iteration plateau.
    assert not res.stalled
    assert res.steps == base.steps
    np.testing.assert_array_equal(np.asarray(res.xopt), np.asarray(base.xopt))


def test_stall_detector_unroll_exact():
    """Stall-stop must fire at the SAME step under unroll=K as K=1."""
    D, s = _f32_stalling_instance(seed=11)
    kw = dict(maxiters=3000, abstol=1e-12, reltol=1e-11, stallwindow=50)
    from admm_tpu import basispursuit

    r1 = basispursuit(D, s, ADMMConfig(unroll=1, **kw))
    rK = basispursuit(D, s, ADMMConfig(unroll=8, **kw))
    assert r1.stalled and rK.stalled
    assert r1.steps == rK.steps
    np.testing.assert_array_equal(np.asarray(r1.xopt), np.asarray(rK.xopt))


def test_stall_config_validation_and_domaxiters_gate():
    with pytest.raises(ValueError, match="stallwindow"):
        ADMMConfig(stallwindow=-1)
    with pytest.raises(ValueError, match="stalltol"):
        ADMMConfig(stalltol=1.5)
    assert not ADMMConfig(stallwindow=50, domaxiters=True).use_stall
    assert ADMMConfig(stallwindow=50).use_stall

    # domaxiters wins: all N iterations run even on a plateau.
    D, s = _f32_stalling_instance()
    from admm_tpu import basispursuit

    res = basispursuit(D, s, ADMMConfig(
        maxiters=300, domaxiters=True, stallwindow=20,
        abstol=1e-12, reltol=1e-11))
    assert res.steps == 300 and not res.stalled


def test_quiet_false_prints_table_rows(capfd):
    """quiet=0 per-iteration console table (admm.m:318-330, 661-673):
    one row per executed iteration plus the final summary line, gated on
    the live mask so unrolled sub-steps past done print nothing."""
    import jax

    P, Q, r, s, _ = _instance()
    res = model(P, Q, r, s, ADMMConfig(maxiters=500, quiet=False, unroll=4))
    jax.effects_barrier()  # drain the debug.print callbacks
    out = capfd.readouterr().out
    rows = [ln for ln in out.splitlines() if "pnorm" in ln and "perr" in ln]
    assert len(rows) == res.steps, (len(rows), res.steps)
    # Rows carry the 1-based iteration counter in order.
    assert rows[0].startswith("1\t") and rows[-1].startswith(f"{res.steps}\t")
    assert f"ADMM finished: {res.steps} steps" in out
