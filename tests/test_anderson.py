"""Anderson acceleration (ADMMConfig.anderson).

Safeguarded type-II AA on the ADMM fixed-point map — a
convergence lever with no reference analog (the reference's only
acceleration is the fast/accelerated momentum, admm.m:563-600).  The
oracles below pin: (a) AA reaches the same optimum in strictly fewer
iterations on the soft-threshold and projection families, (b) the
safeguard's fallback reproduces the plain trajectory bit-for-bit,
(c) unroll freeze-masking and vmapped lanes stay exact under AA.
"""

import numpy as np
import pytest

from admm_tpu import ADMMConfig, lasso, linearprogram, model
from admm_tpu.models.batch import lasso_batch

TOL = dict(abstol=1e-8, reltol=1e-8, maxiters=20000)


def _lasso_instance(rng, m=200, n=400):
    D = rng.standard_normal((m, n))
    s = rng.standard_normal(m)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    return D, s, lam


def _lasso_obj(D, s, lam, x):
    x = np.asarray(x)
    return 0.5 * np.sum((D @ x - s) ** 2) + lam * np.sum(np.abs(x))


def test_lasso_fewer_steps_same_optimum(rng):
    D, s, lam = _lasso_instance(rng)
    r_plain = lasso(D, s, lam, ADMMConfig(**TOL))
    r_aa = lasso(D, s, lam, ADMMConfig(anderson=10, **TOL))
    assert int(r_aa.steps) < int(r_plain.steps) * 0.6
    f0 = _lasso_obj(D, s, lam, r_plain.zopt)
    f1 = _lasso_obj(D, s, lam, r_aa.zopt)
    assert abs(f1 - f0) <= 1e-9 * (1.0 + abs(f0))
    np.testing.assert_allclose(np.asarray(r_aa.zopt),
                               np.asarray(r_plain.zopt), atol=1e-5)


def test_model_reaches_closed_form(rng):
    # Closed-form oracle (reference modeltest.m:122-124): the AA run
    # must hit the exact solution, not just a nearby fixed point.
    m = n = 64
    P = rng.standard_normal((m, n))
    Q = rng.standard_normal((m, n))
    r = rng.standard_normal(m)
    s = rng.standard_normal(m)
    xstar = np.linalg.solve(P.T @ P + Q.T @ Q, P.T @ r + Q.T @ s)
    res = model(P, Q, r, s, ADMMConfig(anderson=8, **TOL))
    assert not res.diverged
    np.testing.assert_allclose(np.asarray(res.xopt), xstar, atol=1e-6)


def test_linearprogram_accelerates(rng):
    # Projection-family oracle: plant a feasible optimum
    # (linearprogramtest.m:108-138 construction).
    m, n = 60, 200
    D = rng.standard_normal((m, n))
    xt = np.abs(rng.standard_normal(n))
    s = D @ xt
    b = np.abs(rng.standard_normal(n))
    cfgs = {"plain": ADMMConfig(**TOL),
            "aa": ADMMConfig(anderson=10, **TOL)}
    res = {k: linearprogram(b, D, s, c) for k, c in cfgs.items()}
    assert int(res["aa"].steps) < int(res["plain"].steps)
    fa = float(b @ np.asarray(res["aa"].xopt))
    fp = float(b @ np.asarray(res["plain"].xopt))
    assert abs(fa - fp) <= 1e-3 * (1.0 + abs(fp))


def test_safeguard_fallback_is_exact_plain(rng):
    # aa_gmax below any attainable ||gamma||_1 rejects every candidate:
    # the safeguarded fallback must reproduce the PLAIN trajectory
    # bit-for-bit (same step count, same iterates).
    D, s, lam = _lasso_instance(rng, 80, 160)
    cfg = ADMMConfig(abstol=1e-6, reltol=1e-6, maxiters=3000)
    r_plain = lasso(D, s, lam, cfg)
    r_gated = lasso(D, s, lam,
                    ADMMConfig(abstol=1e-6, reltol=1e-6, maxiters=3000,
                               anderson=5, aa_gmax=1e-300))
    assert int(r_gated.steps) == int(r_plain.steps)
    np.testing.assert_array_equal(np.asarray(r_gated.zopt),
                                  np.asarray(r_plain.zopt))
    np.testing.assert_array_equal(np.asarray(r_gated.uopt),
                                  np.asarray(r_plain.uopt))


def test_unroll_bit_exact(rng):
    D, s, lam = _lasso_instance(rng, 120, 240)
    base = dict(abstol=1e-7, reltol=1e-7, maxiters=4000, anderson=6)
    r1 = lasso(D, s, lam, ADMMConfig(unroll=1, **base))
    r4 = lasso(D, s, lam, ADMMConfig(unroll=4, **base))
    assert int(r1.steps) == int(r4.steps)
    np.testing.assert_array_equal(np.asarray(r1.zopt), np.asarray(r4.zopt))
    np.testing.assert_array_equal(np.asarray(r1.uopt), np.asarray(r4.uopt))


def test_vmap_lanes_match_serial(rng):
    # AA state is lane-local: batched lanes under vmap must agree with
    # per-instance serial AA solves lane-for-lane, including when lanes
    # converge at different steps (per-lane freeze).
    D, _, _ = _lasso_instance(rng, 100, 150)
    B = 3
    S = rng.standard_normal((B, 100))
    lams = np.geomspace(0.5, 2.0, B)
    cfg = ADMMConfig(abstol=1e-7, reltol=1e-7, maxiters=3000, anderson=5)
    batch = lasso_batch(D, S, lams, cfg)
    steps = np.asarray(batch.steps)
    assert len(set(steps.tolist())) > 1  # different lanes, different steps
    for b in range(B):
        solo = lasso(D, S[b], float(lams[b]), cfg)
        # Batched linalg rounds differently from serial and AA amplifies
        # the drift, so step counts agree approximately (observed within
        # ~2%), not exactly (plain ADMM's exact-steps batching invariant
        # does not survive extrapolation).
        assert abs(int(steps[b]) - int(solo.steps)) <= 0.05 * int(solo.steps)
        # Batched vs serial kernels differ in reduction order, and the
        # AA window solve amplifies the ULP drift near the
        # soft-threshold boundary — iterates agree loosely (~1e-7
        # observed), objectives to solver precision.
        np.testing.assert_allclose(np.asarray(batch.zopt)[b],
                                   np.asarray(solo.zopt),
                                   rtol=1e-3, atol=1e-5)
        fb = _lasso_obj(D, S[b], float(lams[b]), np.asarray(batch.zopt)[b])
        fs = _lasso_obj(D, S[b], float(lams[b]), solo.zopt)
        assert abs(fb - fs) <= 1e-9 * (1.0 + abs(fs))


def test_path_composes(rng):
    # AA through the vmapped regularization path: per-lane windows,
    # per-lam optima matching solo AA solves.
    from admm_tpu.models.paths import lasso_path

    D = rng.standard_normal((100, 150))
    s = rng.standard_normal(100)
    lams = np.geomspace(0.2, 2.0, 4)
    cfg = ADMMConfig(abstol=1e-7, reltol=1e-7, maxiters=5000, anderson=8)
    path = lasso_path(D, s, lams, cfg)
    for i, lam in enumerate(lams):
        solo = lasso(D, s, float(lam), cfg)
        fb = _lasso_obj(D, s, float(lam), np.asarray(path.zopt)[i])
        fs = _lasso_obj(D, s, float(lam), solo.zopt)
        assert abs(fb - fs) <= 1e-8 * (1.0 + abs(fs))
        # lane-local windows: step counts agree to the batched-rounding
        # drift (observed <= 3 steps of ~400)
        assert abs(int(np.asarray(path.steps)[i]) - int(solo.steps)) <= \
            0.05 * int(solo.steps)


def test_sdp_batch_composes(rng):
    # Matrix-iterate batched lanes (max-cut style diag-constrained
    # SDPs): AA per lane, 5-6x fewer steps, same optima.
    from admm_tpu.models.batch import sdp_batch

    B, n = 3, 24
    Ws = [rng.standard_normal((n, n)) for _ in range(B)]
    Ls = np.stack([np.diag(np.abs(W).sum(1)) - np.abs(W) for W in Ws])
    bs = np.ones(n)
    cfg = dict(maxiters=5000, abstol=1e-7, reltol=1e-7)
    rp = sdp_batch(-0.25 * Ls, "diag", bs, config=ADMMConfig(**cfg))
    ra = sdp_batch(-0.25 * Ls, "diag", bs,
                   config=ADMMConfig(anderson=8, **cfg))
    for b in range(B):
        assert int(np.asarray(ra.steps)[b]) < 0.5 * int(np.asarray(rp.steps)[b])
        fp = float(np.sum(-0.25 * Ls[b] * np.asarray(rp.zopt)[b]))
        fa = float(np.sum(-0.25 * Ls[b] * np.asarray(ra.zopt)[b]))
        assert abs(fa - fp) <= 1e-4 * (1.0 + abs(fp))


def test_relax_composes(rng):
    D, s, lam = _lasso_instance(rng, 100, 200)
    r = lasso(D, s, lam,
              ADMMConfig(relax=1.5, anderson=8, abstol=1e-7, reltol=1e-7,
                         maxiters=5000))
    r_ref = lasso(D, s, lam, ADMMConfig(abstol=1e-7, reltol=1e-7,
                                        maxiters=20000))
    f0 = _lasso_obj(D, s, lam, r_ref.zopt)
    f1 = _lasso_obj(D, s, lam, r.zopt)
    assert not r.diverged
    assert abs(f1 - f0) <= 1e-7 * (1.0 + abs(f0))


def test_sdp_sharded_supports_aa(rng):
    # sdp_sharded rides the CORE engine (GSPMD from data shardings), so
    # AA composes for free: the sharded AA run must agree with the
    # serial AA run and not be slower in steps than plain.
    from admm_tpu import sdp
    from admm_tpu.models.sdp import random_sdp_instance
    from admm_tpu.parallel import sdp_sharded
    from admm_tpu.parallel.mesh import make_mesh

    C, A, b, _X, _y, _S = random_sdp_instance(8, 8, 3, rng,
                                              dtype=np.float64)
    cfg = ADMMConfig(maxiters=2000, abstol=1e-7, reltol=1e-7, anderson=5)
    r_ser = sdp(C, A, b, config=cfg)
    r_sh = sdp_sharded(C, A, b, config=cfg, mesh=make_mesh(4))
    assert int(r_sh.steps) == int(r_ser.steps)
    np.testing.assert_allclose(np.asarray(r_sh.zopt),
                               np.asarray(r_ser.zopt),
                               rtol=1e-6, atol=1e-8)
    r_plain = sdp(C, A, b, config=ADMMConfig(maxiters=2000, abstol=1e-7,
                                             reltol=1e-7))
    assert int(r_ser.steps) <= int(r_plain.steps)


def test_consensus_aa_accelerates_and_gates(rng):
    # AA on the consensus map (state = (z, dual stack); window dots
    # all-reduce over the shard axis): fewer steps, same optimum, and
    # the rejected-candidate fallback reproduces plain bit-for-bit.
    from admm_tpu.parallel import consensus_lasso

    D = rng.standard_normal((128, 48))
    s = rng.standard_normal(128)
    lam = 0.1 * np.max(np.abs(D.T @ s))
    tol = dict(abstol=1e-8, reltol=1e-8, maxiters=20000)
    rp = consensus_lasso(D, s, lam, ADMMConfig(**tol), nshards=8)
    ra = consensus_lasso(D, s, lam, ADMMConfig(anderson=10, **tol),
                         nshards=8)
    assert int(ra.steps) < int(rp.steps) * 0.5
    fp = _lasso_obj(D, s, lam, rp.zopt)
    fa = _lasso_obj(D, s, lam, ra.zopt)
    assert abs(fa - fp) <= 1e-7 * (1.0 + abs(fp))
    rg = consensus_lasso(D, s, lam,
                         ADMMConfig(anderson=5, aa_gmax=1e-300, **tol),
                         nshards=8)
    assert int(rg.steps) == int(rp.steps)
    np.testing.assert_array_equal(np.asarray(rg.zopt), np.asarray(rp.zopt))


def test_consensus_covsel_aa(rng):
    # Matrix-iterate tier: AA rides the flattened consensus state.
    import jax.numpy as jnp

    from admm_tpu.models.covarianceselection import (_obj,
                                                     covarianceselection,
                                                     empirical_covariance)
    from admm_tpu.parallel import consensus_covsel

    Dcv = rng.standard_normal((160, 16))
    cfgc = dict(abstol=1e-7, reltol=1e-7, maxiters=5000)
    rc = consensus_covsel(Dcv, 0.1, ADMMConfig(**cfgc), nshards=8)
    rca = consensus_covsel(Dcv, 0.1, ADMMConfig(anderson=10, **cfgc),
                           nshards=8)
    assert int(rca.steps) < int(rc.steps)
    ser = covarianceselection(Dcv, 0.1, ADMMConfig(abstol=1e-9,
                                                   reltol=1e-9,
                                                   maxiters=20000))
    dS = {"S": jnp.asarray(empirical_covariance(Dcv)),
          "lam": jnp.asarray(0.1)}
    f = lambda r: float(_obj(jnp.asarray(r.xopt), jnp.asarray(r.zopt), dS))
    assert abs(f(rca) - f(ser)) <= 1e-4 * (1.0 + abs(f(ser)))


def test_exchange_aa_accelerates_and_gates(rng):
    # AA on the exchange map (state = (mean-free z stack, price u)):
    # the closed-form market equilibrium in an order of magnitude fewer
    # iterations, with the gated fallback reproducing plain exactly.
    from admm_tpu.parallel import exchange_quadratic

    W, m, n = 8, 24, 12
    As = rng.standard_normal((W, m, n))
    bs = rng.standard_normal((W, m))
    Ginv = np.stack([np.linalg.inv(A.T @ A) for A in As])
    Atb = np.einsum("wmi,wm->wi", As, bs)
    nu = np.linalg.solve(Ginv.sum(0), np.einsum("wij,wj->i", Ginv, Atb))
    xeq = np.einsum("wij,wj->wi", Ginv, Atb - nu[None, :])
    tol = dict(abstol=1e-8, reltol=1e-8, maxiters=20000)
    rp = exchange_quadratic(As, bs, ADMMConfig(**tol))
    ra = exchange_quadratic(As, bs, ADMMConfig(anderson=10, **tol))
    rg = exchange_quadratic(As, bs,
                            ADMMConfig(anderson=5, aa_gmax=1e-300, **tol))
    for r in (rp, ra):
        err = np.linalg.norm(np.asarray(r.xopt) - xeq) / np.linalg.norm(xeq)
        assert err < 1e-6
    assert int(ra.steps) < int(rp.steps) * 0.3
    assert int(rg.steps) == int(rp.steps)
    np.testing.assert_array_equal(np.asarray(rg.xopt), np.asarray(rp.xopt))


def test_consensus_batch_2d_aa_lane_exact(rng):
    # AA through the 2-D lanes x shards composed program: per-lane AA
    # windows, lane-for-lane step counts matching the 1-D consensus AA
    # solve on the shard sub-mesh.
    from admm_tpu.parallel import (consensus_lasso, consensus_lasso_batch,
                                   make_mesh, make_mesh2d)

    D = rng.standard_normal((64, 16)).astype(np.float32)
    S = (rng.standard_normal((4, 64)) * 0.5).astype(np.float32)
    lams = np.geomspace(0.05, 0.3, 4).astype(np.float32)
    cfg = ADMMConfig(maxiters=2000, abstol=1e-6, reltol=1e-6, anderson=5)
    batch = consensus_lasso_batch(D, S, lams, cfg,
                                  mesh=make_mesh2d(2, 4), nshards=4)
    sub = make_mesh(4)
    for b in range(4):
        solo = consensus_lasso(D, S[b], float(lams[b]), cfg, mesh=sub,
                               nshards=4)
        assert int(np.asarray(batch.steps)[b]) == int(solo.steps)
        fb = _lasso_obj(D, S[b], float(lams[b]),
                        np.asarray(batch.zopt, np.float64)[b])
        fs = _lasso_obj(D, S[b], float(lams[b]),
                        np.asarray(solo.zopt, np.float64))
        assert abs(fb - fs) <= 1e-5 * (1.0 + abs(fs))


def _lad_proxg_shard(Dx, z, u, rho, aux):
    # Unwrapped-LAD z-prox: s + soft-threshold(Dx + u - s, 1/rho).
    import jax.numpy as jnp

    v = Dx + u - aux
    return aux + jnp.sign(v) * jnp.maximum(jnp.abs(v) - 1.0 / rho, 0.0)


def test_tr_runner_aa_standard_stop(rng):
    # The generic TR path accepts AA under the standard stop: fewer
    # steps to the same fixed point, gated fallback bit-exact.  (The
    # reference-parity SVM wrapper still rejects AA because it forces
    # stopcond='both', whose H-norm stop AA invalidates — next test.)
    from admm_tpu.parallel import unwrapped_admm_sharded

    m, n = 96, 10
    D = rng.standard_normal((m, n))
    xt = rng.standard_normal(n)
    s = D @ xt
    s[rng.choice(m, 5, replace=False)] += 30.0  # sparse outliers
    base = dict(stopcond="standard", nodualerror=True,
                abstol=1e-8, reltol=1e-8, maxiters=20000)
    kw = dict(aux=s, nshards=4, x0=np.zeros(n), z0=np.zeros(m),
              u0=np.zeros(m))
    rp = unwrapped_admm_sharded(_lad_proxg_shard, D, ADMMConfig(**base),
                                **kw)
    ra = unwrapped_admm_sharded(_lad_proxg_shard, D,
                                ADMMConfig(anderson=10, **base), **kw)
    rg = unwrapped_admm_sharded(_lad_proxg_shard, D,
                                ADMMConfig(anderson=5, aa_gmax=1e-300,
                                           **base), **kw)
    assert int(ra.steps) < int(rp.steps)
    np.testing.assert_allclose(np.asarray(ra.xopt), np.asarray(rp.xopt),
                               rtol=1e-5, atol=1e-7)
    assert int(rg.steps) == int(rp.steps)
    np.testing.assert_array_equal(np.asarray(rg.xopt), np.asarray(rp.xopt))


def test_svm_wrapper_rejects_aa(rng):
    from admm_tpu.parallel import linearsvm_sharded
    from admm_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(2)
    D = rng.standard_normal((16, 6)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    cfg = ADMMConfig(maxiters=10, anderson=3)
    # linearsvm_sharded forces stopcond='both' (unwrappedadmm.m:88
    # parity), so the config re-validation rejects AA there.
    with pytest.raises(ValueError):
        linearsvm_sharded(D[:, :2], np.sign(s).astype(np.float32), 1.0,
                          cfg, mesh=mesh, nshards=2)


def test_matrix_iterates_and_feature_combos(rng):
    # (a) AA over matrix-valued iterates (covsel (p, p) state rides the
    # flattened window); (b) AA composes with record_iterates /
    # nodualerror / quiet=0 without trace errors.
    from admm_tpu.models.covarianceselection import covarianceselection

    Dcv = rng.standard_normal((200, 16))
    rp = covarianceselection(Dcv, 0.1, ADMMConfig(abstol=1e-7, reltol=1e-7,
                                                  maxiters=10000))
    ra = covarianceselection(Dcv, 0.1, ADMMConfig(abstol=1e-7, reltol=1e-7,
                                                  maxiters=10000,
                                                  anderson=8))
    assert int(ra.steps) <= int(rp.steps)
    np.testing.assert_allclose(np.asarray(ra.zopt), np.asarray(rp.zopt),
                               atol=1e-5)

    D, s, lam = _lasso_instance(rng, 60, 120)
    res = lasso(D, s, lam, ADMMConfig(maxiters=200, anderson=5,
                                      record_iterates=True,
                                      nodualerror=True, quiet=False))
    assert np.all(np.isfinite(np.asarray(res.zopt)))
    assert np.asarray(res.hist["zvals"]).shape[0] == 200


@pytest.mark.parametrize("bad", [
    dict(anderson=5, fast=True),
    dict(anderson=5, adaptive=True),
    dict(anderson=5, rbadaptive=True),
    dict(anderson=5, convtest=True),
    dict(anderson=5, stopcond="hnorm"),
    dict(anderson=-1),
    dict(anderson=5, aa_restart=1.0),
])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        ADMMConfig(**bad)
