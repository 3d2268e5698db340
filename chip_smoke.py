#!/usr/bin/env python3
"""Smoke run of the ADMM solver library on the GPU.

    python chip_smoke.py                  one card: phases device, headline,
                                          large, families
    python chip_smoke.py --multi          four cards: the sharded runners only
    python chip_smoke.py --cpu-rehearsal  tiny sizes on the CPU: paths and
                                          control flow only, no device numbers
    python chip_smoke.py --phase NAME     run only the named phase(s)

Every solve goes through the library's entry points (``admm_tpu.lasso`` and
the other solvers, ``models/batch.py``, ``admm_tpu.parallel``) and is
compared with a plain float64 reference computed on the host with NumPy and
SciPy (``admm_tpu.testers.reference``).  Each comparison prints its value,
tolerance, precision and reason on a JSON line.  A comparison that fails is
reported and the run exits 1 at the end without a result line; an
exception ends the run at once.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU (and without ``--cpu-rehearsal``) the run stops at once with
a "no GPU" message and exit code 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

PHASES = ("device", "headline", "large", "families")

# Sizes on the card, and the tiny ones of the CPU rehearsal.
REAL = {
    "headline": (1500, 5000), "headline_iters": 16384,
    "unrolls": (1, 16, 64), "large": (4096, 32768),
    "qp": (1024, 256, 64), "covsel": ((256, "eigh"), (256, "ns"),
                                      (512, "ns"), (512, "ns_fast")),
    "sdp": (16, 128), "tv": 65536, "path": (1500, 5000, 128),
    "path_lanes": (64, 96, 127), "consensus": (4, 16384, 512),
}
TINY = {
    "headline": (48, 160), "headline_iters": 64,
    "unrolls": (1, 2, 4), "large": (64, 512),
    "qp": (32, 8, 4), "covsel": ((16, "eigh"), (16, "ns"),
                                 (24, "ns"), (24, "ns_fast")),
    "sdp": (2, 12), "tv": 512, "path": (48, 160, 8),
    "path_lanes": (4, 6, 7), "consensus": (4, 64, 16),
}

# Boyd tolerances fit for f32 (the library's defaults are the reference's
# f64-grade ones): the same settings as the accuracy matrix.
F32_STOP = dict(maxiters=20000, abstol=1e-7, reltol=1e-6)


def emit(**row):
    print(json.dumps(row), flush=True)


class Run:
    """Shared state of one run: sizes, platform and the failed checks."""

    def __init__(self, sizes, platform):
        self.sz = sizes
        self.platform = platform
        self.failed = []

    def check(self, name, value, tol, precision, reason):
        ok = bool(value <= tol)
        emit(check=name, value=float(value), tol=tol, precision=precision,
             reason=reason, ok=ok)
        if not ok:
            self.failed.append(name)

    def peak_bytes(self):
        import jax

        stats = jax.devices()[0].memory_stats()
        return None if stats is None else stats.get("peak_bytes_in_use")


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def relerr(x, ref):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-30))


# ---- phases -----------------------------------------------------------------


def phase_device(run):
    import jax
    import jaxlib

    dev = jax.devices()[0]
    emit(phase="device", platform=dev.platform, device_kind=dev.device_kind,
         device_count=len(jax.devices()), jax=jax.__version__,
         jaxlib=jaxlib.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""))


def _lasso_against_f64(run, tag, D, s, lam):
    """Solve under the solver's own stopping rule, twice (the first call
    compiles), and compare x and the objective with the f64 reference."""
    from admm_tpu import ADMMConfig, lasso
    from admm_tpu.testers.reference import lasso_admm_f64, lasso_objective

    (zref, kref), t_ref = timed(lambda: lasso_admm_f64(D, s, lam))
    fref = lasso_objective(D, s, lam, zref)
    cfg = ADMMConfig(stallwindow=100, **F32_STOP)
    first, wall_first = timed(lambda: lasso(D, s, lam, cfg))
    warm, wall_warm = timed(lambda: lasso(D, s, lam, cfg))
    emit(phase=tag, shape=list(D.shape), steps=int(warm.steps),
         stalled=bool(warm.stalled), first_call_s=wall_first,
         compile_s=first.runtime - warm.runtime, setup_s=wall_warm - warm.runtime,
         solve_s=warm.runtime, iters_per_s=int(warm.steps) / warm.runtime,
         ref_iters=kref, ref_s=t_ref)
    x = np.asarray(warm.zopt, np.float64)
    why = ("the accuracy matrix's f32 bar for lasso; the f32 solve floors "
           "near 1e-5 relative")
    run.check(f"{tag}_x_relerr", relerr(x, zref), 1e-3, "f32, matmul highest",
              why)
    run.check(f"{tag}_objective_relerr",
              abs(lasso_objective(D, s, lam, x) - fref) / abs(fref), 1e-5,
              "f32, matmul highest",
              "objective is flat at the optimum: f32 x error enters squared")
    return zref


def phase_headline(run):
    from admm_tpu import ADMMConfig, lasso
    from admm_tpu.benchmarks.headline import fat_lasso_instance
    from admm_tpu.testers.reference import lasso_objective

    m, n = run.sz["headline"]
    D, s, lam = fat_lasso_instance(m, n)
    zref = _lasso_against_f64(run, "headline", D, s, lam)
    fref = lasso_objective(D, s, lam, zref)

    iters = run.sz["headline_iters"]
    for K in run.sz["unrolls"]:
        cfg = ADMMConfig(maxiters=iters, domaxiters=True, unroll=K)
        first = lasso(D, s, lam, cfg)
        np.asarray(first.steps)
        best = min((lasso(D, s, lam, cfg) for _ in range(3)),
                   key=lambda r: r.runtime)
        emit(phase="headline_domaxiters", shape=[m, n], unroll=K,
             iters=int(best.steps), compile_s=first.runtime - best.runtime,
             solve_s=best.runtime, iters_per_s=int(best.steps) / best.runtime,
             peak_bytes_in_use=run.peak_bytes())
        x = np.asarray(best.zopt, np.float64)
        run.check(f"headline_unroll{K}_objective_relerr",
                  abs(lasso_objective(D, s, lam, x) - fref) / abs(fref), 1e-5,
                  "f32, matmul highest",
                  "a fixed-iteration run past convergence must sit at the "
                  "f64 optimum to f32 accuracy")


def phase_large(run):
    from admm_tpu.benchmarks.headline import fat_lasso_instance

    m, n = run.sz["large"]
    D, s, lam = fat_lasso_instance(m, n)
    _lasso_against_f64(run, "large", D, s, lam)
    emit(phase="large", stream_matrix_bytes=D.nbytes,
         peak_bytes_in_use=run.peak_bytes())


def _oracle_rows(run):
    from admm_tpu.benchmarks.matrix import accuracy_matrix

    for row in accuracy_matrix():
        run.check(f"oracle_{row['solver']}", float(row["failed"]), 0.0,
                  "f32, matmul highest" + (
                      ", coarse NS passes at default precision (TF32)"
                      if "nsfast" in row["solver"] else ""),
                  f"tester's own criterion at f32 errtol {row['f32_errtol']}")


def _qp_batch(run):
    from admm_tpu import ADMMConfig
    from admm_tpu.models.batch import qp_batch
    from admm_tpu.testers.reference import qp_standard_admm_f64

    nq, mq, B = run.sz["qp"]
    rng = np.random.default_rng(11)
    R = rng.standard_normal((nq, 2 * nq))
    P = (R @ R.T / (2 * nq) + 0.1 * np.eye(nq)).astype(np.float32)
    D = rng.standard_normal((mq, nq)).astype(np.float32)
    S = (np.abs(rng.standard_normal((B, nq))) @ D.T).astype(np.float32)
    Q = rng.standard_normal((B, nq)).astype(np.float32)
    (Zref, kref), t_ref = timed(lambda: qp_standard_admm_f64(P, Q, D, S))
    res, wall = timed(lambda: qp_batch(P, Q, 0.0, D, S,
                                       ADMMConfig(stallwindow=100, **F32_STOP)))
    X = np.asarray(res.zopt, np.float64)
    err = max(relerr(X[b], Zref[b]) for b in range(B))
    emit(phase="qp_batch", n=nq, m=mq, lanes=B, steps_max=int(np.max(res.steps)),
         wall_s=wall, ref_iters=kref, ref_s=t_ref)
    run.check("qp_batch_x_relerr_max", err, 1e-3, "f32, matmul highest",
              "worst lane against the f64 ADMM reference; f32 floors near 1e-5")


def _covsel(run):
    from admm_tpu import ADMMConfig, covarianceselection
    from admm_tpu.testers.reference import covsel_gap_f64

    for n, pm in run.sz["covsel"]:
        rng = np.random.default_rng(n)
        A = rng.standard_normal((4 * n, n)).astype(np.float32)
        # MATLAB's cov, as models/covarianceselection.empirical_covariance.
        S = np.cov(A.astype(np.float64), rowvar=False)
        kw = {} if pm == "eigh" else {"ns_iters": 14}
        res, wall = timed(lambda: covarianceselection(
            A, 0.1, ADMMConfig(**F32_STOP), prox_method=pm, **kw))
        gap, primal = covsel_gap_f64(S, 0.1, res.xopt)
        emit(phase="covsel", n=n, prox_method=pm, steps=int(res.steps),
             wall_s=wall, primal=primal, gap=gap)
        prec = ("f32; square-root passes at default precision (TF32), "
                "corrections highest" if pm == "ns_fast"
                else "f32, matmul highest")
        run.check(f"covsel_{pm}_n{n}_rel_gap", gap / abs(primal), 1e-4, prec,
                  "f64 duality gap bounds suboptimality; f32 solves reach "
                  "~1e-6, ns_fast is held to the same bar as eigh")


def _sdp_batch(run):
    from admm_tpu import ADMMConfig
    from admm_tpu.models.batch import sdp_batch
    from admm_tpu.testers.reference import maxcut_sdp_gap_f64

    B, n = run.sz["sdp"]
    rng = np.random.default_rng(5)
    W = np.triu((rng.random((B, n, n)) < 0.1).astype(np.float32), 1)
    W = W + np.swapaxes(W, 1, 2)
    C = -0.25 * (np.stack([np.diag(w.sum(-1)) for w in W]) - W)
    # No plateau stop: SDP residuals rise before they fall.
    cfg = ADMMConfig(maxiters=20000, abstol=1e-6, reltol=1e-5)
    for pm in ("eigh", "ns"):
        kw = {} if pm == "eigh" else {"ns_iters": 16}
        res, wall = timed(lambda: sdp_batch(C, "diag", np.ones(n, np.float32),
                                            cfg, prox_method=pm, **kw))
        Z = np.asarray(res.zopt)
        gaps = [maxcut_sdp_gap_f64(C[b], Z[b]) for b in range(B)]
        worst = max(g / (1.0 + abs(p)) for g, p in gaps)
        emit(phase="sdp_batch", n=n, lanes=B, prox_method=pm,
             steps_max=int(np.max(res.steps)), wall_s=wall)
        run.check(f"sdp_batch_{pm}_rel_gap_max", worst, 1e-3,
                  "f32, matmul highest",
                  "f64 duality gap of the rescaled feasible X; f32 at Boyd "
                  "1e-6/1e-5 reaches ~3e-5")


def _tv(run):
    from admm_tpu import ADMMConfig, totalvariation
    from admm_tpu.testers.reference import tv_gap_f64

    n = run.sz["tv"]
    rng = np.random.default_rng(3)
    stair = np.repeat(rng.standard_normal(max(n // 64, 1)), 64)[:n]
    sig = (stair + 0.5 * rng.standard_normal(n)).astype(np.float32)
    res, wall = timed(lambda: totalvariation(
        sig, 0.5, ADMMConfig(stallwindow=100, **F32_STOP), solver="cr"))
    gap, primal = tv_gap_f64(sig, 0.5, res.xopt)
    emit(phase="tv_cr", n=n, steps=int(res.steps), wall_s=wall,
         primal=primal, gap=gap,
         x_err_bound_rel=float(np.sqrt(2 * max(gap, 0.0))
                               / np.linalg.norm(np.asarray(res.xopt))))
    run.check("tv_cr_rel_gap", gap / abs(primal), 1e-4, "f32, matmul highest",
              "f64 duality gap via solve_banded; f32 reaches ~5e-6")


def _lasso_path(run):
    from admm_tpu import ADMMConfig
    from admm_tpu.benchmarks.headline import fat_lasso_instance
    from admm_tpu.models.paths import lasso_path
    from admm_tpu.testers.reference import lasso_admm_f64, lasso_objective

    m, n, B = run.sz["path"]
    D, s, _ = fat_lasso_instance(m, n, seed=2)
    lmax = float(np.max(np.abs(D.T @ s)))
    lams = np.geomspace(0.001 * lmax, 0.5 * lmax, B).astype(np.float32)
    refs = {i: lasso_admm_f64(D, s, float(lams[i]))[0]
            for i in run.sz["path_lanes"]}
    res, wall = timed(lambda: lasso_path(D, s, lams, ADMMConfig(**F32_STOP)))
    emit(phase="lasso_path", lanes=B, steps_max=int(np.max(res.steps)),
         wall_s=wall)
    X = np.asarray(res.zopt, np.float64)
    xerr = max(relerr(X[i], z) for i, z in refs.items())
    ferr = max(abs(lasso_objective(D, s, float(lams[i]), X[i])
                   - lasso_objective(D, s, float(lams[i]), z))
               / lasso_objective(D, s, float(lams[i]), z)
               for i, z in refs.items())
    run.check("lasso_path_x_relerr_max", xerr, 1e-3, "f32, matmul highest",
              "the accuracy matrix's f32 bar for lasso")
    run.check("lasso_path_objective_relerr_max", ferr, 1e-5,
              "f32, matmul highest", "objective is flat at the optimum")


def phase_families(run):
    _oracle_rows(run)
    _qp_batch(run)
    _covsel(run)
    _sdp_batch(run)
    _tv(run)
    _lasso_path(run)


def phase_multi(run):
    import jax

    import __graft_entry__
    from admm_tpu import ADMMConfig, lasso
    from admm_tpu.benchmarks.scaling import collective_microbench
    from admm_tpu.parallel import consensus_lasso, make_mesh
    from admm_tpu.testers.reference import lasso_admm_f64, lasso_objective

    W, rows_per_shard, cols = run.sz["consensus"]
    if len(jax.devices()) < W:
        raise SystemExit(f"--multi needs {W} devices, have {len(jax.devices())}")
    mesh = make_mesh(W)
    rng = np.random.default_rng(4)
    m = W * rows_per_shard
    D = (rng.standard_normal((m, cols)) / np.sqrt(m)).astype(np.float32)
    xt = rng.standard_normal(cols) * (rng.random(cols) < 0.2)
    s = (D @ xt + 0.01 * rng.standard_normal(m)).astype(np.float32)
    lam = float(0.1 * np.max(np.abs(D.T @ s)))
    zref, _ = lasso_admm_f64(D, s, lam)
    fref = lasso_objective(D, s, lam, zref)
    cfg = ADMMConfig(stallwindow=100, **F32_STOP)
    # The consensus stop compares squared residual norms (the reference's
    # lassonorms convention), so its tolerances sit on the squared scale.
    cfg_cons = ADMMConfig(maxiters=20000, abstol=1e-9, reltol=1e-8,
                          stallwindow=100)
    cons, wall = timed(lambda: consensus_lasso(D, s, lam, cfg_cons, mesh=mesh,
                                               nshards=W))
    single = lasso(D, s, lam, cfg)
    got = len(cons.extra["xi"].sharding.device_set)
    emit(phase="multi_consensus", shards=W, rows=m, cols=cols,
         steps=int(cons.steps), wall_s=wall, devices_holding_state=got,
         single_card_steps=int(single.steps))
    run.check("multi_consensus_devices_missing", float(W - got), 0.0, "-",
              "every shard on its own card")
    z = np.asarray(cons.zopt, np.float64)
    why = "the accuracy matrix's f32 bar for lasso"
    run.check("multi_consensus_x_relerr_vs_f64", relerr(z, zref), 1e-3,
              "f32, matmul highest", why)
    run.check("multi_consensus_x_relerr_vs_single_card",
              relerr(z, np.asarray(single.zopt, np.float64)), 1e-3,
              "f32, matmul highest", why)
    run.check("multi_consensus_objective_relerr",
              abs(lasso_objective(D, s, lam, z) - fref) / abs(fref), 1e-5,
              "f32, matmul highest", "objective is flat at the optimum")

    __graft_entry__.multichip_checks(mesh, exact=run.platform == "cpu")
    emit(phase="multi_checks", devices=W, ok=True)
    for row in collective_microbench(quiet=True):
        emit(phase="multi_collective", **row)


PHASE_FNS = {"device": phase_device, "headline": phase_headline,
             "large": phase_large, "families": phase_families,
             "multi": phase_multi}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: only the sharded runners and their "
                         "comparisons")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run at tiny sizes on the CPU")
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="run only this phase (repeatable)")
    return ap.parse_args(argv)


def selected_phases(args):
    if args.multi:
        return ["multi"]
    return list(args.phase or PHASES)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.cpu_rehearsal:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=4").strip()
    import jax

    from admm_tpu.benchmarks.device import NoGPUError, card_info, setup

    try:
        platform = setup(cpu=args.cpu_rehearsal)
    except NoGPUError as e:
        print(f"{e} (chip_smoke.py --cpu-rehearsal)", file=sys.stderr)
        return 1
    if platform == "gpu":
        for line in card_info():
            print(f"card: {line}", flush=True)
    else:
        print("card: none (CPU rehearsal)", flush=True)
    emit(compile_cache=jax.config.jax_compilation_cache_dir)

    run = Run(TINY if args.cpu_rehearsal else REAL, platform)
    for name in selected_phases(args):
        t0 = time.perf_counter()
        PHASE_FNS[name](run)
        emit(phase_done=name, seconds=time.perf_counter() - t0)
    if run.failed:
        print(f"failed checks: {run.failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
