"""Multi-controller (jax.distributed) smoke tests: two OS processes, each
contributing virtual CPU devices to one global mesh.  Validates that the
distributed layer's collectives and the consensus solver run across
process boundaries — the single-host stand-in for a multi-host cluster
(parallel/multihost.py).

Skip policy: a worker prints a sentinel line immediately after
``jax.distributed.initialize`` succeeds.  Only a failure BEFORE the
sentinel (jax.distributed unavailable / timed out) skips; any failure
after it — assertion, NaN, crash in the validated cross-process math —
FAILS the test (round-1 review: `if rc != 0: skip` masked real
distributed-path regressions as environment flakes).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

_REPO = str(Path(__file__).resolve().parent.parent)
_SENTINEL = "DIST_INIT_OK"


def _run_workers(worker_code: str, procs: int = 2, timeout: int = 300):
    """Run the worker code in ``procs`` processes; returns
    (rc, initialized, output) where ``initialized`` is True when every
    worker got past jax.distributed.initialize."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    children = [
        subprocess.Popen(
            [sys.executable, "-c", worker_code, str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(procs)
    ]
    rc, outs = 0, []
    for c in children:
        try:
            out, _ = c.communicate(timeout=timeout)
            rc |= c.returncode
        except subprocess.TimeoutExpired:
            c.kill()
            out, _ = c.communicate()
            rc |= 1
        outs.append(out or "")
    initialized = all(_SENTINEL in o for o in outs)
    return rc, initialized, "\n--- worker ---\n".join(outs)


def _check(rc, initialized, output):
    if rc != 0 and not initialized:
        pytest.skip("jax.distributed unavailable in this environment:\n"
                    + output[-2000:])
    assert rc == 0, (
        "cross-process worker FAILED after jax.distributed.initialize — "
        "a real distributed-path regression, not an environment flake:\n"
        + output[-4000:]
    )


def test_consensus_lasso_across_two_processes():
    """consensus_lasso must run UNMODIFIED over a mesh spanning two
    jax.distributed processes (global device_put + cross-process
    all-reduce consensus aggregation), and agree with the single-process
    serial solve."""
    code = textwrap.dedent('''
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=2")
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        jax.distributed.initialize("127.0.0.1:47217", 2, pid)
        print("DIST_INIT_OK", flush=True)
        assert len(jax.devices()) == 4
        import numpy as np
        from admm_tpu import ADMMConfig, lasso
        from admm_tpu.parallel import consensus_lasso, make_mesh
        rng = np.random.default_rng(0)
        D = rng.standard_normal((64, 8))
        s = rng.standard_normal(64)
        res = consensus_lasso(D, s, 0.1, ADMMConfig(maxiters=500),
                              mesh=make_mesh())
        z = np.asarray(jax.device_get(res.zopt))
        assert np.isfinite(z).all()
        assert res.steps > 0
        obj = lambda x: 0.5*np.sum((D@x - s)**2) + 0.1*np.sum(np.abs(x))
        ser = lasso(D, s, 0.1, ADMMConfig(maxiters=2000))
        f_par, f_ser = obj(z), obj(np.asarray(jax.device_get(ser.xopt)))
        assert abs(f_par - f_ser) <= 1e-2 * abs(f_ser), (f_par, f_ser)
        # Accelerated consensus: the d-value restart aggregate is a
        # cross-process all-reduce — must run and stay near the optimum.
        resf = consensus_lasso(D, s, 0.1,
                               ADMMConfig(maxiters=500, fast=True),
                               mesh=make_mesh())
        zf = np.asarray(jax.device_get(resf.zopt))
        assert np.isfinite(zf).all()
        assert abs(obj(zf) - f_ser) <= 5e-2 * abs(f_ser), (obj(zf), f_ser)
    ''')
    _check(*_run_workers(code))


def test_sharded_svm_across_two_processes():
    """The transpose-reduction SVM (psum of per-shard D_i^T v_i +
    replicated solve) must also run over a cross-process mesh."""
    code = textwrap.dedent('''
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=2")
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        jax.distributed.initialize("127.0.0.1:47219", 2, pid)
        print("DIST_INIT_OK", flush=True)
        # f64 so the sharded-vs-serial trajectory comparison is exact
        # (the psum reassociates float sums; at f32 the drift compounds).
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        from admm_tpu import ADMMConfig, linearsvm
        from admm_tpu.parallel import linearsvm_sharded, make_mesh
        from admm_tpu.testers.problems import make_svm_instance
        D, ell = make_svm_instance(0, 64, 64, 0.5)
        cfg = ADMMConfig(maxiters=300)
        res = linearsvm_sharded(D, ell, 1.0, cfg, mesh=make_mesh(),
                                seed=3)
        x = np.asarray(jax.device_get(res.xopt))
        assert np.isfinite(x).all()
        assert x[0] > 0 and x[1] < 0  # separator orientation recovered
        # Exactness across the process boundary: the sharded program is
        # algebraically the serial unwrapped iteration (psum of
        # per-shard D_i^T v_i == D^T v), so from the same warm start it
        # must match the SERIAL solve trajectory, not just its sign.
        ser = linearsvm(D, ell, 1.0, cfg, seed=3)
        xs = np.asarray(jax.device_get(ser.xopt))
        assert res.steps == ser.steps, (res.steps, ser.steps)
        np.testing.assert_allclose(x, xs, rtol=1e-8, atol=1e-8)
    ''')
    _check(*_run_workers(code))


def test_sliced_prox_across_two_processes():
    """The third distributed form (SURVEY.md 2.7) — engine-generic
    sliced proximal updates via shard_map — must also run over a
    cross-process mesh, with uneven slices reassembling exactly."""
    code = textwrap.dedent('''
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=2")
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        jax.distributed.initialize("127.0.0.1:47223", 2, pid)
        print("DIST_INIT_OK", flush=True)
        import numpy as np
        import jax.numpy as jnp
        from admm_tpu.parallel import make_mesh, make_sliced_prox
        from admm_tpu.utils.validate import slicemaker
        mesh = make_mesh()          # 4 devices over 2 processes
        n = 4 * 4 + 3               # uneven slices
        lengths = slicemaker(0, n, 4)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        L = max(lengths)
        sd = jnp.asarray(starts)
        def prox_slice(x, z, u, rho, k):
            seg = jax.lax.dynamic_slice(jnp.pad(z - u, (0, L)), (sd[k],), (L,))
            return seg * rho
        prox = make_sliced_prox(prox_slice, lengths, mesh)
        rng = np.random.default_rng(0)
        zv = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        uv = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        out = np.asarray(jax.device_get(prox(zv, zv, uv, 1.5)))
        np.testing.assert_array_equal(out, np.asarray(1.5 * (zv - uv)))
    ''')
    _check(*_run_workers(code))


def test_worker_failure_is_not_masked():
    """A worker that dies AFTER jax.distributed.initialize must FAIL the
    suite (pytest.fail via _check's assert), proving the skip guard can
    no longer eat real regressions."""
    code = textwrap.dedent('''
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=2")
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        jax.distributed.initialize("127.0.0.1:47221", 2, pid)
        print("DIST_INIT_OK", flush=True)
        assert False, "deliberate post-init failure"
    ''')
    rc, initialized, output = _run_workers(code)
    if rc != 0 and not initialized:
        pytest.skip("jax.distributed unavailable in this environment")
    assert rc != 0 and initialized
    with pytest.raises(AssertionError, match="regression"):
        _check(rc, initialized, output)


def test_consensus_batch_2d_mesh_across_two_processes():
    """The 2-D (lanes x shards) composed program must run over a mesh
    spanning two jax.distributed processes — lanes across the process
    boundary, shard collectives within each process — and stay
    lane-for-lane exact vs the single-process 1-D consensus solve."""
    code = textwrap.dedent('''
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=2")
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        jax.distributed.initialize("127.0.0.1:47227", 2, pid)
        print("DIST_INIT_OK", flush=True)
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        from admm_tpu import ADMMConfig
        from admm_tpu.parallel import consensus_lasso_batch, make_mesh2d
        rng = np.random.default_rng(0)
        D = rng.standard_normal((64, 8))
        S = rng.standard_normal((4, 64))
        lams = np.geomspace(0.05, 0.3, 4)
        cfg = ADMMConfig(maxiters=400)
        batch = consensus_lasso_batch(D, S, lams, cfg,
                                      mesh=make_mesh2d(2, 2))
        # Lane-sharded outputs span both processes: gather them before
        # host inspection (the standard multi-controller pattern).
        from jax.experimental import multihost_utils as mh
        steps = np.asarray(mh.process_allgather(batch.steps, tiled=True))
        zopt = np.asarray(mh.process_allgather(batch.zopt, tiled=True))
        assert np.isfinite(zopt).all()
        assert steps.shape == (4,) and (steps > 0).all()
        # Per-lane correctness vs a process-local SERIAL solve (the 1-D
        # consensus comparison cannot run here: a submesh owned by one
        # process is non-addressable from the other; lane-for-lane
        # exactness vs 1-D consensus is pinned in test_parallel).
        from admm_tpu import lasso
        for b in range(4):
            ser = lasso(D, S[b], float(lams[b]), ADMMConfig(maxiters=3000))
            obj = lambda x: (0.5*np.sum((D@x - S[b])**2)
                             + lams[b]*np.sum(np.abs(x)))
            f_b = obj(zopt[b])
            f_s = obj(np.asarray(jax.device_get(ser.xopt)))
            assert abs(f_b - f_s) <= 1e-2 * (1.0 + abs(f_s)), (b, f_b, f_s)
    ''')
    _check(*_run_workers(code))


def test_matrix_iterate_runners_across_two_processes():
    """Round-5 matrix-iterate tier over a REAL process boundary: the
    sharded SDP (constraint-stack einsums + cross-process all-gather +
    psum through the core engine) and consensus covariance selection
    (flattened (p,p) consensus state, cross-process means), both
    matching their serial solves."""
    code = textwrap.dedent('''
        import os, sys
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=2")
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        jax.distributed.initialize("127.0.0.1:47231", 2, pid)
        print("DIST_INIT_OK", flush=True)
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        from admm_tpu import ADMMConfig, sdp
        from admm_tpu.models.sdp import random_sdp_instance
        from admm_tpu.models.covarianceselection import covarianceselection
        from admm_tpu.parallel import (consensus_covsel, make_mesh,
                                       sdp_sharded)
        cfg = ADMMConfig(maxiters=2000, abstol=1e-8, reltol=1e-8)
        rng = np.random.default_rng(0)

        C, A, b, Xstar, _, _ = random_sdp_instance(8, 8, 3, rng)
        sh = sdp_sharded(C, A, b, config=cfg, mesh=make_mesh())
        ser = sdp(C, A, b, config=cfg)
        Z = np.asarray(jax.device_get(sh.zopt))
        assert np.isfinite(Z).all()
        assert np.abs(Z - np.asarray(jax.device_get(ser.zopt))).max() < 1e-8
        assert int(sh.steps) == int(ser.steps)

        D = rng.standard_normal((64, 8))
        con = consensus_covsel(D, 0.1, cfg, mesh=make_mesh())
        ser_cv = covarianceselection(D, 0.1, cfg)
        Zc = np.asarray(jax.device_get(con.zopt))
        assert np.isfinite(Zc).all()
        assert np.abs(Zc - np.asarray(jax.device_get(ser_cv.zopt))).max() < 1e-2
    ''')
    _check(*_run_workers(code))
