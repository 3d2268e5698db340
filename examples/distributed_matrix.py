"""Distributed matrix-iterate solves: sharded SDP + consensus
covariance selection (round 5).

The matrix-tier families are the ones that actually strain a chip
(an SDP's constraint stack is m x n^2 floats; a graphical lasso's
spectral prox is n^3 work).  This demo runs both distributed forms on
whatever mesh is attached (8 virtual CPU devices under the test
suite, the GPUs of a host):

1. ``sdp_sharded`` — a standard-form SDP whose (m, n, n) constraint
   stack is sharded over the mesh (local einsums + one m-float
   all-gather + replicated (m, m) Cholesky + psum, the
   transpose-reduction pattern of solvers/unwrappedadmm.m:96-141 at
   SDP scale).  Verified here against the serial solve and the
   instance's constructed KKT optimum.

2. ``consensus_covsel`` — graphical lasso over SAMPLE-sharded data
   (Boyd ch. 7 general-form consensus): each shard holds its rows'
   covariance contribution and solves a weighted spectral prox
   locally; only the (p, p) consensus average crosses the mesh.
   Verified against the serial ``covarianceselection`` objective.

Usage:  python -m examples.distributed_matrix
"""

from __future__ import annotations

import numpy as np


def demo(n=12, m=16, p=16, samples=240, nshards=None, quiet=False):
    import jax.numpy as jnp

    from admm_tpu import ADMMConfig, sdp
    from admm_tpu.models.covarianceselection import (covarianceselection,
                                                     empirical_covariance)
    from admm_tpu.models.covarianceselection import _obj as _covsel_obj
    from admm_tpu.models.sdp import random_sdp_instance
    from admm_tpu.parallel import consensus_covsel, make_mesh, sdp_sharded

    mesh = make_mesh()
    W = nshards if nshards is not None else mesh.devices.size
    cfg = ADMMConfig(maxiters=20000, abstol=1e-9, reltol=1e-9)
    out = {}

    # --- sharded SDP vs serial + the constructed optimum ---------------
    rng = np.random.default_rng(0)
    C, A, b, Xstar, _, _ = random_sdp_instance(n, m, n // 3, rng)
    ser = sdp(C, A, b, config=cfg)
    sh = sdp_sharded(C, A, b, config=cfg, nshards=W)
    gap_serial = float(np.abs(np.asarray(sh.zopt) - np.asarray(ser.zopt)).max())
    gap_opt = float(np.abs(np.asarray(sh.zopt) - Xstar).max())
    out["sdp"] = dict(shards=W, steps=int(sh.steps),
                      max_dev_vs_serial=gap_serial, max_dev_vs_opt=gap_opt)
    if not quiet:
        print(f"sdp_sharded ({W} shards, n={n}, m={m}): steps {sh.steps}, "
              f"|Z - Z_serial|_max {gap_serial:.2e}, "
              f"|Z - X*|_max {gap_opt:.2e}")

    # --- consensus covsel vs the serial graphical lasso ----------------
    Sinv = np.eye(p) + 0.3 * np.triu(
        (rng.random((p, p)) < 0.15) * rng.standard_normal((p, p)), 1)
    Sinv = Sinv @ Sinv.T
    L = np.linalg.cholesky(np.linalg.inv(Sinv))
    D = rng.standard_normal((samples, p)) @ L.T
    lam = 0.1
    ser_cv = covarianceselection(D, lam, cfg)
    con_cv = consensus_covsel(D, lam, cfg, nshards=W)
    dS = {"S": jnp.asarray(empirical_covariance(D)), "lam": jnp.asarray(lam)}
    f_ser = float(_covsel_obj(jnp.asarray(ser_cv.xopt),
                              jnp.asarray(ser_cv.zopt), dS))
    f_con = float(_covsel_obj(jnp.asarray(con_cv.xopt),
                              jnp.asarray(con_cv.zopt), dS))
    out["covsel"] = dict(shards=W, steps=int(con_cv.steps),
                         obj_serial=f_ser, obj_consensus=f_con,
                         obj_gap=abs(f_con - f_ser))
    if not quiet:
        print(f"consensus_covsel ({W} shards, p={p}, {samples} samples): "
              f"steps {con_cv.steps}, objective {f_con:.6f} vs serial "
              f"{f_ser:.6f} (gap {abs(f_con - f_ser):.2e})")
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    demo()
