"""Weak-scaling benchmark for consensus-ADMM LASSO, and the collective
microbenchmark.

BASELINE.md target: >= 80% weak-scaling efficiency at 2+ workers.  Rows
grow with the shard count (constant per-device work: rows_per_shard per
shard); efficiency(W) = iters_per_sec(W) / iters_per_sec(1).  It runs on
the real devices of the default platform (e.g. the four GPUs of one host,
whose collectives XLA hands to NCCL) and stops when there is no GPU.
``--cpu-devices N`` asks instead for N virtual CPU devices — a check of
the sharded programs, not a scaling measurement.

``collective_microbench`` times the consensus iteration's one collective
(the mean over the shard axis) as an isolated repeated program on the
available mesh: on one device this is the zero-communication floor (the
stacked mean's compute), on several the real all-reduce.

Prints one JSON line per shard count plus a summary line, each with the
platform and device kind it ran on.

Usage:  python -m admm_tpu scaling [--devices 4] [--rows-per-shard 4096]
        [--cols 512] [--iters 300] [--cpu-devices N]
(``python -m admm_tpu.benchmarks.scaling`` takes the same options.)
"""

from __future__ import annotations

import json


def weak_scaling(device_counts=(1, 2, 4, 8), rows_per_shard=4096, cols=512,
                 iters=300, quiet=False):
    import jax
    import numpy as np

    from admm_tpu import ADMMConfig
    from admm_tpu.parallel import consensus_lasso, make_mesh

    dev = {"platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind}
    cfg = ADMMConfig(maxiters=iters, domaxiters=True)
    results = {}
    for W in device_counts:
        rng = np.random.default_rng(0)
        m = rows_per_shard * W
        D = rng.standard_normal((m, cols)).astype(np.float32)
        s = rng.standard_normal(m).astype(np.float32)
        mesh = make_mesh(W)
        consensus_lasso(D, s, 0.1, cfg, mesh=mesh, nshards=W)  # compile
        res = consensus_lasso(D, s, 0.1, cfg, mesh=mesh, nshards=W)
        ips = iters / res.runtime
        results[W] = ips
        if not quiet:
            print(json.dumps({
                "metric": "consensus_lasso_weak_scaling",
                "devices": W,
                "rows": m,
                "cols": cols,
                "value": ips,
                "unit": "iter/s",
                **dev,
            }))
    base = results[min(results)]
    effs = {W: results[W] / base for W in results}
    if not quiet:
        line = {
            "metric": "weak_scaling_efficiency",
            "efficiency": {str(W): e for W, e in effs.items()},
            "target": 0.8,
            **dev,
        }
        if dev["platform"] == "cpu":
            # Virtual host-platform devices share the physical cores:
            # every extra "device" adds real work to the same silicon, so
            # efficiency here validates CORRECTNESS of the sharded
            # program, not scaling.  Run on several GPUs for real numbers.
            line["caveat"] = "virtual CPU devices share one host; not a scaling measurement"
        print(json.dumps(line))
    return results, effs


def collective_microbench(payload_cols=(512, 4096, 65536), inner=256,
                          quiet=False):
    """Time the consensus iteration's collective in isolation.

    The per-iteration cross-shard traffic of consensus ADMM is the mean
    of the stacked (W, n) state over the shard axis (2 such means +
    O(1) scalar norm reductions; parallel/consensus.py).  This times
    ``inner`` chained mean+broadcast rounds on a (W, n) sharded array
    inside one jitted scan, per payload width — the dispatch cost
    amortizes away, leaving the per-collective time.

    On one device this is the ZERO-COMM floor (pure stacked-mean
    compute).  On a real mesh the same program times the actual
    all-reduce; subtracting the single-device floor isolates the wire.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    import time

    from admm_tpu.parallel import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh()
    W = mesh.devices.size
    spec = NamedSharding(mesh, P(mesh.axis_names[0]))
    rows = []
    for n in payload_cols:
        x = jax.device_put(
            jnp.asarray(np.random.default_rng(0).standard_normal(
                (W, n)).astype(np.float32)), spec)

        def body(c, _):
            # mean over the sharded axis -> all-reduce; broadcast back.
            m = jnp.mean(c, axis=0, keepdims=True)
            return c - 0.5 * m, ()

        run = jax.jit(lambda x: jax.lax.scan(body, x, None, length=inner)[0])
        np.asarray(run(x))  # compile + host sync
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(run(x))
            best = min(best, time.perf_counter() - t0)
        row = {
            "metric": "collective_mean_roundtrip",
            "devices": W,
            "payload_floats": n,
            "us_per_collective": best / inner * 1e6,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
        }
        if W == 1:
            row["note"] = "single device: zero-comm floor (stacked mean)"
        rows.append(row)
        if not quiet:
            print(json.dumps(row))
    return rows


def main(devices=None, rows_per_shard=4096, cols=512, iters=300,
         cpu_devices=None):
    """The weak-scaling sweep over 1, 2, 4, 8 shards up to ``devices``
    (default: every device).  Stops (NoGPUError) when there is no GPU,
    unless ``cpu_devices`` asks for that many virtual CPU devices."""
    import os

    from admm_tpu.benchmarks.device import setup

    if cpu_devices:
        # Must reach XLA before JAX initializes its backends.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{cpu_devices}").strip()
    setup(cpu=bool(cpu_devices))
    import jax

    have = len(jax.devices())
    want = have if devices is None else devices
    if want > have:
        raise SystemExit(f"need {want} devices, the {jax.devices()[0].platform}"
                         f" platform has {have}")
    counts = [w for w in (1, 2, 4, 8) if w <= want]
    return weak_scaling(device_counts=counts, rows_per_shard=rows_per_shard,
                        cols=cols, iters=iters)


if __name__ == "__main__":
    import sys

    from admm_tpu.__main__ import main as cli

    raise SystemExit(cli(["scaling", *sys.argv[1:]]))
