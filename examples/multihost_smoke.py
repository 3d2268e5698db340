"""Two-process jax.distributed smoke test (multi-controller, CPU).

Validates the multi-host wiring of parallel/multihost.py on one host:
each process initializes jax.distributed against a local coordinator,
contributes its virtual CPU devices to the global mesh, and the processes
jointly run a global psum — the collective pattern every distributed
solver in this package reduces to.

Usage (single entry — it re-execs itself as the worker processes):

    python examples/multihost_smoke.py [--procs 2] [--local-devices 2]
"""

from __future__ import annotations

import os
import subprocess
import sys


def worker(coordinator: str, num_processes: int, process_id: int,
           local_devices: int) -> None:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from admm_tpu.parallel import initialize_cluster

    n = initialize_cluster(coordinator_address=coordinator,
                           num_processes=num_processes,
                           process_id=process_id)
    expected = num_processes * local_devices
    assert n == expected, f"global devices {n} != {expected}"

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(jax.devices(), ("shards",))
    # Each process contributes its local shard of a global array.
    local = jnp.full((local_devices, 4), float(process_id + 1))
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("shards")), local,
        global_shape=(expected, 4),
    )

    @jax.jit
    def total(a):
        return jnp.sum(a)

    got = float(total(garr))
    want = sum((p + 1) * local_devices * 4 for p in range(num_processes))
    assert got == want, (got, want)
    if process_id == 0:
        print(f"MULTIHOST OK: {num_processes} processes x {local_devices} "
              f"devices, global psum = {got}")


def main(procs: int = 2, local_devices: int = 2, port: int = 47123) -> int:
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    children = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             coordinator, str(procs), str(i), str(local_devices)],
            env=env,
        )
        for i in range(procs)
    ]
    rc = 0
    for c in children:
        rc |= c.wait(timeout=300)
    return rc


if __name__ == "__main__":
    if "--worker" in sys.argv:
        idx = sys.argv.index("--worker")
        coordinator, procs, pid, ldev = sys.argv[idx + 1 : idx + 5]
        worker(coordinator, int(procs), int(pid), int(ldev))
    else:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--procs", type=int, default=2)
        ap.add_argument("--local-devices", type=int, default=2)
        ap.add_argument("--port", type=int, default=47123)
        a = ap.parse_args()
        raise SystemExit(main(a.procs, a.local_devices, a.port))
