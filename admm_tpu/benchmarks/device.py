"""What the benchmarks and the smoke run need to know about the device.

* ``enable_compile_cache`` — JAX's persistent compilation cache, in one
  fixed place so that a second run finds what the first compiled.
* ``PEAKS`` / ``peaks`` — published peak rates of the cards the
  benchmark knows, keyed by ``jax.Device.device_kind``.  A card that is
  not in the table is an error, never a default.
* ``card_info`` — the card's name and power limit from ``nvidia-smi``.
* ``require_gpu`` / ``setup`` — a measurement path that finds no GPU
  stops; a CPU rehearsal runs only when the caller asked for one.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

# The checkout's root: admm_tpu/benchmarks/device.py -> ../../
_CHECKOUT = Path(__file__).resolve().parents[2]
CACHE_DIR = _CHECKOUT / ".jax_cache"

# NVIDIA H100 SXM data sheet: dense tensor-core rates without sparsity,
# float32 outside the tensor cores, HBM3 bandwidth; all at the 700 W
# power limit (a card set below it cannot hold its top clock under load).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "f32_flops_per_s": 67e12,
        "source": "NVIDIA H100 SXM data sheet",
    },
}


def peaks(device_kind: str) -> dict:
    """Published peaks for ``device_kind``; KeyError for an unknown card."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add the "
            "card's data-sheet rates to admm_tpu.benchmarks.device.PEAKS"
        ) from None


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here; otherwise the cache lives in the
    git-ignored ``.jax_cache/`` of this checkout.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def card_info() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints them.

    Runs in a child process that does not import JAX, so it never opens
    the card.  Raises when nvidia-smi is missing or fails.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


class NoGPUError(RuntimeError):
    pass


def require_gpu(allow_cpu: bool = False) -> str:
    """Return the default platform; raise NoGPUError unless it is ``gpu``
    or the caller asked for a CPU rehearsal and got the CPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu" or (allow_cpu and platform == "cpu"):
        return platform
    raise NoGPUError(
        f"no GPU: JAX's default platform is {platform!r}.  This path "
        "measures the card; pass the CPU-rehearsal option to run it on "
        "the CPU instead.")


def setup(cpu: bool = False) -> str:
    """Start a measurement run: the CPU only when ``cpu`` asks for a
    rehearsal, else the GPU or NoGPUError; then the compile cache.
    Returns the platform.  Must run before JAX picks its backend."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    platform = require_gpu(allow_cpu=cpu)
    enable_compile_cache()
    return platform
