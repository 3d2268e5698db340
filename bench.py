"""Headline benchmark (one JSON line) on the GPU.

    python bench.py [--smoke] [--cpu]
    python bench.py --matrix [--smoke] [--cpu]   per-solver timing + f32 oracles
    python bench.py --sweep [--smoke] [--cpu]    on-device solvertester sweep

Without a GPU the run stops with a "no GPU" message; ``--cpu`` asks for a
CPU rehearsal instead, and every number it prints is labelled ``cpu``.
Thin wrapper over ``python -m admm_tpu bench|matrix|sweep``.
"""

import sys

from admm_tpu.__main__ import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    cmd = ("matrix" if "--matrix" in argv
           else "sweep" if "--sweep" in argv else "bench")
    sys.exit(main([cmd] + [a for a in argv if a in ("--smoke", "--cpu")]))
