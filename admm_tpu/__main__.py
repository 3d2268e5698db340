"""Command-line interface.

    python -m admm_tpu demo <solver>            run a solver's demo test
    python -m admm_tpu test <solver> [opts]     solvertester scale sweep
    python -m admm_tpu bench [--smoke] [--cpu]  headline benchmark
    python -m admm_tpu matrix [--smoke] [--cpu] per-solver timing + f32 matrix
    python -m admm_tpu sweep [--smoke] [--cpu]  on-device solvertester sweep
    python -m admm_tpu scaling [--devices N] [--cpu-devices N]
                                                consensus weak-scaling sweep
    python -m admm_tpu list                     list solvers

The measuring commands stop when they find no GPU; ``--cpu`` (for
scaling, ``--cpu-devices N``) asks for a CPU rehearsal instead.

The CLI analog of the reference's interactive MATLAB session entry points
(zero-arg solver demos, solvertester, examples).
"""

from __future__ import annotations

import argparse
import sys

_SOLVERS = [
    "model", "lasso", "basispursuit", "totalvariation", "lad", "huberfit",
    "linearprogram", "quadraticprogram", "covarianceselection", "linearsvm",
]


def main(argv=None):
    p = argparse.ArgumentParser(prog="admm_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="run a solver's zero-arg demo")
    d.add_argument("solver", choices=_SOLVERS)

    t = sub.add_parser("test", help="solvertester scale sweep")
    t.add_argument("solver", choices=_SOLVERS)
    t.add_argument("--minscale", type=int, default=4)
    t.add_argument("--maxscale", type=int, default=6)
    t.add_argument("--trials", type=int, default=3)
    t.add_argument("--testtype", default="square",
                   choices=["square", "fat", "skinny", "morepos", "moreneg"])
    t.add_argument("--seed", type=int, default=None)

    b = sub.add_parser("bench", help="headline benchmark (one JSON line)")
    b.add_argument("--smoke", action="store_true")
    b.add_argument("--cpu", action="store_true", help="CPU rehearsal")

    mx = sub.add_parser(
        "matrix", help="per-solver timing + f32 oracle accuracy matrix")
    mx.add_argument("--smoke", action="store_true")
    mx.add_argument("--cpu", action="store_true", help="CPU rehearsal")
    mx.add_argument("--out", default="BENCH_MATRIX.json")

    sw = sub.add_parser(
        "sweep", help="on-device multi-scale solvertester sweep (all families)")
    sw.add_argument("--smoke", action="store_true")
    sw.add_argument("--cpu", action="store_true", help="CPU rehearsal")
    sw.add_argument("--out", default="BENCH_SWEEP.json")

    s = sub.add_parser("scaling", help="consensus weak-scaling sweep")
    s.add_argument("--devices", type=int, default=None,
                   help="largest shard count (default: every device)")
    s.add_argument("--rows-per-shard", type=int, default=4096)
    s.add_argument("--cols", type=int, default=512)
    s.add_argument("--iters", type=int, default=300)
    s.add_argument("--cpu-devices", type=int, default=None,
                   help="CPU rehearsal on this many virtual CPU devices")

    sub.add_parser("list", help="list available solvers")

    args = p.parse_args(argv)

    if args.cmd == "list":
        print("\n".join(_SOLVERS))
        return 0

    if args.cmd == "demo":
        import admm_tpu

        getattr(admm_tpu, args.solver)()
        return 0

    if args.cmd == "test":
        from admm_tpu.testers import solvertester

        report = solvertester(
            args.solver, args.minscale, args.maxscale, args.trials,
            testtype=args.testtype, seed=args.seed, quiet=False,
        )
        return 1 if report.any_failed else 0

    if args.cmd in ("bench", "matrix", "sweep", "scaling"):
        from admm_tpu.benchmarks import headline, matrix, scaling, sweep
        from admm_tpu.benchmarks.device import NoGPUError

        try:
            if args.cmd == "scaling":
                scaling.main(devices=args.devices,
                             rows_per_shard=args.rows_per_shard,
                             cols=args.cols, iters=args.iters,
                             cpu_devices=args.cpu_devices)
                return 0
            kw = {} if args.cmd == "bench" else {"out_path": args.out}
            run = {"bench": headline, "matrix": matrix, "sweep": sweep}[args.cmd]
            doc = run.main(smoke=args.smoke, cpu=args.cpu, **kw)
        except NoGPUError as e:
            print(e, file=sys.stderr)
            return 1
        # A failed oracle row fails the matrix and the sweep.
        return 0 if doc is None or doc["all_green"] else 1

    return 1


if __name__ == "__main__":
    raise SystemExit(main())
