"""Command-line driver with the reference's flag contract.

Equivalent of the reference CLI (reference: main.cu:14-115):

* ``-f <file>`` — solve a dense-format problem file (main.cu:27-32).
* ``-r <vars> <constraints> [seed]`` — random problem, uniform
  [-100, 100], seed defaults to the current time (main.cu:33-36,7-8).
* ``-rs <vars> <constraints> [seed]`` — like -r, additionally saving a
  seed file ``data/examples/random_<timestamp>.txt`` (main.cu:37-42,
  141-153).
* ``-rf <file>`` — regenerate + solve from a seed file (main.cu:43-48).
* ``-t`` — benchmark sweep: vars, constraints in {256, 512, ..., 8192},
  seed = vars*100 + constraints (+1 at 1024x8192), range [+1, +100], one
  timing CSV per size (main.cu:49-77).

On success the solution vector and optimal value go to
``<data-dir>/solution.txt`` in the reference's format (main.cu:104-110)
and the status line matches the reference's stdout (main.cu:87-102).

Extensions beyond the reference (all optional flags): ``--dtype``
(float32 tableau, the mixed production mode), ``--timer``/``--per-iteration`` chrono control,
``--reference-degeneracy`` (abort on degeneracy like the reference
instead of resolving it via Bland's rule), ``--limit`` for the sweep
size, ``--batch`` to solve one seeded instance many times vmapped,
``--checkpoint PATH [--checkpoint-every N]`` for a kill-safe resumable
solve, ``--sharded NDEV`` to solve on a multi-device 'vars'-sharded
mesh, ``--resume-sweep`` to restart a crashed -t sweep where it died,
and ``--platform`` to force the JAX backend.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .chrono import Chrono, NullChrono
from .config import SolverOptions, Status
from .generator import (benchmark_seed, benchmark_sizes,
                        generate_random_problem)
from .problem import (Problem, format_problem, read_problem,
                      read_random_problem, write_seed_file)
from .result import SolveResult
from .timed import solve_timed

#: Reference CLI generation range (main.cu:7-8).
MIN, MAX = -100.0, 100.0


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simplex-tpu",
        description="Dense two-phase simplex LP solver (JAX)")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-f", metavar="FILE", help="problem file")
    mode.add_argument("-r", nargs="+", metavar="N",
                      help="vars constraints [seed]")
    mode.add_argument("-rs", nargs="+", metavar="N",
                      help="vars constraints [seed]; saves a seed file")
    mode.add_argument("-rf", metavar="FILE", help="seed file")
    mode.add_argument("-t", action="store_true", help="benchmark sweep")

    p.add_argument("--data-dir", default="data",
                   help="output root (solution.txt, examples/, measures/)")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64"])
    p.add_argument("--vector-dtype", default="float64",
                   choices=["float32", "float64"],
                   help="dtype of b/costs/z; float64 over a float32 "
                        "tableau is the robust mixed-precision mode "
                        "(default)")
    p.add_argument("--timer", action="store_true",
                   help="write per-operation timing CSV (reference -D TIMER)")
    p.add_argument("--per-iteration", action="store_true",
                   help="one CSV row per pivot (reference solve timing)")
    p.add_argument("--reference-degeneracy", action="store_true",
                   help="abort DEGENERATE like the reference instead of "
                        "resolving via Bland's rule")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--eps", type=float, default=None,
                   help="comparison epsilon (default: 1e-9 for float64 "
                        "matching the reference, 1e-4 for float32)")
    p.add_argument("--block", type=int, default=None, metavar="L",
                   help="deferred block-pivot window (solver."
                        "solve_loop_blocked); default: plain "
                        "reference-semantics loop")
    p.add_argument("--pivot-rule", default="auto",
                   choices=["auto", "dantzig", "devex", "bland"],
                   help="entering-variable pricing: auto (default — devex "
                        "for f32 --block production runs, dantzig "
                        "elsewhere), dantzig (reference parity rule, "
                        "solver.cu:87), devex (Forrest-Goldfarb weights, "
                        "fewer pivots), or bland (anti-cycling)")
    p.add_argument("--equilibrate", action="store_true",
                   help="power-of-two row/column equilibration at fill "
                        "(extreme-magnitude LPs in the mixed mode; "
                        "results unwound/refined to original units)")
    p.add_argument("--limit", type=int, default=8192,
                   help="benchmark sweep upper size")
    p.add_argument("--resume-sweep", action="store_true",
                   help="with -t --timer: skip sizes whose measures CSV "
                        "is already complete (ends with a solution row), "
                        "so a crashed sweep can be re-run from where it "
                        "stopped")
    p.add_argument("--debug", action="store_true",
                   help="print the parsed/generated problem and the "
                        "tableau after every stage (reference -D DEBUG)")
    p.add_argument("--pause", action="store_true",
                   help="with --debug: wait for Enter after each tableau "
                        "dump (the reference DEBUG build's getchar() "
                        "pause, solver.cu:112-116)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax.profiler (TensorBoard) trace of the "
                        "solve to DIR")
    p.add_argument("--batch", type=int, default=1, metavar="B",
                   help="with -r/-rs/-rf: solve B instances (seeds "
                        "seed..seed+B-1) in one vmapped device call")
    p.add_argument("--fleet", type=int, default=None, metavar="NDEV",
                   help="with --batch: shard the B instances across an "
                        "NDEV-device mesh (B must divide by NDEV)")
    p.add_argument("--checkpoint", metavar="PATH", default=None,
                   help="solve resumably, persisting the tableau to PATH "
                        "every --checkpoint-every pivots; rerun the same "
                        "command after a crash/kill to continue from the "
                        "newest checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=1000,
                   metavar="N", help="pivots per checkpoint window")
    p.add_argument("--sharded", type=int, default=None, metavar="NDEV",
                   help="solve on an NDEV-device mesh, tableau sharded "
                        "over the 'vars' axis (jax.sharding + shard_map); "
                        "NDEV must not exceed the available devices")
    p.add_argument("--platform", choices=["cpu", "gpu"], default=None,
                   help="force the JAX backend (default: JAX's own "
                        "choice, the GPU when one is present)")
    return p


def _options(args) -> SolverOptions:
    return SolverOptions(
        dtype=np.dtype(args.dtype),
        vector_dtype=np.dtype(args.vector_dtype),
        eps=args.eps,   # None -> dtype-resolved default (config.EPS_F32)
        max_iter=args.max_iter,
        block_pivots=args.block,
        pivot_rule=None if args.pivot_rule == "auto" else args.pivot_rule,
        degeneracy="reference" if args.reference_degeneracy else "continue",
        equilibrate=args.equilibrate,
    )


def _int3(values, what: str) -> tuple[int, int, int]:
    if len(values) < 2:
        raise SystemExit(f"{what} needs: vars constraints [seed]")
    n, m = int(values[0]), int(values[1])
    seed = int(values[2]) if len(values) > 2 else int(time.time())
    return n, m, seed


def _report(result: SolveResult, problem: Problem, data_dir: str) -> None:
    """Reference status lines + solution file (main.cu:84-111)."""
    print()
    print(result.status.message)
    if result.status == Status.OPTIMAL:
        import os

        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, "solution.txt")
        with open(path, "w") as fh:
            for v in result.x:
                fh.write(f"{v:f}\n")
            fh.write(f"\nOptimal value: {result.objective:f}\n")
        print(f"Optimal value: {result.objective:f}")
        print(f"Solution written to {path}")
    print(f"(phase-1 pivots: {result.iterations_phase1}, "
          f"phase-2 pivots: {result.iterations_phase2})")


def _sweep_manifest(measures: str) -> str:
    import os

    return os.path.join(measures, ".sweep_done")


def _sweep_csv_complete(measures: str, n_vars: int,
                        n_constraints: int) -> bool:
    """True when the size finished: either its chrono CSV ends with the
    ``solution`` row (OPTIMAL solves — timed.py writes it last), or the
    sweep manifest records the size (covers runs that legitimately ended
    INFEASIBLE/UNBOUNDED/MAXITER, whose CSVs end on a ``solveIterations``
    row indistinguishable from a mid-sweep crash). A crashed sweep
    leaves a dangling partial row and no manifest entry, so the size is
    re-run."""
    import os

    key = f"{n_vars}_{n_constraints}"
    try:
        with open(_sweep_manifest(measures)) as fh:
            if any(line.split()[:1] == [key] for line in fh):
                return True
    except OSError:
        pass
    path = os.path.join(measures, f"benchmark_{n_vars}_{n_constraints}.txt")
    try:
        with open(path, "rb") as fh:
            tail = fh.read()[-256:].decode("utf-8", "replace")
    except OSError:
        return False
    lines = [l for l in tail.splitlines() if l.strip()]
    return bool(lines) and lines[-1].split(",")[2:3] == ["solution"]


def _sweep(args, options: SolverOptions) -> None:
    """Benchmark sweep (reference main.cu:49-77)."""
    import os

    measures = os.path.join(args.data_dir, "measures")
    print(f"Running a benchmark (max {args.limit}*{args.limit})...",
          file=sys.stderr)
    sweep_start = time.time()
    for n_vars, n_constraints in benchmark_sizes(args.limit):
        print(f"\nCurrent matrix: {n_vars}*{n_constraints}\n")
        if args.resume_sweep and args.timer and _sweep_csv_complete(
                measures, n_vars, n_constraints):
            print("already measured (complete CSV); skipping")
            continue
        seed = benchmark_seed(n_vars, n_constraints)
        problem = generate_random_problem(n_vars, n_constraints, seed,
                                          1.0, 100.0)
        chrono = (Chrono.open_benchmark(measures, n_vars, n_constraints)
                  if args.timer else NullChrono())
        with chrono:
            result = solve_timed(problem, options, chrono,
                                 per_iteration=args.per_iteration)
        print(f"status={result.status.name} objective={result.objective:f} "
              f"pivots={result.iterations_phase1}+"
              f"{result.iterations_phase2}")
        if args.timer:
            with open(_sweep_manifest(measures), "a") as fh:
                fh.write(f"{n_vars}_{n_constraints} "
                         f"{result.status.name}\n")
    print(f"Benchmark finished in {time.time() - sweep_start:.3f}s")


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    print("Starting...")
    if args.platform:
        # Must run before any backend use.
        import jax

        jax.config.update("jax_platforms", args.platform)
    options = _options(args)

    if args.t:
        _sweep(args, options)
        return 0

    import os

    if args.f:
        print("Reading problem from file...")
        problem = read_problem(args.f)
    elif args.rf:
        print("Reading seed from file")
        problem = read_random_problem(args.rf)
    else:
        values = args.r or args.rs
        n, m, seed = _int3(values, "-r/-rs")
        print(f"Generating random problem with {n} variables, "
              f"{m} constraints with seed: {seed}")
        problem = generate_random_problem(n, m, seed, MIN, MAX)
        if args.rs:
            stamp = time.strftime("%Y%m%d%H%M")
            path = os.path.join(args.data_dir, "examples",
                                f"random_{stamp}.txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_seed_file(path, n, m, seed, MIN, MAX)
            print(f"Seed file saved to {path}")

    if args.sharded:
        if args.timer or args.per_iteration or args.batch > 1 or args.fleet:
            raise SystemExit(
                "--sharded runs one fused device program and is "
                "incompatible with --timer/--per-iteration/--batch/--fleet")
        import jax
        from jax.sharding import Mesh

        from .parallel.sharded import solve_sharded

        devices = jax.devices()
        if args.sharded > len(devices):
            raise SystemExit(f"--sharded {args.sharded}: only "
                             f"{len(devices)} device(s) available")
        mesh = Mesh(np.array(devices[:args.sharded]), ("vars",))
        print(f"Resolving on a {args.sharded}-device 'vars' mesh....")
        t0 = time.time()
        if args.checkpoint:
            from .checkpoint import solve_resumable_sharded

            if os.path.exists(args.checkpoint):
                print(f"Resuming from checkpoint {args.checkpoint}")
            result = solve_resumable_sharded(
                problem, mesh, args.checkpoint,
                checkpoint_every=args.checkpoint_every, options=options)
        else:
            result = solve_sharded(problem, mesh, options)
        print(f"Sharded solve finished in {time.time() - t0:.3f}s")
        _report(result, problem, args.data_dir)
        return 0

    if args.fleet and args.batch <= 1:
        raise SystemExit("--fleet requires --batch B > 1 (it shards the "
                         "batch axis across devices)")
    if args.batch > 1:
        if args.f:
            raise SystemExit("--batch requires a seeded mode (-r/-rs/-rf)")
        from .batch import solve_batched
        from .problem import read_seed_file

        if args.rf:
            n, m, seed, lo, hi = read_seed_file(args.rf)
        else:
            lo, hi = MIN, MAX
        problems = [generate_random_problem(n, m, seed + i, lo, hi)
                    for i in range(args.batch)]
        mesh = None
        if args.fleet:
            import jax
            from jax.sharding import Mesh

            devices = jax.devices()
            if args.fleet > len(devices):
                raise SystemExit(f"--fleet {args.fleet}: only "
                                 f"{len(devices)} devices available")
            mesh = Mesh(np.array(devices[:args.fleet]), ("batch",))
        where = (f"across a {args.fleet}-device fleet" if mesh is not None
                 else "vmapped")
        print(f"Solving {args.batch} instances "
              f"(seeds {seed}..{seed + args.batch - 1}) {where}...")
        t0 = time.time()
        results = solve_batched(problems, options, mesh=mesh)
        dt = time.time() - t0
        for i, r in enumerate(results):
            obj = f"{r.objective:f}" if r.status == Status.OPTIMAL else "-"
            print(f"seed {seed + i}: {r.status.name} objective={obj} "
                  f"pivots={r.iterations_phase1}+{r.iterations_phase2}")
        print(f"Batch solved in {dt:.3f}s "
              f"({dt / args.batch * 1e3:.1f} ms/instance)")
        return 0

    if args.debug:
        print(format_problem(problem))

    if args.checkpoint:
        if args.timer or args.per_iteration:
            raise SystemExit(
                "--checkpoint is incompatible with --timer/--per-iteration "
                "(the resumable solve runs in fused windows with no "
                "per-operation boundaries)")
        from .checkpoint import solve_resumable

        if os.path.exists(args.checkpoint):
            print(f"Resuming from checkpoint {args.checkpoint}")
        result = solve_resumable(problem, args.checkpoint,
                                 checkpoint_every=args.checkpoint_every,
                                 options=options)
        _report(result, problem, args.data_dir)
        return 0

    chrono = (Chrono.open_timestamped(os.path.join(args.data_dir,
                                                   "measures"))
              if args.timer else NullChrono())
    print("Resolving....")
    import contextlib

    profiler_cm = contextlib.nullcontext()
    if args.profile:
        import jax

        profiler_cm = jax.profiler.trace(args.profile)
    with profiler_cm, chrono:
        result = solve_timed(problem, options, chrono,
                             per_iteration=args.per_iteration,
                             debug=args.debug, pause=args.pause)
    _report(result, problem, args.data_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
