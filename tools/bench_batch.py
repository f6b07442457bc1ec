"""Batched scenario solving benchmark (north-star config 3) on one GPU.

256 independent seeded LPs (m=500 constraints x n=2,000 vars each) in
ONE vmapped device call, across solver configurations, with statuses
checked and a few lanes cross-checked against the NumPy oracle.

Run on the card (one process): python tools/bench_batch.py [--batch 256]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--vars", type=int, default=2000)
    parser.add_argument("--constraints", type=int, default=500)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--config", default=None,
                        help="run only the config whose name contains "
                             "this substring")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from simplex_tpu.batch import solve_batched
    from simplex_tpu.config import SolverOptions, Status
    from simplex_tpu.generator import generate_random_problem
    from simplex_tpu.oracle import solve_oracle

    from simplex_tpu.device import card_info, require_gpu

    log(f"device: {require_gpu()}; card: {card_info()}")
    n, m, B = args.vars, args.constraints, args.batch
    log(f"generating {B} instances ({n} x {m}, seeds 1000..{1000 + B - 1})")
    problems = [generate_random_problem(n, m, 1000 + i, 1, 100)
                for i in range(B)]

    mixed = dict(dtype=np.float32, vector_dtype=np.float64, eps=1e-5)
    configs = [
        (f"L={L} {rule}",
         SolverOptions(**mixed, block_pivots=L, pivot_rule=rule))
        for L in (32, 128) for rule in ("dantzig", "devex")
    ]
    # (The vmapped SEQUENTIAL loop is deliberately absent: each pivot
    # streams the whole 1.6 GB batch tableau, ~600x per phase.)
    if args.config:
        configs = [(n_, o) for n_, o in configs if args.config in n_]
        assert configs, f"no config matches {args.config!r}"

    import jax
    import jax.numpy as jnp

    from simplex_tpu.batch import solve_device_batched

    # Host->device transfer is timed SEPARATELY: a production fleet
    # ships instances once (or generates on device); the per-call
    # metric that matters is the device solve.
    t0 = time.perf_counter()
    A_host = np.stack([p.A for p in problems]).astype(np.float32)
    b_host = np.stack([p.b for p in problems])
    c_host = np.stack([p.c for p in problems])
    A = jax.device_put(jnp.asarray(A_host))
    bb = jax.device_put(jnp.asarray(b_host))
    cc = jax.device_put(jnp.asarray(c_host))
    jax.block_until_ready((A, bb, cc))
    log(f"[batch] host stack + device transfer "
        f"({A_host.nbytes / 1e6:.0f} MB f32): "
        f"{time.perf_counter() - t0:.1f} s (once per fleet)")

    def run(opt):
        return jax.block_until_ready(
            solve_device_batched(A, bb, cc, n, m, opt))

    for name, opt in configs:
        t0 = time.perf_counter()
        out = run(opt)
        warm = time.perf_counter() - t0
        times = []
        for _ in range(args.repeats - 1):
            t0 = time.perf_counter()
            out = run(opt)
            times.append(time.perf_counter() - t0)
        best = min(times) if times else warm
        status = np.asarray(out.status)
        n_opt = int((status == int(Status.OPTIMAL)).sum())
        log(f"[batch] {name:40s} {best:8.1f} s "
            f"({best / B * 1e3:6.1f} ms/instance), "
            f"{n_opt}/{B} OPTIMAL (cold {warm:.1f} s)")
        assert n_opt == B, f"{name}: {B - n_opt} lanes not OPTIMAL"

    # Spot-check a few lanes against the oracle through the FULL host
    # surface (solve_batched refines every OPTIMAL lane in f64 now —
    # certified lanes must land at 1e-9; a fallback lane is f64-exact).
    results = solve_batched(problems, configs[-1][1])
    for i in (0, B // 2, B - 1):
        want = solve_oracle(problems[i])
        rel = abs(results[i].objective - want.objective) / (
            1 + abs(want.objective))
        ri = results[i].refine
        log(f"lane {i}: objective rel err {rel:.1e} "
            f"(pivots {results[i].iterations_phase1}"
            f"+{results[i].iterations_phase2}, "
            f"refine={None if ri is None else (ri.certified, ri.fallback)})")
        # certified lanes are 1e-9-class; a fallback lane may settle at
        # the finisher's refine_tol certificate (1e-6 scale-relative).
        bound = 1e-6 if (ri is not None and ri.fallback) else 1e-9
        assert rel < bound, (i, results[i].objective, want.objective)
    print("BENCH_BATCH_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
