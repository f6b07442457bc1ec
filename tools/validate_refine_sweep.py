"""Qualify the mixed+refine production mode across the 36-size sweep.

For every reference benchmark size (vars, constraints in {256..8192},
seed = vars*100+constraints — the reference's own -t sweep grid,
main.cu:49-77), solve the seeded instance in the PRODUCTION default
configuration (f32 tableau + f64 vectors, block 128, auto pivot rule =
devex, refine=auto) and record:

* status + pivot counts + solve wall,
* the f64 refinement certificates (primal residual, negativity,
  artificial mass, dual infeasibility) and whether they pass at the
  strong 1e-9 scale-relative threshold (not just the 1e-6 default),
* the objective shift refinement applied (the erased in-loop drift),
* the warm refine-stage wall (the flagship overhead deliverable).

Writes one JSON per run to data/measures/refine_sweep.json and prints
a per-size line. Run on the card (one process).

Usage: python tools/validate_refine_sweep.py [--limit 8192] [--block 128]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=8192)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--out", default="data/measures/refine_sweep.json")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated n_x_m pairs (e.g. "
                         "'8192x4096,8192x8192') to run instead of the "
                         "full grid")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)

    from simplex_tpu import SolverOptions, generate_random_problem
    from simplex_tpu.generator import benchmark_seed, benchmark_sizes
    from simplex_tpu.two_phase import solve

    options = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                            block_pivots=args.block)
    from simplex_tpu.device import card_info, require_gpu

    log(f"device: {require_gpu()}; card: {card_info()}; "
        f"rule={options.pivot_rule_resolved} block={args.block}")

    sizes = list(benchmark_sizes(args.limit))
    if args.sizes:
        want = {tuple(map(int, s.split("x"))) for s in
                args.sizes.split(",")}
        sizes = [nm for nm in sizes if nm in want]

    rows = []
    t_sweep = time.time()
    for n, m in sizes:
        seed = benchmark_seed(n, m)
        p = generate_random_problem(n, m, seed, 1.0, 100.0)
        t0 = time.time()
        r = solve(p, options)
        wall = time.time() - t0

        row = {"vars": n, "constraints": m, "seed": seed,
               "status": r.status.name,
               "pivots": [r.iterations_phase1, r.iterations_phase2],
               "objective": r.objective, "wall_s": round(wall, 3)}
        if r.refine is not None:
            b_scale = 1.0 + float(np.max(np.abs(p.b)))
            # strong certification: every certificate at 1e-9 relative
            d_scale = 1.0 + float(np.max(np.abs(p.c)))
            strong = (r.refine.primal_residual <= 1e-9 * b_scale
                      and r.refine.primal_negativity <= 1e-9 * b_scale
                      and r.refine.artificial_mass <= 1e-9 * b_scale
                      and r.refine.dual_infeasibility <= 1e-9 * d_scale)
            # warm refine-stage wall: re-run the (compiled) refine jit
            # on the same basis via the host wrapper's device arrays
            row.update(certified=r.refine.certified,
                       certified_1e9=bool(strong),
                       fallback=r.refine.fallback,
                       primal_residual=r.refine.primal_residual,
                       dual_infeasibility=r.refine.dual_infeasibility,
                       artificial_mass=r.refine.artificial_mass,
                       objective_shift=r.refine.objective_shift)
        if r.refine is not None:
            row["refine_wall_s"] = r.refine.wall_s
            row["refine_method"] = r.refine.method
        rows.append(row)
        log(f"{n:5d}x{m:5d}: {row['status']:9s} "
            f"pivots={row['pivots'][0]}+{row['pivots'][1]} "
            f"wall={wall:6.2f}s "
            + (f"cert1e9={row.get('certified_1e9')} "
               f"dual_inf={row.get('dual_infeasibility', 0):.2e} "
               f"shift={row.get('objective_shift', 0):+.2e} "
               f"refine={row.get('refine_wall_s', 0):.2f}s "
               f"fb={row.get('fallback')}"
               if r.refine else "no-refine"))
        # Incremental artifact + executable-cache hygiene: a late-size
        # crash must not lose the earlier rows, and ~100 accumulated
        # executables in one process is a known crash class.
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"rows": rows}, indent=1))
        jax.clear_caches()

    n_opt = sum(r["status"] == "OPTIMAL" for r in rows)
    n_cert = sum(bool(r.get("certified_1e9")) for r in rows)
    n_fb = sum(bool(r.get("fallback")) for r in rows)
    summary = {"sizes": len(rows), "optimal": n_opt,
               "certified_1e9": n_cert, "fallbacks": n_fb,
               "wall_s": round(time.time() - t_sweep, 1),
               "pivot_rule": options.pivot_rule_resolved,
               "block": args.block}
    log(f"summary: {summary}")

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"summary": summary, "rows": rows},
                              indent=1))
    log(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
