"""Measure the sharded blocked loop's ms/pivot on a mesh of GPUs.

Mirrors bench.py's structure (prep jit builds + eliminates the phase-1
tableau, a second jit runs the capped hot loop) so the number is
apples-to-apples with the single-card flagship ms/pivot: the deltas are
the shard_map program structure and the per-pivot collectives (the
candidate all_gathers + one (M_pad,) psum). On a mesh of ONE card
(``--devices 1``) that is pure program overhead; on four, XLA hands the
collectives to NCCL over NVLink.

    ms/pivot = (t(hi) - t(lo)) / (pivots(hi) - pivots(lo))

(the two-point max_iter diff cancels the per-call transpose + fixed
costs).

Run on the card(s): python tools/bench_sharded.py [--devices 4]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vars", type=int, default=100_000)
    ap.add_argument("--constraints", type=int, default=10_000)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--lo", type=int, default=256)
    ap.add_argument("--hi", type=int, default=768)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--pivot-rule", default="dantzig",
                    choices=["dantzig", "bland", "devex"],
                    help="pricing rule")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from simplex_tpu.config import SolverOptions
    from simplex_tpu.parallel import sharded as sh
    from simplex_tpu.tableau import Tableau

    from simplex_tpu.device import card_info, require_gpu

    log(f"device: {require_gpu()}; card: {card_info()}")
    n, m = args.vars, args.constraints
    opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                        block_pivots=args.block or None,
                        pivot_rule=args.pivot_rule)

    mesh = Mesh(np.array(jax.devices()[:args.devices]), (sh.AXIS,))
    n_shards = mesh.shape[sh.AXIS]
    log(f"mesh={n_shards}")

    tab_specs = Tableau(
        T=P(sh.AXIS, None), b=P(None), costs=P(sh.AXIS), z=P(),
        base=P(None), n=n, m=m, r=n + 2 * m)

    def constrain(tab):
        return jax.lax.with_sharding_constraint(
            tab, jax.tree.map(
                lambda s: NamedSharding(mesh, s) if isinstance(s, P) else s,
                tab_specs, is_leaf=lambda x: isinstance(x, P)))

    key = jax.random.key(n * 100 + m)
    ka, kb = jax.random.split(key, 2)

    @jax.jit
    def prep():
        # A generated INSIDE the jit: a freeable temp, so peak device
        # memory is A + T (8.5 GB), not A + T + the loop's transposed
        # copy.
        A = jax.random.uniform(ka, (m, n), jnp.float32, 1.0, 100.0)
        b = jax.random.uniform(kb, (m,), jnp.float32, 1.0, 100.0)
        tab = sh.build_phase1_sharded(A, b, n, m, n_shards, opt)
        tab = constrain(tab)
        costs0 = tab.costs        # pre-elimination, sharded like costs
        return jax.shard_map(
            sh.gaussian_eliminate_sharded, mesh=mesh,
            in_specs=(tab_specs,),
            out_specs=tab_specs, check_vma=False)(tab), costs0

    t0 = time.perf_counter()
    tab0, costs0 = jax.block_until_ready(prep())
    log(f"tableau {tab0.T.shape} built+eliminated in "
        f"{time.perf_counter()-t0:.1f}s")

    def make_run(cap):
        def core(tab, costs0):
            # costs0 enables the window re-pricing — the production
            # configuration (solve_sharded passes it too).
            tab, status, iters = sh.run_solve_loop_sharded(
                tab, opt, cap, costs0)
            return tab.z, status, iters
        return jax.jit(jax.shard_map(
            core, mesh=mesh, in_specs=(tab_specs, P(sh.AXIS)),
            out_specs=(P(), P(), P()), check_vma=False))

    results = {}
    for cap in (args.lo, args.hi):
        fn = make_run(cap)
        t0 = time.perf_counter()
        z, status, iters = jax.block_until_ready(fn(tab0, costs0))
        pivots = int(iters)
        log(f"max_iter={cap}: compile+run {time.perf_counter()-t0:.1f}s, "
            f"status={int(status)} pivots={pivots} z={float(z):.3f}")
        best = np.inf
        for i in range(args.repeats):
            t0 = time.perf_counter()
            z, status, iters = jax.block_until_ready(fn(tab0, costs0))
            dt = time.perf_counter() - t0
            pivots = int(iters)
            best = min(best, dt)
            log(f"  repeat {i}: {dt:.3f}s, {pivots} pivots")
        results[cap] = (best, pivots)

    (t_lo, p_lo), (t_hi, p_hi) = results[args.lo], results[args.hi]
    if p_hi == p_lo:
        log("ERROR: same pivot count at both caps (solve finished early)")
        return 1
    ms = (t_hi - t_lo) / (p_hi - p_lo) * 1e3
    log(f"marginal sharded ms/pivot (mesh={n_shards}): {ms:.3f} "
        f"({(p_hi - p_lo)} marginal pivots)")
    print(f'{{"sharded_ms_per_pivot_mesh{n_shards}": {ms:.4f}, '
          f'"lo": [{t_lo:.3f}, {p_lo}], "hi": [{t_hi:.3f}, {p_hi}]}}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
