"""Smoke test of the solver's main path on one GPU.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # four cards: sharded + fleet only

One process drives the card through the entry points a user calls, at
the widest instances the repository supports, and checks every answer:

1. golden files: smallProblem / infeasibleProblem / unboundedProblem in
   the f64 mode (the sequential reference loop) and the production mode
   (f32 tableau, f64 vectors, blocked L=128, devex, f64 refinement);
2. the reference's flagship, the seeded 8192 x 8192 XORWOW instance, in
   the production mode (certified) and in the f64 blocked mode
   (Dantzig); the two objectives agree to 1e-9 relative;
3. the north-star width, m=10k x n=100k built on the device: the
   production blocked loop for a capped number of pivots, then its
   carried b, reduced costs and z against the same quantities recomputed
   in f64 from the final basis (one f64 basis solve on the device);
4. batch config 3, 256 LPs of m=500 x n=2k, in the production mode:
   every lane OPTIMAL and certified, 8 lanes against the f64 oracle;
5. the CLI in-process: ``-f smallProblem.txt`` and ``-rf`` on a
   256-class seed file, checking the written solution file.

``--four-cards`` runs only the two multi-device surfaces and what they
are compared with: the flagship on a 4-card 'vars' mesh against
``st.solve`` on one card, and a 4-card 'batch' fleet of 64 LPs of
500 x 2k against the unsharded batch, lane by lane.

Each phase prints its wall time, compile time, pivots, the device's
peak memory and its checks. A failed check raises, so the script exits
non-zero; so does a run where JAX finds no GPU. The last line of stdout
is the JSON record ``{"ok": true, "device": {...}}``.

Tolerances: golden objectives and certified objectives are f64 results
of the same basis (refinement or the f64 loop), so they agree to 1e-9
relative. The north-star carried quantities come from the f32 tableau,
whose entries drift from B^-1 [A I I] by f32 rounding compounded over
every pivot (about K * u * g after K pivots, u = 6e-8, g the walk's
element growth); the f64 refinement removes that drift at extraction.
The check measures b against 1 + max|x_B|, z against 1 + |z| and the
reduced costs against 1 + max|d|. b and z are updated in f64 from one
f32 column per pivot and are bounded at 1e-3; each reduced cost is
re-priced as a 10k-term sum over a drifted f32 row, with cancellation,
and is bounded at 5e-2. On an H100 they measured 1.7e-4, 1.2e-6 and
1.8e-2 after 1,024 pivots, and the same check on an f64 tableau gives
3e-11, so the check itself is exact. A wrong loop (a skipped or
misapplied pivot) misses by O(1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "data", "examples")
FLAGSHIP_SEED_FILE = os.path.join(EXAMPLES, "benchmark_problems",
                                  "random_8192_8192.txt")
CLI_SEED_FILE = os.path.join(EXAMPLES, "benchmark_problems",
                             "random_256_512.txt")

#: The reference's recorded pivot counts on its flagship (phase 1 +
#: phase 2, data/reference_measures/benchmark_8192_8192.txt).
REFERENCE_FLAGSHIP_PIVOTS = (20639, 1160)

#: Sizes on the card; tests pass smaller ones to the phase functions.
CARD = {
    "northstar": (100_000, 10_000), "northstar_cap": 1024,
    "batch": (256, 2000, 500), "batch_oracle_lanes": 8,
    "fleet": (64, 2000, 500),
}

#: Bounds of the north-star check (see the module docstring).
NORTHSTAR_TOL = {"b": 1e-3, "z": 1e-3, "costs": 5e-2}


class CheckFailed(AssertionError):
    """A phase's answer is wrong."""


def check(ok: bool, what: str, checks: list) -> None:
    """Record a passed check or raise CheckFailed (explicit, so it holds
    under ``python -O`` too)."""
    if not ok:
        raise CheckFailed(what)
    checks.append(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def production(block_pivots: int = 128):
    """The production mode: f32 tableau, f64 vectors, blocked L=128
    (devex and refinement resolve automatically)."""
    from simplex_tpu.config import SolverOptions

    return SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                         block_pivots=block_pivots)


def rel(a: float, b: float) -> float:
    return abs(a - b) / (1.0 + abs(b))


class Phase:
    """Times one phase: wall clock, compile time (JAX's own compile
    events), pivots and the device's peak memory after it."""

    _compile_s = 0.0
    _listening = False

    def __init__(self, name: str):
        self.name = name
        self.checks: list[str] = []
        self.pivots: list[str] = []
        self.extra: dict = {}

    @classmethod
    def _listen(cls):
        if cls._listening:
            return
        from jax import monitoring

        def on_event(name, secs, **_):
            if name.startswith("/jax/core/compile/"):
                cls._compile_s += secs

        monitoring.register_event_duration_secs_listener(on_event)
        cls._listening = True

    def __enter__(self):
        self._listen()
        self._c0 = Phase._compile_s
        self._t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        import jax

        wall = time.perf_counter() - self._t0
        stats = jax.devices()[0].memory_stats() or {}
        rec = {"phase": self.name, "ok": exc is None,
               "wall_s": round(wall, 3),
               "compile_s": round(Phase._compile_s - self._c0, 3),
               "pivots": self.pivots,
               "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
               "checks": self.checks, **self.extra}
        log("   " + json.dumps(rec))
        return False


def pivots(r) -> str:
    return f"{r.iterations_phase1}+{r.iterations_phase2}"


# ---------------------------------------------------------------------------
# Phases (each takes its sizes, so the CPU tests run them tiny).

def phase_golden() -> None:
    import simplex_tpu as st

    with Phase("golden") as ph:
        for mode, opts in (("f64", None), ("production", production())):
            small = st.solve(st.read_problem(
                os.path.join(EXAMPLES, "smallProblem.txt")), opts)
            check(small.status == st.Status.OPTIMAL
                  and rel(small.objective, 64.0) < 1e-9
                  and np.allclose(small.x, [8.0, 0.0, 0.0], atol=1e-9),
                  f"{mode}: smallProblem OPTIMAL 64 at (8,0,0)", ph.checks)
            inf = st.solve(st.read_problem(
                os.path.join(EXAMPLES, "infeasibleProblem.txt")), opts)
            check(inf.status == st.Status.INFEASIBLE,
                  f"{mode}: infeasibleProblem INFEASIBLE", ph.checks)
            unb = st.solve(st.read_problem(
                os.path.join(EXAMPLES, "unboundedProblem.txt")), opts)
            check(unb.status == st.Status.UNBOUNDED,
                  f"{mode}: unboundedProblem UNBOUNDED", ph.checks)
            ph.pivots += [f"{mode} small {pivots(small)}"]


def phase_flagship(problem=None, label: str = "8192x8192") -> None:
    """Production (certified) vs f64 blocked Dantzig on the reference's
    flagship, regenerated from its seed file."""
    import simplex_tpu as st
    from simplex_tpu.utils.curand import native_available

    with Phase(f"flagship {label}") as ph:
        if problem is None:
            check(native_available(),
                  "native XORWOW generator built on this machine",
                  ph.checks)
            t0 = time.perf_counter()
            problem = st.read_random_problem(FLAGSHIP_SEED_FILE)
            ph.extra["generate_s"] = round(time.perf_counter() - t0, 3)
        prod = st.solve(problem, production())
        check(prod.status == st.Status.OPTIMAL and prod.refine is not None
              and prod.refine.certified,
              "production: OPTIMAL and refine.certified", ph.checks)
        ph.extra["production_refine"] = prod.refine._asdict()
        f64 = st.solve(problem, block_pivots=128, pivot_rule="dantzig")
        check(f64.status == st.Status.OPTIMAL, "f64 blocked: OPTIMAL",
              ph.checks)
        r = rel(prod.objective, f64.objective)
        check(r < 1e-9, f"objectives agree: rel {r:.3e} < 1e-9",
              ph.checks)
        ph.pivots += [f"production {pivots(prod)}",
                      f"f64 dantzig {pivots(f64)}",
                      "reference {}+{}".format(*REFERENCE_FLAGSHIP_PIVOTS)]
        ph.extra["objective"] = prod.objective


def phase_northstar(n: int, m: int, cap: int, block: int = 128) -> None:
    """The production blocked loop at width (n, m), capped at ``cap``
    pivots, checked against an f64 recomputation from its final basis."""
    import jax
    import jax.numpy as jnp

    import bench
    from simplex_tpu.solver import run_solve_loop
    from simplex_tpu.tableau import accum_matvec

    opts = production(block_pivots=block)
    with Phase(f"northstar m={m} n={n}") as ph:
        tab, costs0 = bench.build_bench_state(n, m, opts, ph.extra)

        def run(tab, costs0):
            out, status, iters = run_solve_loop(tab, opts, cap, costs0)
            return out.b, out.costs, out.z, out.base, iters

        compiled = jax.jit(run).lower(tab, costs0).compile()
        log(f"   memory_analysis: {compiled.memory_analysis()}")
        t0 = time.perf_counter()
        b, costs, z, base, iters = jax.block_until_ready(
            compiled(tab, costs0))
        ph.extra["loop_s"] = round(time.perf_counter() - t0, 3)
        L = int(opts.block_pivots)
        check(int(iters) == cap and cap >= 4 * L,
              f"{int(iters)} pivots = cap, >= 4 windows of {L}", ph.checks)
        ph.pivots.append(f"{int(iters)} (capped)")

        # f64 recomputation from the final basis: B from the phase-1
        # columns [A | I (slack) | I (artificial)].
        key = jax.random.key(n * 100 + m)
        A, b0 = (jax.random.uniform(k, s, dtype=jnp.float32, minval=1.0,
                                    maxval=100.0)
                 for k, s in zip(jax.random.split(key), ((m, n), (m,))))
        f64 = jnp.float64
        v = base[:m]
        struct = v < n
        unit = jnp.where(struct, 0, jnp.where(v < n + m, v - n, v - n - m))
        Bt = jnp.where(struct[:, None],
                       A.T[jnp.clip(v, 0, n - 1)].astype(f64),
                       jax.nn.one_hot(unit, m, dtype=f64))
        cB = jnp.where(v >= n + m, 1.0, 0.0).astype(f64)
        xB = jnp.linalg.solve(Bt.T, b0.astype(f64))
        y = jnp.linalg.solve(Bt, cB)
        # A^T y without an f64 copy of A: y splits into two f32 parts,
        # each product accumulated in f64 (exact to ~2^-48 relative).
        y_hi = y.astype(jnp.float32)
        y_lo = (y - y_hi).astype(jnp.float32)
        At_y = accum_matvec(A, y_hi, 0, f64) + accum_matvec(A, y_lo, 0, f64)
        d = jnp.concatenate([-At_y, -y, 1.0 - y])
        z_exact = -jnp.dot(cB, xB, precision=jax.lax.Precision.HIGHEST)
        r = n + 2 * m
        devs = {
            "b": float(jnp.max(jnp.abs(b[:m] - xB))
                       / (1.0 + jnp.max(jnp.abs(xB)))),
            "costs": float(jnp.max(jnp.abs(costs[:r] - d))
                           / (1.0 + jnp.max(jnp.abs(d)))),
            "z": float(jnp.abs(z - z_exact) / (1.0 + jnp.abs(z_exact))),
        }
        ph.extra["max_rel_deviation"] = devs
        for key, dev in devs.items():
            check(dev < NORTHSTAR_TOL[key],
                  f"carried {key} vs f64 from the basis: max rel "
                  f"{dev:.3e} < {NORTHSTAR_TOL[key]}", ph.checks)


def phase_batch(lanes: int, n: int, m: int, oracle_lanes: int) -> None:
    import simplex_tpu as st

    with Phase(f"batch {lanes}x({m}x{n})") as ph:
        problems = [st.generate_random_problem(n, m, 1000 + s, 1.0, 100.0)
                    for s in range(lanes)]
        t0 = time.perf_counter()
        results = st.solve_batch(problems, production())
        ph.extra["solve_batch_s"] = round(time.perf_counter() - t0, 3)
        check(all(r.status == st.Status.OPTIMAL for r in results),
              f"all {lanes} lanes OPTIMAL", ph.checks)
        check(all(r.refine is not None and r.refine.certified
                  for r in results), f"all {lanes} lanes certified",
              ph.checks)
        worst = 0.0
        for p, r in zip(problems[:oracle_lanes], results):
            worst = max(worst, rel(r.objective, st.solve_oracle(p).objective))
        check(worst < 1e-9, f"{oracle_lanes} lanes vs oracle: max rel "
              f"{worst:.3e} < 1e-9", ph.checks)
        # A lane whose first certificate failed is finished in f64 and
        # reports the finisher's pivots; the walk's own count is lost.
        ph.extra["fallback_lanes"] = sum(r.refine.fallback for r in results)
        total = [r.iterations_phase1 + r.iterations_phase2 for r in results
                 if not r.refine.fallback]
        ph.pivots.append(f"per lane min {min(total)} max {max(total)}")


def phase_cli(out_dir: str, seed_file: str = CLI_SEED_FILE) -> None:
    import simplex_tpu as st
    from simplex_tpu import cli

    def written(path):
        with open(path) as fh:
            lines = [l.strip() for l in fh if l.strip()]
        return ([float(l) for l in lines[:-1]],
                float(lines[-1].split(":")[1]))

    with Phase("cli") as ph:
        sol = os.path.join(out_dir, "solution.txt")
        check(cli.main(["-f", os.path.join(EXAMPLES, "smallProblem.txt"),
                        "--data-dir", out_dir]) == 0, "-f exits 0",
              ph.checks)
        x, obj = written(sol)
        check(np.allclose(x, [8.0, 0.0, 0.0]) and obj == 64.0,
              "-f solution.txt: x=(8,0,0), Optimal value 64", ph.checks)
        os.unlink(sol)
        check(cli.main(["-rf", seed_file, "--data-dir", out_dir]) == 0,
              "-rf exits 0", ph.checks)
        x, obj = written(sol)
        want = st.solve_oracle(st.read_random_problem(seed_file))
        # solution.txt holds %f (6 decimals).
        check(abs(obj - want.objective) <= 1e-6 + 1e-9 * abs(want.objective)
              and np.allclose(x, want.x, atol=1e-6),
              f"-rf solution.txt matches the oracle ({obj} vs "
              f"{want.objective:.6f})", ph.checks)


def phase_four_cards_sharded(problem=None, n_devices: int = 4) -> None:
    import jax
    from jax.sharding import Mesh

    import simplex_tpu as st

    with Phase(f"sharded {n_devices} cards") as ph:
        if problem is None:
            problem = st.read_random_problem(FLAGSHIP_SEED_FILE)
        mesh = Mesh(np.array(jax.devices()[:n_devices]), ("vars",))
        t0 = time.perf_counter()
        got = st.solve_sharded(problem, mesh, production())
        ph.extra["sharded_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        one = st.solve(problem, production())
        ph.extra["one_card_s"] = round(time.perf_counter() - t0, 3)
        check(got.status == one.status == st.Status.OPTIMAL,
              "sharded and one-card statuses OPTIMAL", ph.checks)
        check(got.refine.certified and one.refine.certified,
              "both certified", ph.checks)
        ph.extra["refine"] = {"sharded": got.refine._asdict(),
                              "one_card": one.refine._asdict()}
        r = rel(got.objective, one.objective)
        check(r < 1e-9, f"objectives rel {r:.3e} < 1e-9", ph.checks)
        ph.pivots += [f"sharded {pivots(got)}", f"one card {pivots(one)}"]


def phase_four_cards_fleet(lanes: int, n: int, m: int,
                           n_devices: int = 4) -> None:
    import jax
    from jax.sharding import Mesh

    import simplex_tpu as st

    with Phase(f"fleet {n_devices} cards {lanes}x({m}x{n})") as ph:
        problems = [st.generate_random_problem(n, m, 2000 + s, 1.0, 100.0)
                    for s in range(lanes)]
        mesh = Mesh(np.array(jax.devices()[:n_devices]), ("batch",))
        t0 = time.perf_counter()
        fleet = st.solve_batch(problems, production(), mesh=mesh)
        ph.extra["fleet_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        single = st.solve_batch(problems, production())
        ph.extra["one_card_s"] = round(time.perf_counter() - t0, 3)
        check(all(f.status == s.status == st.Status.OPTIMAL
                  for f, s in zip(fleet, single)),
              f"all {lanes} lanes OPTIMAL on both", ph.checks)
        check(all(f.refine.certified and s.refine.certified
                  for f, s in zip(fleet, single)), "all lanes certified",
              ph.checks)
        worst = max(rel(f.objective, s.objective)
                    for f, s in zip(fleet, single))
        check(worst < 1e-9, f"lane by lane: max rel {worst:.3e} < 1e-9",
              ph.checks)
        ph.extra["bitwise_equal_lanes"] = sum(
            f.objective == s.objective for f, s in zip(fleet, single))
        ph.extra["fallback_lanes"] = [sum(r.refine.fallback for r in rs)
                                      for rs in (fleet, single)]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded and fleet "
                             "phases and their one-card comparisons")
    args = parser.parse_args(argv)

    import jax

    from simplex_tpu.device import NoGPUError, card_info, require_gpu

    try:
        device = require_gpu()
    except NoGPUError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    log(f"card: {card_info()} | jax {jax.__version__} | {device}")
    jax.config.update("jax_enable_x64", True)

    if args.four_cards:
        if device["count"] < 4:
            raise CheckFailed(f"--four-cards needs 4 GPUs, found "
                              f"{device['count']}")
        phase_four_cards_sharded()
        phase_four_cards_fleet(*CARD["fleet"])
    else:
        phase_golden()
        phase_flagship()
        phase_northstar(*CARD["northstar"], CARD["northstar_cap"])
        lanes, n, m = CARD["batch"]
        phase_batch(lanes, n, m, CARD["batch_oracle_lanes"])
        out_dir = os.path.join(HERE, "chiprun_out", "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        phase_cli(out_dir)

    print(json.dumps({"ok": True, "device": require_gpu()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
