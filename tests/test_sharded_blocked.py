"""The sharded blocked loop (parallel/sharded.py
solve_loop_blocked_sharded) on the virtual 8-device CPU mesh: pivot-walk
equality with the unsharded blocked loop, the oracle, devex, and the
per-pivot collective structure."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from simplex_tpu import Status, solve
from simplex_tpu.config import SolverOptions
from simplex_tpu.generator import generate_random_problem
from simplex_tpu.oracle import solve_oracle
from simplex_tpu.parallel import sharded as sh
from simplex_tpu.parallel.sharded import solve_sharded
from simplex_tpu.problem import Problem
from simplex_tpu.tableau import Tableau

from conftest import assert_valid_solution


def mesh_of(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("vars",))


# Walk-equality pins are Dantzig artifacts: devex scores are
# representation-sensitive at near-ties, so its guarantee is optimality
# (+ refinement), not walk equality.
MIXED = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                      eps=1e-5, block_pivots=8, pivot_rule="dantzig",
                      refine=False)
EXACT = SolverOptions(block_pivots=8)


@pytest.mark.parametrize("mode", ["exact", "mixed"])
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_sharded_blocked_matches_unsharded(n_devices, mode):
    """Same pivot walk as the unsharded blocked loop on every mesh
    width: identical pivot counts and basis-determined objective."""
    opt = EXACT if mode == "exact" else MIXED
    problem = generate_random_problem(96, 24, seed=7, lo=1.0, hi=100.0)
    single = solve(problem, opt)
    got = solve_sharded(problem, mesh_of(n_devices), opt)
    assert got.status == single.status == Status.OPTIMAL
    assert got.iterations_phase1 == single.iterations_phase1
    assert got.iterations_phase2 == single.iterations_phase2
    rel = 1e-12 if mode == "exact" else 1e-5
    assert got.objective == pytest.approx(single.objective, rel=rel)
    assert_valid_solution(problem, got, tol=1e-6 if mode == "exact"
                          else 1e-4)


def test_sharded_blocked_matches_oracle():
    problem = generate_random_problem(72, 28, seed=13, lo=1.0, hi=100.0)
    want = solve_oracle(problem)
    got = solve_sharded(problem, mesh_of(4), MIXED)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-4)


def test_sharded_blocked_pure_f32():
    """vector_dtype == dtype == f32: window-boundary re-pricing keeps the
    toy-size walk on the oracle's optimum."""
    opt = SolverOptions(dtype=np.float32, block_pivots=8, eps=1e-4)
    problem = generate_random_problem(64, 16, seed=3, lo=1.0, hi=100.0)
    want = solve_oracle(problem)
    got = solve_sharded(problem, mesh_of(2), opt)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-3)


def test_sharded_blocked_infeasible(infeasible_problem):
    got = solve_sharded(infeasible_problem, mesh_of(2), MIXED)
    assert got.status == Status.INFEASIBLE


def test_sharded_blocked_unbounded():
    problem = Problem(A=np.array([[-1.0, 1.0]]), b=np.array([1.0]),
                      c=np.array([1.0, 0.0]))
    got = solve_sharded(problem, mesh_of(2), MIXED)
    assert got.status == Status.UNBOUNDED


def test_sharded_blocked_degenerate_continue():
    """Redundant constraint: phase 1 ends degenerate, the sharded
    pivot-out repair runs between the two blocked-loop phases."""
    A = np.array([[1.0, 1.0, 1.0],
                  [1.0, 1.0, 1.0],
                  [1.0, -1.0, 0.0]])
    problem = Problem(A=A, b=np.array([4.0, 4.0, 0.0]),
                      c=np.array([2.0, 3.0, 1.0]))
    want = solve_oracle(problem)
    got = solve_sharded(problem, mesh_of(2), MIXED)
    assert want.status == Status.OPTIMAL
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-5)


@pytest.mark.parametrize("n,m,n_shards", [(100, 7, 8), (3, 5, 4),
                                          (96, 24, 1), (1000, 130, 2)])
def test_sharded_padding_divides_mesh(n, m, n_shards):
    """Every shard holds the same whole number of sublane_pad rows and
    the constraint axis is padded to lane_pad."""
    opt = SolverOptions(dtype=np.float32, block_pivots=8)
    R_pad, M_pad = sh.sharded_padded_dims(n, m, n_shards, opt)
    assert R_pad >= n + 2 * m and R_pad % (opt.sublane_pad * n_shards) == 0
    assert R_pad - (n + 2 * m) < opt.sublane_pad * n_shards
    assert M_pad >= m and M_pad % opt.lane_pad == 0


def _collectives(rule):
    opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                        eps=1e-5, block_pivots=8, pivot_rule=rule)
    n, m = 96, 24
    R_pad, M_pad = sh.sharded_padded_dims(n, m, 4, opt)
    tab = Tableau(T=jnp.zeros((R_pad, M_pad), jnp.float32),
                  b=jnp.zeros((M_pad,)), costs=jnp.zeros((R_pad,)),
                  z=jnp.zeros(()), base=jnp.zeros((M_pad,), jnp.int32),
                  n=n, m=m, r=n + 2 * m)
    specs = sh.tableau_specs(n, m, n + 2 * m)
    fn = jax.shard_map(
        lambda t, c0: sh.run_solve_loop_sharded(t, opt, 100, c0),
        mesh=mesh_of(4), in_specs=(specs, P("vars")),
        out_specs=(specs, P(), P()), check_vma=False)
    jaxpr = jax.make_jaxpr(fn)(tab, jnp.zeros((R_pad,)))

    def walk(jx, c):
        for eqn in jx.eqns:
            c[eqn.primitive.name] += 1
            for v in eqn.params.values():
                vs = v if isinstance(v, (list, tuple)) else (v,)
                for x in vs:
                    if hasattr(x, "jaxpr"):
                        walk(x.jaxpr, c)
                    elif hasattr(x, "eqns"):
                        walk(x, c)
        return c

    counts = walk(jaxpr.jaxpr, Counter())
    return {k: v for k, v in counts.items()
            if k in ("all_gather", "psum", "psum_invariant", "all_to_all",
                     "ppermute", "pmin", "pmax")}


@pytest.mark.parametrize("rule,want", [
    ("dantzig", {"all_gather": 4, "psum": 2, "pmax": 1, "pmin": 1}),
    ("devex", {"all_gather": 2, "psum": 2, "pmax": 2, "pmin": 1}),
])
def test_per_pivot_collective_structure_pinned(rule, want):
    """Regression guard on the sharded blocked loop's communication
    structure, counted in the traced program:

    * pivot body: the entering fold's all_gathers (Dantzig: value and
      index of the argmin plus the Bland pair = 4; devex: one stacked
      float gather + one index gather = 2, plus the weight re-anchor's
      pmax) and one psum of the (M_pad,) live entering row;
    * window boundary: one psum (basic-coefficient gather) and one pmin
      (premature-optimal check);
    * once per call: the scale-aware pricing pmax.

    A change that adds a per-pivot collective fails here first."""
    got = _collectives(rule)
    got.pop("psum_invariant", None)
    assert got == want, (rule, got)


def test_sharded_devex_matches_oracle():
    """Sharded devex (weights shard with the costs; the candidate fold
    carries scores + winner weight): oracle optimum with a pivot count
    in the devex regime, across 4 shards."""
    opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                        eps=1e-5, block_pivots=8, pivot_rule="devex",
                        refine=False)
    problem = generate_random_problem(96, 40, seed=5, lo=1.0, hi=100.0)
    want = solve_oracle(problem)
    dant = solve_sharded(problem, mesh_of(4), MIXED)
    got = solve_sharded(problem, mesh_of(4), opt)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-4)
    assert (got.iterations_phase1 + got.iterations_phase2
            < dant.iterations_phase1 + dant.iterations_phase2)


def test_sharded_devex_rejects_sequential_path():
    # Devex needs the deferred block-pivot loop (which carries the
    # weights); the sequential sharded loop rejects it, mirroring
    # solver.run_solve_loop's gate.
    opt = SolverOptions(pivot_rule="devex")   # block_pivots=None
    problem = generate_random_problem(32, 12, seed=3, lo=1.0, hi=100.0)
    with pytest.raises(ValueError, match="devex"):
        solve_sharded(problem, mesh_of(2), opt)


def test_xla_fallback_sharded_devex_matches_single_chip():
    """Devex on the sharded blocked loop (f64 tableau): identical
    status, pivot counts and objective to the single-device blocked
    devex walk, plus the oracle optimum."""
    opt = SolverOptions(block_pivots=8, pivot_rule="devex")   # f64
    problem = generate_random_problem(48, 16, seed=9, lo=1.0, hi=100.0)
    want = solve_oracle(problem)
    single = solve(problem, opt)
    got = solve_sharded(problem, mesh_of(4), opt)
    assert got.status == single.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert got.iterations_phase1 == single.iterations_phase1
    assert got.iterations_phase2 == single.iterations_phase2


def test_xla_fallback_sharded_devex_degenerate_guard():
    """devex_update_sharded's leaving-weight guard must match the
    single-device update's (any in-range row, including a basic
    ARTIFICIAL leaving in phase 2 under degeneracy='continue') so the
    weight state and 1e8 re-anchor trigger stay identical across the two
    paths on degenerate instances — pinned by exact pivot-count parity
    on the canonical degenerate fixtures."""
    opt = SolverOptions(block_pivots=8, pivot_rule="devex")   # f64
    fixtures = [
        Problem(A=np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0],
                            [1.0, -1.0, 0.0]]),
                b=np.array([4.0, 4.0, 0.0]),
                c=np.array([2.0, 3.0, 1.0])),
        Problem(A=np.array([[1.0, 1.0, 0.0], [-1.0, -1.0, 0.0],
                            [1.0, 0.0, 0.0]]),
                b=np.array([3.0, -3.0, 2.0]),
                c=np.array([1.0, 2.0, 0.0])),
    ]
    for problem in fixtures:
        single = solve(problem, opt)
        got = solve_sharded(problem, mesh_of(2), opt)
        assert got.status == single.status
        assert got.iterations_phase1 == single.iterations_phase1
        assert got.iterations_phase2 == single.iterations_phase2
        assert got.objective == pytest.approx(single.objective, rel=1e-9)


def test_xla_fallback_sharded_devex_mixed_precision():
    """Mixed-precision devex through the sharded blocked loop: window
    re-pricing + devex weights together across 2 shards."""
    opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                        eps=1e-5, block_pivots=8, pivot_rule="devex")
    problem = generate_random_problem(64, 20, seed=13, lo=1.0, hi=100.0)
    want = solve_oracle(problem)
    got = solve_sharded(problem, mesh_of(2), opt)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
