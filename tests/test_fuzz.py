"""Randomized cross-mode agreement fuzz.

Every solve mode (sequential, deferred block pivoting, the sharded
blocked loop, the vmapped batch) must agree with the NumPy oracle on
status and, for OPTIMAL, on the objective — across a
spread of shapes, seeds, and value ranges, including shapes chosen to
sit on padding boundaries. This is the wide-net complement to the
instance-specific parity tests (tests/test_parity.py asserts bit-level
pivot counts on the reference's own instances; this file asserts
semantic agreement on arbitrary ones).
"""

import numpy as np
import pytest

from simplex_tpu import Status, generate_random_problem, solve, solve_oracle
from simplex_tpu.config import SolverOptions

CASES = [
    # (vars, constraints, seed, lo, hi)
    (8, 3, 1, 1.0, 100.0),
    (17, 9, 2, 1.0, 10.0),        # off the 8-lane grid
    (32, 32, 3, 1.0, 100.0),      # square
    (64, 16, 4, 0.5, 2.0),        # narrow value range (tie-prone)
    (96, 40, 5, 1.0, 100.0),
    (128, 8, 6, 1.0, 1000.0),     # wide aspect, large values
    (40, 24, 7, 1.0, 100.0),
    (200, 50, 8, 1.0, 100.0),
]


def _modes():
    # (name, options, objective rel-tol, feasibility rel-tol): the f32
    # tableau carries ~1e-7-relative coefficient rounding that shows up
    # as ~1e-5-relative constraint residuals in x; the f64 modes are
    # tight.
    yield "f64-seq", dict(dtype=np.float64), 1e-9, 1e-9
    yield "f64-blocked", dict(dtype=np.float64, block_pivots=8), 1e-9, 1e-8
    yield "mixed-blocked", dict(dtype=np.float32,
                                vector_dtype=np.float64,
                                block_pivots=8, eps=1e-5), 1e-4, 1e-4


def test_normalization_identity_below_floor():
    """When BOTH phases' cost scales keep the absolute eps above the
    data-precision floor, scale resolves to exactly 1 and the solve is
    bit-for-bit identical with normalization disabled. Note phase 1's
    cost scale is ~m * mean|A| (eliminated artificial-column sums), so
    this regime needs a small instance; at sweep sizes phase 1's floor
    engages and only SEMANTIC equality holds (covered by
    test_modes_agree_with_oracle)."""
    problem = generate_random_problem(8, 3, 99, 1.0, 10.0)
    kwargs = dict(dtype=np.float32, vector_dtype=np.float64,
                  block_pivots=8, eps=1e-5)
    on = solve(problem, SolverOptions(**kwargs))
    off = solve(problem, SolverOptions(**kwargs, normalize_costs=False))
    assert on.status == off.status == Status.OPTIMAL
    assert on.objective == off.objective            # bit-identical
    assert on.iterations_phase1 == off.iterations_phase1
    assert on.iterations_phase2 == off.iterations_phase2
    np.testing.assert_array_equal(on.x, off.x)


def test_normalization_fixes_large_scale_crawl():
    """The motivating regression: values 1..1000 used to crawl 7,600
    noise pivots into MAXITER under the absolute 1e-5 eps; the floored
    pricing stops at the data-precision optimum in tens of pivots."""
    problem = generate_random_problem(128, 8, 6, 1.0, 1000.0)
    want = solve_oracle(problem)
    got = solve(problem, SolverOptions(dtype=np.float32,
                                       vector_dtype=np.float64,
                                       block_pivots=8, eps=1e-5))
    assert got.status == Status.OPTIMAL
    assert got.iterations_phase1 + got.iterations_phase2 < 200
    scale = 1 + abs(want.objective)
    assert abs(got.objective - want.objective) < 1e-4 * scale


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_modes_agree_infeasible(seed):
    """A nonnegative constraint row with a negative right-hand side is
    unsatisfiable for x >= 0; every mode must report INFEASIBLE."""
    rng = np.random.default_rng(seed)
    base = generate_random_problem(24, 10, seed, 1.0, 100.0)
    b = np.asarray(base.b).copy()
    b[rng.integers(0, 10)] = -5.0
    problem = type(base)(A=base.A, b=b, c=base.c)
    assert solve_oracle(problem).status == Status.INFEASIBLE
    for name, kwargs, _, _ in _modes():
        got = solve(problem, SolverOptions(**kwargs))
        assert got.status == Status.INFEASIBLE, name


@pytest.mark.parametrize("seed", [21, 22])
def test_modes_agree_unbounded(seed):
    """A variable with a profitable objective and a non-positive column
    can grow without bound; every mode must report UNBOUNDED."""
    rng = np.random.default_rng(seed)
    base = generate_random_problem(24, 10, seed, 1.0, 100.0)
    A = np.asarray(base.A).copy()
    j = int(rng.integers(0, 24))
    A[:, j] = -np.abs(A[:, j])
    c = np.asarray(base.c).copy()
    c[j] = abs(c[j]) + 1.0
    problem = type(base)(A=A, b=base.b, c=c)
    assert solve_oracle(problem).status == Status.UNBOUNDED
    for name, kwargs, _, _ in _modes():
        got = solve(problem, SolverOptions(**kwargs))
        assert got.status == Status.UNBOUNDED, name


@pytest.mark.parametrize("n,m,seed,lo,hi", CASES)
def test_modes_agree_with_oracle(n, m, seed, lo, hi):
    problem = generate_random_problem(n, m, seed, lo, hi)
    want = solve_oracle(problem)
    bscale = 1 + np.abs(problem.b).max()
    for name, kwargs, otol, ftol in _modes():
        got = solve(problem, SolverOptions(**kwargs))
        assert got.status == want.status, (name, got.status, want.status)
        if want.status == Status.OPTIMAL:
            scale = 1 + abs(want.objective)
            assert abs(got.objective - want.objective) < otol * scale, (
                name, got.objective, want.objective)
            # The reported x must actually satisfy Ax <= b and
            # reproduce the objective (not just match a number).
            x = np.asarray(got.x)
            resid = (problem.A @ x - problem.b).max()
            assert resid < ftol * bscale, (name, resid)
            assert (x >= -ftol * bscale).all(), name
            assert abs(problem.c @ x - got.objective) < otol * scale, name


MIXED_L8 = dict(dtype=np.float32, vector_dtype=np.float64,
                block_pivots=8, eps=1e-5)


def _check_mixed(problem, want, status, objective, x, label):
    assert status == want.status, (label, status, want.status)
    if want.status == Status.OPTIMAL:
        scale = 1 + abs(want.objective)
        assert abs(objective - want.objective) < 1e-4 * scale, (
            label, objective, want.objective)
        x = np.asarray(x)
        bscale = 1 + np.abs(problem.b).max()
        assert (problem.A @ x - problem.b).max() < 1e-4 * bscale, label
        assert (x >= -1e-4 * bscale).all(), label


@pytest.mark.parametrize("n,m,seed,lo,hi", CASES)
def test_sharded_blocked_agrees_with_oracle(n, m, seed, lo, hi):
    """The sharded blocked loop on the 8-device CPU mesh across the same
    case spread; shapes smaller than the mesh leave shards that own only
    padding rows."""
    import jax
    from jax.sharding import Mesh

    from simplex_tpu.parallel.sharded import solve_sharded

    problem = generate_random_problem(n, m, seed, lo, hi)
    want = solve_oracle(problem)
    mesh = Mesh(np.array(jax.devices()[:8]), ("vars",))
    got = solve_sharded(problem, mesh,
                        SolverOptions(**MIXED_L8, refine=False))
    _check_mixed(problem, want, got.status, got.objective, got.x,
                 "sharded")


@pytest.mark.parametrize("n,m,seed,lo,hi", CASES)
def test_batched_agrees_with_oracle(n, m, seed, lo, hi):
    """The vmapped batch across the same case spread, three lanes per
    case, under both pricing rules of the production loop."""
    from simplex_tpu.batch import solve_batched

    problems = [generate_random_problem(n, m, s, lo, hi)
                for s in (seed, seed + 10, seed + 20)]
    wants = [solve_oracle(p) for p in problems]
    for rule in ("dantzig", "devex"):
        opt = SolverOptions(**MIXED_L8, pivot_rule=rule, refine=False)
        results = solve_batched(problems, opt)
        for p, got, want in zip(problems, results, wants):
            _check_mixed(p, want, got.status, got.objective, got.x, rule)
