"""NumPy oracle two-phase simplex (semantics of solver.cu:78-126,
twoPhaseMethod.cu:225-356)."""

import numpy as np
import pytest

from simplex_tpu import (Problem, SolverOptions, Status,
                         generate_random_problem, solve_oracle)
from conftest import assert_valid_solution


def test_small_problem_golden(small_problem):
    r = solve_oracle(small_problem)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(64.0, abs=1e-9)
    np.testing.assert_allclose(r.x, [8.0, 0.0, 0.0], atol=1e-9)
    assert_valid_solution(small_problem, r)


def test_infeasible_problem_golden(infeasible_problem):
    r = solve_oracle(infeasible_problem)
    assert r.status == Status.INFEASIBLE


def test_unbounded():
    # max x1 with x1 - x2 <= 1: ray x1 = x2 + 1 -> unbounded.
    p = Problem(A=np.array([[1.0, -1.0]]), b=np.array([1.0]),
                c=np.array([1.0, 0.0]))
    r = solve_oracle(p)
    assert r.status == Status.UNBOUNDED


def test_negative_rhs_feasible():
    # max x1+x2 s.t. -x1 <= -2 (x1 >= 2), x1 + x2 <= 5 -> optimum 5.
    p = Problem(A=np.array([[-1.0, 0.0], [1.0, 1.0]]),
                b=np.array([-2.0, 5.0]), c=np.array([1.0, 1.0]))
    r = solve_oracle(p)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(5.0, abs=1e-8)
    assert_valid_solution(p, r)


def test_degenerate_reference_mode():
    # Redundant constraints with b=0 keep an artificial basic at phase-1
    # optimum often enough; craft one: x1 <= 0 twice.
    p = Problem(A=np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                b=np.array([0.0, 0.0, 4.0]), c=np.array([1.0, 1.0]))
    r_ref = solve_oracle(p, SolverOptions(degeneracy="reference"))
    r_cont = solve_oracle(p, SolverOptions(degeneracy="continue"))
    # continue-mode must still solve it: optimum x=(0,4) -> 4.
    assert r_cont.status == Status.OPTIMAL
    assert r_cont.objective == pytest.approx(4.0, abs=1e-8)
    # reference mode either solves it (no artificial stuck) or reports
    # DEGENERATE; in both cases 'continue' dominates.
    assert r_ref.status in (Status.OPTIMAL, Status.DEGENERATE)
    if r_ref.status == Status.DEGENERATE:
        assert r_cont.degenerate


def test_random_instances_feasible_and_consistent():
    # b, c, A in [1,100] => x=0 feasible, bounded (all coeffs positive).
    for seed in (1, 7, 42):
        p = generate_random_problem(60, 40, seed, 1, 100)
        r = solve_oracle(p)
        assert r.status == Status.OPTIMAL, seed
        assert_valid_solution(p, r)


def test_random_mixed_sign_instances():
    # Mixed-sign instances built to be feasible (b = A@x0 + slack for a
    # known x0 >= 0) and bounded (a sum(x) <= M row), so every one must
    # reach OPTIMAL with a certified solution.
    rng = np.random.default_rng(3)
    for _ in range(10):
        m, n = int(rng.integers(3, 12)), int(rng.integers(3, 12))
        A = rng.normal(size=(m, n))
        x0 = rng.uniform(0, 2, size=n)
        b = A @ x0 + rng.uniform(0.1, 1.0, size=m)
        A = np.vstack([A, np.ones(n)])
        b = np.append(b, x0.sum() + 10.0)
        p = Problem(A=A, b=b, c=rng.normal(size=n))
        r = solve_oracle(p)
        assert r.status == Status.OPTIMAL
        assert_valid_solution(p, r)
        # x0 feasible => optimum at least c@x0.
        assert r.objective >= p.c @ x0 - 1e-8


def test_bland_rule_agrees_with_dantzig():
    p = generate_random_problem(30, 20, 11, 1, 100)
    r_d = solve_oracle(p, SolverOptions(pivot_rule="dantzig"))
    r_b = solve_oracle(p, SolverOptions(pivot_rule="bland"))
    assert r_d.status == r_b.status == Status.OPTIMAL
    assert r_b.objective == pytest.approx(r_d.objective, rel=1e-9)


def test_beale_cycling_resolved():
    """Beale-style cycling instance (degenerate vertex at the origin, exact
    ties): pure Dantzig can cycle; the Bland fallback must terminate at the
    true optimum 1.25 (x = (1, 0, 1, 0): binding rows 2 and 3)."""
    A = np.array([
        [0.25, -8.0, -1.0, 9.0],
        [0.5, -12.0, -0.5, 3.0],
        [0.0, 0.0, 1.0, 0.0],
    ])
    b = np.array([0.0, 0.0, 1.0])
    c = np.array([0.75, -20.0, 0.5, -6.0])
    p = Problem(A=A, b=b, c=c)
    r = solve_oracle(p, SolverOptions(bland_threshold=10))
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(1.25, abs=1e-8)


def test_maxiter_fuse():
    p = generate_random_problem(40, 30, 5, 1, 100)
    r = solve_oracle(p, SolverOptions(max_iter=1))
    assert r.status == Status.MAXITER
