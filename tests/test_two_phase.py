"""End-to-end jitted solver vs oracle and golden outputs
(reference twoPhaseMethod semantics, twoPhaseMethod.cu:385-435)."""

import numpy as np
import pytest

from simplex_tpu import (Problem, SolverOptions, Status,
                         generate_random_problem, solve, solve_oracle)
from conftest import assert_valid_solution


def test_small_problem_golden(small_problem):
    r = solve(small_problem)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(64.0, abs=1e-8)
    np.testing.assert_allclose(r.x, [8.0, 0.0, 0.0], atol=1e-8)
    assert_valid_solution(small_problem, r)


def test_infeasible_problem_golden(infeasible_problem):
    r = solve(infeasible_problem)
    assert r.status == Status.INFEASIBLE
    ro = solve_oracle(infeasible_problem)
    assert r.objective == pytest.approx(ro.objective, rel=1e-9)


def test_unbounded():
    p = Problem(A=np.array([[1.0, -1.0]]), b=np.array([1.0]),
                c=np.array([1.0, 0.0]))
    assert solve(p).status == Status.UNBOUNDED


def test_unbounded_problem_golden():
    """The reference's own unbounded example file, vendored verbatim
    (reference data/examples/unboundedProblem.txt: max 2x0 + x1 s.t.
    x0 - x1 <= 10, 2x0 - x1 <= 40 — x1 grows without bound)."""
    from simplex_tpu import read_problem
    from conftest import DATA

    p = read_problem(DATA / "unboundedProblem.txt")
    assert (p.vars, p.constraints) == (2, 2)
    assert solve(p).status == Status.UNBOUNDED
    assert solve_oracle(p).status == Status.UNBOUNDED
    from simplex_tpu.timed import solve_timed

    assert solve_timed(p).status == Status.UNBOUNDED


def test_matches_oracle_on_random_instances():
    for seed in (1, 7, 42, 99):
        p = generate_random_problem(50, 30, seed, 1, 100)
        r = solve(p)
        ro = solve_oracle(p)
        assert r.status == ro.status == Status.OPTIMAL
        assert r.objective == pytest.approx(ro.objective, rel=1e-6)
        assert_valid_solution(p, r)
        # Same deterministic pivot sequence -> same iteration counts.
        assert (r.iterations_phase1, r.iterations_phase2) == (
            ro.iterations_phase1, ro.iterations_phase2)


def test_matches_oracle_mixed_sign():
    rng = np.random.default_rng(5)
    for _ in range(8):
        m, n = int(rng.integers(3, 15)), int(rng.integers(3, 15))
        A = rng.normal(size=(m, n))
        x0 = rng.uniform(0, 2, size=n)
        b = A @ x0 + rng.uniform(0.1, 1.0, size=m)
        A = np.vstack([A, np.ones(n)])
        b = np.append(b, x0.sum() + 10.0)
        p = Problem(A=A, b=b, c=rng.normal(size=n))
        r, ro = solve(p), solve_oracle(p)
        assert r.status == ro.status == Status.OPTIMAL
        assert r.objective == pytest.approx(ro.objective, rel=1e-8)
        assert_valid_solution(p, r)


def test_negative_rhs():
    p = Problem(A=np.array([[-1.0, 0.0], [1.0, 1.0]]),
                b=np.array([-2.0, 5.0]), c=np.array([1.0, 1.0]))
    r = solve(p)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(5.0, abs=1e-8)
    assert_valid_solution(p, r)


def test_degenerate_continue_and_reference_modes():
    p = Problem(A=np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
                b=np.array([0.0, 0.0, 4.0]), c=np.array([1.0, 1.0]))
    r_cont = solve(p)
    assert r_cont.status == Status.OPTIMAL
    assert r_cont.objective == pytest.approx(4.0, abs=1e-8)
    r_ref = solve(p, degeneracy="reference")
    ro_ref = solve_oracle(p, SolverOptions(degeneracy="reference"))
    assert r_ref.status == ro_ref.status


def test_bland_pivot_rule():
    p = generate_random_problem(30, 20, 11, 1, 100)
    r = solve(p, pivot_rule="bland")
    ro = solve_oracle(p, SolverOptions(pivot_rule="bland"))
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(ro.objective, rel=1e-8)
    assert r.iterations == ro.iterations


def test_cycling_instance_terminates():
    A = np.array([
        [0.25, -8.0, -1.0, 9.0],
        [0.5, -12.0, -0.5, 3.0],
        [0.0, 0.0, 1.0, 0.0],
    ])
    p = Problem(A=A, b=np.array([0.0, 0.0, 1.0]),
                c=np.array([0.75, -20.0, 0.5, -6.0]))
    r = solve(p, bland_threshold=10)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(1.25, abs=1e-8)


def test_maxiter_fuse():
    p = generate_random_problem(40, 30, 5, 1, 100)
    r = solve(p, max_iter=1)
    assert r.status == Status.MAXITER


def test_float32_mode():
    p = generate_random_problem(40, 30, 3, 1, 100)
    r32 = solve(p, dtype=np.float32, eps=1e-4)
    r64 = solve_oracle(p)
    assert r32.status == Status.OPTIMAL
    assert r32.objective == pytest.approx(r64.objective, rel=1e-3)


def test_wide_and_tall_shapes():
    # Wide (vars >> constraints) and tall (constraints >> vars) like the
    # reference sweep extremes (benchmark_8192_256 / benchmark_256_8192).
    for n, m in ((200, 10), (10, 200)):
        p = generate_random_problem(n, m, n * 100 + m, 1, 100)
        r, ro = solve(p), solve_oracle(p)
        assert r.status == ro.status == Status.OPTIMAL
        assert r.objective == pytest.approx(ro.objective, rel=1e-6)


def test_chunked_flagship_build_matches_oneshot(monkeypatch):
    """build_phase1's chunked structural fill (used past
    BUILD_CHUNK_BYTES to keep multi-GB flagship builds in device memory) is
    bitwise identical to the one-shot concat path, including the
    clamped-overlap tail chunk and negative-b sign flips."""
    import jax.numpy as jnp

    import simplex_tpu.tableau as tb
    from simplex_tpu.config import SolverOptions

    opts = SolverOptions(dtype=np.float32, vector_dtype=np.float64)
    rng = np.random.default_rng(7)
    m, n = 48, 300                      # n not divisible by the chunk
    A = jnp.asarray(rng.uniform(-5, 5, (m, n)), jnp.float32)
    b = jnp.asarray(rng.uniform(-2, 5, (m,)))   # mixed-sign rows
    want = tb.build_phase1(A, b, n, m, opts)
    monkeypatch.setattr(tb, "BUILD_CHUNK_BYTES", 1)   # force chunked
    got = tb.build_phase1(A, b, n, m, opts)
    for f in ("T", "b", "costs", "z", "base"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      np.asarray(getattr(got, f)))
