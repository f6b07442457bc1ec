"""The deferred block-pivot loop (solver.solve_loop_blocked) against the
sequential reference loop, the NumPy oracle and itself across modes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from simplex_tpu import Status, solve
from simplex_tpu.config import SolverOptions
from simplex_tpu.generator import generate_random_problem
from simplex_tpu.oracle import solve_oracle
from simplex_tpu.solver import (apply_window, apply_window_T, solve_loop,
                                solve_loop_blocked)
from simplex_tpu.tableau import build_phase1, gaussian_eliminate


def _tableau(n=60, m=20, seed=5, dtype=np.float64):
    opt = SolverOptions(dtype=np.dtype(dtype))
    rng = np.random.Generator(np.random.Philox(key=seed))
    A = jnp.asarray(rng.uniform(1, 100, (m, n)), opt.dtype)
    b = jnp.asarray(rng.uniform(1, 100, (m,)), opt.dtype)
    return gaussian_eliminate(build_phase1(A, b, n, m, opt)), opt


class TestBlockedLoop:
    """Deferred block pivoting (solver.solve_loop_blocked)."""

    @pytest.mark.parametrize("L", [1, 2, 8, 32])
    def test_matches_sequential_loop_f64(self, L):
        tab, opt = _tableau(n=80, m=25, seed=11)
        optb = dataclasses.replace(opt, block_pivots=L)
        tx, sx, ix = solve_loop(tab, opt, 2000)
        tb, sb, ib = solve_loop_blocked(tab, optb, 2000)
        assert int(sx) == int(sb) == int(Status.OPTIMAL)
        assert int(ix) == int(ib)
        assert np.array_equal(np.asarray(tx.base), np.asarray(tb.base))
        np.testing.assert_allclose(np.asarray(tx.b), np.asarray(tb.b),
                                   rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("seed", [1, 7, 42])
    def test_end_to_end_vs_oracle(self, seed):
        problem = generate_random_problem(120, 40, seed, 1, 100)
        want = solve_oracle(problem)
        got = solve(problem, block_pivots=16)
        assert got.status == Status.OPTIMAL
        assert got.objective == pytest.approx(want.objective, rel=1e-6)

    def test_unbounded(self):
        from simplex_tpu.problem import Problem

        problem = Problem(A=np.array([[-1.0, 1.0]]), b=np.array([1.0]),
                          c=np.array([1.0, 0.0]))
        got = solve(problem, block_pivots=8)
        assert got.status == Status.UNBOUNDED

    def test_infeasible(self, infeasible_problem):
        got = solve(infeasible_problem, block_pivots=8)
        assert got.status == Status.INFEASIBLE


@pytest.mark.parametrize("rule", ["dantzig", "bland"])
@pytest.mark.parametrize("L", [2, 8, 32, 128])
@pytest.mark.parametrize("n,m,seed", [(48, 24, 3), (96, 30, 8),
                                      (130, 33, 21)])
def test_blocked_after_k_pivots_matches_sequential(n, m, seed, L, rule):
    """Stopped after the same K pivots (the per-pivot iteration fuse),
    the f64 blocked loop holds the sequential loop's state: same basis,
    and the same b, reduced costs and (window-applied) tableau to
    round-off. K is below both walks' length, so it ends mid-window for
    most L and the last partial window's apply is checked too."""
    tab, opt = _tableau(n=n, m=m, seed=seed)
    opt = dataclasses.replace(opt, pivot_rule=rule)
    K = 17
    tx, sx, ix = solve_loop(tab, opt, K)
    tb, sb, ib = solve_loop_blocked(
        tab, dataclasses.replace(opt, block_pivots=L), K)
    assert int(ix) == int(ib) == K
    assert int(sx) == int(sb) == int(Status.RUNNING)
    assert np.array_equal(np.asarray(tx.base), np.asarray(tb.base))
    for got, want in ((tb.b, tx.b), (tb.costs, tx.costs), (tb.T, tx.T)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_apply_matches_numpy(dtype):
    """Both apply orientations compute T - C @ F at full precision."""
    rng = np.random.default_rng(4)
    R, M, L = 48, 24, 8
    T = rng.uniform(-1, 1, (R, M)).astype(dtype)
    C = rng.uniform(-1, 1, (R, L)).astype(dtype)
    F = rng.uniform(-1, 1, (L, M)).astype(dtype)
    want = T.astype(np.float64) - C.astype(np.float64) @ F
    tol = 1e-5 if dtype == np.float32 else 1e-12
    got = apply_window(jnp.asarray(T), jnp.asarray(C), jnp.asarray(F))
    np.testing.assert_allclose(np.asarray(got), want, atol=tol)
    got_t = apply_window_T(jnp.asarray(T.T), jnp.asarray(C.T),
                           jnp.asarray(F))
    np.testing.assert_allclose(np.asarray(got_t), want.T, atol=tol)


class TestMixedPrecision:
    """f32 tableau + f64 vectors (SolverOptions.vector_dtype): the
    vectors that integrate per-pivot updates stay drift-free while the
    tableau keeps f32 memory/bandwidth."""

    def test_dtypes(self):
        opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64)
        tab2 = build_phase1(jnp.asarray(np.ones((8, 20))),
                            jnp.asarray(np.ones(8)), 20, 8, opt)
        assert tab2.T.dtype == jnp.float32
        assert tab2.b.dtype == jnp.float64
        assert tab2.costs.dtype == jnp.float64
        assert tab2.z.dtype == jnp.float64

    @pytest.mark.parametrize("L", [None, 16])
    def test_matches_oracle(self, L):
        problem = generate_random_problem(150, 60, 9, 1, 100)
        want = solve_oracle(problem)
        got = solve(problem, dtype=np.float32, vector_dtype=np.float64,
                    eps=1e-5, block_pivots=L)
        assert got.status == Status.OPTIMAL
        assert got.objective == pytest.approx(want.objective, rel=1e-4)


class TestDevex:
    """Devex pricing (pivot_rule='devex', Forrest-Goldfarb reference
    weights) through the blocked loop: fewer pivots than Dantzig, same
    optimum as the oracle."""

    def test_oracle_devex_fewer_pivots_same_optimum(self):
        p = generate_random_problem(256, 96, 5, 1, 100)
        a = solve_oracle(p)
        d = solve_oracle(p, SolverOptions(pivot_rule="devex"))
        assert a.status == d.status == Status.OPTIMAL
        assert d.objective == pytest.approx(a.objective, rel=1e-9)
        assert (d.iterations_phase1 + d.iterations_phase2
                < a.iterations_phase1 + a.iterations_phase2)

    def test_xla_blocked_devex_matches_oracle_walk(self):
        """f64 blocked loop with devex: same pivot counts as the
        oracle's devex walk (both price on exact arithmetic with
        lowest-index ties) and the oracle optimum."""
        p = generate_random_problem(96, 40, 5, 1, 100)
        want = solve_oracle(p, SolverOptions(pivot_rule="devex"))
        got = solve(p, SolverOptions(pivot_rule="devex", block_pivots=8))
        assert got.status == want.status == Status.OPTIMAL
        assert got.iterations_phase1 == want.iterations_phase1
        assert got.iterations_phase2 == want.iterations_phase2
        assert got.objective == pytest.approx(want.objective, rel=1e-9)

    def test_mixed_devex_fewer_pivots_than_dantzig(self):
        """Mixed-precision devex with window re-pricing: the oracle
        optimum after refinement, in fewer pivots than Dantzig."""
        p = generate_random_problem(96, 24, 11, 1, 100)
        want = solve_oracle(p)
        kw = dict(dtype=np.float32, vector_dtype=np.float64,
                  block_pivots=8, eps=1e-5)
        dev = solve(p, SolverOptions(pivot_rule="devex", **kw))
        dan = solve(p, SolverOptions(pivot_rule="dantzig", **kw))
        assert dev.status == dan.status == Status.OPTIMAL
        assert dev.objective == pytest.approx(want.objective, rel=1e-9)
        assert (dev.iterations_phase1 + dev.iterations_phase2
                < dan.iterations_phase1 + dan.iterations_phase2)

    def test_devex_requires_blocked(self):
        p = generate_random_problem(16, 8, 1, 1, 100)
        with pytest.raises(ValueError, match="devex"):
            solve(p, SolverOptions(pivot_rule="devex"))
