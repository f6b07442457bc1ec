"""f64 basis-system refinement at solution extraction (refine.py).

The reference solves in TYPE double end-to-end (macro.h:6) and so its
getSolutionHost extraction (twoPhaseMethod.cu:370-383) reports
f64-class optima; the mixed production mode here (f32 tableau + f64
vectors) matches that only through the refinement layer these tests
pin: mixed+refine must agree with the f64 oracle to <= 1e-9 relative,
certificates must pass, and certificate failure must fall back to an
f64 finishing solve.
"""

import dataclasses

import numpy as np
import pytest

from simplex_tpu import (Problem, SolverOptions, Status,
                         generate_random_problem, solve, solve_batched,
                         solve_oracle)
from simplex_tpu.config import refine_enabled
from simplex_tpu.refine import (certificates_pass, refine_solution,
                                refine_solution_host)
from conftest import assert_valid_solution

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=16)


def mixed_options(**kw):
    return SolverOptions(**{**MIXED, **kw})


class TestGating:
    def test_auto_resolves_to_mixed_only(self):
        assert refine_enabled(mixed_options())
        assert not refine_enabled(SolverOptions())                  # f64
        assert not refine_enabled(SolverOptions(
            dtype=np.float32, vector_dtype=np.float32))             # pure f32
        assert refine_enabled(SolverOptions(refine=True))
        assert not refine_enabled(mixed_options(refine=False))

    def test_f64_parity_mode_untouched(self):
        p = generate_random_problem(60, 30, 3, 1, 100)
        r = solve(p)
        assert r.status == Status.OPTIMAL and r.refine is None

    def test_validation(self):
        with pytest.raises(ValueError):
            SolverOptions(refine="always")
        with pytest.raises(ValueError):
            SolverOptions(refine_iters=0)
        with pytest.raises(ValueError):
            SolverOptions(refine_tol=0.0)


class TestSingleChip:
    @pytest.mark.parametrize("seed", [1, 7, 42, 99, 777])
    def test_mixed_refined_matches_oracle_1e9(self, seed):
        """The round-5 headline contract: mixed + refine == f64 oracle
        to <= 1e-9 relative (the raw mixed envelope is ~1e-4..1e-6)."""
        p = generate_random_problem(200, 80, seed, 1, 100)
        r = solve(p, mixed_options())
        ro = solve_oracle(p)
        assert r.status == ro.status == Status.OPTIMAL
        assert r.refine is not None and r.refine.certified
        assert not r.refine.fallback
        assert r.objective == pytest.approx(ro.objective, rel=1e-9)
        np.testing.assert_allclose(r.x, ro.x, rtol=1e-8, atol=1e-9)
        assert_valid_solution(p, r)

    def test_refinement_actually_improves(self):
        """Guard against the layer silently becoming a no-op: on an
        instance where raw mixed drifts past 1e-7, refined must land
        at 1e-9."""
        p = generate_random_problem(300, 120, 42, 1, 100)
        ro = solve_oracle(p)
        raw = solve(p, mixed_options(refine=False))
        ref = solve(p, mixed_options())
        rel_raw = abs(raw.objective - ro.objective) / abs(ro.objective)
        rel_ref = abs(ref.objective - ro.objective) / abs(ro.objective)
        assert rel_raw > 1e-7          # the drift refinement exists for
        assert rel_ref <= 1e-9

    def test_degenerate_instance(self):
        """A degenerate optimum (redundant constraints) keeps the
        artificial-mass certificate at ~0 and still certifies."""
        A = np.array([[1.0, 1.0], [2.0, 2.0], [1.0, 0.0]])
        b = np.array([4.0, 8.0, 3.0])
        c = np.array([3.0, 2.0])
        p = Problem(A=A, b=b, c=c)
        r = solve(p, mixed_options())
        ro = solve_oracle(p)
        assert r.status == Status.OPTIMAL
        assert r.objective == pytest.approx(ro.objective, rel=1e-9)
        assert r.refine.certified

    def test_negative_rhs(self):
        """b < 0 rows exercise the no-flip-needed argument in the
        module docstring (values are row-scaling invariant)."""
        A = np.array([[-1.0, -1.0], [1.0, 2.0]])
        b = np.array([-1.0, 10.0])
        c = np.array([1.0, 1.0])
        p = Problem(A=A, b=b, c=c)
        r = solve(p, mixed_options())
        ro = solve_oracle(p)
        assert r.status == ro.status == Status.OPTIMAL
        assert r.objective == pytest.approx(ro.objective, rel=1e-9)
        assert r.refine.certified

    def test_tableau_preconditioner_is_the_default_path(self):
        """The LU-free slack-block refinement (r5) certifies the common
        case — no O(m^3) factorization on the production path."""
        p = generate_random_problem(200, 80, 3, 1, 100)
        r = solve(p, mixed_options())
        assert r.status == Status.OPTIMAL
        assert r.refine is not None and r.refine.certified
        assert r.refine.method == "tableau"
        ro = solve_oracle(p)
        assert r.objective == pytest.approx(ro.objective, rel=1e-11)

    def test_equilibrated_solves_refine_in_scaled_space(self):
        """Equilibrated solves refine against the SCALED problem (the
        slack block preconditions it directly — power-of-two scaling is
        exact, certificates are scale-invariant) and unwind exactly."""
        p = generate_random_problem(80, 32, 3, 1, 100)
        r = solve(p, mixed_options(equilibrate=True))
        ro = solve_oracle(p)
        assert r.status == Status.OPTIMAL
        assert r.refine is not None and r.refine.certified
        assert r.refine.method == "tableau"
        assert r.objective == pytest.approx(ro.objective, rel=1e-9)

    def test_impossible_tolerance_still_lands_exact(self):
        """refine_tol below f64 round-off: either a reinversion-restart
        round reaches EXACT-zero residuals (which pass any positive
        tol) or the finishing tiers run — both ways the result is the
        oracle optimum and RefineInfo says which tier delivered it."""
        p = generate_random_problem(100, 40, 5, 1, 100)
        r = solve(p, mixed_options(refine_tol=1e-300))
        ro = solve_oracle(p)
        assert r.status == Status.OPTIMAL
        assert r.refine is not None
        assert (r.refine.certified and r.refine.method == "restart"
                ) or r.refine.fallback
        assert r.objective == pytest.approx(ro.objective, rel=1e-12)

    def test_fallback_when_restart_unavailable(self, monkeypatch):
        """With the restart tier knocked out (simulating the OOM escape
        hatch), an impossible tolerance must reach the host fallback
        tiers and still land on the oracle optimum."""
        import simplex_tpu.reinvert as reinvert

        def boom(*a, **k):
            raise RuntimeError("simulated RESOURCE_EXHAUSTED")

        monkeypatch.setattr(reinvert, "restart_device", boom)
        p = generate_random_problem(100, 40, 5, 1, 100)
        r = solve(p, mixed_options(refine_tol=1e-300))
        ro = solve_oracle(p)
        assert r.status == Status.OPTIMAL
        assert r.refine is not None
        # fallback ran; the info describes the DELIVERED solution (the
        # finishing tier attaches its own certificates — r5 review fix)
        assert r.refine.fallback
        assert r.refine.method in ("finish", "tableau")
        assert r.objective == pytest.approx(ro.objective, rel=1e-12)


class TestHostMirror:
    def test_host_and_device_agree(self):
        """refine_solution (device LU + mixed-precision IR) and
        refine_solution_host (LAPACK f64) must agree to round-off on
        the same basis."""
        p = generate_random_problem(150, 60, 11, 1, 100)
        opts = mixed_options(refine=False)
        r = solve(p, opts)
        assert r.status == Status.OPTIMAL
        # recover the basis by re-running the device core
        import jax.numpy as jnp

        from simplex_tpu.two_phase import solve_device

        out = solve_device(jnp.asarray(p.A), jnp.asarray(p.b),
                           jnp.asarray(p.c), p.vars, p.constraints, opts)
        base = np.asarray(out.base)
        dev = refine_solution(jnp.asarray(p.A), jnp.asarray(p.b),
                              jnp.asarray(p.c), jnp.asarray(base),
                              n=p.vars, m=p.constraints)
        host = refine_solution_host(p.A, p.b, p.c, base,
                                    p.vars, p.constraints)
        assert host is not None
        assert float(dev.objective) == pytest.approx(host.objective,
                                                     rel=1e-12)
        np.testing.assert_allclose(np.asarray(dev.x), host.x,
                                   rtol=1e-10, atol=1e-12)
        assert certificates_pass(host, p.b, p.c, 1e-6)

    def test_host_singular_basis_returns_none(self):
        """A deliberately repeated basis column makes B singular; the
        host mirror reports None instead of raising."""
        p = generate_random_problem(20, 10, 1, 1, 100)
        base = np.zeros(10, np.int32)          # variable 0 basic 10 times
        assert refine_solution_host(p.A, p.b, p.c, base, 20, 10) is None


class TestBatched:
    def test_batched_lanes_refined(self):
        problems = [generate_random_problem(96, 40, s, 1, 100)
                    for s in (1, 2, 3, 4)]
        rs = solve_batched(problems, mixed_options())
        for p, r in zip(problems, rs):
            ro = solve_oracle(p)
            assert r.status == ro.status == Status.OPTIMAL
            assert r.refine is not None and r.refine.certified
            assert r.objective == pytest.approx(ro.objective, rel=1e-9)

    def test_batched_short_window_lanes_refined(self):
        """Short-window (L=8) vmapped lanes go through the same host
        refinement: the window's f32 eta drift is exactly what the
        refinement erases."""
        problems = [generate_random_problem(64, 24, s, 1, 100)
                    for s in (5, 6)]
        rs = solve_batched(problems, mixed_options(block_pivots=8))
        for p, r in zip(problems, rs):
            ro = solve_oracle(p)
            assert r.status == ro.status == Status.OPTIMAL
            assert r.refine is not None and r.refine.certified
            assert r.objective == pytest.approx(ro.objective, rel=1e-9)

    def test_batched_fallback_lane(self):
        problems = [generate_random_problem(48, 20, s, 1, 100)
                    for s in (8, 9)]
        rs = solve_batched(problems, mixed_options(refine_tol=1e-300))
        for p, r in zip(problems, rs):
            ro = solve_oracle(p)
            assert r.refine is not None and r.refine.fallback
            assert r.objective == pytest.approx(ro.objective, rel=1e-12)


class TestSharded:
    def test_sharded_solve_refined(self):
        import jax
        from jax.sharding import Mesh

        from simplex_tpu.parallel.sharded import solve_sharded

        mesh = Mesh(np.array(jax.devices()[:4]), ("vars",))
        p = generate_random_problem(160, 64, 13, 1, 100)
        r = solve_sharded(p, mesh, mixed_options())
        ro = solve_oracle(p)
        assert r.status == ro.status == Status.OPTIMAL
        assert r.refine is not None and r.refine.certified
        # the psum-gathered slack block preconditions it — no LU on the
        # sharded production path either
        assert r.refine.method == "tableau"
        assert r.objective == pytest.approx(ro.objective, rel=1e-9)
