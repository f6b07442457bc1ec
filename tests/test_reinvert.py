"""Device reinversion restart (reinvert.py).

Component contract: given a feasible-but-suboptimal basis and its
(possibly drifted) slack block, ``restart_device`` rebuilds an exact
tableau on device (Newton-Schulz sharpened inverse) and the mixed loop
finishes the walk; the follow-up refinement certifies at 1e-9.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from simplex_tpu import (SolverOptions, Status, generate_random_problem,
                         solve, solve_oracle)
from simplex_tpu.refine import (certificates_pass, refine_solution,
                                refine_solution_tableau)
from simplex_tpu.reinvert import restart_device
from simplex_tpu.two_phase import solve_device_with_binv

MIXED = dict(dtype=np.float32, vector_dtype=np.float64, block_pivots=16)


def _drifted_restart_inputs(p, stop_short: int, drift: float,
                            seed: int = 0):
    """The restart tier's true input shape: a FEASIBLE suboptimal basis
    (an oracle walk capped ``stop_short`` pivots early — every simplex
    step preserves feasibility), its exact basic values, and a slack
    block perturbed by ``drift`` relative noise (simulating the f32
    tableau drift Newton-Schulz must sharpen away)."""
    from simplex_tpu.tableau import padded_dims
    from test_finish import _suboptimal_feasible_basis

    m, n = p.constraints, p.vars
    base = np.asarray(_suboptimal_feasible_basis(p, stop_short))
    v = base[:m]
    struct = v < n
    unit = np.where((v >= n) & (v < n + m), v - n, np.arange(m))
    Bt = np.eye(m)[unit]
    Bt[struct] = p.A.T[v[struct]]
    B = Bt.T
    Minv = np.linalg.inv(B)
    xB = np.linalg.solve(B, p.b)
    rng = np.random.default_rng(seed)
    noise = 1.0 + drift * rng.standard_normal(Minv.shape)
    binv_t = jnp.asarray((Minv * noise).T, jnp.float32)

    opts = SolverOptions(**MIXED)
    _, _, M_pad = padded_dims(n, m, opts)
    base_pad = np.full(M_pad, n + 2 * m + 7, np.int32)
    base_pad[:m] = v
    return jnp.asarray(base_pad), binv_t, jnp.asarray(xB)


class TestRestartDevice:
    def test_finishes_and_certifies(self):
        p = generate_random_problem(200, 80, 9, 1, 100)
        want = solve_oracle(p)
        base, binv, xB = _drifted_restart_inputs(p, stop_short=6,
                                                 drift=1e-3)
        A, b, c = (jnp.asarray(p.A), jnp.asarray(p.b), jnp.asarray(p.c))
        ro = jax.device_get(refine_solution_tableau(
            A, b, c, base, binv, n=p.vars, m=p.constraints))
        # capped walk => genuinely suboptimal basis
        assert float(ro.dual_infeasibility) > 1e-3

        opts = SolverOptions(**MIXED)          # production eps
        out2, binv2, ns_res = restart_device(
            A, b, c, base, binv, jnp.asarray(ro.xB),
            p.vars, p.constraints, opts)
        assert int(out2.status) == int(Status.OPTIMAL)
        assert int(out2.iterations_phase2) > 0     # it kept walking
        assert float(ns_res) < 1e-3                # sharpened inverse

        ro2 = jax.device_get(refine_solution_tableau(
            A, b, c, out2.base, binv2, n=p.vars, m=p.constraints))
        assert certificates_pass(ro2, p.b, p.c, 1e-6)
        assert float(ro2.objective) == pytest.approx(want.objective,
                                                     rel=1e-9)

    def test_zero_pivots_from_optimal_basis(self):
        """Restarting from an already-optimal basis is a no-op walk."""
        p = generate_random_problem(120, 48, 4, 1, 100)
        opts = SolverOptions(**MIXED, refine=False)
        out, binv = solve_device_with_binv(
            jnp.asarray(p.A), jnp.asarray(p.b), jnp.asarray(p.c),
            p.vars, p.constraints, opts)
        A, b, c = (jnp.asarray(p.A), jnp.asarray(p.b), jnp.asarray(p.c))
        ro = jax.device_get(refine_solution(
            A, b, c, out.base, n=p.vars, m=p.constraints))
        out2, binv2, ns_res = restart_device(
            A, b, c, out.base, binv, jnp.asarray(ro.xB),
            p.vars, p.constraints, opts)
        assert int(out2.status) == int(Status.OPTIMAL)
        assert int(out2.iterations_phase2) <= 2
        want = solve_oracle(p)
        assert float(out2.objective) == pytest.approx(want.objective,
                                                      rel=1e-4)

    def test_junk_basis_reports_numeric(self):
        """xB far below the mixed envelope poisons the round (the
        driver then falls through to the host tiers)."""
        p = generate_random_problem(64, 24, 2, 1, 100)
        opts = SolverOptions(**MIXED, refine=False)
        out, binv = solve_device_with_binv(
            jnp.asarray(p.A), jnp.asarray(p.b), jnp.asarray(p.c),
            p.vars, p.constraints, opts)
        bad_xB = jnp.full((p.constraints,), -1.0, jnp.float64)
        out2, _, _ = restart_device(
            jnp.asarray(p.A), jnp.asarray(p.b), jnp.asarray(p.c),
            out.base, binv, bad_xB, p.vars, p.constraints, opts)
        assert int(out2.status) == int(Status.NUMERIC)


class TestIntegratedTiering:
    def test_impossible_tol_still_lands_exact(self):
        """refine_tol=1e-300: restart rounds run and fail their own
        certificates, the host tiers finish — the result is still the
        oracle optimum (the tier chain never returns a worse answer)."""
        p = generate_random_problem(96, 40, 6, 1, 100)
        r = solve(p, SolverOptions(**MIXED, refine_tol=1e-300))
        want = solve_oracle(p)
        assert r.status == Status.OPTIMAL
        assert r.refine is not None
        assert (r.refine.certified and r.refine.method == "restart"
                ) or r.refine.fallback
        assert r.objective == pytest.approx(want.objective, rel=1e-12)
