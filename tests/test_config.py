"""Epsilon resolution policy (config.SolverOptions.eps_resolved).

An f32 tableau carries ~1e-6-relative noise in every re-priced reduced
cost; the reference's 1e-9 discipline (macro.h:28) then sees noise as
eligible entering columns and pivots degenerately forever at the optimal
vertex. eps=None therefore resolves by tableau dtype — and the
resolution must survive ``dataclasses.replace`` (the keyword path every
``solve(p, dtype=...)`` call goes through), which once carried the f64
default's resolved 1e-9 into f32 runs and turned a 33-pivot phase 2
into a 150,000-pivot MAXITER crawl.
"""

import dataclasses

import numpy as np
import pytest

import simplex_tpu as st
from simplex_tpu.config import DEFAULT_OPTIONS, EPS, EPS_F32, SolverOptions


class TestEpsResolution:
    def test_default_f64(self):
        assert SolverOptions().eps is None
        assert SolverOptions().eps_resolved == EPS

    def test_default_f32(self):
        assert SolverOptions(dtype=np.float32).eps_resolved == EPS_F32

    def test_mixed_precision_uses_tableau_dtype(self):
        o = SolverOptions(dtype=np.float32, vector_dtype=np.float64)
        assert o.eps_resolved == EPS_F32

    def test_explicit_eps_honored(self):
        assert SolverOptions(dtype=np.float32, eps=1e-6).eps_resolved == 1e-6
        assert SolverOptions(eps=1e-5).eps_resolved == 1e-5

    def test_replace_dtype_reresolves(self):
        """The footgun: replace() re-runs __post_init__, so a dtype
        override must pick up the new dtype's default instead of the
        donor's resolved value."""
        o = dataclasses.replace(DEFAULT_OPTIONS, dtype=np.float32,
                                vector_dtype=np.float64)
        assert o.eps is None
        assert o.eps_resolved == EPS_F32

    def test_replace_preserves_explicit_eps(self):
        o = SolverOptions(dtype=np.float32, eps=1e-6)
        o2 = dataclasses.replace(o, dtype=np.float64)
        assert o2.eps_resolved == 1e-6


class TestPivotRuleResolution:
    """The r5 production default: devex for f32 blocked configs, the
    reference's own Dantzig rule (solver.cu:87) everywhere else."""

    def test_mixed_blocked_resolves_devex(self):
        o = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                          block_pivots=128)
        assert o.pivot_rule_resolved == "devex"

    def test_f64_parity_mode_stays_dantzig(self):
        assert SolverOptions().pivot_rule_resolved == "dantzig"
        assert SolverOptions(
            dtype=np.float64,
            block_pivots=128).pivot_rule_resolved == "dantzig"

    def test_sequential_f32_stays_dantzig(self):
        assert SolverOptions(
            dtype=np.float32).pivot_rule_resolved == "dantzig"

    def test_explicit_rule_wins(self):
        o = SolverOptions(dtype=np.float32, block_pivots=128,
                          pivot_rule="dantzig")
        assert o.pivot_rule_resolved == "dantzig"

    def test_replace_rederives_rule(self):
        o = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                          block_pivots=128)
        o2 = dataclasses.replace(o, dtype=np.float64,
                                 vector_dtype=np.float64)
        assert o2.pivot_rule_resolved == "dantzig"

    def test_unknown_rule_rejected(self):
        with pytest.raises(ValueError):
            SolverOptions(pivot_rule="steepest")


@pytest.mark.slow
def test_degenerate_crawl_instance_terminates():
    """n=300 m=900 seed=777: phase 2 visits a degenerate optimal vertex
    where eps=1e-9 + f32 noise never detects optimality (150k-pivot
    crawl). With the dtype-resolved eps the keyword-path solve matches
    the oracle in the oracle's own pivot counts."""
    p = st.generate_random_problem(300, 900, 777, 1, 100)
    r = st.solve(p, dtype=np.float32, vector_dtype=np.float64,
                 block_pivots=32)
    ro = st.solve_oracle(p)
    assert r.status == ro.status == st.Status.OPTIMAL
    assert abs(r.objective - ro.objective) < 1e-3 * (1 + abs(ro.objective))
    assert r.iterations_phase2 < 200
