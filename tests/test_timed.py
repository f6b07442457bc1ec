"""The per-operation timed driver (timed.solve_timed) — the -D TIMER
build of the reference (twoPhaseMethod.cu:225-435 + chrono.cu).

Covers both timing modes (aggregate per-phase rows vs the reference's
one-``solve``-row-per-pivot behaviour, solver.cu:84-123), the Chrono CSV
schema (``vars,contraints,operation,elapsed_time``, chrono.cu:29 — the
reference's header typo is reproduced verbatim), and result parity with
the fused two_phase.solve path on golden/degenerate/infeasible inputs.
"""

import glob
import os

import numpy as np
import pytest

from simplex_tpu import Problem, Status, read_problem, solve
from simplex_tpu.chrono import Chrono
from simplex_tpu.timed import solve_timed

from conftest import DATA

# The op sequence the reference times (twoPhaseMethod.cu:230-425).
TIMED_OPS = ("fillTableau", "gauss1", "solve", "checkDegeneracy",
             "costsVector", "gauss2", "solution")


def read_csv(data_dir):
    path = sorted(glob.glob(os.path.join(data_dir, "times_*.txt")))[-1]
    rows = open(path).read().strip().splitlines()
    assert rows[0] == "vars,contraints,operation,elapsed_time"
    return [r.split(",") for r in rows[1:]]


def test_aggregate_mode_golden_and_csv(tmp_path):
    p = read_problem(DATA / "smallProblem.txt")
    ch = Chrono.open_timestamped(str(tmp_path))
    with ch:
        r = solve_timed(p, chrono=ch)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(64.0, abs=1e-9)
    ops = [row[2] for row in read_csv(str(tmp_path))]
    for op in TIMED_OPS:
        assert op in ops, (op, ops)
    # Aggregate mode: exactly one solve row per phase + iteration counts.
    assert ops.count("solve") == 2
    assert ops.count("solveIterations") == 2


def test_per_iteration_mode_rows_match_pivots(tmp_path):
    p = read_problem(DATA / "smallProblem.txt")
    ch = Chrono.open_timestamped(str(tmp_path))
    with ch:
        r = solve_timed(p, chrono=ch, per_iteration=True)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(64.0, abs=1e-9)
    solve_rows = [row for row in read_csv(str(tmp_path))
                  if row[2] == "solve"]
    # One row per host-driven pivot step; >= pivots because each phase's
    # final (exit-detecting) step is also timed (reference behaviour:
    # the optimality-detecting cycle gets a row too, solver.cu:84-123).
    pivots = r.iterations_phase1 + r.iterations_phase2
    assert pivots <= len(solve_rows) <= pivots + 2
    # Both phases' row shapes appear: phase-1 rows = n+2m+1 tableau rows.
    vars_cols = {(row[0], row[1]) for row in solve_rows}
    assert ("8", "2") in vars_cols          # n=3, m=2 -> 3+2*2+1 = 8
    assert ("6", "2") in vars_cols          # phase 2: 3+2+1 = 6


def test_infeasible_and_agreement_with_fused_path():
    p = read_problem(DATA / "infeasibleProblem.txt")
    r = solve_timed(p)
    assert r.status == Status.INFEASIBLE
    assert r.x is None

    rng = np.random.default_rng(5)
    q = Problem(A=rng.uniform(1, 100, (20, 40)),
                b=rng.uniform(1, 100, 20), c=rng.uniform(1, 100, 40))
    rt, rf = solve_timed(q), solve(q)
    assert rt.status == rf.status == Status.OPTIMAL
    assert rt.objective == pytest.approx(rf.objective, rel=1e-12)
    assert rt.iterations_phase1 == rf.iterations_phase1
    assert rt.iterations_phase2 == rf.iterations_phase2
    np.testing.assert_allclose(rt.x, rf.x, atol=1e-9)


def test_degeneracy_reference_policy_parity():
    # Zero-RHS degenerate instance: both drivers must agree under both
    # degeneracy policies (continue-and-resolve vs reference classify).
    A = np.array([[1.0, 1.0], [1.0, -1.0]])
    p = Problem(A=A, b=np.array([2.0, 0.0]), c=np.array([1.0, 1.0]))
    for kwargs in ({}, {"degeneracy": "reference"}):
        rt, rf = solve_timed(p, **kwargs), solve(p, **kwargs)
        assert rt.status == rf.status
        if rt.status == Status.OPTIMAL:
            assert rt.objective == pytest.approx(rf.objective, rel=1e-12)


def test_per_iteration_warns_when_block_pivots_ignored():
    """--per-iteration drives the single-pivot loop; a configured
    block_pivots must produce a loud warning, not silent divergence."""
    problem = read_problem(DATA / "smallProblem.txt")
    with pytest.warns(RuntimeWarning, match="block_pivots=16 is ignored"):
        r = solve_timed(problem, per_iteration=True, block_pivots=16)
    assert r.status == Status.OPTIMAL
    assert r.objective == pytest.approx(64.0, abs=1e-8)


def test_per_iteration_debug_dumps_every_pivot(capsys):
    """debug=True + per_iteration=True prints the tableau after EVERY
    pivot (the reference's -D DEBUG behaviour, solver.cu:112-116)."""
    problem = read_problem(DATA / "smallProblem.txt")
    r = solve_timed(problem, per_iteration=True, debug=True)
    assert r.status == Status.OPTIMAL
    out = capsys.readouterr().out
    n_pivots = r.iterations_phase1 + r.iterations_phase2
    assert n_pivots >= 1
    dumps = [l for l in out.splitlines() if l.startswith("--- pivot ")]
    assert len(dumps) == n_pivots


def test_aggregate_windowing_matches_unwindowed(monkeypatch, tmp_path):
    """The device-call pivot cap (DEVICE_CALL_PIVOT_CAP) re-enters the host
    between fixed-size solve windows; pivot counts, objective, and the
    CSV row contract must be identical to a single unbounded call — for
    both the single-pivot loop and the blocked (deferred-pivot) loop."""
    import simplex_tpu.timed as timed

    rng = np.random.default_rng(11)
    p = Problem(A=rng.uniform(1, 100, (24, 48)),
                b=rng.uniform(1, 100, 24), c=rng.uniform(1, 100, 48))
    for kwargs in ({}, {"block_pivots": 8}):
        ref = solve_timed(p, **kwargs)
        assert ref.status == Status.OPTIMAL
        assert ref.iterations_phase1 + ref.iterations_phase2 > 7
        monkeypatch.setattr(timed, "DEVICE_CALL_PIVOT_CAP", 7)
        ch = Chrono.open_timestamped(str(tmp_path))
        with ch:
            r = solve_timed(p, chrono=ch, **kwargs)
        monkeypatch.undo()
        assert r.status == ref.status
        assert r.objective == pytest.approx(ref.objective, rel=1e-12)
        assert r.iterations_phase1 == ref.iterations_phase1
        assert r.iterations_phase2 == ref.iterations_phase2
        np.testing.assert_allclose(r.x, ref.x, atol=1e-9)
        ops = [row[2] for row in read_csv(str(tmp_path))]
        # Still ONE aggregate solve row per phase: the windows run inside
        # a single chrono.start/stop bracket.
        assert ops.count("solve") == 2
        assert ops.count("solveIterations") == 2


def test_zero_pivot_window_maps_to_maxiter(monkeypatch):
    """A solve window returning RUNNING with 0 pivots (the device-side
    zero-pivot-cycle guard's outcome) must terminate the host loop as
    MAXITER instead of re-running the identical window forever."""
    import jax.numpy as jnp

    import simplex_tpu.timed as timed
    from simplex_tpu.chrono import NullChrono
    from simplex_tpu.tableau import build_phase1
    from simplex_tpu.config import DEFAULT_OPTIONS

    rng = np.random.default_rng(5)
    A = rng.uniform(1, 10, (4, 8))
    tab = build_phase1(jnp.asarray(A), jnp.asarray(rng.uniform(1, 10, 4)),
                       8, 4, DEFAULT_OPTIONS)
    calls = []

    class FakeCompiled:
        def __call__(self, t, costs0=None):
            calls.append(1)
            return t, jnp.int32(int(Status.RUNNING)), jnp.int32(0)

    class FakeLowered:
        def compile(self):
            return FakeCompiled()

    monkeypatch.setattr(timed, "_solve",
                        type("S", (), {"lower":
                                       staticmethod(lambda *a: FakeLowered())}))
    out_tab, status, total = timed._run_solve(
        tab, DEFAULT_OPTIONS, 1000, NullChrono(), None, False)
    assert status == int(Status.MAXITER)
    assert total == 0
    assert len(calls) == 1          # exactly one window, no host loop


def test_sweep_resume_skips_complete_csvs(tmp_path, capsys):
    """-t --timer --resume-sweep re-runs only sizes whose CSV is missing
    or truncated (crash recovery for the 36-size sweep)."""
    from simplex_tpu.cli import _sweep_csv_complete

    measures = str(tmp_path)
    path = os.path.join(measures, "benchmark_256_256.txt")
    assert not _sweep_csv_complete(measures, 256, 256)
    # Truncated file (dangling row, as left by a mid-solve crash).
    with open(path, "w") as fh:
        fh.write("vars,contraints,operation,elapsed_time\n"
                 "769,256,fillTableau,1000.0\n769,256,solve,")
    assert not _sweep_csv_complete(measures, 256, 256)
    with open(path, "a") as fh:
        fh.write("5.0\n513,256,solveIterations,0.00001\n"
                 "513,256,solution,42.0\n")
    assert _sweep_csv_complete(measures, 256, 256)


def test_sweep_resume_manifest_covers_non_optimal(tmp_path):
    """A size that legitimately ended INFEASIBLE/MAXITER has no
    `solution` row; the sweep manifest records it as done so
    --resume-sweep does not re-measure it on every resume."""
    from simplex_tpu.cli import _sweep_csv_complete, _sweep_manifest

    measures = str(tmp_path)
    path = os.path.join(measures, "benchmark_512_256.txt")
    # CSV ends on phase-1 solveIterations: indistinguishable from a
    # crash right after phase 1 — incomplete without a manifest entry.
    with open(path, "w") as fh:
        fh.write("vars,contraints,operation,elapsed_time\n"
                 "1025,256,fillTableau,1000.0\n"
                 "1025,256,solve,5000.0\n"
                 "1025,256,solveIterations,0.0005\n")
    assert not _sweep_csv_complete(measures, 512, 256)
    with open(_sweep_manifest(measures), "a") as fh:
        fh.write("512_256 INFEASIBLE\n")
    assert _sweep_csv_complete(measures, 512, 256)
    # Other sizes are not affected by the entry.
    assert not _sweep_csv_complete(measures, 256, 256)


def test_debug_pause_waits_for_enter(small_problem, capsys, monkeypatch):
    """--pause: the reference DEBUG build's getchar() per dump
    (solver.cu:112-116) — every tableau dump waits for Enter."""
    prompts = []

    def fake_input(prompt=""):
        prompts.append(prompt)
        return ""

    monkeypatch.setattr("builtins.input", fake_input)
    from simplex_tpu.timed import solve_timed

    result = solve_timed(small_problem, per_iteration=True, debug=True,
                         pause=True)
    assert result.status.name == "OPTIMAL"
    out = capsys.readouterr().out
    n_dumps = out.count("--- ")
    assert prompts and len(prompts) == n_dumps
