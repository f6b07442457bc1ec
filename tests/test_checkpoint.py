"""Checkpoint/resume (SURVEY.md §5 — no reference equivalent; the solve
state is a pytree, dumped per window of pivots)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from simplex_tpu import Status, generate_random_problem, solve_oracle
from simplex_tpu.checkpoint import load_state, save_state, solve_resumable
from simplex_tpu.config import DEFAULT_OPTIONS
from simplex_tpu.solver import run_solve_loop
from simplex_tpu.tableau import build_phase1, gaussian_eliminate


@pytest.fixture
def problem():
    return generate_random_problem(120, 50, 3, 1, 100)


def test_full_run_with_small_windows(problem, tmp_path):
    path = str(tmp_path / "state.npz")
    want = solve_oracle(problem)
    got = solve_resumable(problem, path, checkpoint_every=50)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert not os.path.exists(path), "checkpoint removed on success"


def test_resume_after_interrupt(problem, tmp_path):
    """Run 30 phase-1 pivots, 'crash', resume from the dump."""
    path = str(tmp_path / "state.npz")
    tab = gaussian_eliminate(build_phase1(
        jnp.asarray(problem.A), jnp.asarray(problem.b), problem.vars,
        problem.constraints, DEFAULT_OPTIONS))
    tab, _, it = run_solve_loop(tab, DEFAULT_OPTIONS, 30)
    assert int(it) == 30
    save_state(path, tab, phase=1, iterations=30)

    want = solve_oracle(problem)
    got = solve_resumable(problem, path, checkpoint_every=50)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)


def test_state_roundtrip(problem, tmp_path):
    path = str(tmp_path / "state.npz")
    tab = gaussian_eliminate(build_phase1(
        jnp.asarray(problem.A), jnp.asarray(problem.b), problem.vars,
        problem.constraints, DEFAULT_OPTIONS))
    save_state(path, tab, phase=1, iterations=7, iters1=3)
    tab2, phase, iterations, iters1, n_shards = load_state(path)
    assert (phase, iterations, iters1, n_shards) == (1, 7, 3, 0)
    assert (tab2.n, tab2.m, tab2.r) == (tab.n, tab.m, tab.r)
    np.testing.assert_array_equal(np.asarray(tab.T), np.asarray(tab2.T))
    np.testing.assert_array_equal(np.asarray(tab.base),
                                  np.asarray(tab2.base))


def test_max_iter_never_overshoots(problem, tmp_path):
    """The final window is capped to the remaining budget, so the total
    pivot count cannot exceed max_iter (it previously overshot by up to
    checkpoint_every - 1)."""
    path = str(tmp_path / "state.npz")
    got = solve_resumable(problem, path, checkpoint_every=40,
                          max_iter=10, bland_threshold=None)
    assert got.status == Status.MAXITER
    assert got.iterations_phase1 == 10


def test_checkpoint_every_clamp_warns(problem, tmp_path):
    path = str(tmp_path / "state.npz")
    with pytest.warns(RuntimeWarning, match="raised to"):
        got = solve_resumable(problem, path, checkpoint_every=10)
    assert got.status == Status.OPTIMAL


def test_shape_mismatch_rejected(problem, tmp_path):
    path = str(tmp_path / "state.npz")
    tab = gaussian_eliminate(build_phase1(
        jnp.asarray(problem.A), jnp.asarray(problem.b), problem.vars,
        problem.constraints, DEFAULT_OPTIONS))
    save_state(path, tab, phase=1, iterations=0)
    other = generate_random_problem(60, 30, 5, 1, 100)
    with pytest.raises(ValueError, match="checkpoint is for"):
        solve_resumable(other, path)


def test_dtype_mismatch_rejected(problem, tmp_path):
    from simplex_tpu.config import SolverOptions

    path = str(tmp_path / "state.npz")
    tab = gaussian_eliminate(build_phase1(
        jnp.asarray(problem.A), jnp.asarray(problem.b), problem.vars,
        problem.constraints, DEFAULT_OPTIONS))
    save_state(path, tab, phase=1, iterations=0)
    with pytest.raises(ValueError, match="dtypes"):
        solve_resumable(problem, path,
                        options=SolverOptions(dtype=np.float32))


# ---------------------------------------------------------------------------
# Sharded checkpoint/resume (VERDICT r2 #4): the n=1M column-sharded solve
# is the longest-running configuration — it gets the same crash-recovery
# contract as the single-chip path, on the virtual 8-device CPU mesh.

def _mesh(n_devices):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n_devices]), ("vars",))


def test_sharded_full_run_with_small_windows(problem, tmp_path):
    from simplex_tpu.checkpoint import solve_resumable_sharded

    path = str(tmp_path / "state.npz")
    want = solve_oracle(problem)
    got = solve_resumable_sharded(problem, _mesh(4), path,
                                  checkpoint_every=50)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert not os.path.exists(path), "checkpoint removed on success"


def test_sharded_resume_midway_matches_oracle(problem, tmp_path):
    """Write a mid-phase-1 sharded checkpoint, then resume from it: the
    windowed sharded runner must pick up the exact state (global arrays
    re-sharded onto the mesh) and finish at the oracle optimum."""
    from simplex_tpu.checkpoint import solve_resumable_sharded

    path = str(tmp_path / "state.npz")

    # Interrupt by running with an artificially tiny max_iter: the
    # checkpoint survives (MAXITER keeps the file for a bigger rerun).
    got = solve_resumable_sharded(problem, _mesh(4), path,
                                  checkpoint_every=50, max_iter=60,
                                  bland_threshold=None)
    assert got.status == Status.MAXITER
    assert os.path.exists(path), "MAXITER keeps the checkpoint"

    want = solve_oracle(problem)
    got = solve_resumable_sharded(problem, _mesh(4), path,
                                  checkpoint_every=50,
                                  bland_threshold=None)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-9)
    assert not os.path.exists(path)


def test_sharded_mesh_width_mismatch_rejected(problem, tmp_path):
    from simplex_tpu.checkpoint import solve_resumable_sharded

    path = str(tmp_path / "state.npz")
    got = solve_resumable_sharded(problem, _mesh(4), path,
                                  checkpoint_every=50, max_iter=60,
                                  bland_threshold=None)
    assert got.status == Status.MAXITER and os.path.exists(path)
    with pytest.raises(ValueError, match="4-shard mesh"):
        solve_resumable_sharded(problem, _mesh(2), path)


def test_single_chip_rejects_sharded_checkpoint(problem, tmp_path):
    from simplex_tpu.checkpoint import solve_resumable_sharded

    path = str(tmp_path / "state.npz")
    got = solve_resumable_sharded(problem, _mesh(4), path,
                                  checkpoint_every=50, max_iter=60,
                                  bland_threshold=None)
    assert got.status == Status.MAXITER and os.path.exists(path)
    with pytest.raises(ValueError, match="sharded"):
        solve_resumable(problem, path)


def test_sharded_checkpoint_blocked_path(problem, tmp_path):
    """The windowed sharded runner dispatches to the sharded blocked
    loop in the mixed production mode like the non-checkpointed path."""
    from simplex_tpu.checkpoint import solve_resumable_sharded
    from simplex_tpu.config import SolverOptions

    path = str(tmp_path / "state.npz")
    opts = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                         eps=1e-5, block_pivots=8)
    want = solve_oracle(problem)
    got = solve_resumable_sharded(problem, _mesh(4), path,
                                  checkpoint_every=60, options=opts)
    assert got.status == Status.OPTIMAL
    assert got.objective == pytest.approx(want.objective, rel=1e-4)
    assert not os.path.exists(path)


def test_reference_degeneracy_deletes_checkpoint(tmp_path):
    """A terminal DEGENERATE verdict (reference policy) removes the
    checkpoint like the other terminal statuses — a rerun would only
    re-derive the same verdict from a stale phase-1 file. The resume
    starts from a hand-built phase-1-OPTIMAL state whose basis still
    holds an artificial at value 0 (the degenerate fingerprint)."""
    from simplex_tpu.problem import Problem
    from simplex_tpu.tableau import Tableau

    n, m = 2, 2
    problem = Problem(A=np.eye(2), b=np.array([1.0, 0.0]),
                      c=np.array([1.0, 1.0]))
    r = n + 2 * m
    R_pad, M_pad = 8, 128
    T = np.zeros((R_pad, M_pad))
    T[0, 0] = 1.0               # x1 basic in constraint 0 at value 1
    T[n + m + 1, 1] = 1.0       # artificial a2 basic at value 0
    base = np.full(M_pad, R_pad, np.int32)
    base[:m] = [0, n + m + 1]
    b = np.zeros(M_pad)
    b[0] = 1.0
    tab = Tableau(T=jnp.asarray(T), b=jnp.asarray(b),
                  costs=jnp.zeros((R_pad,)),   # all >= 0: loop exits
                  z=jnp.zeros(()), base=jnp.asarray(base), n=n, m=m, r=r)
    path = str(tmp_path / "state.npz")
    save_state(path, tab, phase=1, iterations=5)
    got = solve_resumable(problem, path, checkpoint_every=50,
                          degeneracy="reference")
    assert got.status == Status.DEGENERATE
    assert got.degenerate
    assert not os.path.exists(path), (
        "terminal DEGENERATE must delete the checkpoint")
