"""The vmapped batch (batch.solve_batched): lanes that end in different
statuses share one device loop, and a fleet sharded over a 'batch' mesh
gives the unsharded batch's answers lane by lane."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from simplex_tpu import Status, generate_random_problem, solve_oracle
from simplex_tpu.batch import solve_batched
from simplex_tpu.config import SolverOptions
from simplex_tpu.problem import Problem

N, M, CAP = 24, 10, 14


def _infeasible(seed):
    p = generate_random_problem(N, M, seed, 1.0, 100.0)
    b = np.asarray(p.b).copy()
    b[seed % M] = -5.0                 # nonnegative row, negative rhs
    return Problem(A=p.A, b=b, c=p.c)


def _unbounded(seed):
    p = generate_random_problem(N, M, seed, 1.0, 100.0)
    A = np.asarray(p.A).copy()
    c = np.asarray(p.c).copy()
    j = seed % N
    A[:, j] = -np.abs(A[:, j])         # column j never leaves
    c[j] = abs(c[j]) + 1.0
    return Problem(A=A, b=p.b, c=c)


def _mixed_status_lanes():
    """One lane of each terminal kind at the per-phase cap CAP, chosen by
    the oracle's own walk: OPTIMAL, INFEASIBLE, UNBOUNDED, and a lane
    whose walk is longer than CAP (MAXITER)."""
    capped = SolverOptions(max_iter=CAP)
    found = {}
    for seed in range(1, 200):
        for make in (lambda s: generate_random_problem(N, M, s, 1.0, 100.0),
                     _infeasible, _unbounded):
            p = make(seed)
            st = solve_oracle(p, capped).status
            found.setdefault(st, p)
        if len(found) >= 4:
            break
    want = (Status.OPTIMAL, Status.INFEASIBLE, Status.UNBOUNDED,
            Status.MAXITER)
    assert set(want) <= set(found), sorted(found)
    return [found[s] for s in want]


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("block", [None, 8])
def test_batch_mixes_terminal_statuses(block, order):
    """Lanes that finish OPTIMAL, INFEASIBLE, UNBOUNDED or hit the
    iteration fuse in one vmapped call each report the oracle's status
    (f64, Dantzig: the same walk), and OPTIMAL lanes its objective —
    whichever lane is slowest."""
    lanes = _mixed_status_lanes()
    if order == "reversed":
        lanes = lanes[::-1]
    opt = SolverOptions(max_iter=CAP, block_pivots=block)
    got = solve_batched(lanes, opt)
    for p, r in zip(lanes, got):
        want = solve_oracle(p, SolverOptions(max_iter=CAP))
        assert r.status == want.status, (r.status, want.status)
        if want.status == Status.OPTIMAL:
            assert r.objective == pytest.approx(want.objective, rel=1e-9)
            assert r.iterations_phase1 == want.iterations_phase1
            assert r.iterations_phase2 == want.iterations_phase2
        else:
            assert r.x is None


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_fleet_matches_unsharded_batch(n_devices):
    """A 'batch'-mesh fleet (vmapped core per device under shard_map)
    answers every lane exactly like the unsharded batch: same status,
    pivot counts and certified objective."""
    opt = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                        block_pivots=8)
    problems = [generate_random_problem(64, 20, seed=300 + s, lo=1.0,
                                        hi=100.0)
                for s in range(2 * n_devices)]
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("batch",))
    fleet = solve_batched(problems, opt, mesh=mesh)
    single = solve_batched(problems, opt)
    for rf, rs in zip(fleet, single):
        assert rf.status == rs.status == Status.OPTIMAL
        assert rf.refine.certified and rs.refine.certified
        assert (rf.iterations_phase1, rf.iterations_phase2) == (
            rs.iterations_phase1, rs.iterations_phase2)
        assert rf.objective == rs.objective


def test_fleet_rejects_uneven_batch():
    problems = [generate_random_problem(16, 6, seed=s, lo=1.0, hi=100.0)
                for s in range(3)]
    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
    with pytest.raises(ValueError, match="divide"):
        solve_batched(problems, mesh=mesh)


def test_batch_rejects_mixed_shapes():
    problems = [generate_random_problem(16, 6, seed=1, lo=1.0, hi=100.0),
                generate_random_problem(16, 7, seed=2, lo=1.0, hi=100.0)]
    with pytest.raises(ValueError, match="homogeneous"):
        solve_batched(problems)
