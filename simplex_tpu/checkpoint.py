"""Checkpoint / resume of the solve state.

The reference has no checkpointing (SURVEY.md §5); its closest artifacts
are the ``-rs`` seed-file save (main.cu:141-153) and the solution file.
Here the entire solver state is one pytree — (T, b, costs, z, base) plus
loop counters — so iteration-level checkpointing is a plain ``.npz``
dump. ``solve_resumable`` runs the jitted pivot loop in windows of
``checkpoint_every`` pivots, persisting state between windows, and picks
up from the newest checkpoint after an interruption: kill the process at
any point and rerun the same call to continue.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_OPTIONS, SolverOptions, Status
from .problem import Problem
from .result import SolveResult
from .solver import run_solve_loop
from .tableau import (Tableau, build_phase1, count_basic_artificials,
                      extract_solution, gaussian_eliminate, phase1_objective,
                      phase2_reset)

_FIELDS = ("T", "b", "costs", "z", "base")


def save_state(path: str, tab: Tableau, *, phase: int,
               iterations: int, iters1: int = 0,
               n_shards: int = 0) -> None:
    """Atomically persist a Tableau + progress counters to ``path``.

    ``n_shards`` records the mesh width for sharded checkpoints (0 =
    unsharded); ``np.asarray`` on a sharded array gathers the global
    value, so the file format is mesh-independent — only the resume-side
    validation cares."""
    arrays = {f: np.asarray(getattr(tab, f)) for f in _FIELDS}
    meta = np.array([tab.n, tab.m, tab.r, phase, iterations, iters1,
                     n_shards], dtype=np.int64)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, __meta__=meta, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> tuple[Tableau, int, int, int, int]:
    """Inverse of save_state:
    (tableau, phase, iterations, iters1, n_shards)."""
    with np.load(path) as z:
        meta = [int(v) for v in z["__meta__"]]
        n, m, r, phase, iterations, iters1 = meta[:6]
        n_shards = meta[6] if len(meta) > 6 else 0
        tab = Tableau(
            T=jnp.asarray(z["T"]), b=jnp.asarray(z["b"]),
            costs=jnp.asarray(z["costs"]), z=jnp.asarray(z["z"]),
            base=jnp.asarray(z["base"]), n=n, m=m, r=r)
    return tab, phase, iterations, iters1, n_shards


def _phase_costs0(tab: Tableau, problem, phase: int):
    """The phase's pre-elimination cost vector, reconstructed
    deterministically (phase 1: ones on the artificials; phase 2:
    [-c | 0]) so the blocked loop's window-boundary re-pricing works on
    the resume path too."""
    vdtype = tab.costs.dtype
    r_pad = tab.costs.shape[0]
    n, m = tab.n, tab.m
    if phase == 1:
        return jnp.zeros((r_pad,), vdtype).at[n + m:n + 2 * m].set(1.0)
    c = jnp.asarray(problem.c, vdtype)
    return jnp.zeros((r_pad,), vdtype).at[:n].set(-c)


def _run_windows(tab: Tableau, options: SolverOptions, max_iter: int,
                 path: str, phase: int, done: int, every: int,
                 costs0, iters1: int = 0, make_run=None,
                 n_shards: int = 0):
    """Run the solve loop ``every`` pivots at a time, checkpointing after
    each window. Returns (tab, status:int, total_iterations).

    ``make_run(window) -> fn(tab, costs0) -> (tab, status, iters)``
    overrides the loop runner (the sharded resume path supplies a
    shard_map'd one); default is the single-chip run_solve_loop.

    Limitation (documented): the stall counter behind the Bland
    anti-cycling fallback resets at window boundaries, so ``every`` is
    clamped (with a warning) to at least 4x the Bland threshold to leave
    room for the fallback to trigger within one window. The final window
    is capped to the remaining ``max_iter - done`` budget so the total
    pivot count never overshoots ``max_iter`` (costing at most one extra
    jit specialization for the shorter window)."""
    if options.bland_threshold and options.pivot_rule_resolved == "dantzig":
        clamped = max(every, 4 * int(options.bland_threshold))
        if clamped != every:
            import warnings

            warnings.warn(
                f"checkpoint_every={every} raised to {clamped} (4x the "
                f"Bland anti-cycling threshold of "
                f"{options.bland_threshold}); pass bland_threshold=None "
                "or a smaller threshold for finer checkpoints",
                RuntimeWarning, stacklevel=3)
        every = clamped

    if make_run is None:
        @partial(jax.jit, static_argnames=("window",))
        def _default_run(t, c0, window):
            return run_solve_loop(t, options, window, c0)

        def make_run(window):
            return partial(_default_run, window=window)

    runners: dict[int, object] = {}
    while True:
        window = min(every, max_iter - done)
        if window <= 0:
            return tab, int(Status.RUNNING), done
        if window not in runners:
            runners[window] = make_run(window)
        tab, status, it = runners[window](tab, costs0)
        done += int(it)
        status = int(status)
        if status == int(Status.RUNNING) and int(it) == 0:
            # No progress is possible (device windows<max_iter guard
            # tripped on a zero-pivot cycle): stop instead of re-saving
            # the same checkpoint forever. Same mapping as the device's
            # own guard: report MAXITER.
            return tab, int(Status.MAXITER), done
        if status != int(Status.RUNNING) or done >= max_iter:
            return tab, status, done
        save_state(path, tab, phase=phase, iterations=done, iters1=iters1,
                   n_shards=n_shards)


def _resumable_core(problem: Problem, checkpoint_path: str,
                    checkpoint_every: int, options: SolverOptions, *,
                    build, phase2, pivot_out, put=None,
                    make_run_for_r=None, n_shards: int = 0,
                    refine_extraction: bool | None = None) -> SolveResult:
    """The shared two-phase resumable orchestration: load-or-build,
    windowed phase 1, the INFEASIBLE/DEGENERATE/MAXITER ladder, the
    phase-2 transition checkpoint, windowed phase 2, and the checkpoint
    lifecycle (terminal statuses delete the file; MAXITER keeps it so a
    rerun with a larger budget resumes). The single-chip and sharded
    entry points differ only in the injected stage callables:

    * ``build()`` -> eliminated phase-1 tableau,
    * ``phase2(tab, c)`` -> eliminated phase-2 tableau,
    * ``pivot_out(tab)`` -> degenerate-basis repair,
    * ``put(tab)`` -> lay a loaded (host/global) tableau out on the
      target devices (None = leave as-is),
    * ``make_run_for_r(r)`` -> a window-runner factory for _run_windows
      (None = the single-chip default),
    * ``n_shards`` -> written into the checkpoint metadata (0 = unsharded).
    """
    m, n = problem.constraints, problem.vars
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    r1 = n + 2 * m

    if os.path.exists(checkpoint_path):
        tab, phase, done, iters1, ck_shards = load_state(checkpoint_path)
        if ck_shards != n_shards:
            if n_shards == 0:
                raise ValueError(
                    f"checkpoint was written by a {ck_shards}-shard "
                    "sharded solve; resume it with "
                    "solve_resumable_sharded / --sharded")
            if ck_shards == 0:
                raise ValueError(
                    "checkpoint was written by a single-chip solve; "
                    "resume it without --sharded (or delete it)")
            raise ValueError(
                f"checkpoint was written on a {ck_shards}-shard mesh, "
                f"resuming on {n_shards} shards (re-shard by deleting "
                "the checkpoint or matching the mesh)")
        if (tab.n, tab.m) != (n, m):
            raise ValueError(
                f"checkpoint is for a {tab.n}x{tab.m} problem, "
                f"got {n}x{m}")
        if (tab.T.dtype != jnp.dtype(options.dtype)
                or tab.b.dtype != jnp.dtype(options.vector_dtype)):
            raise ValueError(
                f"checkpoint dtypes ({tab.T.dtype}/{tab.b.dtype}) do not "
                f"match options ({options.dtype}/{options.vector_dtype})")
        if put is not None:
            tab = put(tab)
    else:
        tab = build()
        phase, done, iters1 = 1, 0, 0

    def runner(r):
        return make_run_for_r(r) if make_run_for_r is not None else None

    degenerate = False
    if phase == 1:
        tab, status1, done = _run_windows(
            tab, options, max_iter, checkpoint_path, 1, done,
            checkpoint_every, _phase_costs0(tab, problem, 1),
            make_run=runner(r1), n_shards=n_shards)
        if status1 == int(Status.RUNNING):
            return SolveResult(Status.MAXITER, None, float(tab.z), done, 0)
        z1 = float(phase1_objective(tab))
        b_scale = 1.0 + float(np.max(np.abs(problem.b)))
        if z1 <= -eps * b_scale:
            if os.path.exists(checkpoint_path):
                os.unlink(checkpoint_path)
            return SolveResult(Status.INFEASIBLE, None, z1, done, 0)
        degenerate = int(count_basic_artificials(tab)) > 0
        if degenerate and options.degeneracy == "reference":
            # Terminal verdict: the phase-1 checkpoint is useless for a
            # rerun (it would re-derive DEGENERATE) — delete it like the
            # other terminal statuses do.
            if os.path.exists(checkpoint_path):
                os.unlink(checkpoint_path)
            return SolveResult(Status.DEGENERATE, None, z1, done, 0,
                               degenerate=True)
        if degenerate:
            tab = pivot_out(tab)
        tab = phase2(tab, jnp.asarray(problem.c,
                                      jnp.dtype(options.vector_dtype)))
        phase, iters1, done = 2, done, 0
        save_state(checkpoint_path, tab, phase=2, iterations=0,
                   iters1=iters1, n_shards=n_shards)

    tab, status2, done = _run_windows(
        tab, options, max_iter, checkpoint_path, 2, done,
        checkpoint_every, _phase_costs0(tab, problem, 2), iters1,
        make_run=runner(n + m), n_shards=n_shards)
    if status2 == int(Status.RUNNING):
        # Keep the checkpoint: rerunning with a larger max_iter resumes.
        return SolveResult(Status.MAXITER, None, float(tab.z), iters1, done)
    if os.path.exists(checkpoint_path):
        os.unlink(checkpoint_path)
    if status2 != int(Status.OPTIMAL):
        return SolveResult(Status(status2), None, float(tab.z), iters1,
                           done, degenerate=degenerate)
    x = np.asarray(extract_solution(tab))
    objective = float(np.dot(problem.c, x))
    refine_info = None
    if refine_extraction is None:
        from .config import refine_enabled

        refine_extraction = refine_enabled(options)
    if refine_extraction:
        # f64 extraction refinement (mirror of two_phase.solve): the
        # last-resort fallback (two_phase.fallback_solve passes
        # refine_extraction=True) certifies its result against the host
        # data with the final tableau's slack block as the
        # preconditioner — a few matvecs, no LU.
        from .refine import (RefineInfo, certificates_pass,
                             refine_solution_tableau_host)

        n_, m_ = problem.vars, problem.constraints
        binv = np.asarray(tab.T[n_:n_ + m_, :m_])
        ro = refine_solution_tableau_host(problem.A, problem.b,
                                          problem.c, np.asarray(tab.base),
                                          binv, n_, m_)
        ok = certificates_pass(ro, problem.b, problem.c,
                               float(options.refine_tol))
        refine_info = RefineInfo(
            certified=ok,
            primal_residual=float(ro.primal_residual),
            primal_negativity=float(ro.primal_negativity),
            artificial_mass=float(ro.artificial_mass),
            dual_infeasibility=float(ro.dual_infeasibility),
            tol=float(options.refine_tol),
            method="tableau",
            objective_shift=float(ro.objective) - objective)
        if ok:
            x, objective = np.asarray(ro.x), float(ro.objective)
    return SolveResult(Status.OPTIMAL, x, objective, iters1, done,
                       degenerate=degenerate, refine=refine_info)


def solve_resumable(problem: Problem, checkpoint_path: str,
                    checkpoint_every: int = 1000,
                    options: SolverOptions | None = None,
                    refine_extraction: bool | None = None,
                    **replacements) -> SolveResult:
    """Two-phase solve with iteration-level checkpoint/resume.

    If ``checkpoint_path`` exists, the solve continues from it (the
    problem must be the same one); otherwise it starts fresh. The file is
    removed on successful completion.
    """
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    if options.needs_x64:
        jax.config.update("jax_enable_x64", True)

    A = jnp.asarray(problem.A)
    b = jnp.asarray(problem.b)
    m, n = problem.constraints, problem.vars

    def build():
        return gaussian_eliminate(build_phase1(A, b, n, m, options))

    def phase2(tab, c):
        return gaussian_eliminate(phase2_reset(tab, c, options))

    def pivot_out(tab):
        from .two_phase import pivot_out_artificials

        return pivot_out_artificials(tab, options)

    return _resumable_core(problem, checkpoint_path, checkpoint_every,
                           options, build=build, phase2=phase2,
                           pivot_out=pivot_out,
                           refine_extraction=refine_extraction)


def solve_resumable_sharded(problem: Problem, mesh, checkpoint_path: str,
                            checkpoint_every: int = 1000,
                            options: SolverOptions | None = None,
                            **replacements) -> SolveResult:
    """Sharded two-phase solve with iteration-level checkpoint/resume —
    the north-star n=1M column-sharded configuration is the
    longest-running solve in the framework and (as of round 3) the only
    one that can survive a crash.

    Same windowed contract as ``solve_resumable`` (one shared
    orchestration core), with every stage shard_map'd over ``mesh``
    ('vars' axis): build + Gaussian elimination sharded, each window of
    pivots runs the full sharded hot loop (parallel/sharded.py
    run_solve_loop_sharded), and the checkpoint file holds the gathered
    GLOBAL arrays plus the mesh width (``np.asarray`` on a sharded array
    assembles it), so the artifact is identical in shape to a single-chip
    checkpoint and resume just re-shards it onto the same mesh width."""
    from jax.sharding import PartitionSpec as P

    from .parallel import sharded as sh

    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    if options.needs_x64:
        jax.config.update("jax_enable_x64", True)

    m, n = problem.constraints, problem.vars
    n_shards = int(mesh.shape[sh.AXIS])
    r1 = n + 2 * m

    def specs(r):
        return sh.tableau_specs(n, m, r)

    def shardings(r):
        return sh.tableau_shardings(mesh, n, m, r)

    A = jnp.asarray(problem.A)
    b = jnp.asarray(problem.b)

    @jax.jit
    def build_fn(A, b):
        tab = sh.build_phase1_sharded(A, b, n, m, n_shards, options)
        tab = jax.lax.with_sharding_constraint(tab, shardings(r1))
        return jax.shard_map(
            sh.gaussian_eliminate_sharded, mesh=mesh,
            in_specs=(specs(r1),), out_specs=specs(r1),
            check_vma=False)(tab)

    def make_run_for_r(r):
        sp = specs(r)

        def make_run(window):
            core = jax.shard_map(
                lambda t, c0: sh.run_solve_loop_sharded(
                    t, options, window, c0),
                mesh=mesh, in_specs=(sp, P(sh.AXIS)),
                out_specs=(sp, P(), P()), check_vma=False)
            return jax.jit(core)

        return make_run

    @jax.jit
    def pivot_out_fn(tab):
        return jax.shard_map(
            lambda t: sh.pivot_out_artificials_sharded(t, options),
            mesh=mesh, in_specs=(specs(r1),), out_specs=specs(r1),
            check_vma=False)(tab)

    @jax.jit
    def phase2_fn(tab, c):
        def core(t, c):
            t2 = dataclasses.replace(
                t, costs=sh._phase2_costs_local(t, c), r=n + m)
            return sh.gaussian_eliminate_sharded(t2)

        return jax.shard_map(
            core, mesh=mesh, in_specs=(specs(r1), P(None)),
            out_specs=specs(n + m), check_vma=False)(tab, c)

    return _resumable_core(
        problem, checkpoint_path, checkpoint_every, options,
        build=lambda: build_fn(A, b), phase2=phase2_fn,
        pivot_out=pivot_out_fn,
        put=lambda tab: jax.device_put(tab, shardings(tab.r)),
        make_run_for_r=make_run_for_r, n_shards=n_shards)
