"""Per-operation timed two-phase solve (the -D TIMER build of the
reference, twoPhaseMethod.cu:225-435 with chrono instrumentation).

Unlike the fused ``two_phase.solve_device`` (one jitted core, zero host
round-trips — the performance path), this driver splits the solve at the
same operation boundaries the reference times (SURVEY.md C9):
``fillTableau``, ``gauss1``, ``solve``, ``checkDegeneracy``,
``costsVector``, ``gauss2``, ``solve``, ``solution`` — each a separate
jitted call bracketed by host timing that ends in
``jax.block_until_ready``, rows appended to the Chrono CSV with the
reference's schema and row conventions.

Two solve-timing modes:

* aggregate (default): one ``solve`` row per phase (total wall time of the
  fused ``lax.while_loop``) plus a ``solveIterations`` row whose
  elapsed_time column holds the pivot count — a documented divergence
  from the reference, which emits one ``solve`` row per pivot
  (solver.cu:84-123) because its loop round-trips the host anyway.
* ``per_iteration=True``: exact reference behaviour — the jitted
  single-pivot step (solver.iteration_body) is driven from the host and
  every pivot gets its own ``solve`` row. Slower (per-pivot host sync),
  meant for profiling parity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .chrono import Chrono, NullChrono
from .config import (DEFAULT_OPTIONS, SolverOptions, Status,
                     refine_enabled)
from .problem import Problem
from .result import SolveResult
from .solver import (LoopState, initial_state, iteration_body,
                     run_solve_loop)
from .tableau import (build_phase1, count_basic_artificials,
                      extract_solution, format_tableau, gaussian_eliminate,
                      phase2_reset)
from .two_phase import pivot_out_artificials


@partial(jax.jit, static_argnames=("n", "m", "options"))
def _build(A, b, n, m, options):
    return build_phase1(A, b, n, m, options)


@partial(jax.jit, static_argnames=())
def _gauss(tab):
    return gaussian_eliminate(tab)


@partial(jax.jit, static_argnames=("options", "max_iter"))
def _solve(tab, options, max_iter, costs0=None):
    return run_solve_loop(tab, options, max_iter, costs0)


@partial(jax.jit, static_argnames=("options",))
def _step(state: LoopState, options) -> LoopState:
    return iteration_body(state, options)


@partial(jax.jit, static_argnames=("options",))
def _phase2(tab, c, options):
    return phase2_reset(tab, c, options)


_pivot_out = jax.jit(pivot_out_artificials, static_argnames=("options",))
_extract = jax.jit(extract_solution)


def _sync(out):
    """Wait until a jitted call's outputs are computed."""
    return jax.block_until_ready(out)


def _timed(chrono, rows, cols, op, fn, args, dyn=None):
    """Time one operation with XLA compilation excluded: AOT-compile the
    jitted ``fn`` for these exact ``args`` BEFORE starting the clock,
    then execute the compiled object on the dynamic args ``dyn`` (= args
    minus the static ones). The reference's chrono times kernel
    execution under a precompiled binary (chrono.cu wraps CUDA events
    around launches); without this, the first call per shape would land
    its compile time in the CSV row — a 3-7 s floor that swamps every
    small sweep size. The persistent compilation cache makes the
    ``.compile()`` itself a disk hit on warm runs."""
    compiled = fn.lower(*args).compile()
    chrono.start(rows, cols, op)
    out = _sync(compiled(*(args if dyn is None else dyn)))
    chrono.stop()
    return out


#: Max pivots per DEVICE CALL in the aggregate timed solve: the host
#: re-enters every 8192 pivots, which bounds one device call's length
#: at the largest sweep sizes; the re-entry cost (two tableau transposes
#: for the blocked loop + dispatch) is small against 8192 pivots.
DEVICE_CALL_PIVOT_CAP = 8192


def _run_solve(tab, options, max_iter, chrono, rows_csv, per_iteration,
               costs0=None, pivot_cb=None):
    if not per_iteration:
        cap = min(max_iter, DEVICE_CALL_PIVOT_CAP)
        total = 0
        # Compile outside the clock (see _timed); every window of this
        # phase reuses the same executable.
        compiled = _solve.lower(tab, options, cap, costs0).compile()
        chrono.start(rows_csv, tab.m, "solve")
        while True:
            tab, status, iters = compiled(tab, costs0)
            status_i = int(status)      # scalar readback = sync point
            if status_i == int(Status.RUNNING) and int(iters) == 0:
                # A RUNNING window that applied no pivots cannot make
                # progress (the device-side windows<max_iter guard
                # tripped on a zero-pivot cycle); re-running the same
                # executable on identical state would loop the host
                # forever. Surface it as MAXITER, like the device would.
                status_i = int(Status.MAXITER)
                break
            total += int(iters)
            # The final window may overshoot max_iter by < cap (same
            # contract as checkpoint._run_windows).
            if status_i != int(Status.RUNNING) or total >= max_iter:
                break
        chrono.stop()
        chrono.row(rows_csv, tab.m, "solveIterations", total / 1e6)
        return tab, status_i, total

    if options.pivot_rule_resolved == "devex":
        raise ValueError(
            "per-iteration timing drives the single-pivot reference "
            "loop, which prices with Dantzig/Bland only (devex lives in "
            "the blocked loops)")
    if options.block_pivots and int(options.block_pivots) > 1:
        # The per-iteration driver steps the SINGLE-PIVOT reference loop
        # (one CSV row per pivot, reference solver.cu:84-123); deferred
        # block pivoting has no per-pivot boundary to time, so the option
        # is ignored here — loudly, not silently.
        import warnings

        warnings.warn(
            f"per_iteration timing drives the single-pivot reference "
            f"loop; block_pivots={options.block_pivots} is ignored "
            "(use the aggregate solve timing for the blocked loop)",
            RuntimeWarning, stacklevel=3)

    state = initial_state(tab, options)
    step = _step.lower(state, options).compile()    # outside the clock
    iters = 0
    while int(state.status) == int(Status.RUNNING) and iters < max_iter:
        chrono.start(rows_csv, tab.m, "solve")
        state = step(state)
        status_i = int(state.status)    # scalar readback = sync point
        chrono.stop()
        if int(state.iterations) > iters and pivot_cb is not None:
            pivot_cb(state.tab, int(state.iterations))
        iters = int(state.iterations)
        if status_i != int(Status.RUNNING):
            break
    return state.tab, int(state.status), iters


def solve_timed(problem: Problem, options: SolverOptions | None = None,
                chrono: Chrono | NullChrono | None = None,
                per_iteration: bool = False, debug: bool = False,
                pause: bool = False,
                **replacements) -> SolveResult:
    """Host-orchestrated two-phase solve with per-op CSV timing; same
    result contract as two_phase.solve (and the reference's host
    early-returns for INFEASIBLE/DEGENERATE, twoPhaseMethod.cu:414-427).
    ``debug=True`` prints the tableau after every stage (the reference's
    -D DEBUG dumps, twoPhaseMethod.cu:237-262 via tabular.cu:41-98);
    ``pause=True`` additionally waits for Enter after each dump — the
    reference's interactive ``getchar()`` pause (solver.cu:112-116)."""
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    if per_iteration and options.pivot_rule is None:
        # Per-iteration timing drives the SINGLE-PIVOT reference loop,
        # where the auto rule's devex resolution (an f32 blocked-config
        # default the user never chose) would otherwise raise below —
        # auto resolves to the reference's own Dantzig here.
        options = dataclasses.replace(options, pivot_rule="dantzig")
    if options.needs_x64:
        jax.config.update("jax_enable_x64", True)
    chrono = chrono or NullChrono()

    m, n = problem.constraints, problem.vars
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    A = jnp.asarray(problem.A)
    b = jnp.asarray(problem.b)
    c = jnp.asarray(problem.c)

    # CSV "vars" column convention: tableau rows incl. the cost row
    # (chrono.cu:37) — n+2m+1 in phase 1, n+m+1 in phase 2.
    r1, r2 = n + 2 * m + 1, n + m + 1

    # Device warm-up OUTSIDE any timer: the first executed op on the
    # backend pays one-time runtime initialisation, which would
    # otherwise land in the first CSV row.
    # The reference does the same — setupDevice precedes all chrono
    # timers (main.cu:117-133).
    np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros((1,), A.dtype)))

    def dump(stage, tab):
        if debug:
            print(f"--- {stage} ---")
            print(format_tableau(tab))
            if pause:
                try:
                    input("[debug] Enter to continue...")
                except EOFError:       # non-interactive stdin: no pause
                    pass

    # Per-pivot tableau dumps in the per-iteration driver — the exact
    # behaviour of the reference's -D DEBUG build, which prints the
    # tableau after EVERY pivot and pauses on getchar()
    # (solver.cu:112-116; the pause needs ``pause=True``).
    pivot_cb = ((lambda t, it: dump(f"pivot {it}", t))
                if (debug and per_iteration) else None)

    # ---- Phase 1 ----
    tab = _timed(chrono, r1, m, "fillTableau", _build,
                 (A, b, n, m, options), (A, b))
    dump("fillTableau", tab)
    costs0_1 = tab.costs
    tab = _timed(chrono, r1, m, "gauss1", _gauss, (tab,))
    dump("gauss1", tab)
    tab, status1, iters1 = _run_solve(tab, options, max_iter, chrono, r1,
                                      per_iteration, costs0_1,
                                      pivot_cb=pivot_cb)
    dump("phase1 solved", tab)
    if status1 == int(Status.RUNNING):
        return SolveResult(Status.MAXITER, None, float(tab.z), iters1, 0)
    from .tableau import phase1_objective

    z1 = float(phase1_objective(tab))
    b_scale = 1.0 + float(np.max(np.abs(problem.b)))
    if z1 <= -eps * b_scale:
        return SolveResult(Status.INFEASIBLE, None, z1, iters1, 0)

    count_art = jax.jit(count_basic_artificials).lower(tab).compile()
    chrono.start(r1, m, "checkDegeneracy")
    n_art = int(count_art(tab))
    chrono.stop()
    degenerate = n_art > 0
    if degenerate:
        if options.degeneracy == "reference":
            return SolveResult(Status.DEGENERATE, None, float(tab.z),
                               iters1, 0, degenerate=True)
        tab = _sync(_pivot_out(tab, options))

    # ---- Phase 2 ----
    tab = _timed(chrono, r2, m, "costsVector", _phase2,
                 (tab, c, options), (tab, c))
    costs0_2 = tab.costs
    tab = _timed(chrono, r2, m, "gauss2", _gauss, (tab,))
    dump("gauss2", tab)
    tab, status2, iters2 = _run_solve(tab, options, max_iter, chrono, r2,
                                      per_iteration, costs0_2,
                                      pivot_cb=pivot_cb)
    dump("phase2 solved", tab)
    if status2 == int(Status.RUNNING):
        return SolveResult(Status.MAXITER, None, float(tab.z), iters1,
                           iters2, degenerate=degenerate)
    if status2 != int(Status.OPTIMAL):
        return SolveResult(Status(status2), None, float(tab.z), iters1,
                           iters2, degenerate=degenerate)

    extract = _extract.lower(tab).compile()
    chrono.start(r2, m, "solution")
    x = np.asarray(extract(tab))    # readback = sync
    chrono.stop()
    # Same contract as two_phase.solve: report c @ x recomputed from the
    # final basis, not the drift-prone running objective cell.
    objective = float(np.dot(problem.c, x))
    refine_info = None
    if refine_enabled(options):
        # Same f64 refinement contract as two_phase.solve, OUTSIDE the
        # chrono ops (the CSV schema mirrors the reference's op set;
        # refinement is this repo's extension — the reference gets f64
        # extraction for free from its all-f64 tableau). The tableau's
        # slack block preconditions it, LU retry / chunked f64
        # finishing on certificate failure.
        from .two_phase import fallback_solve, refine_result

        binv = tab.T[n:n + m, :m]
        rx, robj, refine_info, _ro = refine_result(
            problem, tab.base, options, A, b, c,
            raw_objective=objective, binv=binv)
        if rx is not None:
            x, objective = rx, robj
        else:
            result64 = fallback_solve(problem, options,
                                      base=np.asarray(tab.base))
            info = (result64.refine or refine_info)._replace(
                fallback=True)
            # Keep the TIMED walk's pivot counts — they describe the
            # solve the chrono CSV rows recorded; the finisher's own
            # counts (0 + a handful) would misread as the sweep's.
            return dataclasses.replace(result64, refine=info,
                                       iterations_phase1=iters1,
                                       iterations_phase2=iters2)
    return SolveResult(Status.OPTIMAL, x, objective, iters1, iters2,
                       degenerate=degenerate, refine=refine_info)
