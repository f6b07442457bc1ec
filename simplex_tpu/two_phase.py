"""Two-phase simplex orchestration, jitted end-to-end.

Equivalent of the reference's algorithm layer (reference:
src/twoPhaseMethod.cu:225-435). One fully-jitted device core
(``solve_device``) runs: Phase-1 build -> Gaussian elimination -> solve
loop -> infeasibility/degeneracy checks -> (extension) pivot artificials
out of a degenerate basis -> Phase-2 truncation + cost reset -> Gaussian
elimination -> solve loop -> solution extraction. Statuses are data, not
host branches, so the same core vmaps (batch.py) and shard_maps
(parallel/sharded.py) unchanged; Phase 2 always executes on device and its
result is masked out when Phase 1 already decided INFEASIBLE/DEGENERATE
(the reference instead early-returns on the host,
twoPhaseMethod.cu:414-427).

The host wrapper ``solve()`` is the public entry point and reproduces the
reference's end-to-end contract (problem in, status + solution + optimal
value out, twoPhaseMethod.h:19).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np

from .config import DEFAULT_OPTIONS, SolverOptions, Status
from .problem import Problem
from .result import SolveResult
from .solver import pivot_update, run_solve_loop
from .tableau import (Tableau, build_phase1, count_basic_artificials,
                      extract_solution, gaussian_eliminate, phase1_objective,
                      phase2_reset)


class DeviceSolveOutput(NamedTuple):
    """Raw device outputs of one two-phase solve (all jax arrays)."""

    status: jax.Array        # int32 Status
    x: jax.Array             # (n,) solution, zeros unless OPTIMAL
    objective: jax.Array     # scalar, reference costs[0] convention
    iterations_phase1: jax.Array
    iterations_phase2: jax.Array
    n_artificial_in_base: jax.Array
    base: jax.Array          # (M_pad,) int32 final basis (refine.py input)


def pivot_out_artificials(tab: Tableau, options: SolverOptions,
                          gate: jax.Array | None = None) -> Tableau:
    """Drive zero-valued artificials out of the Phase-1 basis (north-star
    extension; the reference aborts with DEGENERATE instead,
    twoPhaseMethod.cu:270-282). For each constraint whose basic variable
    is artificial: pivot in the lowest-index non-artificial variable with
    a nonzero coefficient (a degenerate pivot — b[k] ~ 0 keeps feasibility
    even for a negative pivot element); if the row has none it is a
    redundant constraint — its column is zeroed and its base entry set to
    the R_pad sentinel (excluded from every downstream gather/scatter).

    Implemented as a ``while_loop`` that runs ONE full-tableau pass per
    *actual* basic artificial (typically a handful), not per constraint —
    an m-iteration loop of conditional rank-1 updates lowers to m full
    passes and dominated the whole solve at large sizes.

    ``gate``: optional bool scalar ANDed into the loop condition. Under
    ``jax.vmap`` a ``lax.cond`` wrapper lowers to select and EXECUTES
    both branches (the CLAUDE.md cond gotcha), so gating must live in
    the while condition itself: a fuse-hit (MAXITER) phase-1 tableau can
    carry hundreds of basic artificials, and without the in-cond gate a
    vmapped batch ran ~466 full-tableau repair sweeps of discarded work
    (all of a capped 64-lane solve's time).
    """
    eps = float(options.eps_resolved)
    n, m = tab.n, tab.m
    R_pad = tab.rows_padded
    real_rows = jnp.arange(R_pad) < (n + m)
    none = jnp.int32(tab.cols_padded)

    def first_artificial(t):
        is_art = (t.base >= (n + m)) & (t.base < n + 2 * m)
        k = jnp.argmax(is_art).astype(jnp.int32)
        return jnp.where(is_art.any(), k, none)

    def cond(carry):
        t, fixes = carry
        go = (first_artificial(t) < none) & (fixes < m)
        return go if gate is None else go & gate

    def body(carry):
        t, fixes = carry
        k = first_artificial(t)
        colk = t.T[:, k]
        candidates = real_rows & (jnp.abs(colk) >= eps)
        has_pivot = candidates.any()
        h = jnp.argmin(jnp.where(candidates, jnp.arange(R_pad), R_pad))
        h = h.astype(jnp.int32)

        pivoted = pivot_update(t, h, k, t.costs[h])
        dropped = dataclasses.replace(
            t, T=t.T.at[:, k].set(0.0), b=t.b.at[k].set(0.0),
            base=t.base.at[k].set(t.rows_padded))
        t2 = jax.tree.map(
            lambda a, b: jnp.where(has_pivot, a, b), pivoted, dropped)
        return t2, fixes + 1

    out, _ = lax.while_loop(cond, body, (tab, jnp.zeros((), jnp.int32)))
    return out


def _solve_device_core(A: jax.Array, b: jax.Array, c: jax.Array,
                       n: int, m: int,
                       options: SolverOptions = DEFAULT_OPTIONS):
    """Trace-level body shared by ``solve_device`` (public: outputs
    only) and ``solve_device_with_binv`` (adds the final tableau's
    slack block — the free approximate basis inverse refine.py's
    LU-free fast path preconditions with). ``A`` is (m, n), ``b``
    (m,), ``c`` (n,). Returns (DeviceSolveOutput, phase-2 Tableau).
    """
    eps = float(options.eps_resolved)
    max_iter = options.resolved_max_iter(n + 2 * m, m)

    # Pre-flight numeric guard: a non-finite entry anywhere in the input
    # poisons the tableau silently (inf * 0 = nan in row updates, or a
    # pivot column that never prices out, spinning the loop to MAXITER).
    # One reduction up front is cheap against the solve and lets the
    # post-hoc guard below stay output-focused.
    inputs_finite = (jnp.isfinite(A).all() & jnp.isfinite(b).all()
                     & jnp.isfinite(c).all())

    # ---- Phase 1 (twoPhaseMethod.cu:225-283) ----
    tab = build_phase1(A, b, n, m, options)
    costs0_1 = tab.costs                 # pre-elimination (re-pricing)
    tab = gaussian_eliminate(tab)
    tab, status1, iters1 = run_solve_loop(tab, options, max_iter, costs0_1)

    # Infeasibility test on the exactly-recomputed phase-1 objective
    # (reference costs[0] < 0 check, twoPhaseMethod.cu:264-268; see
    # tableau.phase1_objective for why not the running z). The threshold
    # scales with the right-hand side's magnitude: an artificial residual
    # of ~1e-9 against b values of ~100 is a degenerate zero, not
    # infeasibility (the reference's absolute eps misclassifies such
    # knife-edge vertices).
    z_phase1 = phase1_objective(tab)
    b_scale = 1.0 + jnp.max(jnp.abs(b))
    infeasible = z_phase1 <= -eps * b_scale
    n_art = count_basic_artificials(tab)
    degenerate = n_art > 0

    if options.degeneracy == "continue":
        # Only meaningful for feasible-but-degenerate bases (artificials at
        # value ~0); infeasible tableaus keep their phase-1 state for the
        # reported objective. Fuse-hit (MAXITER) tableaus are excluded
        # too: their phase-2 result is discarded by the status
        # resolution, and a capped phase 1 can leave HUNDREDS of basic
        # artificials — each costing a full-tableau repair sweep. The
        # gate rides INSIDE the repair loop's condition (not only this
        # lax.cond) because solve_device is vmapped by the batch
        # fallback, where cond lowers to select and runs both branches.
        # != RUNNING, not == OPTIMAL: a (noise-driven) phase-1
        # UNBOUNDED lane's phase-2 result is NOT discarded by the
        # status resolution, so its basis must still be repaired.
        repair = (degenerate & ~infeasible
                  & (status1 != int(Status.RUNNING)))
        tab = lax.cond(
            repair,
            lambda t: pivot_out_artificials(t, options, gate=repair),
            lambda t: t, tab)

    # ---- Phase 2 (twoPhaseMethod.cu:285-356) ----
    # At multi-GB tableaus the artificial-block truncation is a
    # 4-GB-class HLO temp (the row slice materializes next to the
    # phase-1 copy, with the binv output live). Past ~2 GB keep the phase-1
    # row allocation and mask via ``r`` instead, exactly the sharded
    # core's approach (its padded extent cannot shrink either); the
    # wasted phase-2 rows are 2m/(n+2m) of the apply work. Below the
    # threshold the walks stay bitwise identical to previous rounds.
    if (tab.rows_padded * tab.cols_padded
            * jnp.dtype(options.dtype).itemsize) > (1 << 31):
        tab2 = phase2_reset(tab, c, options, r2_pad=tab.rows_padded)
    else:
        tab2 = phase2_reset(tab, c, options)
    costs0_2 = tab2.costs
    tab2 = gaussian_eliminate(tab2)
    tab2, status2, iters2 = run_solve_loop(tab2, options, max_iter,
                                           costs0_2)

    x = extract_solution(tab2)

    # Status resolution, replacing the reference's host early-returns.
    fuse1 = status1 == int(Status.RUNNING)
    fuse2 = status2 == int(Status.RUNNING)
    phase1_failed = infeasible | fuse1
    if options.degeneracy == "reference":
        phase1_failed = phase1_failed | degenerate

    status = jnp.where(fuse2, int(Status.MAXITER), status2)
    if options.degeneracy == "reference":
        status = jnp.where(degenerate, int(Status.DEGENERATE), status)
    status = jnp.where(infeasible, int(Status.INFEASIBLE), status)
    status = jnp.where(fuse1, int(Status.MAXITER), status)
    # Numeric guard (the error-handling layer of SURVEY.md C10): a
    # non-finite objective/solution means the tableau was poisoned (e.g.
    # a near-zero pivot divided through) — report NUMERIC instead of
    # returning garbage. The reference has no fp guard at all. When phase
    # 1 already failed, the phase-2 tableau is semantically dead and its
    # values must not override the phase-1 verdict.
    finite = jnp.isfinite(tab2.z) & jnp.isfinite(x).all()
    status = jnp.where(finite | phase1_failed, status,
                       int(Status.NUMERIC))
    status = jnp.where(jnp.isfinite(z_phase1), status,
                       int(Status.NUMERIC))
    status = jnp.where(inputs_finite, status, int(Status.NUMERIC))
    status = status.astype(jnp.int32)
    # Report c @ x recomputed from the final basis rather than the running
    # objective cell (identical in exact arithmetic; drift-immune).
    objective_opt = jnp.dot(c.astype(x.dtype), x,
                            precision=jax.lax.Precision.HIGHEST)
    objective = jnp.where(phase1_failed, z_phase1,
                          jnp.where(status2 == int(Status.OPTIMAL),
                                    objective_opt, tab2.z))
    x = jnp.where(status == int(Status.OPTIMAL), x, jnp.zeros_like(x))
    iters2 = jnp.where(phase1_failed, 0, iters2)

    return DeviceSolveOutput(status, x, objective,
                             iters1.astype(jnp.int32),
                             iters2.astype(jnp.int32), n_art,
                             tab2.base), tab2


@partial(jax.jit, static_argnames=("n", "m", "options"))
def solve_device(A: jax.Array, b: jax.Array, c: jax.Array, n: int, m: int,
                 options: SolverOptions = DEFAULT_OPTIONS
                 ) -> DeviceSolveOutput:
    """Full two-phase solve on device (reference twoPhaseMethod,
    twoPhaseMethod.cu:385-435). ``A`` is (m, n), ``b`` (m,), ``c`` (n,).
    """
    return _solve_device_core(A, b, c, n, m, options)[0]


@partial(jax.jit, static_argnames=("n", "m", "options"))
def solve_device_with_binv(A: jax.Array, b: jax.Array, c: jax.Array,
                           n: int, m: int,
                           options: SolverOptions = DEFAULT_OPTIONS):
    """solve_device + the final tableau's slack block T2[n:n+m, :m] —
    exactly B^{-1} of the final basis in exact arithmetic (the b-flip
    signs cancel: B^{-1}[k, j] = T[n+j, k]), f32-drift-accurate after a
    long mixed solve. refine.refine_solution_tableau uses it as the
    iterative-refinement preconditioner, replacing the O(m^3) LU whose
    cost grows past the solve's own at reference sizes."""
    out, tab2 = _solve_device_core(A, b, c, n, m, options)
    return out, tab2.T[n:n + m, :m]


def refine_result(problem: Problem, base, options: SolverOptions,
                  A_dev=None, b_dev=None, c_dev=None,
                  raw_objective: float = float("nan"), binv=None):
    """Run f64 basis refinement for one OPTIMAL solve and certify it
    (see refine.py). Returns ``(x, objective, RefineInfo, RefineOutput)``
    — x None means the certificates failed and the caller should move
    to the finishing tiers (the RefineOutput still carries the exact
    basic values a reinversion restart needs). Shared by solve(), the
    batched wrapper (per-lane) and the sharded wrapper.

    ``binv``: the final tableau's slack block (from
    solve_device_with_binv) — tries the LU-free preconditioned path
    first and silently retries with the O(m^3) LU path only if its
    certificates fail (singular direction from a redundant-row drop,
    extreme conditioning)."""
    import time

    from .refine import (RefineInfo, certificates_pass, refine_solution,
                         refine_solution_tableau)

    t0 = time.perf_counter()
    m, n = problem.constraints, problem.vars
    A_dev = A_dev if A_dev is not None else jnp.asarray(problem.A)
    b_dev = b_dev if b_dev is not None else jnp.asarray(problem.b)
    c_dev = c_dev if c_dev is not None else jnp.asarray(problem.c)
    tol = float(options.refine_tol)
    base = jnp.asarray(base)

    ro = None
    method = "lu"
    ok = False
    skip_lu = False
    if binv is not None:
        ro = jax.device_get(refine_solution_tableau(
            A_dev, b_dev, c_dev, base, binv, n=n, m=m))
        ok = certificates_pass(ro, problem.b, problem.c, tol)
        method = "tableau"
        if not ok:
            # If the IR converged (primal residual at round-off) and
            # only DUAL feasibility failed, the basis is genuinely
            # suboptimal: the O(m^3) LU retry would reach the same
            # verdict — go straight to the f64 finishing fallback.
            b_scale = 1.0 + float(np.max(np.abs(problem.b)))
            skip_lu = (float(ro.primal_residual) <= tol * b_scale
                       and float(ro.primal_negativity) <= tol * b_scale
                       and float(ro.artificial_mass) <= tol * b_scale)
    if not ok and not skip_lu:
        ro = jax.device_get(refine_solution(
            A_dev, b_dev, c_dev, base, n=n, m=m,
            iters=int(options.refine_iters)))
        ok = certificates_pass(ro, problem.b, problem.c, tol)
        method = "lu"
    info = RefineInfo(
        certified=ok,
        primal_residual=float(ro.primal_residual),
        primal_negativity=float(ro.primal_negativity),
        artificial_mass=float(ro.artificial_mass),
        dual_infeasibility=float(ro.dual_infeasibility),
        tol=tol,
        objective_shift=float(ro.objective) - raw_objective,
        wall_s=round(time.perf_counter() - t0, 4),
        method=method)
    if not ok:
        return None, None, info, ro
    return np.asarray(ro.x), float(ro.objective), info, ro


def fallback_options(options: SolverOptions) -> SolverOptions:
    """The f64 finishing configuration used when refinement certificates
    fail: full-f64 tableau under the reference's 1e-9 eps discipline
    (eps=None re-resolves by dtype), refinement off (already exact)."""
    return dataclasses.replace(
        options, dtype=np.float64, vector_dtype=np.float64, refine=False)


def fallback_solve(problem: Problem, options: SolverOptions,
                   base=None) -> SolveResult:
    """The f64 finishing tier when refinement certificates fail.

    With ``base`` (the mixed solve's final basis): try the WARM-START
    host finisher first (finish.finish_from_basis — rebuild the exact
    f64 tableau for that basis, run the oracle's f64 loop for the few
    finishing pivots; seconds instead of the minutes a full re-solve
    costs at 8192-class sizes). Otherwise — or when warm finishing
    does not apply — run the full f64 re-solve through the checkpoint
    machinery with a throwaway checkpoint file: it chunks the loop into
    bounded device calls and certifies the extraction."""
    import os
    import tempfile

    if base is not None:
        from .finish import finish_from_basis

        finished = finish_from_basis(problem, np.asarray(base), options)
        if finished is not None:
            return finished

    from .checkpoint import solve_resumable

    opts64 = fallback_options(options)
    tmpdir = tempfile.mkdtemp(prefix="simplex_fb_")
    path = os.path.join(tmpdir, "fallback.ckpt")
    try:
        return solve_resumable(problem, path, checkpoint_every=2000,
                               options=opts64, refine_extraction=True)
    finally:
        for p in (path, tmpdir):
            try:
                os.unlink(p) if os.path.isfile(p) else os.rmdir(p)
            except OSError:
                pass


def solve(problem: Problem, options: SolverOptions | None = None,
          **replacements) -> SolveResult:
    """Public entry point: solve a dense LP with the jitted device core.

    ``replacements`` override individual SolverOptions fields, e.g.
    ``solve(p, dtype=np.float32, pivot_rule="bland")``.

    In the mixed production mode (f32 tableau + f64 vectors) the
    OPTIMAL result is passed through f64 basis refinement (refine.py)
    so the reported x/objective are f64-class like the reference's
    all-double extraction; if the refinement certificates fail the
    solve is finished in full f64 (``RefineInfo.fallback``).
    """
    from .config import refine_enabled

    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    if options.needs_x64:
        jax.config.update("jax_enable_x64", True)

    scaling = None
    solve_problem = problem
    if options.equilibrate:
        from .scaling import equilibrate

        solve_problem, scaling = equilibrate(problem)

    m, n = problem.constraints, problem.vars
    A_dev, b_dev, c_dev = (jnp.asarray(solve_problem.A),
                           jnp.asarray(solve_problem.b),
                           jnp.asarray(solve_problem.c))
    binv = None
    if refine_enabled(options):
        # Keep the final tableau's slack block on device: the LU-free
        # refinement preconditioner (refine.refine_solution_tableau).
        out, binv = solve_device_with_binv(A_dev, b_dev, c_dev, n, m,
                                           options)
    else:
        out = solve_device(A_dev, b_dev, c_dev, n, m, options)
    out = jax.device_get(out)
    status = Status(int(out.status))

    x = np.asarray(out.x) if status == Status.OPTIMAL else None
    objective = float(out.objective)
    if scaling is not None and x is not None:
        # Raw unwind (x = col * x', objective = c @ x in f64); a
        # certified refinement below replaces this wholesale (it also
        # unwinds exactly). Non-OPTIMAL objectives (phase-1
        # diagnostics) stay in scaled units.
        x = scaling.col * np.asarray(x, np.float64)
        objective = float(problem.c @ x)
    refine_info = None
    extra_pivots = 0
    if status == Status.OPTIMAL and refine_enabled(options):
        # Refinement runs against the SOLVED problem's f64 data — for
        # an equilibrated solve that is the SCALED problem: the
        # power-of-two scaling is exact, optimality certificates are
        # scale-invariant statements about the same basis, and refining
        # in scaled space avoids factorizing/multiplying original-unit
        # magnitudes an f32 preconditioner cannot represent (a 1e40
        # coefficient overflows the LU path outright). Certified
        # results unwind exactly below.
        rx, robj, refine_info, ro = refine_result(
            solve_problem, out.base, options, A_dev, b_dev, c_dev,
            raw_objective=objective, binv=binv)
        base_cur = out.base
        if rx is None and binv is not None:
            # Device reinversion-restart rounds (reinvert.py): rebuild
            # the exact tableau for the drifted basis on the device and
            # continue the mixed loop — the drifted basis is typically
            # a handful of pivots from optimal, so a round is a few
            # matrix products where the host tiers pay an m^3-class
            # factorization.
            from .reinvert import restart_device

            binv_cur = binv
            for _ in range(2):
                try:
                    out2, binv2, ns_res = restart_device(
                        A_dev, b_dev, c_dev, jnp.asarray(base_cur),
                        binv_cur, jnp.asarray(ro.xB), n, m, options)
                    st2 = Status(int(out2.status))
                except Exception:      # OOM at extreme shapes and the
                    break              # like: hand to the host tiers
                if st2 != Status.OPTIMAL:
                    break
                extra_pivots += int(out2.iterations_phase2)
                base_cur, binv_cur = out2.base, binv2
                rx, robj, refine_info, ro = refine_result(
                    solve_problem, base_cur, options, A_dev, b_dev,
                    c_dev, raw_objective=float(out2.objective),
                    binv=binv_cur)
                if rx is not None:
                    refine_info = refine_info._replace(method="restart")
                    break

        if rx is not None:
            x, objective = rx, robj
            if scaling is not None:
                # Exact unwind of the (scaled-space) certified values.
                x = scaling.col * np.asarray(x, np.float64)
                objective = float(problem.c @ x)
        else:
            # The finishing tiers run on the SOLVED (possibly scaled)
            # problem — the eps discipline stays meaningful in scaled
            # units — then unwind. Prefer the fallback's OWN certified
            # RefineInfo (the warm finisher and the refined chunked
            # re-solve both attach one, in scaled space for an
            # equilibrated solve); the pre-fallback failed certificates
            # describe a solution that was thrown away.
            result64 = fallback_solve(solve_problem, options,
                                      base=base_cur)
            if scaling is not None:
                from .scaling import unwind_result

                result64 = unwind_result(result64, scaling, problem)
            info = (result64.refine or refine_info)._replace(
                fallback=True)
            return dataclasses.replace(result64, refine=info)

    return SolveResult(
        status=status,
        x=x,
        objective=objective,
        iterations_phase1=int(out.iterations_phase1),
        iterations_phase2=int(out.iterations_phase2) + extra_pivots,
        degenerate=bool(out.n_artificial_in_base > 0),
        refine=refine_info,
    )
