"""The pivot iteration hot loop, jitted.

Equivalent of the reference's solve loop (reference:
src/solver.cu:78-149) and its reduction primitives (src/reduction.cu).
The entire iteration — entering-variable argmin, unboundedness test,
min-ratio leaving test, rank-1 tableau update — lives inside one
``jax.lax.while_loop``; statuses are loop-carried values, so there are
**zero host round-trips per pivot** (the reference pays >=5 device-to-host
copies plus full device synchronisations per iteration, SURVEY.md §3.2).

Reductions: the reference's warp-shuffle two-pass argmin kernels
(reduction.cu:10-104) and the DBL_MAX-masked ratio-test indicator
(reduction.cu:106-140) become masked ``jnp.argmin`` calls XLA lowers to
on-device tree reductions; the unboundedness max-reduction
(``isLessOrEqualThanZero``, reduction.cu:143-201) becomes ``jnp.any``.

The rank-1 update (``updateContraintsMatrix`` + ``updateCostsVector``,
solver.cu:34-75) is a single fused elementwise pass over the tableau —
one read + one write of T per pivot, the memory-bandwidth floor. The
deferred block-pivot loop (``solve_loop_blocked``) amortises that pass
over a window of pivots.

Beyond the reference: Bland's-rule anti-cycling fallback (activated after
``bland_threshold`` consecutive non-improving pivots, reset on progress)
and an iteration fuse — the reference has neither and can cycle forever
(relazione.Rmd:1037-1039).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .config import SolverOptions, Status
from .tableau import Tableau, accum_matvec


class LoopState(NamedTuple):
    tab: Tableau
    status: jax.Array        # int32, Status.RUNNING while iterating
    iterations: jax.Array    # int32
    stall: jax.Array         # int32 consecutive non-improving pivots
    bland: jax.Array         # bool, Bland fallback currently active


def pivot_update(tab: Tableau, h, k, minc, p=None) -> Tableau:
    """Rank-1 pivot update (reference updateTableau, solver.cu:58-75).

    With p = T[h, k], column k of T and b divides by p; every other entry
    gets ``T[i, j] -= (a_h[j] / p) * T[i, k]`` (solver.cu:43, as fma), the
    cost row gets ``costs[i] -= (minc / p) * T[i, k]`` and the objective
    cell ``z -= (minc / p) * b[k]`` (solver.cu:48-56 — colPivot[0] is b[k]
    in the reference's fused layout). The pivot scalar p never leaves the
    device (the reference round-trips it to the host each iteration,
    solver.cu:65-66).
    """
    a_h = tab.T[h]                       # entering column, (M_pad,)
    if p is None:
        p = a_h[k]
    colk = tab.T[:, k]                   # leaving-constraint row, (R_pad,)
    bk = tab.b[k]
    factor = a_h / p
    lane = jnp.arange(tab.cols_padded)
    is_k = lane == k
    T = jnp.where(is_k[None, :], (colk / p)[:, None],
                  tab.T - colk[:, None] * factor[None, :])
    b = jnp.where(is_k, bk / p, tab.b - bk * factor)
    costs = tab.costs - (minc / p) * colk
    z = tab.z - (minc / p) * bk
    base = tab.base.at[k].set(h.astype(tab.base.dtype))
    return dataclasses.replace(tab, T=T, b=b, costs=costs, z=z, base=base)


def choose_entering(tab: Tableau, bland, eps: float):
    """Entering variable (reference minElement over costs, solver.cu:87):
    Dantzig argmin of reduced costs, or — when the Bland fallback is
    active — the lowest index with cost <= -eps. Ties break to the lowest
    index (deterministic; the reference's tie order is its GPU reduction
    order, reduction.cu:10-22 — documented divergence, SURVEY.md §7).

    Returns (h, minc); the caller is optimal iff ``minc > -eps``
    (reference ``compare(minCosts) < 0`` continue-test, solver.cu:88).
    """
    masked = jnp.where(tab.row_mask(), tab.costs, jnp.inf)
    h_dantzig = jnp.argmin(masked)
    eligible = masked <= -eps
    iota = jnp.arange(tab.rows_padded)
    h_bland = jnp.argmin(jnp.where(eligible, iota, tab.rows_padded))
    h = jnp.where(bland & eligible.any(), h_bland, h_dantzig)
    h = h.astype(jnp.int32)
    return h, masked[h]


def ratio_test(tab: Tableau, a_h, eps: float):
    """Leaving constraint (reference createIndicatorsVector + minElement,
    reduction.cu:106-140): argmin of ``b[j] / a_h[j]`` over columns with
    ``a_h[j] >= eps`` (``compare(rowPivot[i]) > 0``), DBL_MAX -> +inf
    elsewhere. Padded columns have a_h == 0 and are masked implicitly.

    Returns (k, unbounded); unbounded iff no eligible column — exactly the
    reference's max <= eps test (``isLessOrEqualThanZero``,
    reduction.cu:186-201).
    """
    mask = a_h >= eps
    unbounded = ~mask.any()
    ratios = jnp.where(mask, tab.b / jnp.where(mask, a_h, 1.0), jnp.inf)
    k = jnp.argmin(ratios).astype(jnp.int32)
    return k, unbounded


def iteration_body(state: LoopState, options: SolverOptions) -> LoopState:
    """One pivot iteration (reference inner solve, solver.cu:78-126):
    entering argmin -> unboundedness test -> min-ratio test -> rank-1
    update, as pure data flow. Shared by the fused ``lax.while_loop``
    driver (solve_loop) and the host-stepped timed driver
    (timed.solve_timed with per_iteration=True). Idempotent once
    OPTIMAL/UNBOUNDED (re-derives the same exit and skips the update),
    which also makes it vmap-safe for lanes that finish early."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    threshold = options.bland_threshold

    tab = state.tab
    h, minc = choose_entering(tab, state.bland, eps)
    optimal = minc > -eps

    a_h = tab.T[h]
    k, unbounded = ratio_test(tab, a_h, eps)
    do_pivot = ~(optimal | unbounded)

    # Guard the division for exit iterations (p could be ~0 garbage).
    p_raw = a_h[k]
    p = jnp.where(do_pivot, p_raw, jnp.ones_like(p_raw))
    new_tab = pivot_update(tab, h, k, minc, p=p)

    tab_out = jax.tree.map(
        lambda new, old: jnp.where(do_pivot, new, old),
        new_tab, tab)

    status = jnp.where(
        optimal, int(Status.OPTIMAL),
        jnp.where(unbounded, int(Status.UNBOUNDED),
                  int(Status.RUNNING))).astype(jnp.int32)

    improved = jnp.abs(tab_out.z - tab.z) >= eps
    stall, bland = anticycling_update(
        do_pivot, improved, state.stall, state.bland,
        bland_static=bland_static, threshold=threshold)

    return LoopState(tab_out, status,
                     state.iterations + do_pivot.astype(jnp.int32),
                     stall, bland)


def anticycling_update(do, improved, prev_stall, prev_bland, *,
                       bland_static: bool, threshold):
    """The shared stall/Bland anti-cycling policy, identical across
    every solve loop (sequential, blocked, and their sharded mirrors): an applied pivot that improves z by
    >= eps resets the stall counter and leaves Bland mode; a
    non-improving pivot increments it and enters Bland once the counter
    reaches ``threshold``. ``bland_static`` pins Bland on
    (pivot_rule='bland'); ``threshold=None`` disables the fallback.
    Returns (stall, bland)."""
    stall = jnp.where(do, jnp.where(improved, 0, prev_stall + 1),
                      prev_stall).astype(jnp.int32)
    if bland_static:
        bland = jnp.ones((), bool)
    elif threshold is None:
        bland = jnp.zeros((), bool)
    else:
        bland = jnp.where(do, jnp.where(improved, False,
                                        stall >= threshold), prev_bland)
    return stall, bland


def initial_state(tab: Tableau, options: SolverOptions) -> LoopState:
    return LoopState(tab, jnp.asarray(int(Status.RUNNING), jnp.int32),
                     jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                     jnp.asarray(options.pivot_rule_resolved == "bland"))


def solve_loop(tab: Tableau, options: SolverOptions,
               max_iter: int) -> tuple[Tableau, jax.Array, jax.Array]:
    """Run pivots until OPTIMAL / UNBOUNDED / iteration fuse
    (reference outer solve, solver.cu:128-149).

    Returns (tableau, status, iterations); status stays RUNNING if the
    fuse tripped (mapped to MAXITER by the caller).
    """

    def cond(state: LoopState):
        return (state.status == int(Status.RUNNING)) & (
            state.iterations < max_iter)

    final = lax.while_loop(cond, lambda s: iteration_body(s, options),
                           initial_state(tab, options))
    return final.tab, final.status, final.iterations


def _dot(a: jax.Array, b: jax.Array, dims) -> jax.Array:
    """The blocked loops' products at full precision in the operands'
    dtype: HIGHEST keeps f32 products out of TF32 on the GPU, and f64
    runs as a native f64 dot."""
    return lax.dot_general(a, b, dims, precision=lax.Precision.HIGHEST,
                           preferred_element_type=a.dtype)


def apply_window(T: jax.Array, C: jax.Array, F: jax.Array) -> jax.Array:
    """``T - C @ F`` — the once-per-window tableau apply of the deferred
    block-pivot scheme (C: R x L eta columns, F: L x M eta rows)."""
    return T - _dot(C, F, (((1,), (0,)), ((), ())))


def apply_window_T(Tt: jax.Array, C: jax.Array, F: jax.Array) -> jax.Array:
    """``Tt - F^T @ C`` for the transposed blocked loop: Tt (M_pad,
    R_pad), C (L, R_pad) holds the eta columns as rows, F (L, M_pad) the
    eta rows."""
    return Tt - _dot(F, C, (((0,), (0,)), ((), ())))


class BlockedLoopState(NamedTuple):
    """solve_loop_blocked carry. ``Tt`` is the *stale* tableau stored
    TRANSPOSED — (M_pad, R_pad), constraint-major — so the per-pivot
    leaving-column fetch is a contiguous row read; the live tableau is
    implicitly ``Tt^T - C^T @ F``. costs/b/z/base are always current."""

    Tt: jax.Array
    b: jax.Array
    costs: jax.Array
    z: jax.Array
    base: jax.Array
    w: jax.Array             # devex reference weights ((R_pad,), all-ones
    #                          and untouched under dantzig/bland)
    status: jax.Array
    iterations: jax.Array
    stall: jax.Array
    bland: jax.Array


def solve_loop_blocked(tab: Tableau, options: SolverOptions,
                       max_iter: int, costs0: jax.Array | None = None
                       ) -> tuple[Tableau, jax.Array, jax.Array]:
    """Deferred block-pivot loop: the production hot loop.

    ``costs0`` — the phase's ORIGINAL (pre-Gaussian-elimination) cost
    vector — enables exact re-pricing at every window boundary; pass it
    whenever available (two_phase does) to make f32 runs drift-immune.

    The reference (and the L=1 paths here) stream the whole tableau
    through device memory once per pivot (rank-1 update, solver.cu:34-46) — at
    large sizes that is the entire runtime (>99%, relazione.Rmd:506) and
    is memory-bound. This loop instead keeps the tableau STALE for a
    window of ``L = options.block_pivots`` pivots, accumulating each
    pivot's eta pair

        C[t, :] = colk_t   (live leaving column),
        F[t, :] = v_t      (live entering row / p, with v_t[k] = 1 - 1/p)

    and applies ``T <- T - C^T... i.e. Tt -= F^T @ C`` ONCE per window —
    one matrix product — amortising the 2-pass memory cost of the update
    over L pivots. Within the window every quantity is computed EXACTLY against
    the live (virtual) tableau:

        live column j:  Tt[j, :] - F[:, j] @ C     (contiguous row + O(RL))
        live row h:     Tt[:, h] - C[:, h] @ F     (small stride + O(LM))

    while costs, b, z and base are updated exactly every pivot (O(R+M)).

    Layout note (why transposed): in the reference's variable-major
    layout the leaving column T[:, k] is a strided gather over the long
    variable axis (R_pad elements, one memory transaction each). Stored
    constraint-major, that fetch is one contiguous row and only the much
    shorter entering-row fetch (M_pad elements) is strided. The two
    physical transposes per phase are amortised over thousands of
    pivots.

    The pivot *choices* (Dantzig/Bland entering, ratio test, statuses,
    eps discipline) are identical to solve_loop; only floating-point
    summation order differs.
    """
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots or 1)
    r_pad, m_pad = tab.T.shape
    dtype = tab.T.dtype
    vdtype = tab.costs.dtype
    row_iota = jnp.arange(r_pad)
    row_mask = row_iota < tab.r
    # Re-price only f32 tableaus, whose incremental costs drift. f64
    # updates drift ~1e-13, and re-pricing them would change the pivot
    # walk that the f64 parity tests pin (whether f64 should re-price
    # is an open question in ROADMAP.md).
    if jnp.dtype(dtype).itemsize >= 8:
        costs0 = None

    def corr_vec(Ct, w):
        """w (L,) against Ct (L, K) -> (K,): the per-pivot eta
        correction."""
        return _dot(w, Ct, (((0,), (0,)), ((), ())))

    def entering(costs, w, bland_flag):
        """choose_entering on the bare cost vector (same semantics),
        with the devex score (cost^2 / weight over eligible columns)
        replacing the Dantzig argmin when configured."""
        masked = jnp.where(row_mask, costs, jnp.inf)
        eligible = masked <= -eps
        if devex:
            score = jnp.where(eligible, masked * masked / w, -jnp.inf)
            h_main = jnp.argmax(score)
        else:
            h_main = jnp.argmin(masked)
        h_bland = jnp.argmin(jnp.where(eligible, row_iota, r_pad))
        h = jnp.where(bland_flag & eligible.any(), h_bland, h_main)
        h = h.astype(jnp.int32)
        return h, masked[h]

    def devex_update(w, do, colk, p, h, old_base_k):
        """Forrest-Goldfarb reference-framework weight update: alpha is
        the leaving row over all variables (colk/p); the leaving
        variable gets max(w_h / p^2, 1); re-anchor to all-ones when the
        framework drifts beyond 1e8."""
        wh = w[h]
        alpha = (colk / p).astype(w.dtype)
        w2 = jnp.maximum(w, alpha * alpha * wh)
        lv = jnp.minimum(old_base_k, r_pad - 1)
        w2 = w2.at[lv].set(jnp.where(old_base_k < r_pad,
                                     jnp.maximum(wh / (p * p).astype(
                                         w.dtype), 1.0),
                                     w2[lv]))
        # Per-update cap + NaN guard (overflow to inf then inf*0=NaN
        # would poison the score argmax), then the framework re-anchor.
        w2 = jnp.minimum(w2, 1e12)
        w2 = jnp.where(jnp.isnan(w2), jnp.ones_like(w2), w2)
        w2 = jnp.where(jnp.max(w2) > 1e8, jnp.ones_like(w2), w2)
        return jnp.where(do, w2, w)

    def inner(t, carry):
        """One pivot against the virtual tableau; no-op once finished.
        Gated on the iteration fuse PER PIVOT (not just per window) so a
        MAXITER exit reports exactly max_iter pivots on every loop
        variant instead of overrunning up to L-1 into the last window."""
        C, F, s = carry
        active = ((s.status == int(Status.RUNNING))
                  & (s.iterations < max_iter))

        h, minc = entering(s.costs, s.w, s.bland)
        optimal = minc > -eps

        a_h = s.Tt[:, h] - corr_vec(F, C[:, h])
        mask = a_h >= eps
        unbounded = ~mask.any()
        ratios = jnp.where(mask, s.b / jnp.where(mask, a_h, 1.0), jnp.inf)
        k = jnp.argmin(ratios).astype(jnp.int32)
        do = active & ~(optimal | unbounded)

        p_raw = a_h[k]
        p = jnp.where(do, p_raw, jnp.ones_like(p_raw))
        colk = s.Tt[k, :] - corr_vec(C, F[:, k])
        bk = s.b[k]

        costs2 = jnp.where(do, s.costs - (minc / p) * colk, s.costs)
        z2 = jnp.where(do, s.z - (minc / p) * bk, s.z)
        is_k = jnp.arange(m_pad) == k
        b2 = jnp.where(do,
                       jnp.where(is_k, bk / p, s.b - bk * (a_h / p)),
                       s.b)
        base2 = jnp.where(do, s.base.at[k].set(h.astype(s.base.dtype)),
                          s.base)
        w2 = (devex_update(s.w, do, colk, p, h,
                           s.base[k].astype(jnp.int32))
              if devex else s.w)

        v = (a_h / p).at[k].set(1.0 - 1.0 / p)             # eta row
        C2 = C.at[t, :].set(jnp.where(do, colk, jnp.zeros_like(colk)))
        F2 = F.at[t, :].set(jnp.where(do, v, jnp.zeros_like(v)))

        status = jnp.where(
            active,
            jnp.where(optimal, int(Status.OPTIMAL),
                      jnp.where(unbounded, int(Status.UNBOUNDED),
                                int(Status.RUNNING))),
            s.status).astype(jnp.int32)

        improved = jnp.abs(z2 - s.z) >= eps
        stall, bland = anticycling_update(
            do, improved, s.stall, s.bland,
            bland_static=bland_static, threshold=threshold)

        return (C2, F2, BlockedLoopState(
            s.Tt, b2, costs2, z2, base2, w2, status,
            s.iterations + do.astype(jnp.int32), stall, bland))

    def outer(s: BlockedLoopState):
        C = jnp.zeros((L, r_pad), dtype)
        F = jnp.zeros((L, m_pad), dtype)
        C, F, s = lax.fori_loop(0, L, inner, (C, F, s))
        Tt2 = apply_window_T(s.Tt, C, F)
        s = s._replace(Tt=Tt2)
        if costs0 is not None:
            # Window-boundary re-pricing: the incrementally-maintained
            # reduced costs accumulate O(sqrt(pivots)) ulp drift — enough
            # in f32 to stop phase 1 prematurely (observed false
            # INFEASIBLE at 2048^2 after ~5k pivots). Recompute them
            # EXACTLY from the freshly applied tableau (one matvec), and
            # if the loop just declared OPTIMAL on drifted costs while
            # exact pricing still shows an improving direction, keep
            # running.
            valid = s.base < tab.r
            coeffs = jnp.where(
                valid, costs0[jnp.minimum(s.base, r_pad - 1)], 0.0)
            costs_exact = costs0 - accum_matvec(
                Tt2, coeffs, 0, costs0.dtype)
            vmin = jnp.min(jnp.where(row_mask, costs_exact, jnp.inf))
            premature = (s.status == int(Status.OPTIMAL)) & (vmin <= -eps)
            status = jnp.where(premature, int(Status.RUNNING),
                               s.status).astype(jnp.int32)
            s = s._replace(costs=costs_exact, status=status)
        return s

    def cond(s: BlockedLoopState):
        return (s.status == int(Status.RUNNING)) & (s.iterations < max_iter)

    init = BlockedLoopState(
        tab.T.T, tab.b, tab.costs, tab.z, tab.base,
        jnp.ones((r_pad,), vdtype),
        jnp.asarray(int(Status.RUNNING), jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
        jnp.asarray(bland_static))
    final = lax.while_loop(cond, outer, init)
    out_tab = dataclasses.replace(
        tab, T=final.Tt.T, b=final.b, costs=final.costs, z=final.z,
        base=final.base)
    return out_tab, final.status, final.iterations


def run_solve_loop(tab: Tableau, options: SolverOptions, max_iter: int,
                   costs0=None):
    """Dispatch: the deferred block-pivot loop when ``block_pivots > 1``,
    else the sequential reference loop. ``costs0`` (the phase's
    pre-elimination cost vector) enables the blocked loop's exact
    window-boundary re-pricing; ignored by the sequential loop.

    When ``config.normalize_enabled`` (f32 tableaus by default), the
    working cost vector, z, and costs0 are scaled for the duration of
    the call and restored on exit, which floors the effective pricing
    eps at ``EPS_REL_F32 * (1 + max|costs|)`` (see
    SolverOptions.normalize_costs): large-coefficient problems stop at
    the f32-data-precision optimum instead of crawling noise pivots to
    the fuse, while problems already above the floor run bit-for-bit
    unchanged (scale = 1). Positive scaling never changes an argmin,
    and the ratio test reads the (unscaled) tableau, so only the
    pricing/improvement discipline is affected."""
    from .config import EPS_REL_F32, normalize_enabled

    if (options.pivot_rule_resolved == "devex"
            and not (options.block_pivots
                     and int(options.block_pivots) > 1)):
        raise ValueError(
            "pivot_rule='devex' requires block_pivots > 1 (the deferred "
            "block-pivot loops carry the devex weights); the sequential "
            "reference loop prices with Dantzig/Bland only")

    scale = None
    if normalize_enabled(options):
        cmax = jnp.max(jnp.abs(
            jnp.where(jnp.arange(tab.rows_padded) < tab.r, tab.costs,
                      0.0)))
        scale = jnp.maximum(
            1.0, (EPS_REL_F32 / float(options.eps_resolved))
            * (1.0 + cmax)).astype(tab.costs.dtype)
        tab = dataclasses.replace(tab, costs=tab.costs / scale,
                                  z=tab.z / scale)
        if costs0 is not None:
            costs0 = costs0 / scale

    if options.block_pivots and int(options.block_pivots) > 1:
        out = solve_loop_blocked(tab, options, max_iter, costs0)
    else:
        out = solve_loop(tab, options, max_iter)

    if scale is not None:
        tab_out, status, iters = out
        tab_out = dataclasses.replace(tab_out,
                                      costs=tab_out.costs * scale,
                                      z=tab_out.z * scale)
        return tab_out, status, iters
    return out
