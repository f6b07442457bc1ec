"""Multi-device column-sharded two-phase simplex.

The reference is strictly single-GPU (SURVEY.md §2 "Parallelism
strategies"); this module is the north-star extension: the tableau's
*variable axis* (its stored rows — structural + slack + artificial
variables, reference tabular.cu:30-31) is sharded across a
``jax.sharding.Mesh`` axis, so LPs with millions of variables
spread over devices; XLA hands every per-pivot collective to NCCL on
the GPU.

Sharding layout (per SURVEY.md §5 "Long-context" analogue):

* ``T (R_pad, M_pad)`` and ``costs (R_pad,)`` — sharded on axis 0 (vars).
* ``b (M_pad,)``, ``base (M_pad,)``, ``z ()`` — replicated; every shard
  computes identical updates to them (no communication needed).

Per-pivot communication (cost model in SURVEY.md §5):

1. Entering variable: local masked argmin over the costs shard, then an
   ``all_gather`` of P (value, index) scalar pairs + lexicographic argmin —
   the distributed analogue of the reference's two-pass grid argmin
   (reference reduction.cu:51-104). Ties break to the lowest global index.
2. Entering column broadcast: the owning shard contributes its row
   ``T_local[h_local]``, everyone else zeros, one ``psum`` of an (M_pad,)
   vector — the only O(m) collective per pivot.
3. Ratio test, unboundedness, base/b/z updates: replicated host-free math
   on the broadcast column (reference reduction.cu:106-201 equivalents).
4. Rank-1 update: embarrassingly parallel per shard (reference
   solver.cu:34-56 equivalent), zero communication.

Phase 1 -> Phase 2: the reference drops the artificial block by shrinking
``rows`` (twoPhaseMethod.cu:288). A sharded array cannot cheaply change its
padded extent, so the sharded path keeps the Phase-1 row allocation and
masks the artificial rows out via the ``r`` metadata instead — at the
north-star shape (n >> m) the wasted rows are ~2m/(n+m) of the update work.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_OPTIONS, SolverOptions, Status
from ..solver import LoopState, _dot, anticycling_update, apply_window
from ..tableau import Tableau, accum_matvec, round_up

AXIS = "vars"


def sharded_padded_dims(n: int, m: int, n_shards: int,
                        options: SolverOptions) -> tuple[int, int]:
    """(R_pad, M_pad) with R_pad divisible by n_shards and every local
    shard a whole number of ``sublane_pad`` rows."""
    r_pad = round_up(n + 2 * m, options.sublane_pad * n_shards)
    m_pad = round_up(m, options.lane_pad)
    return r_pad, m_pad


def tableau_specs(n: int, m: int, r: int) -> Tableau:
    """The canonical PartitionSpec pytree for a sharded Tableau: T and
    costs row-sharded over the 'vars' axis, everything else replicated.
    Shared by the solver factory, the sharded checkpoint/resume path,
    and the CPU-mesh tests."""
    return Tableau(T=P(AXIS, None), b=P(None), costs=P(AXIS), z=P(),
                   base=P(None), n=n, m=m, r=r)


def tableau_shardings(mesh: Mesh, n: int, m: int, r: int) -> Tableau:
    """tableau_specs with each spec bound to ``mesh`` as a NamedSharding
    (for device_put / with_sharding_constraint)."""
    return jax.tree.map(
        lambda sp: NamedSharding(mesh, sp) if isinstance(sp, P) else sp,
        tableau_specs(n, m, r), is_leaf=lambda x: isinstance(x, P))


def _local_rows(tab: Tableau) -> int:
    return tab.T.shape[0]


def _global_row_offset(tab: Tableau) -> jax.Array:
    return lax.axis_index(AXIS) * _local_rows(tab)


def _local_row_mask(tab: Tableau) -> jax.Array:
    """(R_loc,) bool — True on rows that are globally real (< tab.r)."""
    gi = _global_row_offset(tab) + jnp.arange(_local_rows(tab))
    return gi < tab.r


def entering_sharded(tab: Tableau, bland, eps: float):
    """Distributed entering-variable selection (reference minElement over
    the costs vector, solver.cu:87 + reduction.cu:82-104): local masked
    argmin per shard, then an all-gather of P scalar pairs and a
    lexicographic (value, index) argmin so ties break to the lowest global
    index on every shard identically.

    Returns (h_global, min_cost), both replicated.
    """
    R_loc = _local_rows(tab)
    offset = _global_row_offset(tab)
    gmask = _local_row_mask(tab)
    masked = jnp.where(gmask, tab.costs, jnp.inf)

    # Dantzig candidate: most negative reduced cost in this shard.
    lh = jnp.argmin(masked)
    lmin = masked[lh]
    cand_dantzig = offset + lh

    # Bland candidate: lowest global index with cost <= -eps in this shard.
    eligible = masked <= -eps
    iota = jnp.arange(R_loc)
    lh_bland = jnp.argmin(jnp.where(eligible, iota, R_loc))
    has_eligible = eligible.any()
    big = jnp.iinfo(jnp.int32).max
    cand_bland = jnp.where(has_eligible, offset + lh_bland, big)
    val_bland = jnp.where(has_eligible,
                          masked[jnp.minimum(lh_bland, R_loc - 1)], jnp.inf)

    vals = lax.all_gather(lmin, AXIS)            # (P,)
    idxs = lax.all_gather(cand_dantzig, AXIS)    # (P,)
    gmin = jnp.min(vals)
    at_min = vals == gmin
    h_dantzig = jnp.min(jnp.where(at_min, idxs, big))

    bland_idxs = lax.all_gather(cand_bland, AXIS)
    bland_vals = lax.all_gather(val_bland, AXIS)
    owner = jnp.argmin(bland_idxs)
    h_bland = bland_idxs[owner]
    v_bland = bland_vals[owner]
    any_eligible = h_bland < big

    use_bland = bland & any_eligible
    h = jnp.where(use_bland, h_bland, h_dantzig)
    minc = jnp.where(use_bland, v_bland, gmin)
    return h.astype(jnp.int32), minc


def broadcast_entering_column(tab: Tableau, h) -> jax.Array:
    """Broadcast the entering variable's constraint column a_h (length
    M_pad) from its owning shard: owner contributes ``T_local[h_local]``,
    others zeros, one ``psum`` over the vars axis (the distributed analogue
    of the reference's contiguous entering-column memcpy, solver.cu:90-94).
    """
    R_loc = _local_rows(tab)
    offset = _global_row_offset(tab)
    local_h = h - offset
    own = (local_h >= 0) & (local_h < R_loc)
    row = tab.T[jnp.clip(local_h, 0, R_loc - 1)]
    contrib = jnp.where(own, row, jnp.zeros_like(row))
    return lax.psum(contrib, AXIS)


def gather_cost_at(tab: Tableau, h) -> jax.Array:
    """Replicate costs[h] (global index) to every shard via a psum."""
    R_loc = _local_rows(tab)
    offset = _global_row_offset(tab)
    local_h = h - offset
    own = (local_h >= 0) & (local_h < R_loc)
    val = tab.costs[jnp.clip(local_h, 0, R_loc - 1)]
    return lax.psum(jnp.where(own, val, jnp.zeros_like(val)), AXIS)


def _gather_basic_coeffs(base, costs, r, R_loc) -> jax.Array:
    """(M_pad,) replicated coefficient vector costs[base] for the basic
    variables: each shard contributes the entries whose GLOBAL variable
    index it owns (dropped/artificial sentinels ``base >= r`` contribute
    0), folded with one psum. Shared by the sharded Gaussian elimination
    and both sharded window re-pricing paths — the validity mask here
    was patched once already (dropped-constraint sentinel) and must stay
    identical across all three."""
    offset = (lax.axis_index(AXIS) * R_loc).astype(base.dtype)
    local_idx = base - offset
    own = (local_idx >= 0) & (local_idx < R_loc) & (base < r)
    vals = costs[jnp.clip(local_idx, 0, R_loc - 1)]
    return lax.psum(jnp.where(own, vals, 0.0), AXIS)


def ratio_test_replicated(tab: Tableau, a_h, eps: float):
    """Leaving constraint on the replicated (b, a_h) pair — identical math
    to the single-chip path (reference reduction.cu:106-140), computed
    redundantly on every shard (no communication). Like every other
    ratio test in this repo, padded constraint columns need no explicit
    mask: a_h is exactly 0 there (padded tableau columns stay zero under
    both rank-1 and eta updates), so ``a_h >= eps`` already excludes
    them."""
    mask = a_h >= eps
    unbounded = ~mask.any()
    ratios = jnp.where(mask, tab.b / jnp.where(mask, a_h, 1.0), jnp.inf)
    k = jnp.argmin(ratios).astype(jnp.int32)
    return k, unbounded


def pivot_update_sharded(tab: Tableau, a_h, h, k, minc) -> Tableau:
    """Rank-1 pivot update with a sharded tableau (reference updateTableau
    + updateCostsVector, solver.cu:34-75): given the replicated entering
    column a_h, every shard updates its own rows of T and costs; b, z, and
    base are updated replicated. Zero communication."""
    p = a_h[k]
    colk = tab.T[:, k]                   # local rows of the leaving column
    bk = tab.b[k]
    factor = a_h / p
    is_k = jnp.arange(tab.cols_padded) == k
    T = jnp.where(is_k[None, :], (colk / p)[:, None],
                  tab.T - colk[:, None] * factor[None, :])
    b = jnp.where(is_k, bk / p, tab.b - bk * factor)
    costs = tab.costs - (minc / p) * colk
    z = tab.z - (minc / p) * bk
    base = tab.base.at[k].set(h.astype(tab.base.dtype))
    return dataclasses.replace(tab, T=T, b=b, costs=costs, z=z, base=base)


def solve_loop_sharded(tab: Tableau, options: SolverOptions, max_iter: int):
    """The hot loop under shard_map: one ``lax.while_loop`` whose body does
    (gather-argmin, psum a_h, replicated ratio test, local rank-1 update) —
    the distributed mirror of solver.solve_loop with the same statuses,
    Bland fallback, and iteration fuse."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    threshold = options.bland_threshold

    def cond(state: LoopState):
        return (state.status == int(Status.RUNNING)) & (
            state.iterations < max_iter)

    def body(state: LoopState):
        tab = state.tab
        h, minc = entering_sharded(tab, state.bland, eps)
        optimal = minc > -eps

        a_h = broadcast_entering_column(tab, h)
        k, unbounded = ratio_test_replicated(tab, a_h, eps)
        do_pivot = ~(optimal | unbounded)

        safe_a_h = jnp.where(do_pivot, a_h,
                             jnp.zeros_like(a_h).at[k].set(1.0))
        new_tab = pivot_update_sharded(tab, safe_a_h, h, k, minc)
        tab_out = jax.tree.map(
            lambda new, old: jnp.where(do_pivot, new, old), new_tab, tab)

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

    init = LoopState(tab, jnp.asarray(int(Status.RUNNING), jnp.int32),
                     jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                     jnp.asarray(bland_static))
    final = lax.while_loop(cond, body, init)
    return final.tab, final.status, final.iterations


def broadcast_live_row(tab: Tableau, C: jax.Array, F: jax.Array,
                       h) -> jax.Array:
    """Live row h of the virtual tableau ``T0 - C @ F`` under sharding:
    the owning shard computes ``T0_loc[h_loc] - C_loc[h_loc] @ F`` and one
    psum broadcasts it — the same single (M_pad,) collective per pivot as
    the unblocked path."""
    R_loc = _local_rows(tab)
    offset = _global_row_offset(tab)
    local_h = h - offset
    own = (local_h >= 0) & (local_h < R_loc)
    lh = jnp.clip(local_h, 0, R_loc - 1)
    row = tab.T[lh] - _dot(C[lh], F, (((0,), (0,)), ((), ())))
    contrib = jnp.where(own, row, jnp.zeros_like(row))
    return lax.psum(contrib, AXIS)


def entering_sharded_devex(tab: Tableau, w, bland, eps: float):
    """Distributed Devex entering selection (the sharded mirror of
    solver.solve_loop_blocked's devex branch): local score argmax
    (cost^2 / weight over eligible rows) per shard, one all-gather of
    each shard's (score, cost, weight) triple — plus the Bland
    candidate's pair on the same gather — then the global score argmax
    with ties to the lowest global index.

    Returns (h_global, cost at h, weight at h), all replicated."""
    R_loc = _local_rows(tab)
    offset = _global_row_offset(tab)
    masked = jnp.where(_local_row_mask(tab), tab.costs, jnp.inf)
    eligible = masked <= -eps
    big = jnp.iinfo(jnp.int32).max

    score = jnp.where(eligible, masked * masked / w, -jnp.inf)
    lh_d = jnp.argmax(score).astype(jnp.int32)

    iota = jnp.arange(R_loc)
    lh_b = jnp.argmin(jnp.where(eligible, iota, R_loc)).astype(jnp.int32)
    has_el = eligible.any()
    cand_b = jnp.where(has_el, (offset + lh_b).astype(jnp.int32), big)
    lb = jnp.minimum(lh_b, R_loc - 1)

    vals = lax.all_gather(jnp.stack([
        score[lh_d], masked[lh_d], w[lh_d],
        jnp.where(has_el, masked[lb], jnp.inf),
        jnp.where(has_el, w[lb], jnp.ones((), w.dtype))]), AXIS)  # (P, 5)
    idxs = lax.all_gather(jnp.stack([(offset + lh_d).astype(jnp.int32),
                                     cand_b]), AXIS)              # (P, 2)
    kmax = jnp.max(vals[:, 0])
    h_d = jnp.min(jnp.where(vals[:, 0] == kmax, idxs[:, 0], big))
    at_d = idxs[:, 0] == h_d                 # global indices are unique
    v_d = jnp.sum(jnp.where(at_d, vals[:, 1], 0.0))
    w_d = jnp.sum(jnp.where(at_d, vals[:, 2], 0.0))

    h_b = jnp.min(idxs[:, 1])
    any_el = h_b < big
    at_b = idxs[:, 1] == h_b
    v_b = jnp.where(any_el, jnp.sum(jnp.where(at_b, vals[:, 3], 0.0)),
                    jnp.inf)
    w_b = jnp.where(any_el, jnp.sum(jnp.where(at_b, vals[:, 4], 0.0)),
                    jnp.ones((), w.dtype))

    use_b = bland & any_el
    h = jnp.where(use_b, h_b, h_d).astype(jnp.int32)
    return (h, jnp.where(use_b, v_b, v_d), jnp.where(use_b, w_b, w_d))


def devex_update_sharded(w, do, colk_local, p, wh, old_base_k, tab):
    """Forrest-Goldfarb weight update on the LOCAL weight slice (the
    sharded mirror of solver.solve_loop_blocked's devex_update): alpha is
    the shard's slice of the live leaving row over p; the leaving
    variable's row (owned by exactly one shard) gets max(w_h / p^2, 1);
    same per-update overflow cap + NaN guard, and the same per-pivot
    framework re-anchor — made GLOBAL with one scalar all-gather so every
    shard re-anchors on the same pivot (the single-chip walk's 1e8 test
    sees the global max by construction)."""
    R_loc = _local_rows(tab)
    offset = _global_row_offset(tab)
    alpha = (colk_local / p).astype(w.dtype)
    w2 = jnp.maximum(w, alpha * alpha * wh)
    lv_loc = old_base_k - offset
    # Guard matches the single-chip update's (solver.devex_update:
    # old_base_k < r_pad, i.e. ANY in-range row — including a basic
    # artificial in [r, r_pad) leaving in phase 2 under
    # degeneracy='continue'); the row-index equality already bounds
    # old_base_k to this shard's slice, so no extra range test. A
    # stricter `< tab.r` guard here skipped those artificial-row weight
    # writes, letting the weight state (and the 1e8 re-anchor trigger)
    # drift off the single-chip walk on degenerate instances.
    hit = jnp.arange(R_loc) == lv_loc
    w2 = jnp.where(hit, jnp.maximum(wh / (p * p).astype(w.dtype), 1.0),
                   w2)
    w2 = jnp.minimum(w2, 1e12)
    w2 = jnp.where(jnp.isnan(w2), jnp.ones_like(w2), w2)
    wmax = lax.pmax(jnp.max(w2), AXIS)
    w2 = jnp.where(wmax > 1e8, jnp.ones_like(w2), w2)
    return jnp.where(do, w2, w)


def solve_loop_blocked_sharded(tab: Tableau, options: SolverOptions,
                               max_iter: int, costs0=None):
    """Sharded deferred block pivoting (see solver.solve_loop_blocked):
    the stale T shard and the eta columns C shard together along the vars
    axis; the eta rows F are replicated (computed identically everywhere
    from the broadcast live row). Per-pivot communication is unchanged —
    the candidate all-gather plus one (M_pad,) psum — and the per-window
    ``T -= C @ F`` apply is a local matrix product per shard, so the ~L x
    traffic reduction carries over to the distributed solver.

    Devex pricing is supported: the weights shard with the costs, the
    entering fold gathers (score, cost, weight), and the per-pivot
    framework re-anchor adds one scalar pmax."""
    eps = float(options.eps_resolved)
    bland_static = options.pivot_rule_resolved == "bland"
    devex = options.pivot_rule_resolved == "devex"
    threshold = options.bland_threshold
    L = int(options.block_pivots or 1)
    R_loc, m_pad = tab.T.shape
    dtype = tab.T.dtype
    vdtype = tab.costs.dtype
    if jnp.dtype(dtype).itemsize >= 8:
        costs0 = None        # see solver.solve_loop_blocked

    def inner(t, carry):
        C, F, w, s = carry
        tab = s.tab
        # Per-pivot iteration fuse — see solver.solve_loop_blocked.inner.
        active = ((s.status == int(Status.RUNNING))
                  & (s.iterations < max_iter))

        if devex:
            h, minc, w_h = entering_sharded_devex(tab, w, s.bland, eps)
        else:
            h, minc = entering_sharded(tab, s.bland, eps)
            w_h = None
        optimal = minc > -eps

        a_h = broadcast_live_row(tab, C, F, h)
        k, unbounded = ratio_test_replicated(tab, a_h, eps)
        do = active & ~(optimal | unbounded)

        p_raw = a_h[k]
        p = jnp.where(do, p_raw, jnp.ones_like(p_raw))
        colk = tab.T[:, k] - _dot(C, F[:, k], (((1,), (0,)), ((), ())))
        bk = tab.b[k]

        costs2 = jnp.where(do, tab.costs - (minc / p) * colk, tab.costs)
        z2 = jnp.where(do, tab.z - (minc / p) * bk, tab.z)
        is_k = jnp.arange(m_pad) == k
        b2 = jnp.where(do,
                       jnp.where(is_k, bk / p, tab.b - bk * (a_h / p)),
                       tab.b)
        base2 = jnp.where(do, tab.base.at[k].set(h.astype(tab.base.dtype)),
                          tab.base)
        w2 = (devex_update_sharded(w, do, colk, p, w_h,
                                   tab.base[k].astype(jnp.int32), tab)
              if devex else w)

        v = (a_h / p).at[k].set(1.0 - 1.0 / p)
        C2 = C.at[:, t].set(jnp.where(do, colk, jnp.zeros_like(colk)))
        F2 = F.at[t, :].set(jnp.where(do, v, jnp.zeros_like(v)))

        status = jnp.where(
            active,
            jnp.where(optimal, int(Status.OPTIMAL),
                      jnp.where(unbounded, int(Status.UNBOUNDED),
                                int(Status.RUNNING))),
            s.status).astype(jnp.int32)

        improved = jnp.abs(z2 - tab.z) >= eps
        stall, bland = anticycling_update(
            do, improved, s.stall, s.bland,
            bland_static=bland_static, threshold=threshold)

        tab2 = dataclasses.replace(tab, costs=costs2, b=b2, z=z2,
                                   base=base2)
        return (C2, F2, w2, LoopState(
            tab2, status, s.iterations + do.astype(jnp.int32), stall,
            bland))

    def outer(carry):
        s, w = carry
        C = jnp.zeros((R_loc, L), dtype)
        F = jnp.zeros((L, m_pad), dtype)
        C, F, w, s = lax.fori_loop(0, L, inner, (C, F, w, s))
        T2 = apply_window(s.tab.T, C, F)
        tab2 = dataclasses.replace(s.tab, T=T2)
        status = s.status
        if costs0 is not None:
            # Window-boundary exact re-pricing (see the single-chip
            # solve_loop_blocked): basic-cost gather is one psum, the
            # reprice a local matvec; a premature OPTIMAL on drifted
            # costs is reverted if exact pricing still improves.
            coeffs = _gather_basic_coeffs(tab2.base, costs0, tab2.r,
                                          R_loc)
            costs_exact = costs0 - accum_matvec(
                tab2.T, coeffs, 1, costs0.dtype)
            lmin = jnp.min(jnp.where(_local_row_mask(tab2), costs_exact,
                                     jnp.inf))
            vmin = lax.pmin(lmin, AXIS)
            premature = (status == int(Status.OPTIMAL)) & (
                vmin <= -float(options.eps_resolved))
            status = jnp.where(premature, int(Status.RUNNING),
                               status).astype(jnp.int32)
            tab2 = dataclasses.replace(tab2, costs=costs_exact)
        return (LoopState(tab2, status, s.iterations, s.stall, s.bland),
                w)

    def cond(carry):
        s, _w = carry
        return (s.status == int(Status.RUNNING)) & (s.iterations < max_iter)

    init = (LoopState(tab, jnp.asarray(int(Status.RUNNING), jnp.int32),
                      jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                      jnp.asarray(bland_static)),
            jnp.ones((R_loc,), vdtype))
    final, _w = lax.while_loop(cond, outer, init)
    return final.tab, final.status, final.iterations


def run_solve_loop_sharded(tab: Tableau, options: SolverOptions,
                           max_iter: int, costs0=None):
    """The sharded mirror of solver.run_solve_loop: the blocked loop when
    ``block_pivots > 1``, else the sequential loop."""
    from ..config import EPS_REL_F32, normalize_enabled

    # Scale-aware f32 pricing, as in solver.run_solve_loop (the eps
    # floor at EPS_REL_F32 * cost scale). The scale is a GLOBAL max
    # over the sharded cost vector.
    scale = None
    if normalize_enabled(options):
        lmax = jnp.max(jnp.abs(jnp.where(_local_row_mask(tab), tab.costs,
                                         0.0)))
        cmax = lax.pmax(lmax, AXIS)
        scale = jnp.maximum(
            1.0, (EPS_REL_F32 / float(options.eps_resolved))
            * (1.0 + cmax)).astype(tab.costs.dtype)
        tab = dataclasses.replace(tab, costs=tab.costs / scale,
                                  z=tab.z / scale)
        if costs0 is not None:
            costs0 = costs0 / scale

    L = int(options.block_pivots or 1)
    if options.pivot_rule_resolved == "devex" and L <= 1:
        raise ValueError(
            "sharded pivot_rule='devex' requires block_pivots > 1 (the "
            "deferred block-pivot loop carries the devex weights; the "
            "sequential sharded loop prices with Dantzig/Bland only, like "
            "solver.run_solve_loop)")
    if L > 1:
        out = solve_loop_blocked_sharded(tab, options, max_iter, costs0)
    else:
        out = solve_loop_sharded(tab, options, max_iter)

    if scale is not None:
        tab_out, status, iters = out
        tab_out = dataclasses.replace(tab_out,
                                      costs=tab_out.costs * scale,
                                      z=tab_out.z * scale)
        return tab_out, status, iters
    return out


def gaussian_eliminate_sharded(tab: Tableau) -> Tableau:
    """Objective-row elimination with sharded costs/T (reference
    updateObjectiveFunction, gaussian.cu:110-162): the basic-variable cost
    gather becomes one psum of an (M_pad,) coefficient vector, then the
    update is a local matvec per shard."""
    coeffs = _gather_basic_coeffs(tab.base, tab.costs, tab.r,
                                  _local_rows(tab))        # (M_pad,)
    delta = accum_matvec(tab.T, coeffs, 1, tab.costs.dtype)
    return dataclasses.replace(
        tab,
        costs=tab.costs - delta,
        z=tab.z - jnp.dot(tab.b, coeffs,
                          precision=jax.lax.Precision.HIGHEST),
    )


def _phase2_costs_local(tab: Tableau, c: jax.Array) -> jax.Array:
    """Local slice of the Phase-2 cost vector [-c | 0] (reference
    twoPhaseMethod.cu:296-325), built from the replicated c by global row
    index — rows >= n (slack + masked artificials) get 0."""
    gi = _global_row_offset(tab) + jnp.arange(_local_rows(tab))
    c_val = c[jnp.clip(gi, 0, tab.n - 1)].astype(tab.costs.dtype)
    return jnp.where(gi < tab.n, -c_val,
                     jnp.zeros((), tab.costs.dtype))


def extract_solution_replicated(tab: Tableau) -> jax.Array:
    """Solution scatter on replicated (base, b) — identical on every shard
    (reference getSolution, twoPhaseMethod.cu:116-128)."""
    idx = jnp.where(tab.base < tab.n, tab.base, tab.n)
    x_ext = jnp.zeros((tab.n + 1,), tab.b.dtype).at[idx].set(
        tab.b, mode="drop")
    return x_ext[:tab.n]


class ShardedSolveOutput(NamedTuple):
    status: jax.Array
    x: jax.Array
    objective: jax.Array
    iterations_phase1: jax.Array
    iterations_phase2: jax.Array
    n_artificial_in_base: jax.Array
    base: jax.Array          # (M_pad,) int32 final basis (replicated)


def pivot_out_artificials_sharded(tab: Tableau,
                                  options: SolverOptions) -> Tableau:
    """Sharded mirror of two_phase.pivot_out_artificials: one full pivot
    (or redundant-constraint drop) per basic artificial, with the entering
    row found by the same local-argmin + gather pattern as the solve loop
    and the pivot applied shard-locally."""
    eps = float(options.eps_resolved)
    n, m = tab.n, tab.m
    R_loc = _local_rows(tab)
    none = jnp.int32(tab.cols_padded)
    big = jnp.iinfo(jnp.int32).max
    # Sentinel for a dropped (redundant) constraint's base entry. Under
    # shard_map ``tab.rows_padded`` is the LOCAL row count R_loc, which for
    # R_loc < n aliases a real structural variable and silently corrupts
    # the solution scatter — the sentinel must be globally out of range:
    # >= tab.r (excluded from every validity mask ``base < tab.r``) and
    # >= n (dropped by the solution scatter). n + 2m is both.
    dropped_sentinel = jnp.int32(n + 2 * m)

    def first_artificial(t):
        is_art = (t.base >= (n + m)) & (t.base < n + 2 * m)
        k = jnp.argmax(is_art).astype(jnp.int32)
        return jnp.where(is_art.any(), k, none)

    def cond(carry):
        t, fixes = carry
        return (first_artificial(t) < none) & (fixes < m)

    def body(carry):
        t, fixes = carry
        k = first_artificial(t)
        colk = t.T[:, k]
        offset = _global_row_offset(t)
        gi = offset + jnp.arange(R_loc)
        cand = (gi < (n + m)) & (jnp.abs(colk) >= eps)
        lh = jnp.min(jnp.where(cand, gi, big))
        h = lax.pmin(lh, AXIS).astype(jnp.int32)
        has_pivot = h < big

        a_h = broadcast_entering_column(t, jnp.minimum(h, t.r - 1))
        minc = gather_cost_at(t, jnp.minimum(h, t.r - 1))
        pivoted = pivot_update_sharded(t, a_h, h, k, minc)
        dropped = dataclasses.replace(
            t, T=t.T.at[:, k].set(0.0), b=t.b.at[k].set(0.0),
            base=t.base.at[k].set(dropped_sentinel))
        t2 = jax.tree.map(
            lambda a, b: jnp.where(has_pivot, a, b), pivoted, dropped)
        return t2, fixes + 1

    out, _ = lax.while_loop(cond, body, (tab, jnp.zeros((), jnp.int32)))
    return out


def _two_phase_core(tab: Tableau, c: jax.Array, b_scale, inputs_finite,
                    options: SolverOptions,
                    max_iter: int,
                    with_binv: bool = False):
    """Both phases under one shard_map (mirror of
    two_phase.solve_device's device core, incl. the 'continue' degeneracy
    repair, the NUMERIC guards, and the recomputed ``c @ x`` objective —
    the sharded and single-chip cores must return identical statuses and
    objectives on the same pivot walk; tests/test_sharded.py pins it).

    ``inputs_finite`` is the pre-flight input scan (two_phase.solve_device
    computes it over A/b/c before the build); it is computed OUTSIDE the
    shard_map by the caller because A never enters the core."""
    eps = float(options.eps_resolved)
    n, m = tab.n, tab.m

    costs0_1 = tab.costs
    tab = gaussian_eliminate_sharded(tab)
    tab, status1, iters1 = run_solve_loop_sharded(tab, options, max_iter,
                                                  costs0_1)

    # Exact phase-1 objective from the basis (drift-immune; see
    # tableau.phase1_objective), with the b-scaled threshold of
    # two_phase.solve_device (b_scale from the ORIGINAL right-hand side,
    # passed in by the caller).
    in_range = (tab.base >= n + m) & (tab.base < n + 2 * m)
    z_phase1 = -jnp.sum(jnp.where(in_range, tab.b, 0.0))
    infeasible = z_phase1 <= -eps * b_scale
    n_art = jnp.sum(in_range.astype(jnp.int32))
    degenerate = n_art > 0

    if options.degeneracy == "continue":
        # Fuse-hit tableaus excluded (see two_phase.solve_device): the
        # phase-2 result is discarded for them and a capped phase 1 can
        # leave up to m basic artificials' worth of repair sweeps.
        tab = lax.cond(
            degenerate & ~infeasible
            & (status1 != int(Status.RUNNING)),
            lambda t: pivot_out_artificials_sharded(t, options),
            lambda t: t, tab)

    # Phase 2: keep the row allocation, mask artificials via r = n + m.
    tab2 = dataclasses.replace(
        tab, costs=_phase2_costs_local(tab, c), r=n + m)
    costs0_2 = tab2.costs
    tab2 = gaussian_eliminate_sharded(tab2)
    tab2, status2, iters2 = run_solve_loop_sharded(tab2, options, max_iter,
                                                   costs0_2)

    x = extract_solution_replicated(tab2)

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
    # NUMERIC guards, identical to two_phase.solve_device:175-181 — x, z,
    # z_phase1 and inputs_finite are all replicated, so the guard is
    # shard-local math with no collective.
    finite = jnp.isfinite(tab2.z) & jnp.isfinite(x).all()
    status = jnp.where(finite | phase1_failed, status,
                       int(Status.NUMERIC))
    status = jnp.where(jnp.isfinite(z_phase1), status,
                       int(Status.NUMERIC))
    status = jnp.where(inputs_finite, status, int(Status.NUMERIC))
    status = status.astype(jnp.int32)

    # Drift-immune recomputed objective (two_phase.solve_device:183-188):
    # c and x are replicated, so c @ x is shard-local.
    objective_opt = jnp.dot(c.astype(x.dtype), x,
                            precision=lax.Precision.HIGHEST)
    objective = jnp.where(phase1_failed, z_phase1,
                          jnp.where(status2 == int(Status.OPTIMAL),
                                    objective_opt, tab2.z))
    x = jnp.where(status == int(Status.OPTIMAL), x, jnp.zeros_like(x))
    iters2 = jnp.where(phase1_failed, 0, iters2)
    out = ShardedSolveOutput(status, x, objective,
                             iters1.astype(jnp.int32),
                             iters2.astype(jnp.int32), n_art, tab2.base)
    if not with_binv:
        return out
    # The final tableau's slack block, gathered to every shard: the
    # LU-free refinement preconditioner (B^{-1}[k, j] = T2[n+j, k] —
    # refine.refine_solution_tableau; without it the sharded wrapper's
    # refinement pays an O(m^3) f32 LU). Each
    # shard scatter-adds its owned slack rows into the replicated
    # (m, m) block; one psum completes it — once per SOLVE, not per
    # pivot.
    R_loc = _local_rows(tab2)
    gi = _global_row_offset(tab2) + jnp.arange(R_loc)
    sel = (gi >= n) & (gi < n + m)
    rows = jnp.where(sel[:, None], tab2.T[:, :m], 0.0)
    idx = jnp.where(sel, gi - n, m)
    local = jnp.zeros((m + 1, m), tab2.T.dtype).at[idx].add(
        rows, mode="drop")[:m]
    return out, lax.psum(local, AXIS)


def build_phase1_sharded(A, b, n: int, m: int, n_shards: int,
                         options: SolverOptions) -> Tableau:
    """Phase-1 tableau with rows padded for the shard count (global build;
    the caller's jit + sharding constraints lay it out across the mesh).
    Delegates to tableau.build_phase1 with the shard-divisible padding."""
    from ..tableau import build_phase1

    dims = sharded_padded_dims(n, m, n_shards, options)
    return build_phase1(A, b, n, m, options, dims=dims)


def make_sharded_solver(mesh: Mesh, n: int, m: int,
                        options: SolverOptions = DEFAULT_OPTIONS,
                        max_iter: int | None = None,
                        donate_a: bool = False,
                        with_binv: bool = False):
    """Build a jitted sharded two-phase solver for a fixed (n, m) over
    ``mesh`` (must have axis 'vars'). Returns ``fn(A, b, c) ->
    ShardedSolveOutput``; T/costs live row-sharded across the mesh for the
    entire solve, everything else replicated. ``donate_a`` donates A's
    buffer to the solve — at flagship sizes on a small mesh the caller's
    A (4 GB at 10k x 100k) plus both tableau orientations otherwise
    overlap in device memory; donation frees A
    after the phase-1 scatter (the caller must not reuse A afterwards)."""
    n_shards = mesh.shape[AXIS]
    resolved_max_iter = (max_iter if max_iter is not None
                         else options.resolved_max_iter(n + 2 * m, m))
    tab_specs = tableau_specs(n, m, n + 2 * m)

    out_specs = ShardedSolveOutput(
        P(), P(None), P(), P(), P(), P(), P(None))
    if with_binv:
        # ``with_binv``: the core additionally emits the replicated
        # (m, m) slack block (the refinement preconditioner).
        out_specs = (out_specs, P(None, None))
    core = jax.shard_map(
        partial(_two_phase_core, options=options,
                max_iter=resolved_max_iter, with_binv=with_binv),
        mesh=mesh,
        in_specs=(tab_specs, P(None), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )

    @partial(jax.jit, donate_argnums=(0,) if donate_a else ())
    def solve_fn(A, b, c):
        # Pre-flight NUMERIC scan (two_phase.solve_device:118-119) runs
        # here, before the build — A is not an input of the shard_map core.
        inputs_finite = (jnp.isfinite(A).all() & jnp.isfinite(b).all()
                         & jnp.isfinite(c).all())
        tab = build_phase1_sharded(A, b, n, m, n_shards, options)
        tab = jax.lax.with_sharding_constraint(
            tab, tableau_shardings(mesh, n, m, n + 2 * m))
        b_scale = 1.0 + jnp.max(jnp.abs(
            b.astype(jnp.dtype(options.vector_dtype))))
        return core(tab, c.astype(jnp.dtype(options.vector_dtype)),
                    b_scale, inputs_finite)

    return solve_fn


def solve_sharded(problem, mesh: Mesh,
                  options: SolverOptions = DEFAULT_OPTIONS):
    """Convenience host wrapper: solve one Problem on a mesh, returning a
    SolveResult like two_phase.solve."""
    from ..result import SolveResult

    from ..config import refine_enabled

    if options.needs_x64:
        jax.config.update("jax_enable_x64", True)
    m, n = problem.constraints, problem.vars
    want_binv = refine_enabled(options)
    fn = make_sharded_solver(mesh, n, m, options, with_binv=want_binv)
    res = fn(jnp.asarray(problem.A), jnp.asarray(problem.b),
             jnp.asarray(problem.c))
    out, binv = res if want_binv else (res, None)
    out = jax.device_get(out)
    status = Status(int(out.status))

    x = np.asarray(out.x) if status == Status.OPTIMAL else None
    objective = float(out.objective)
    refine_info = None
    if status == Status.OPTIMAL and refine_enabled(options):
        from ..two_phase import refine_result
        import dataclasses as _dc

        rx, robj, refine_info, _ro = refine_result(
            problem, out.base, options, raw_objective=objective,
            binv=binv)
        if rx is not None:
            x, objective = rx, robj
        else:
            from ..two_phase import fallback_solve

            result64 = fallback_solve(problem, options, base=out.base)
            info = (result64.refine or refine_info)._replace(
                fallback=True)
            return _dc.replace(result64, refine=info)

    return SolveResult(
        status=status,
        x=x,
        objective=objective,
        iterations_phase1=int(out.iterations_phase1),
        iterations_phase2=int(out.iterations_phase2),
        degenerate=bool(out.n_artificial_in_base > 0),
        refine=refine_info,
    )
