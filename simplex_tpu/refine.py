"""f64 basis-system refinement at solution extraction.

Closes the accuracy gap between the mixed-precision production mode
(f32 tableau + f64 vectors, ~1e-4-class certified envelope) and the
reference, which runs ``TYPE double`` end-to-end (reference:
include/macro.h:6) and therefore reports f64-class optima from its
solution extraction (``getSolutionHost``, twoPhaseMethod.cu:370-383).

The idea: after any solve, the *basis* — which variables are basic in
which constraint — is discrete data that low-precision arithmetic gets
right long after the tableau's floating-point content has drifted. So
at extraction time this module rebuilds the basis system from the
ORIGINAL f64 problem data and re-solves it to f64 accuracy:

1. Gather the basis matrix ``B`` (m x m, f64): column k is A[:, v] for
   a basic structural variable v, the unit vector e_{v-n} for a basic
   slack, and e_k for a basic artificial / dropped redundant row (whose
   basic value must be ~0 — certified below).
2. LU-factorize ``B`` in float32 and run classic mixed-precision
   iterative refinement: the residual ``b - B @ x`` is computed in f64
   (one m x m matvec per sweep), the correction solve reuses the f32 LU. Each sweep contracts
   the error by ~cond(B) * 2^-24, so a handful of sweeps reach f64
   round-off for any basis the f32 solve could have navigated.
3. Same for the dual system ``B^T y = c_B`` (the f32 LU serves both via
   the transposed triangular solves), then the full f64 reduced-cost
   vector ``d = [A^T y - c ; y]`` over all n+m columns.
4. Emit certificates: the f64 primal residual, basic-value negativity,
   artificial mass, and dual infeasibility over nonbasic columns. When
   they pass (the overwhelmingly common case — the mixed solve's final
   basis is the true optimal basis), the refined objective ``c @ x`` is
   an f64-class optimum at mixed-mode speed; when they fail, the caller
   falls back to finishing the solve in f64 (two_phase.solve).

Everything is pure JAX and shape-static: it jits once per (n, m) and
vmaps (jax.scipy LU batches natively). No solver internals are needed
— only the final ``base`` vector, which every device core returns.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class RefineOutput(NamedTuple):
    """Refined solution + f64 certificates (all jax arrays).

    Scales: ``primal_residual`` is absolute against |b|-scale,
    ``dual_infeasibility`` against (1 + max|c|, 1 + max|y|)-scale; the
    caller normalizes (see ``certified``).
    """

    x: jax.Array                  # (n,) refined solution, f64
    objective: jax.Array          # scalar c @ x, f64
    primal_residual: jax.Array    # max |B x_B - b| after refinement
    primal_negativity: jax.Array  # max(0, -min x_B) over basic values
    artificial_mass: jax.Array    # max |x_B| over artificial/dropped slots
    dual_infeasibility: jax.Array # max(0, -min d) over NONBASIC columns
    y: jax.Array                  # (m,) refined dual vector, f64
    xB: jax.Array                 # (m,) refined basic values, f64


@partial(jax.jit, static_argnames=("n", "m", "iters"))
def refine_solution(A: jax.Array, b: jax.Array, c: jax.Array,
                    base: jax.Array, n: int, m: int,
                    iters: int = 3) -> RefineOutput:
    """Refine the basic solution identified by ``base`` against the f64
    problem data (see module docstring). ``A`` (m, n), ``b`` (m,),
    ``c`` (n,) are the ORIGINAL problem arrays (any float dtype; cast
    to f64 here), ``base`` the final tableau's basis vector (>= m
    entries; entry k is the variable index basic in constraint k, using
    the tableau convention: [0, n) structural, [n, n+m) slack,
    [n+m, n+2m) artificial, anything else = dropped redundant row).

    No sign-flip bookkeeping is needed even though the tableau works on
    the b<0-flipped system (tableau.build_phase1): variable VALUES are
    invariant under row scaling, so the unflipped system B x_B = b has
    the same solution; artificial columns (whose unflipped sign would
    differ) are required to carry ~0 mass by the ``artificial_mass``
    certificate, so their sign convention cannot matter.
    """
    f64 = jnp.float64
    A = A.astype(f64)
    b = b.astype(f64)
    c = c.astype(f64)
    v = base[:m].astype(jnp.int32)

    struct = v < n
    slack = (v >= n) & (v < n + m)
    aux = ~(struct | slack)                    # artificial or dropped
    k_iota = jnp.arange(m, dtype=jnp.int32)
    unit = jnp.where(slack, v - n, k_iota)     # e-row for non-structural

    # B as rows-of-columns: Bt[k] = column k of B. One gather from A.T
    # (the only touch of the big array besides the two matvecs below).
    Bt = jnp.where(
        struct[:, None],
        A.T[jnp.clip(v, 0, n - 1)],
        jax.nn.one_hot(unit, m, dtype=f64))
    B = Bt.T

    lu, piv = jax.scipy.linalg.lu_factor(B.astype(jnp.float32))

    def correct(r, trans):
        return jax.scipy.linalg.lu_solve(
            (lu, piv), r.astype(jnp.float32), trans=trans).astype(f64)

    def matmul64(M, w):
        return jnp.dot(M, w, precision=jax.lax.Precision.HIGHEST)

    # Primal: B x_B = b, refined to f64 round-off.
    x_B = correct(b, 0)
    for _ in range(iters):
        x_B = x_B + correct(b - matmul64(B, x_B), 0)
    primal_residual = jnp.max(jnp.abs(b - matmul64(B, x_B)))

    # Dual: B^T y = c_B (same LU, transposed solves).
    c_B = jnp.where(struct, c[jnp.clip(v, 0, n - 1)], 0.0)
    y = correct(c_B, 1)
    for _ in range(iters):
        y = y + correct(c_B - matmul64(B.T, y), 1)

    # Full f64 reduced costs d = [A^T y - c ; y]; optimality of the max
    # problem is d >= 0 over nonbasic columns (slack reduced cost IS the
    # dual value). Basic columns are ~0 by construction and masked out.
    d_struct = matmul64(A.T, y) - c
    nonbasic_struct = jnp.ones((n + 1,), bool).at[
        jnp.where(struct, v, n)].set(False, mode="drop")[:n]
    nonbasic_slack = jnp.ones((m + 1,), bool).at[
        jnp.where(slack, v - n, m)].set(False, mode="drop")[:m]
    d_min = jnp.minimum(
        jnp.min(jnp.where(nonbasic_struct, d_struct, jnp.inf)),
        jnp.min(jnp.where(nonbasic_slack, y, jnp.inf)))
    dual_infeasibility = jnp.maximum(0.0, -d_min)

    # Solution scatter + certificates.
    idx = jnp.where(struct, v, n)
    x = jnp.zeros((n + 1,), f64).at[idx].set(
        jnp.where(struct, x_B, 0.0), mode="drop")[:n]
    objective = jnp.dot(c, x, precision=jax.lax.Precision.HIGHEST)
    primal_negativity = jnp.maximum(0.0, -jnp.min(x_B))
    artificial_mass = jnp.max(jnp.where(aux, jnp.abs(x_B), 0.0))

    return RefineOutput(x, objective, primal_residual, primal_negativity,
                        artificial_mass, dual_infeasibility, y, x_B)


@partial(jax.jit, static_argnames=("n", "m", "iters"))
def refine_solution_tableau(A: jax.Array, b: jax.Array, c: jax.Array,
                            base: jax.Array, binv_t: jax.Array,
                            n: int, m: int,
                            iters: int = 8) -> RefineOutput:
    """LU-free refinement: precondition the iterative refinement with
    the final tableau's slack block instead of factorizing B.

    ``binv_t`` is T2[n:n+m, :m] from the solve's own final tableau
    (two_phase.solve_device_with_binv): in exact arithmetic
    B^{-1}[k, j] = T2[n+j, k] — the b<0 flip signs cancel — so the
    block IS the basis inverse up to the f32 drift the solve
    accumulated. One IR sweep then contracts the error by
    ~||I - M B|| ~ drift * cond(B): a handful of sweeps reach f64
    round-off at a few matvecs each (2mn for the A products, m^2 for
    the preconditioner folds), where the LU path pays O(m^3).

    The caller certifies the result exactly like the LU path's and
    RETRIES with ``refine_solution`` when certificates fail (e.g. a
    redundant-row drop zeroed a slack column, so the block is singular
    along that direction and the IR stalls there).
    """
    from .tableau import accum_matvec

    f64 = jnp.float64
    # A stays in ITS OWN dtype: at flagship scale the f64 cast is an
    # 8 GB materialization next to the tableau. An f32 A is the exact
    # problem the solve saw — its matvecs accumulate in f64
    # (accum_matvec), certifying against the f32-representable
    # instance.
    b = b.astype(f64)
    c = c.astype(f64)
    Mt = binv_t.astype(f64)                     # Mt[j, k] = B^{-1}[k, j]
    v = base[:m].astype(jnp.int32)

    struct = v < n
    slack = (v >= n) & (v < n + m)
    aux = ~(struct | slack)
    k_iota = jnp.arange(m, dtype=jnp.int32)
    unit = jnp.where(slack, v - n, k_iota)
    sv = jnp.where(struct, v, n)                # struct scatter index

    def matmul64(M, w):
        return jnp.dot(M, w, precision=jax.lax.Precision.HIGHEST)

    def A_dot(vec):                              # A @ vec, f64 out
        return accum_matvec(A, vec, 1, f64)

    def At_dot(vec):                             # A^T @ vec, f64 out
        return accum_matvec(A, vec, 0, f64)

    def apply_B(xB):
        # B @ xB columnwise: structural columns through one A matvec on
        # the scattered x, slack/aux through unit-row scatters.
        x_full = jnp.zeros((n + 1,), f64).at[sv].add(
            jnp.where(struct, xB, 0.0), mode="drop")[:n]
        s_full = jnp.zeros((m + 1,), f64).at[
            jnp.where(struct, m, unit)].add(
            jnp.where(struct, 0.0, xB), mode="drop")[:m]
        return A_dot(x_full) + s_full

    def apply_Bt(y):
        # (B^T y)_k = column_k . y
        w = At_dot(y)
        return jnp.where(struct, w[jnp.clip(v, 0, n - 1)], y[unit])

    # Primal: x_B = B^{-1} b via preconditioned IR from zero.
    xB = jnp.zeros((m,), f64)
    for _ in range(iters):
        xB = xB + matmul64(b - apply_B(xB), Mt)     # r @ Mt = Mt^T r
    primal_residual = jnp.max(jnp.abs(b - apply_B(xB)))

    # Dual: y = B^{-T} c_B, preconditioned by Mt on the left.
    c_B = jnp.where(struct, c[jnp.clip(v, 0, n - 1)], 0.0)
    y = jnp.zeros((m,), f64)
    for _ in range(iters):
        y = y + matmul64(Mt, c_B - apply_Bt(y))

    d_struct = At_dot(y) - c
    nonbasic_struct = jnp.ones((n + 1,), bool).at[sv].set(
        False, mode="drop")[:n]
    nonbasic_slack = jnp.ones((m + 1,), bool).at[
        jnp.where(slack, v - n, m)].set(False, mode="drop")[:m]
    d_min = jnp.minimum(
        jnp.min(jnp.where(nonbasic_struct, d_struct, jnp.inf)),
        jnp.min(jnp.where(nonbasic_slack, y, jnp.inf)))
    dual_infeasibility = jnp.maximum(0.0, -d_min)

    x = jnp.zeros((n + 1,), f64).at[sv].set(
        jnp.where(struct, xB, 0.0), mode="drop")[:n]
    objective = jnp.dot(c, x, precision=jax.lax.Precision.HIGHEST)
    primal_negativity = jnp.maximum(0.0, -jnp.min(xB))
    artificial_mass = jnp.max(jnp.where(aux, jnp.abs(xB), 0.0))

    return RefineOutput(x, objective, primal_residual, primal_negativity,
                        artificial_mass, dual_infeasibility, y, xB)


def refine_solution_tableau_host(A, b, c, base, binv_t, n: int, m: int,
                                 iters: int = 8) -> RefineOutput:
    """NumPy mirror of ``refine_solution_tableau`` for host callers
    (finish.py certifies its warm-finished basis with the warm
    tableau's own slack block — f64-quality, so a couple of IR sweeps
    reach round-off; no LU, no device transfers)."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    Mt = np.asarray(binv_t, np.float64)
    v = np.asarray(base, np.int64)[:m]

    struct = v < n
    slack = (v >= n) & (v < n + m)
    aux = ~(struct | slack)
    unit = np.where(slack, v - n, np.arange(m))

    def apply_B(xB):
        x_full = np.zeros(n)
        np.add.at(x_full, v[struct], xB[struct])
        s_full = np.zeros(m)
        np.add.at(s_full, unit[~struct], xB[~struct])
        return A @ x_full + s_full

    def apply_Bt(y):
        w = A.T @ y
        return np.where(struct, w[np.clip(v, 0, n - 1)], y[unit])

    xB = np.zeros(m)
    for _ in range(iters):
        xB = xB + (b - apply_B(xB)) @ Mt
    primal_residual = float(np.max(np.abs(b - apply_B(xB)))) if m else 0.0

    c_B = np.where(struct, c[np.clip(v, 0, n - 1)], 0.0)
    y = np.zeros(m)
    for _ in range(iters):
        y = y + Mt @ (c_B - apply_Bt(y))

    d_struct = A.T @ y - c
    nonbasic_struct = np.ones(n, bool)
    nonbasic_struct[v[struct]] = False
    nonbasic_slack = np.ones(m, bool)
    nonbasic_slack[unit[slack]] = False
    cands = np.concatenate([d_struct[nonbasic_struct], y[nonbasic_slack]])
    d_min = float(cands.min()) if cands.size else 0.0

    x = np.zeros(n)
    x[v[struct]] = xB[struct]
    return RefineOutput(
        x=x,
        objective=float(c @ x),
        primal_residual=primal_residual,
        primal_negativity=float(max(0.0, -xB.min())) if m else 0.0,
        artificial_mass=float(np.max(np.abs(xB[aux]), initial=0.0)),
        dual_infeasibility=max(0.0, -d_min),
        y=y, xB=xB)


def refine_solution_host(A, b, c, base, n: int, m: int) -> RefineOutput | None:
    """Host (NumPy/LAPACK) mirror of ``refine_solution`` in straight
    f64 — no mixed-precision IR needed since LAPACK factorizes in f64
    directly. Used by the batched wrapper, whose device copy of A is
    already downcast to the tableau dtype (batch.solve_batched ships
    f32 over the host->device link on purpose); the
    original f64 problem data lives on the host anyway. Returns None
    for a singular/non-finite basis system (certificates could never
    pass — the caller falls back to the f64 finishing solve)."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    v = np.asarray(base[:m], np.int64)

    struct = v < n
    slack = (v >= n) & (v < n + m)
    aux = ~(struct | slack)
    unit = np.where(slack, v - n, np.arange(m))
    Bt = np.eye(m)[unit]
    Bt[struct] = A.T[v[struct]]
    B = Bt.T

    c_B = np.where(struct, c[np.clip(v, 0, n - 1)], 0.0)
    try:
        x_B = np.linalg.solve(B, b)
        y = np.linalg.solve(B.T, c_B)
    except np.linalg.LinAlgError:
        return None
    if not (np.isfinite(x_B).all() and np.isfinite(y).all()):
        return None

    primal_residual = float(np.max(np.abs(b - B @ x_B))) if m else 0.0
    d_struct = A.T @ y - c
    nonbasic_struct = np.ones(n, bool)
    nonbasic_struct[v[struct]] = False
    nonbasic_slack = np.ones(m, bool)
    nonbasic_slack[unit[slack]] = False
    cands = np.concatenate([d_struct[nonbasic_struct], y[nonbasic_slack]])
    d_min = float(cands.min()) if cands.size else 0.0

    x = np.zeros(n)
    x[v[struct]] = x_B[struct]
    return RefineOutput(
        x=x,
        objective=float(c @ x),
        primal_residual=primal_residual,
        primal_negativity=float(max(0.0, -x_B.min())) if m else 0.0,
        artificial_mass=float(np.max(np.abs(x_B[aux]), initial=0.0)),
        dual_infeasibility=max(0.0, -d_min),
        y=y, xB=x_B)


class RefineInfo(NamedTuple):
    """Host-side refinement record attached to SolveResult."""

    certified: bool               # certificates passed at ``tol``
    primal_residual: float
    primal_negativity: float
    artificial_mass: float
    dual_infeasibility: float
    tol: float
    fallback: bool = False        # f64 finishing solve was used
    #: Which refinement produced the certified values: "tableau" (the
    #: LU-free slack-block preconditioner) or "lu" (f32 LU + IR).
    method: str = "lu"
    #: refined - raw objective: how much in-loop drift the refinement
    #: erased (telemetry, not a certificate).
    objective_shift: float = 0.0
    #: Wall seconds of the refinement stage (device solve + transfers +
    #: certification; first call per shape includes its compile).
    wall_s: float = 0.0


def certificates_pass(out: RefineOutput, b, c, tol: float) -> bool:
    """Scale-relative certification of one refined solution: the primal
    residual against the right-hand-side scale, negativity/artificial
    mass against the basic-value scale, dual infeasibility against the
    cost/dual scale. ``tol`` is SolverOptions.refine_tol."""
    b_scale = 1.0 + float(np.max(np.abs(b))) if np.size(b) else 1.0
    c_scale = 1.0 + float(np.max(np.abs(c))) if np.size(c) else 1.0
    d_scale = c_scale + float(np.max(np.abs(np.asarray(out.y))))
    return (float(out.primal_residual) <= tol * b_scale
            and float(out.primal_negativity) <= tol * b_scale
            and float(out.artificial_mass) <= tol * b_scale
            and float(out.dual_infeasibility) <= tol * d_scale)
