"""Device-side reinversion restart: rebuild the tableau for a drifted
basis on the device and continue the mixed loop.

The classic simplex "reinversion", done with matrix products. When
refinement detects that a long mixed walk drifted (dual certificates
fail — after >10-20k pivots the f32 tableau's accumulated rounding
steers the walk measurably off optimal, typically to a basis a few
dozen pivots from optimum), the recovery does not need a host or an
LU:

1. Sharpen the drifted slack block into an f32-exact basis inverse by
   Newton-Schulz iteration, ``M <- M (2I - B M)`` — pure m x m
   matrix products (all at Precision.HIGHEST); the block enters with ||I - BM|| ~ drift (1e-4..1e-1), so
   2-3 quadratically-convergent steps land at f32 round-off.
2. Rebuild the phase-2 tableau exactly for that basis: structural
   block ``(M A)^T``, slack block ``M^T``, right-hand side = the
   refinement's f64-exact basic values (clamped within the mixed
   envelope — micro-infeasibility is restored by the loop's own
   degenerate pivots and re-certified afterwards), fresh phase-2 costs
   through the standard Gaussian elimination. All flips cancel:
   B~^{-1} (D col) = B^{-1} col, so no sign bookkeeping.
3. Re-enter the production mixed loop (run_solve_loop — same kernels,
   same pricing) from this CLEAN tableau: the few finishing pivots
   accumulate negligible fresh drift, so the follow-up refinement
   certifies at 1e-9.

This replaces minutes of host warm finishing (LAPACK dgesv against
n+m right-hand sides) or a full f64 re-solve with a few m x m and
m x n matrix products. solve() drives up to two rounds before
handing to the host tiers (finish.py, then the chunked f64 re-solve).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .config import DEFAULT_OPTIONS, SolverOptions, Status
from .solver import run_solve_loop
from .tableau import Tableau, extract_solution, gaussian_eliminate, \
    padded_dims

#: Newton-Schulz sharpening steps (quadratic: drift 1e-1 -> f32 eps in 3).
NS_STEPS = 3


@partial(jax.jit, static_argnames=("n", "m", "options"))
def restart_device(A: jax.Array, b: jax.Array, c: jax.Array,
                   base: jax.Array, binv_t: jax.Array, xB: jax.Array,
                   n: int, m: int,
                   options: SolverOptions = DEFAULT_OPTIONS):
    """One reinversion-restart round (see module docstring).

    ``base`` (M_pad,) i32 and ``binv_t`` (m, m) f32 come from the
    previous solve round (solve_device_with_binv); ``xB`` (m,) f64 are
    the refinement's exact basic values. Returns
    ``(DeviceSolveOutput, binv2, ns_residual)`` — the same output
    contract as a phase-2-only solve, the new slack block for the next
    refinement, and max|I - B M| after sharpening (telemetry; large
    means the drifted block was beyond Newton-Schulz's basin and the
    result should not be trusted past its own refinement check).
    """
    from .two_phase import DeviceSolveOutput

    dtype = jnp.dtype(options.dtype)
    vdtype = jnp.dtype(options.vector_dtype)
    max_iter = options.resolved_max_iter(n + 2 * m, m)
    _, R2_pad, M_pad = padded_dims(n, m, options)

    A32 = A.astype(dtype)
    v = base[:m].astype(jnp.int32)
    struct = v < n
    slack = (v >= n) & (v < n + m)
    unit = jnp.where(slack, v - n, jnp.arange(m, dtype=jnp.int32))

    hi = jax.lax.Precision.HIGHEST

    # B (m, m) via one row gather; M0 from the drifted slack block
    # (B^{-1}[k, j] = T2[n+j, k] => M0 = binv_t^T).
    Bt = jnp.where(struct[:, None], A32.T[jnp.clip(v, 0, n - 1)],
                   jax.nn.one_hot(unit, m, dtype=dtype))
    B = Bt.T
    M = binv_t.T.astype(dtype)
    eye2 = 2.0 * jnp.eye(m, dtype=dtype)
    for _ in range(NS_STEPS):
        M = jnp.matmul(M, eye2 - jnp.matmul(B, M, precision=hi),
                       precision=hi)
    ns_res = jnp.max(jnp.abs(
        jnp.eye(m, dtype=dtype) - jnp.matmul(B, M, precision=hi)))

    # Rebuild the phase-2 tableau for this basis (flips cancel).
    TA = jnp.matmul(M, A32, precision=hi)              # (m, n)
    T = jnp.zeros((R2_pad, M_pad), dtype)
    T = T.at[:n, :m].set(TA.T)
    T = T.at[n:n + m, :m].set(M.T)

    b_scale = 1.0 + jnp.max(jnp.abs(b)).astype(vdtype)
    b_new = jnp.maximum(xB.astype(vdtype), 0.0)
    b_pad = jnp.zeros((M_pad,), vdtype).at[:m].set(b_new)
    base_pad = jnp.asarray(base, jnp.int32)

    costs0 = jnp.zeros((R2_pad,), vdtype).at[:n].set(-c.astype(vdtype))
    tab = Tableau(T=T, b=b_pad, costs=costs0, z=jnp.zeros((), vdtype),
                  base=base_pad, n=n, m=m, r=n + m)
    tab = gaussian_eliminate(tab)
    tab2, status2, iters2 = run_solve_loop(tab, options, max_iter, costs0)

    x = extract_solution(tab2)
    fuse2 = status2 == int(Status.RUNNING)
    status = jnp.where(fuse2, int(Status.MAXITER), status2)
    finite = jnp.isfinite(tab2.z) & jnp.isfinite(x).all()
    # Micro-infeasibility beyond the mixed envelope means the caller
    # handed us a junk basis — poison the status so the driver falls
    # through to the host tiers.
    bad_basis = jnp.min(xB) < -1e-4 * b_scale
    status = jnp.where(finite & ~bad_basis, status, int(Status.NUMERIC))
    status = status.astype(jnp.int32)

    objective = jnp.dot(c.astype(x.dtype), x, precision=hi)
    objective = jnp.where(status2 == int(Status.OPTIMAL), objective,
                          tab2.z)
    x = jnp.where(status == int(Status.OPTIMAL), x, jnp.zeros_like(x))

    out = DeviceSolveOutput(status, x, objective, jnp.int32(0),
                            iters2.astype(jnp.int32), jnp.int32(0),
                            tab2.base)
    return out, tab2.T[n:n + m, :m], ns_res
