"""Batched scenario solving: many independent LPs per call.

North-star extension with no reference counterpart — the reference
solves one LP per process run (main.cu:82-111).

The whole jitted two-phase core (two_phase.solve_device) is
``jax.vmap``-ed over a leading batch axis; statuses are loop-carried
data, so lanes that finish early simply stop changing state while the
shared ``lax.while_loop`` runs until every lane is done (the pivot body
is idempotent on finished tableaus).

For multi-device scenario fleets, ``solve_batched`` accepts a mesh and
shards the batch axis across it under ``jax.shard_map``: each device
runs the vmapped core on its own lanes, with no collectives (no value
crosses LPs), and devices finish independently.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .config import DEFAULT_OPTIONS, SolverOptions, Status, refine_enabled
from .result import SolveResult
from .two_phase import DeviceSolveOutput, solve_device


@partial(jax.jit, static_argnames=("n", "m", "options"))
def solve_device_batched(A: jax.Array, b: jax.Array, c: jax.Array,
                         n: int, m: int,
                         options: SolverOptions = DEFAULT_OPTIONS
                         ) -> DeviceSolveOutput:
    """Batched two-phase solve: ``A (B, m, n)``, ``b (B, m)``, ``c (B, n)``
    -> DeviceSolveOutput with a leading batch axis on every field."""
    fn = partial(solve_device, n=n, m=m, options=options)
    return jax.vmap(fn)(A, b, c)


@functools.lru_cache(maxsize=32)
def _fleet_solver(n: int, m: int, mesh: Mesh, options: SolverOptions):
    """Cached jitted shard_map wrapper — jax.jit caches on function
    identity, so building a fresh wrapper per call would retrace and
    recompile the full two-phase program every invocation (Mesh and
    SolverOptions are both hashable)."""
    spec = P(mesh.axis_names[0])
    out_specs = DeviceSolveOutput(*([spec] * len(DeviceSolveOutput._fields)))
    return jax.jit(jax.shard_map(
        partial(solve_device_batched, n=n, m=m, options=options),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=out_specs,
        check_vma=False))


def solve_device_batched_sharded(A: jax.Array, b: jax.Array, c: jax.Array,
                                 n: int, m: int, mesh: Mesh,
                                 options: SolverOptions = DEFAULT_OPTIONS
                                 ) -> DeviceSolveOutput:
    """Multi-device batched fleet: the batch axis sharded across
    ``mesh`` (first axis), each device running ``solve_device_batched``
    on its local lanes under ``jax.shard_map`` with zero collectives."""
    return _fleet_solver(n, m, mesh, options)(A, b, c)


def solve_batched(problems, options: SolverOptions | None = None,
                  mesh: Mesh | None = None,
                  **replacements) -> list[SolveResult]:
    """Solve a homogeneous batch of Problems in one device call.

    All problems must share (vars, constraints). With ``mesh`` (first axis
    used), the batch axis is sharded across its devices (the batch size
    must then divide evenly; solve_device_batched_sharded).
    """
    options = options or DEFAULT_OPTIONS
    if replacements:
        options = dataclasses.replace(options, **replacements)
    if options.needs_x64:
        jax.config.update("jax_enable_x64", True)

    if not problems:
        return []
    n, m = problems[0].vars, problems[0].constraints
    for p in problems:
        if (p.vars, p.constraints) != (n, m):
            raise ValueError(
                f"batch must be homogeneous: got {(p.vars, p.constraints)} "
                f"vs {(n, m)}")

    # Cast A to the tableau dtype ON HOST: build_phase1 converts anyway,
    # and shipping f64 for an f32 solve doubles the host->device
    # transfer.
    A = jnp.asarray(np.stack([p.A for p in problems]).astype(
        options.dtype, copy=False))
    b = jnp.asarray(np.stack([p.b for p in problems]))
    c = jnp.asarray(np.stack([p.c for p in problems]))

    if mesh is not None:
        axis = mesh.axis_names[0]
        if len(problems) % mesh.shape[axis]:
            raise ValueError(
                f"batch size {len(problems)} must divide across "
                f"{mesh.shape[axis]} devices")
        sharding = NamedSharding(mesh, P(axis))
        A, b, c = (jax.device_put(x, sharding) for x in (A, b, c))
        out = jax.device_get(solve_device_batched_sharded(
            A, b, c, n, m, mesh, options))
    else:
        out = jax.device_get(solve_device_batched(A, b, c, n, m, options))

    refine = refine_enabled(options)
    results = []
    for i in range(len(problems)):
        status = Status(int(out.status[i]))
        result = SolveResult(
            status=status,
            x=np.asarray(out.x[i]) if status == Status.OPTIMAL else None,
            objective=float(out.objective[i]),
            iterations_phase1=int(out.iterations_phase1[i]),
            iterations_phase2=int(out.iterations_phase2[i]),
            degenerate=bool(out.n_artificial_in_base[i] > 0),
        )
        if refine and status == Status.OPTIMAL:
            result = _refine_lane(problems[i], out.base[i], options, result)
        results.append(result)
    return results


def _refine_lane(problem, base, options: SolverOptions,
                 result: SolveResult) -> SolveResult:
    """f64 basis refinement for one OPTIMAL batch lane, on the HOST
    (LAPACK f64 against the lane's original problem data — the device
    copy of A was downcast to the tableau dtype for the transfer, see
    solve_batched). Certificate failure falls back to an
    f64 finishing solve of just that lane."""
    from .refine import RefineInfo, certificates_pass, refine_solution_host
    from .two_phase import fallback_solve

    tol = float(options.refine_tol)
    ro = refine_solution_host(problem.A, problem.b, problem.c,
                              np.asarray(base), problem.vars,
                              problem.constraints)
    ok = ro is not None and certificates_pass(ro, problem.b, problem.c, tol)
    if ok:
        info = RefineInfo(True, float(ro.primal_residual),
                          float(ro.primal_negativity),
                          float(ro.artificial_mass),
                          float(ro.dual_infeasibility), tol,
                          objective_shift=(float(ro.objective)
                                           - result.objective))
        return dataclasses.replace(result, x=np.asarray(ro.x),
                                   objective=float(ro.objective),
                                   refine=info)
    info = RefineInfo(False,
                      float(ro.primal_residual) if ro else float("inf"),
                      float(ro.primal_negativity) if ro else float("inf"),
                      float(ro.artificial_mass) if ro else float("inf"),
                      float(ro.dual_infeasibility) if ro else float("inf"),
                      tol, fallback=True)
    result64 = fallback_solve(problem, options, base=np.asarray(base))
    # Prefer the fallback's own certified RefineInfo when it has one.
    info = (result64.refine or info)._replace(fallback=True)
    return dataclasses.replace(result64, refine=info)
