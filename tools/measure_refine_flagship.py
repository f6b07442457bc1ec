"""Measure the f64 refinement stage at the flagship shape on one GPU.

What does certifying a mixed-precision flagship-class solve to f64 cost
on top of the solve itself? Data is generated ON DEVICE in f32 (the
refinement accumulates in f64 against the f32-representable problem
actually being solved). Reports, separately: mixed solve wall, the
tableau-preconditioned refine (compile and warm), and the resulting
certificates. The fused solve_device(+binv) program's peak device memory
at m=10k x n=100k is not measured on the H100 yet.

Run on the card (one process): python tools/measure_refine_flagship.py
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vars", type=int, default=100_000)
    ap.add_argument("--constraints", type=int, default=10_000)
    ap.add_argument("--block", type=int, default=128)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from simplex_tpu.config import SolverOptions, Status
    from simplex_tpu.refine import certificates_pass, refine_solution_tableau
    from simplex_tpu.two_phase import solve_device_with_binv

    n, m = args.vars, args.constraints
    options = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                            block_pivots=args.block)
    from simplex_tpu.device import card_info, require_gpu

    log(f"device: {require_gpu()}; card: {card_info()}; "
        f"rule={options.pivot_rule_resolved}")

    key = jax.random.key(n * 100 + m)
    ka, kb, kc = jax.random.split(key, 3)
    A = jax.random.uniform(ka, (m, n), jnp.float32, 1.0, 100.0)
    b = jax.random.uniform(kb, (m,), jnp.float32, 1.0, 100.0)
    c = jax.random.uniform(kc, (n,), jnp.float32, 1.0, 100.0)
    b64 = b.astype(jnp.float64)
    c64 = c.astype(jnp.float64)
    jax.block_until_ready((A, b64, c64))
    log(f"on-device instance {m} x {n} built")

    t0 = time.perf_counter()
    out, binv = jax.block_until_ready(
        solve_device_with_binv(A, b64, c64, n, m, options))
    status = int(out.status)
    p1, p2 = int(out.iterations_phase1), int(out.iterations_phase2)
    solve_s = time.perf_counter() - t0
    log(f"mixed solve: status={status} pivots={p1}+{p2} "
        f"wall={solve_s:.2f}s (includes compile)")
    assert status == int(Status.OPTIMAL), status

    raw_obj = float(out.objective)
    t0 = time.perf_counter()
    ro = jax.device_get(refine_solution_tableau(
        A, b64, c64, out.base, binv, n=n, m=m))
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ro = jax.device_get(refine_solution_tableau(
        A, b64, c64, out.base, binv, n=n, m=m))
    warm_s = time.perf_counter() - t0

    b_host = np.asarray(b64)
    c_host = np.asarray(c64)
    ok = certificates_pass(ro, b_host, c_host, 1e-6)
    b_scale = 1.0 + float(np.max(np.abs(b_host)))
    d_scale = 1.0 + float(np.max(np.abs(c_host))) + float(
        np.max(np.abs(np.asarray(ro.y))))
    strong = (float(ro.primal_residual) <= 1e-9 * b_scale
              and float(ro.dual_infeasibility) <= 1e-9 * d_scale
              and float(ro.primal_negativity) <= 1e-9 * b_scale
              and float(ro.artificial_mass) <= 1e-9 * b_scale)
    log(f"refine(tableau): cold={cold_s:.2f}s warm={warm_s:.2f}s "
        f"({warm_s / solve_s * 100:.1f}% of the solve wall)")
    log(f"certificates: pass@1e-6={ok} pass@1e-9={strong} "
        f"primal_res={float(ro.primal_residual):.2e} "
        f"dual_inf={float(ro.dual_infeasibility):.2e} "
        f"neg={float(ro.primal_negativity):.2e} "
        f"art={float(ro.artificial_mass):.2e}")
    log(f"objective: raw={raw_obj:.9f} refined={float(ro.objective):.9f} "
        f"shift={float(ro.objective) - raw_obj:+.2e}")

    if not ok:
        # The production fallback tier: warm-start f64 finishing on the
        # host from the drifted basis (finish.py) — measure it at this
        # scale (device->host A transfer + BLAS-3 warm build + oracle
        # finishing pivots).
        from simplex_tpu.finish import finish_from_basis
        from simplex_tpu.problem import Problem

        t0 = time.perf_counter()
        problem = Problem(A=np.asarray(A), b=b_host, c=c_host)
        xfer_s = time.perf_counter() - t0
        base_host = np.asarray(out.base)
        t0 = time.perf_counter()
        fin = finish_from_basis(problem, base_host, options)
        fin_s = time.perf_counter() - t0
        if fin is None:
            log(f"warm finish: not applicable (transfer {xfer_s:.1f}s)")
        else:
            gap = fin.objective - float(ro.objective)
            log(f"warm finish: {fin.status.name} in "
                f"{fin.iterations_phase2} finishing pivots, "
                f"{fin_s:.1f}s (+{xfer_s:.1f}s A device->host); "
                f"objective {fin.objective:.9f} "
                f"(drifted basis was {gap:+.2e} below optimum)")
    print("REFINE_FLAGSHIP_OK", warm_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
