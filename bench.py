"""Benchmark: marginal time per pivot of the blocked hot loop.

Measures the production blocked loop (``solver.run_solve_loop`` with
exact window re-pricing; f32 tableau, f64 vectors, L=128) on the dense
north-star shape m=10k constraints x n=100k variables, under the
resolved default pricing rule and under Dantzig, on one GPU.

Marginal ms/pivot comes from a two-point cap difference,
``(t(K) - t(K/2)) / (pivots(K) - pivots(K/2))``, which cancels the
per-call fixed costs (the tableau transpose into the loop's layout,
dispatch). Beside it: the bytes one pivot moves, computed from shapes
(``bytes_per_pivot``), over a device copy bandwidth measured in the same
process — the loop's byte floor.

``--trace DIR`` additionally records a short window with
``jax.profiler`` and reduces it (``trace_summary``) to the device's busy
and idle share and its top operations.

Prints the card's name and power limit and ONE JSON line on stdout;
diagnostics go to stderr. Exits non-zero, printing no result, when JAX
finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_bench_state(n: int, m: int, options, stages: dict):
    """The eliminated phase-1 tableau of a seeded dense instance, built
    on the device (no host transfer), plus its pre-elimination costs.
    ``stages`` gains build_compile_s / build_exec_s."""
    import jax
    import jax.numpy as jnp

    from simplex_tpu.tableau import build_phase1, gaussian_eliminate

    key = jax.random.key(n * 100 + m)
    ka, kb = jax.random.split(key)
    A = jax.random.uniform(ka, (m, n), dtype=jnp.float32, minval=1.0,
                           maxval=100.0)
    b = jax.random.uniform(kb, (m,), dtype=jnp.float32, minval=1.0,
                           maxval=100.0)

    def prep(A, b):
        tab = build_phase1(A, b, n, m, options)
        return gaussian_eliminate(tab), tab.costs

    t0 = time.perf_counter()
    compiled = jax.jit(prep).lower(A, b).compile()
    stages["build_compile_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    tab, costs0 = jax.block_until_ready(compiled(A, b))
    stages["build_exec_s"] = round(time.perf_counter() - t0, 3)
    return tab, costs0


def measure_copy_gbs(x, repeats: int = 5) -> float:
    """Device copy bandwidth on a tableau-sized array: one read and one
    write of ``x`` per call, best of ``repeats``. Returns GB/s."""
    import jax

    nbytes = x.size * x.dtype.itemsize
    copy = jax.jit(lambda x: x * 1)
    jax.block_until_ready(copy(x))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(copy(x))
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes / best / 1e9


def bytes_per_pivot(r_pad: int, m_pad: int, L: int, itemsize: int,
                    vitemsize: int, repriced: bool = True) -> float:
    """Bytes the blocked loop (solver.solve_loop_blocked) must move per
    pivot, from shapes: the window apply reads and writes the
    (m_pad, r_pad) tableau once per L pivots and the re-pricing reads it
    once more; each pivot's eta corrections read all of C (L x r_pad)
    and F (L x m_pad), fetch one tableau row and one column, and
    read-modify-write the r_pad-long cost and devex vectors."""
    tableau = r_pad * m_pad * itemsize
    window = (3 if repriced else 2) * tableau / L
    eta = L * (r_pad + m_pad) * itemsize
    rows = 2 * (r_pad + m_pad) * itemsize
    vectors = 4 * r_pad * vitemsize + 3 * m_pad * vitemsize
    return window + eta + rows + vectors


def trace_summary(trace_dir: str, top: int = 12) -> dict:
    """Reduce a ``jax.profiler`` trace to the device's busy and idle
    share over the traced window and its top operations. Busy is the
    union of the intervals of every event on the device planes' stream
    lines; idle is 1 - busy over the span from the first event's start
    to the last event's end."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    intervals, per_op, lines = [], {}, {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(events)
            if "Stream" not in line.name:
                continue
            for e in events:
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
                n_t = per_op.setdefault(e.name, [0, 0.0])
                n_t[0] += 1
                n_t[1] += e.duration_ns
    if not intervals:
        return {"lines": lines, "busy_share": None, "idle_share": None,
                "top_ops": []}
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in intervals) - intervals[0][0]
    ops = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "lines": lines,
        "span_ms": span / 1e6,
        "busy_ms": busy / 1e6,
        "busy_share": busy / span,
        "idle_share": 1.0 - busy / span,
        "top_ops": [{"name": k[:120], "count": c, "total_ms": t / 1e6,
                     "share_of_busy": t / busy}
                    for k, (c, t) in ops],
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--vars", type=int, default=100_000)
    parser.add_argument("--constraints", type=int, default=10_000)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "float64"])
    parser.add_argument("--vector-dtype", default="float64",
                        choices=["float32", "float64"],
                        help="dtype of b/costs/z (mixed precision: f32 "
                             "tableau + f64 vectors is the production "
                             "mode)")
    parser.add_argument("--iters", type=int, default=512,
                        help="timed pivot iterations")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--block", type=int, default=128,
                        help="deferred block-pivot window L (0/1 = off)")
    parser.add_argument("--trace", metavar="DIR", default=None,
                        help="also trace a short window of the default "
                             "rule with jax.profiler into DIR and print "
                             "its busy/idle share and top operations")
    args = parser.parse_args(argv)

    import jax

    from simplex_tpu.device import NoGPUError, card_info, require_gpu

    try:
        device = require_gpu()
    except NoGPUError as e:
        log(f"bench.py: {e}")
        return 2
    card = card_info()
    print(f"card: {card}; jax {jax.__version__}; device {device}",
          flush=True)

    if "float64" in (args.dtype, args.vector_dtype):
        jax.config.update("jax_enable_x64", True)

    from simplex_tpu.config import SolverOptions
    from simplex_tpu.solver import run_solve_loop

    n, m, K = args.vars, args.constraints, args.iters
    options = SolverOptions(dtype=np.dtype(args.dtype),
                            vector_dtype=np.dtype(args.vector_dtype),
                            block_pivots=args.block or None)
    L = int(options.block_pivots or 1)

    log(f"building phase-1 tableau n={n} m={m} dtype={args.dtype} ...")
    stages = {}
    tab0, costs0 = build_bench_state(n, m, options, stages)
    R_pad, M_pad = tab0.T.shape
    itemsize = np.dtype(args.dtype).itemsize
    vitemsize = np.dtype(options.vector_dtype).itemsize
    log(f"tableau {R_pad} x {M_pad} = "
        f"{R_pad * M_pad * itemsize / 1e9:.2f} GB ({stages})")

    copy_gbs = measure_copy_gbs(tab0.T)
    log(f"copy bandwidth: {copy_gbs:.0f} GB/s")

    def make_run(cap, opts):
        @jax.jit
        def run(tab, costs0):
            # Scalars only: the production solve never returns the
            # tableau from its loop either.
            tab, status, iters = run_solve_loop(tab, opts, cap, costs0)
            return tab.z, status, iters
        return run

    K_lo = max(K // 2, 1)
    stages["loop_compile_s"] = 0.0

    def measure_marginal(opts, label):
        results = {}
        for cap in (K_lo, K):
            run = make_run(cap, opts)
            t0 = time.perf_counter()
            compiled = run.lower(tab0, costs0).compile()
            stages["loop_compile_s"] = round(
                stages["loop_compile_s"] + time.perf_counter() - t0, 3)
            out = jax.block_until_ready(compiled(tab0, costs0))
            iters_done = int(out[2])
            if iters_done < cap:
                log(f"WARNING: {label} loop ended after {iters_done} < "
                    f"{cap} pivots")
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                jax.block_until_ready(compiled(tab0, costs0))
                times.append(time.perf_counter() - t0)
            log(f"{label} cap={cap}: {iters_done} pivots, times "
                f"{[round(t, 4) for t in times]}")
            results[cap] = (min(times), iters_done, compiled)
        (t_lo, p_lo, _), (t_hi, p_hi, compiled) = results[K_lo], results[K]
        if p_hi == p_lo or t_hi <= t_lo:
            log("WARNING: marginal estimate unavailable "
                f"(pivots {p_lo}->{p_hi}, time {t_lo:.4f}->{t_hi:.4f}s); "
                "reporting the amortised average instead")
            return t_hi / max(p_hi, 1), compiled
        return (t_hi - t_lo) / (p_hi - p_lo), compiled

    per_iter_s, compiled_hi = measure_marginal(
        options, options.pivot_rule_resolved)
    dantzig_ms = None
    if options.pivot_rule_resolved != "dantzig":
        import dataclasses

        alt = dataclasses.replace(options, pivot_rule="dantzig")
        dantzig_ms = measure_marginal(alt, "dantzig")[0] * 1e3

    trace = None
    if args.trace:
        jax.profiler.start_trace(args.trace)
        jax.block_until_ready(compiled_hi(tab0, costs0))
        jax.profiler.stop_trace()
        trace = trace_summary(args.trace)
        log(f"trace: {json.dumps(trace)}")

    moved = (bytes_per_pivot(R_pad, M_pad, L, itemsize, vitemsize)
             if L > 1 else 2 * R_pad * M_pad * itemsize)
    floor_ms = moved / (copy_gbs * 1e9) * 1e3
    log(f"marginal: {per_iter_s * 1e3:.4f} ms/pivot; byte floor "
        f"{floor_ms:.4f} ms ({moved / 1e6:.1f} MB/pivot at "
        f"{copy_gbs:.0f} GB/s)")

    print(json.dumps({
        "metric": (f"marginal ms/pivot, blocked loop, dense LP m={m} "
                   f"n={n} {args.dtype} tableau, L={L}, "
                   f"{options.pivot_rule_resolved} pricing"),
        "value": per_iter_s * 1e3,
        "unit": "ms/pivot",
        "pivot_rule": options.pivot_rule_resolved,
        "dantzig_ms_per_pivot": dantzig_ms,
        "bytes_per_pivot": moved,
        "copy_gbs": copy_gbs,
        "floor_ms_per_pivot": floor_ms,
        "share_of_floor": floor_ms / (per_iter_s * 1e3),
        "trace": trace,
        "card": card,
        "device": device,
        **stages,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
