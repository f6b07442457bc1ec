"""Microbenchmark the blocked solve loop's per-pivot pieces on one GPU.

Times each component of solve_loop_blocked's inner pivot at the flagship
shape (m=10k x n=100k, f32 tableau + f64 vectors, L=128) in its own
jitted fori_loop, so the marginal ms/pivot (bench.py) can be attributed:
corr_vec over C (the O(LR) read), corr_vec over F, the strided live-row
fetch, the f64 vector updates, the argmins, the eta appends, and the
amortised window apply. Diagnostics to stderr, one summary line per
component.

Run on the card (one process): python tools/profile_blocked.py
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vars", type=int, default=100_000)
    ap.add_argument("--constraints", type=int, default=10_000)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--iters", type=int, default=512)
    ap.add_argument("--vector-dtype", default="float64")
    args = ap.parse_args()

    import jax

    if args.vector_dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax import lax

    from simplex_tpu.config import SolverOptions
    from simplex_tpu.device import card_info, require_gpu
    from simplex_tpu.tableau import round_up

    log(f"device: {require_gpu()}; card: {card_info()}")

    n, m, L, K = args.vars, args.constraints, args.block, args.iters
    opt = SolverOptions(dtype=np.float32,
                        vector_dtype=np.dtype(args.vector_dtype))
    r_pad = round_up(n + 2 * m, opt.sublane_pad)
    m_pad = round_up(m, opt.lane_pad)
    dtype = jnp.float32
    vdtype = jnp.dtype(opt.vector_dtype)
    log(f"shape: Tt ({m_pad}, {r_pad}) f32, L={L}, K={K}")

    key = jax.random.key(0)
    ks = jax.random.split(key, 6)
    Tt = jax.random.uniform(ks[0], (m_pad, r_pad), dtype, 0.1, 1.0)
    C = jax.random.uniform(ks[1], (L, r_pad), dtype, 0.1, 1.0)
    F = jax.random.uniform(ks[2], (L, m_pad), dtype, 0.1, 1.0)
    costs = jax.random.uniform(ks[3], (r_pad,), vdtype, -1.0, 1.0)
    b = jax.random.uniform(ks[4], (m_pad,), vdtype, 0.1, 1.0)

    def timeit(name, fn, *arrs):
        jfn = jax.jit(fn)
        jax.block_until_ready(jfn(*arrs))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(jfn(*arrs))
            times.append(time.perf_counter() - t0)
        best = min(times) / K * 1e6
        log(f"{name:34s} {best:9.1f} us/iter")
        return best

    prec = lax.Precision.HIGHEST

    # Each piece in a K-iteration fori_loop with a data dependency so XLA
    # cannot hoist it. h/k rotate to defeat any per-index caching.
    def dep_idx(acc, i, bound):
        return ((i * 7919) ^ jnp.int32(acc % 997)) % bound

    def corr_C(C, F):
        def body(i, acc):
            k = dep_idx(acc, i, m_pad)
            v = jnp.dot(F[:, k].astype(dtype), C, precision=prec)
            return acc + v[i % r_pad].astype(jnp.float32)
        return lax.fori_loop(0, K, body, jnp.float32(0))

    def corr_F(C, F):
        def body(i, acc):
            h = dep_idx(acc, i, r_pad)
            v = jnp.dot(C[:, h], F, precision=prec)
            return acc + v[i % m_pad].astype(jnp.float32)
        return lax.fori_loop(0, K, body, jnp.float32(0))

    def row_fetch(Tt):
        def body(i, acc):
            k = dep_idx(acc, i, m_pad)
            return acc + Tt[k, :].sum()
        return lax.fori_loop(0, K, body, jnp.float32(0))

    def col_fetch(Tt):
        def body(i, acc):
            h = dep_idx(acc, i, r_pad)
            return acc + Tt[:, h].sum()
        return lax.fori_loop(0, K, body, jnp.float32(0))

    def costs_update(costs, C):
        def body(i, carry):
            costs, acc = carry
            k = dep_idx(acc, i, m_pad)
            colk = C[i % L, :].astype(vdtype)
            costs = costs - (0.5 + acc.astype(vdtype) * 1e-9) * colk
            return costs, acc + costs[k].astype(jnp.float32)
        return lax.fori_loop(0, K, body, (costs, jnp.float32(0)))

    def argmin_costs(costs):
        def body(i, carry):
            costs, acc = carry
            h = jnp.argmin(costs).astype(jnp.int32)
            return costs.at[h].set(costs[h] + 1e-6), acc + h
        return lax.fori_loop(0, K, body, (costs, jnp.int32(0)))

    def ratio(b, F):
        def body(i, acc):
            a = F[i % L, :].astype(vdtype)
            mask = a >= 1e-9
            r = jnp.where(mask, b / jnp.where(mask, a, 1.0), jnp.inf)
            return acc + jnp.argmin(r).astype(jnp.int32)
        return lax.fori_loop(0, K, body, jnp.int32(0))

    def eta_append(C, F):
        def body(i, carry):
            C, F, acc = carry
            t = i % L
            rowC = C[(i + 1) % L, :] * 1.0001
            rowF = F[(i + 1) % L, :] * 1.0001
            C = C.at[t, :].set(rowC)
            F = F.at[t, :].set(rowF)
            return C, F, acc + C[t, 0]
        return lax.fori_loop(0, K, body, (C, F, jnp.float32(0)))

    def window_apply(Tt, C, F):
        from simplex_tpu.solver import apply_window_T
        n_windows = max(K // L, 1)

        def body(i, carry):
            Tt, acc = carry
            Tt = apply_window_T(Tt, C * (1e-9 * (i + 1)), F)
            return Tt, acc + Tt[0, 0]
        out = lax.fori_loop(0, n_windows, body, (Tt, jnp.float32(0)))
        return out

    timeit("corr_vec over C  (w@C, L x R)", corr_C, C, F)
    timeit("corr_vec over F  (v@F, L x M)", corr_F, C, F)
    timeit("row fetch Tt[k,:]  (contig)", row_fetch, Tt)
    timeit("col fetch Tt[:,h]  (strided)", col_fetch, Tt)
    timeit(f"costs update ({vdtype.name} R)", costs_update, costs, C)
    timeit(f"argmin costs ({vdtype.name} R)", argmin_costs, costs)
    timeit(f"ratio test ({vdtype.name} M)", ratio, b, F)
    timeit("eta append C/F rows", eta_append, C, F)
    # n_windows applies over K "pivots" -> timeit's us/iter is already the
    # per-pivot amortised apply cost.
    timeit("window apply (amortised/pivot)", window_apply, Tt, C, F)
    return 0


if __name__ == "__main__":
    sys.exit(main())
