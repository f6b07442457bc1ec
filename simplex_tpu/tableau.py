"""Device tableau representation.

Equivalent of the reference's tableau storage layer
(reference: include/tabular.cuh:5-30, src/tabular.cu:25-39) and of the
Phase-1 tableau construction (``fillTableu``, twoPhaseMethod.cu:145-200).

Layout follows the reference's central data-structure decision
(relazione.Rmd:290-301) — the tableau is stored *variable-major*: ``T[i, j]``
is the coefficient of variable ``i`` in constraint ``j``, so an entering
variable's column a_h is a contiguous row slice. Unlike the reference:

* the right-hand side ``b`` and the reduced-cost row ``costs`` are separate
  arrays instead of matrix row 0 / an off-matrix vector with the objective
  cell at index 0 (tabular.cu:35, tabular.cuh:19-20); the objective cell is
  the scalar ``z``. Same semantics, friendlier for sharding: ``T`` and
  ``costs`` shard along the variable axis, ``b``/``base``/``z`` replicate.
* both axes are padded (``SolverOptions.lane_pad`` on the constraint
  axis, ``sublane_pad`` on the variable axis); padding is masked out of
  every reduction via the static real sizes carried as pytree metadata.

The reference's six-stream fill choreography (twoPhaseMethod.cu:147-199) is
replaced by a single jitted concatenation XLA fuses on its own, and the
dynamic-parallelism column-sign fix (``checkColumns`` -> device-launched
``negateColumn``, twoPhaseMethod.cu:100-111) becomes a vectorised
``jnp.where`` on a ``b <= -eps`` mask. Divergence (documented): the
reference negates the artificial identity entry too, which breaks its
Phase-1 basis for negative b; here artificials keep coefficient +1.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import SolverOptions


#: One-shot vs chunked structural fill threshold for build_phase1
#: (bytes of the n x m structural block). Above it the transposed-fill
#: temp would sit next to A and T in device memory (3.7 GB at the
#: 10k x 100k flagship).
BUILD_CHUNK_BYTES = 1 << 30


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def accum_matvec(A: jax.Array, v: jax.Array, contract_axis: int,
                 out_dtype) -> jax.Array:
    """Matrix-vector product contracting ``contract_axis`` of A with v,
    accumulating in ``out_dtype`` (f64 over an f32 tableau in the mixed
    mode) at full precision — never TF32."""
    return jax.lax.dot_general(
        A, v.astype(A.dtype), (((contract_axis,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.dtype(out_dtype))


@partial(jax.tree_util.register_dataclass,
         data_fields=("T", "b", "costs", "z", "base"),
         meta_fields=("n", "m", "r"))
@dataclasses.dataclass
class Tableau:
    """Solver state pytree (reference tabular_t + base vector).

    Shapes: ``T (R_pad, M_pad)``, ``b (M_pad,)``, ``costs (R_pad,)``,
    ``z ()``, ``base (M_pad,) int32``. Static metadata: ``n`` structural
    variables, ``m`` real constraints, ``r`` real (active) variable rows —
    ``n + 2m`` in phase 1, ``n + m`` after the phase-2 truncation
    (``rows -= cols``, twoPhaseMethod.cu:288).
    """

    T: jax.Array
    b: jax.Array
    costs: jax.Array
    z: jax.Array
    base: jax.Array
    n: int
    m: int
    r: int

    @property
    def rows_padded(self) -> int:
        return self.T.shape[-2]

    @property
    def cols_padded(self) -> int:
        return self.T.shape[-1]

    def row_mask(self) -> jax.Array:
        """(R_pad,) bool — True on real (active) variable rows."""
        return jnp.arange(self.rows_padded) < self.r

    def col_mask(self) -> jax.Array:
        """(M_pad,) bool — True on real constraint columns."""
        return jnp.arange(self.cols_padded) < self.m


def padded_dims(n: int, m: int, options: SolverOptions) -> tuple[int, int, int]:
    """(R1_pad, R2_pad, M_pad) for phase-1 rows n+2m, phase-2 rows n+m."""
    sub = options.sublane_pad
    return (round_up(n + 2 * m, sub),
            round_up(n + m, sub),
            round_up(m, options.lane_pad))


def build_phase1(A: jax.Array, b: jax.Array, n: int, m: int,
                 options: SolverOptions,
                 dims: tuple[int, int] | None = None) -> Tableau:
    """Build the Phase-1 tableau (reference fillTableu,
    twoPhaseMethod.cu:145-200): stored rows [structural | slack |
    artificial], artificial basis ``base = [n+m .. n+2m-1]``
    (twoPhaseMethod.cu:190-195), costs 1 on artificials, and the b-sign fix.

    ``A`` is (m, n) constraint-major; it is transposed here into the
    variable-major tableau (the reference receives it already column-major,
    problem.cu:41). ``dims`` overrides the (R_pad, M_pad) padding — the
    sharded path needs the row count divisible by the shard count.
    """
    dtype = jnp.dtype(options.dtype)
    vdtype = jnp.dtype(options.vector_dtype)
    eps = options.eps_resolved
    if dims is None:
        R_pad, _, M_pad = padded_dims(n, m, options)
    else:
        R_pad, M_pad = dims
    r = n + 2 * m

    A = A.astype(dtype)
    b = b.astype(vdtype)

    # Sign fix for negative right-hand sides: negate structural+slack row
    # entries and b, keep the artificial block +1 (see module docstring).
    flip = b <= -eps                       # (m,)
    sign = jnp.where(flip, -1.0, 1.0).astype(dtype)

    eye = jnp.eye(m, dtype=dtype)
    if n * m * dtype.itemsize <= BUILD_CHUNK_BYTES:
        T_real = jnp.concatenate([
            A.T * sign[None, :],           # structural rows (n, m)
            eye * sign[None, :],           # slack identity (m, m)
            eye,                           # artificial identity (m, m)
        ], axis=0)
        T = jnp.zeros((R_pad, M_pad), dtype=dtype).at[:r, :m].set(T_real)
    else:
        # Multi-GB builds: the one-shot ``A.T * sign`` above materializes
        # a full transposed temp NEXT TO A and T (3.7 GB at the 10k x
        # 100k flagship — the peak that kept solve() off flagship
        # shapes). Fill the structural block in bounded chunks instead;
        # the tail chunk re-writes a few already-written rows with
        # identical values (dynamic_slice clamping), which is harmless.
        T = jnp.zeros((R_pad, M_pad), dtype=dtype)
        chunk = max(8, min(n, (1 << 28) // max(1, m * dtype.itemsize)))
        steps = -(-n // chunk)

        def body(i, T):
            start = jnp.minimum(i * chunk, n - chunk).astype(jnp.int32)
            blk = jax.lax.dynamic_slice(A, (jnp.int32(0), start),
                                        (m, chunk))
            blk = blk.T * sign[None, :]
            return jax.lax.dynamic_update_slice(
                T, blk, (start, jnp.int32(0)))

        T = jax.lax.fori_loop(0, steps, body, T)
        T = T.at[n:n + m, :m].set(eye * sign[None, :])
        T = T.at[n + m:r, :m].set(eye)
    b_pad = jnp.zeros((M_pad,), dtype=vdtype).at[:m].set(
        b * sign.astype(vdtype))

    costs = jnp.zeros((R_pad,), dtype=vdtype).at[n + m:r].set(1.0)
    # Padded base entries point past every row -> dropped by masked scatters.
    base = jnp.full((M_pad,), R_pad, dtype=jnp.int32).at[:m].set(
        jnp.arange(n + m, n + 2 * m, dtype=jnp.int32))
    return Tableau(T=T, b=b_pad, costs=costs, z=jnp.zeros((), vdtype),
                   base=base, n=n, m=m, r=r)


def gaussian_eliminate(tab: Tableau) -> Tableau:
    """Objective-row elimination (reference updateObjectiveFunction,
    gaussian.cu:110-162): ``costs -= T @ costs[base]``,
    ``z -= b @ costs[base]``. The reference's atomicAdd tree-reduction
    kernels collapse into one XLA matvec.

    Out-of-range base entries (padding, or artificials left basic over a
    truncated tableau — their columns are zeroed) contribute 0.
    """
    R_pad = tab.rows_padded
    valid = tab.base < tab.r
    coeffs = jnp.where(
        valid, tab.costs[jnp.minimum(tab.base, R_pad - 1)], 0.0)
    # Accumulate in the vector dtype over the (possibly narrower) tableau
    # dtype.
    delta = accum_matvec(tab.T, coeffs, 1, tab.costs.dtype)
    return dataclasses.replace(
        tab,
        costs=tab.costs - delta,
        z=tab.z - jnp.dot(tab.b, coeffs,
                          precision=jax.lax.Precision.HIGHEST),
    )


def phase2_reset(tab: Tableau, c: jax.Array,
                 options: SolverOptions,
                 r2_pad: int | None = None) -> Tableau:
    """Truncate the artificial block and install the Phase-2 objective
    (reference phase2 steps 1-2, twoPhaseMethod.cu:288-325): active rows
    shrink to n+m (a static slice here — the reference just decrements
    ``rows``), costs become [-c | 0], and the objective cell z carries over
    from phase 1 verbatim (the reference never resets costs[0]).

    ``r2_pad`` overrides the phase-2 row padding (like build_phase1's
    ``dims``)."""
    n, m = tab.n, tab.m
    if r2_pad is None:
        _, R2_pad, _ = padded_dims(n, m, options)
    else:
        R2_pad = r2_pad
    r2 = n + m
    vdtype = tab.costs.dtype
    costs = jnp.zeros((R2_pad,), dtype=vdtype).at[:n].set(-c.astype(vdtype))
    return Tableau(T=tab.T[:R2_pad], b=tab.b, costs=costs, z=tab.z,
                   base=tab.base, n=n, m=m, r=r2)


def extract_solution(tab: Tableau) -> jax.Array:
    """Solution vector (reference getSolution scatter,
    twoPhaseMethod.cu:116-128,370-383): ``x[base[k]] = b[k]`` for basic
    structural variables; slack/artificial/padding indices drop."""
    idx = jnp.where(tab.base < tab.n, tab.base, tab.n)
    x_ext = jnp.zeros((tab.n + 1,), tab.b.dtype).at[idx].set(
        tab.b, mode="drop")
    return x_ext[:tab.n]


def phase1_objective(tab: Tableau) -> jax.Array:
    """Exact phase-1 objective of the *current basis*: the artificial
    variables' summed value, negated — every non-basic artificial is 0 and
    a basic one has value b[k], so ``z = -sum(b[k] : base[k] artificial)``.

    Mathematically identical to the incrementally-maintained objective
    cell (reference costs[0], twoPhaseMethod.cu:264-268) but immune to the
    per-pivot fp drift that accumulates in the running z — which matters
    for float32 tableaus and deep block-pivot windows."""
    first_artificial = tab.n + tab.m
    is_art = (tab.base >= first_artificial) & (
        tab.base < tab.n + 2 * tab.m)
    return -jnp.sum(jnp.where(is_art, tab.b, 0.0))


def format_tableau(tab: Tableau, max_rows: int = 32,
                   max_cols: int = 16) -> str:
    """Debug rendering of the tableau (reference printTableauToStream,
    tabular.cu:41-98 — the -D DEBUG build dumps it after every stage and
    pivot): the cost row with the objective cell first, then one line per
    stored variable row with its constraint coefficients, then b and the
    base. Large tableaus elide middle rows/columns."""
    import io

    out = io.StringIO()
    T = np.asarray(tab.T)[:tab.r, :tab.m]
    costs = np.asarray(tab.costs)[:tab.r]
    b = np.asarray(tab.b)[:tab.m]
    base = np.asarray(tab.base)[:tab.m]

    def fmt_row(label, vals):
        shown = vals if len(vals) <= max_cols else np.concatenate(
            [vals[:max_cols // 2], vals[-max_cols // 2:]])
        ellip = " ... " if len(vals) > max_cols else " "
        cells = ellip.join(" ".join(f"{v:10.4f}" for v in half)
                           for half in (np.array_split(shown, 2)
                                        if len(vals) > max_cols
                                        else [shown]))
        out.write(f"{label:>8s} | {cells}\n")

    out.write(f"Tableau {tab.r} vars x {tab.m} constraints "
              f"(z = {float(tab.z):.6f})\n")
    fmt_row("costs", costs[:max_rows])
    rows = range(tab.r) if tab.r <= max_rows else (
        list(range(max_rows // 2))
        + list(range(tab.r - max_rows // 2, tab.r)))
    last = -1
    for i in rows:
        if i != last + 1:
            out.write("     ...\n")
        fmt_row(f"x{i}", T[i])
        last = i
    fmt_row("b", b)
    out.write("    base | " + " ".join(str(v) for v in base) + "\n")
    return out.getvalue()


def count_basic_artificials(tab: Tableau) -> jax.Array:
    """Degeneracy check (reference checkDegeneracy + countElementsInRange,
    twoPhaseMethod.cu:134-143,206-223): artificial indices still in base."""
    first_artificial = tab.n + tab.m
    in_range = (tab.base >= first_artificial) & (
        tab.base < tab.n + 2 * tab.m)
    return jnp.sum(in_range.astype(jnp.int32))
