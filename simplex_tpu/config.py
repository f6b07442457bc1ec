"""Numerics config and solver options.

Equivalent of the reference's cross-cutting macros layer
(reference: include/macro.h:6-42): ``TYPE double`` becomes a configurable
dtype (default float64, requiring ``jax_enable_x64``), and the three-way
epsilon comparator ``compare(x, y, eps=1e-9)`` (macro.h:28-42) becomes the
EPS constant plus explicit ``>= -EPS`` / ``<= EPS`` predicates baked into the
jitted solver, with identical semantics: two values are "equal" when their
absolute difference is strictly below EPS.

Status codes mirror include/twoPhaseMethod.h:5-8 (INFEASIBLE=-1,
UNBOUNDED=-2, DEGENERATE=-3, FEASIBLE=0) plus two additions that the
reference does not have: MAXITER (iteration fuse — the reference can cycle
forever, relazione.Rmd:1037-1039) and RUNNING (the loop-carried NOT_ENDED
analogue, src/solver.cu:77).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import numpy as np

#: Epsilon used by every comparison in the solver (reference macro.h:28).
EPS = 1e-9

#: Default epsilon for float32 tableaus. An f32 tableau carries ~1e-6
#: relative noise in every re-priced reduced cost, so the reference's
#: 1e-9 discipline sees noise as eligible entering columns and pivots
#: degenerately forever at the optimal vertex (observed: n=300 m=900
#: seed=777 phase 2 — the loop reaches the oracle optimum, then crawls
#: until the iteration fuse, 150k pivots in one device call). Matches
#: the CLI's long-standing f32 default.
EPS_F32 = 1e-4

#: Relative pricing floor for f32 tableaus under cost normalization
#: (SolverOptions.normalize_costs): a reduced cost below
#: EPS_REL_F32 * (1 + max|costs|) is data-precision noise — an f32
#: tableau's coefficients carry ~6e-8 relative rounding, so "improving"
#: columns below this threshold chase noise (measured: vars=128 m=8
#: values 1..1000 crawls 7600 noise pivots to MAXITER under an absolute
#: 1e-5; with the 1e-7 relative floor it stops at the data-precision
#: optimum, ~3e-5 relative, in 28 pivots).
EPS_REL_F32 = 1e-7


class Status(enum.IntEnum):
    """Solver exit statuses (reference twoPhaseMethod.h:5-8, solver.cu:77)."""

    OPTIMAL = 0        # reference: FEASIBLE
    INFEASIBLE = -1
    UNBOUNDED = -2
    DEGENERATE = -3    # reference-compat: artificial variable left in base
    MAXITER = -4       # new: iteration fuse tripped (no reference equivalent)
    NUMERIC = -5       # new: non-finite tableau state detected (the
                       # reference exits fatally on CUDA errors instead,
                       # error.cu:5-12; fp poison it never checks)
    RUNNING = -10      # internal: loop not finished (reference NOT_ENDED)

    @property
    def message(self) -> str:
        return {
            Status.OPTIMAL: "Problem solved!",
            Status.INFEASIBLE: "Problem INFEASIBLE!",
            Status.UNBOUNDED: "Problem UNBOUNDED!",
            Status.DEGENERATE: "Problem DEGENERATE!",
            Status.MAXITER: "Iteration limit reached!",
            Status.NUMERIC: "Numerical failure (non-finite tableau)!",
            Status.RUNNING: "Still running",
        }[self]


def compare(x, y=0.0, eps: float = EPS) -> int:
    """Three-way epsilon comparison, identical to reference macro.h:28-42.

    Returns 0 if ``|x - y| < eps``, -1 if ``x < y``, +1 otherwise.
    Host-side helper (NumPy scalars); the jitted solver inlines the same
    predicate as vectorised comparisons.
    """
    if abs(x - y) < eps:
        return 0
    return -1 if x < y else 1


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Options controlling the two-phase solve.

    The defaults reproduce the reference algorithm (Dantzig rule,
    fp64, eps=1e-9) but — unlike the reference, which only detects
    degeneracy and aborts (relazione.Rmd:64-66) — continue through
    degenerate problems with Bland's-rule anti-cycling.
    """

    #: Tableau dtype. float64 matches the reference (macro.h:6); float32
    #: halves the tableau's memory and bandwidth (the mixed production
    #: mode pairs it with float64 vectors and f64 refinement).
    dtype: np.dtype = np.dtype(np.float64)

    #: Epsilon for all comparisons (reference macro.h:28). None (the
    #: default) resolves by tableau dtype into ``eps_resolved``: EPS
    #: (1e-9, the reference's value) for float64, EPS_F32 (1e-4) for
    #: float32 — f32 reduced-cost noise makes a 1e-9 discipline
    #: non-terminating (see EPS_F32). Solver code reads ``eps_resolved``.
    eps: Optional[float] = None

    #: Derived: ``eps`` resolved against the tableau dtype (set in
    #: ``__post_init__``; never pass it yourself).
    eps_resolved: float = dataclasses.field(init=False, repr=False,
                                            compare=False)

    #: Dtype for the small solver vectors (b, reduced costs, z). Defaults
    #: to ``dtype``. Setting float64 with a float32 tableau gives the
    #: mixed-precision mode: the tableau keeps f32 memory/bandwidth (the
    #: whole footprint) while the vectors that accumulate per-pivot
    #: updates stay drift-free — f32-only runs were observed to
    #: accumulate O(0.1) absolute error in b over ~5k pivots, enough to
    #: misclassify feasible problems.
    vector_dtype: Optional[np.dtype] = None

    #: Scale-aware pricing for low-precision tableaus: each solve loop
    #: call divides its working cost vector (and z, and the re-pricing
    #: costs0) by ``max(1, EPS_REL_F32/eps * (1 + max|costs|))`` and
    #: restores the original units on exit. Positive scaling never
    #: changes an argmin; the effect is that the pricing eps becomes
    #: ``max(eps, EPS_REL_F32 * (1 + max|costs|))`` — the user's
    #: absolute eps, FLOORED at the f32 data-precision-resolvable
    #: threshold. Problems whose cost scale makes the absolute eps
    #: sub-noise (coefficients in the thousands) then stop at the
    #: data-precision optimum instead of crawling noise pivots to the
    #: iteration fuse; problems where the absolute eps is already above
    #: the floor are bit-for-bit unchanged (scale = 1). "auto"
    #: (default): enabled for f32 tableaus, disabled for f64 (whose
    #: absolute-eps semantics are the reference parity contract).
    normalize_costs: Union[str, bool] = "auto"

    #: Pivot-iteration fuse per phase. None -> 50 * (rows + cols), a
    #: generous bound (reference benchmark instances need < 3 * rows).
    max_iter: Optional[int] = None

    #: 'dantzig' (reference rule: most negative reduced cost,
    #: solver.cu:87 — the parity rule), 'devex' (Forrest-Goldfarb
    #: reference-framework weights: pick the eligible column maximizing
    #: cost^2 / weight; fewer pivots than Dantzig on seeded dense
    #: instances, tests/test_blocked.py), or 'bland' (always lowest eligible index;
    #: anti-cycling). None (the default) resolves by mode into
    #: ``pivot_rule_resolved``: devex for the f32 blocked production
    #: configurations,
    #: dantzig everywhere else — f64 keeps the reference's own rule
    #: (parity contract), and non-blocked loops match the reference's
    #: sequential economics. Solver code reads ``pivot_rule_resolved``.
    pivot_rule: Optional[str] = None

    #: Derived: ``pivot_rule`` resolved against the mode (set in
    #: ``__post_init__``; never pass it yourself).
    pivot_rule_resolved: str = dataclasses.field(init=False, repr=False,
                                                 compare=False)

    #: Consecutive non-improving (degenerate) pivots before temporarily
    #: switching Dantzig -> Bland. None disables the fallback
    #: (pure reference behaviour, which may cycle).
    bland_threshold: Optional[int] = 50

    #: 'continue': drive artificials out of the base after phase 1 and solve
    #: phase 2 anyway (this repo's extension); 'reference': return
    #: Status.DEGENERATE like the reference does (twoPhaseMethod.cu:270-282).
    degeneracy: str = "continue"

    #: Deferred block pivoting: accumulate this many rank-1 pivot updates
    #: as eta factors (C: R x L, F: L x M) and apply them to the tableau as
    #: ONE matrix product ``T -= C @ F`` per window, dividing memory
    #: traffic per pivot by ~L. All per-pivot selections (entering argmin, ratio test)
    #: are computed exactly against the *virtual* current tableau
    #: ``T0 - C@F`` via small matvecs, so the pivot sequence is the same
    #: simplex algorithm (summation order differs from the sequential
    #: rank-1 path, so last-bit fp may differ). None/<=1 disables.
    block_pivots: Optional[int] = None

    #: f64 basis-system refinement at solution extraction (refine.py):
    #: rebuild B from the ORIGINAL f64 problem data for the final basis,
    #: re-solve B x_B = b and B^T y = c_B with an f32 LU + f64 iterative
    #: refinement, and replace x/objective with the f64-certified values
    #: (the analogue of the reference's f64 getSolutionHost,
    #: twoPhaseMethod.cu:370-383, which extracts from an all-f64
    #: tableau). "auto" (default): enabled exactly for the mixed
    #: production mode (f32 tableau + f64 vectors) — the mode whose
    #: in-loop drift refinement erases; f64 solves are already exact and
    #: pure-f32 solves have no f64 data path. If the refinement
    #: certificates fail (wrong final basis — knife-edge numerics), the
    #: host wrapper falls back to an f64 finishing solve.
    refine: Union[str, bool] = "auto"

    #: Iterative-refinement sweeps for the primal and dual basis solves
    #: (each contracts the error by ~cond(B) * 2^-24; 3 reaches f64
    #: round-off for any basis an f32 pivot walk can navigate).
    refine_iters: int = 3

    #: Scale-relative certificate tolerance (refine.certificates_pass):
    #: primal residual / negativity / artificial mass against the |b|
    #: scale, dual infeasibility against the cost+dual scale. Failing
    #: any of them triggers the f64 finishing fallback.
    refine_tol: float = 1e-6

    #: Opt-in power-of-two row/column equilibration at fill time
    #: (scaling.py): brings extreme-magnitude data (|values| near f32's
    #: ~1e38 limit) into the f32 tableau's range, exactly (power-of-two
    #: factors touch only fp exponents, so pivot arithmetic sees the
    #: same mantissas). The eps
    #: discipline then applies in the scaled units; OPTIMAL results
    #: refine/unwind back to original units. Host-wrapper feature
    #: (solve() and the CLI): the device cores always see the already-
    #: scaled arrays.
    equilibrate: bool = False

    #: Pad the constraint axis to a multiple of this.
    lane_pad: int = 128
    #: Pad the variable axis to a multiple of this.
    sublane_pad: int = 8

    def resolved_max_iter(self, rows: int, cols: int) -> int:
        if self.max_iter is not None:
            return int(self.max_iter)
        return 50 * (rows + cols)

    def __post_init__(self):
        if self.pivot_rule not in (None, "dantzig", "devex", "bland"):
            raise ValueError(f"unknown pivot_rule {self.pivot_rule!r}")
        if self.degeneracy not in ("continue", "reference"):
            raise ValueError(f"unknown degeneracy policy {self.degeneracy!r}")
        if self.refine not in ("auto", True, False):
            raise ValueError(f"refine must be 'auto'/True/False, "
                             f"got {self.refine!r}")
        if int(self.refine_iters) < 1:
            raise ValueError(
                f"refine_iters must be >= 1, got {self.refine_iters}")
        if not (float(self.refine_tol) > 0.0):
            raise ValueError(
                f"refine_tol must be > 0, got {self.refine_tol}")
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        object.__setattr__(
            self, "vector_dtype",
            np.dtype(self.vector_dtype) if self.vector_dtype is not None
            else np.dtype(self.dtype))
        # eps stays raw (None = "resolve by tableau dtype") so that
        # dataclasses.replace(opts, dtype=...) re-resolves for the new
        # dtype instead of carrying the previous dtype's value; solver
        # code reads the derived eps_resolved.
        object.__setattr__(
            self, "eps_resolved",
            float(self.eps) if self.eps is not None
            else (EPS if self.dtype.itemsize == 8 else EPS_F32))
        # pivot_rule follows the same raw-vs-derived pattern: None means
        # "resolve by mode" — devex for the f32 blocked production
        # configurations, dantzig for the f64 parity modes and the
        # sequential loops (the reference's own rule, solver.cu:87).
        if self.pivot_rule is not None:
            resolved_rule = self.pivot_rule
        elif (self.block_pivots and int(self.block_pivots) > 1
                and self.dtype.itemsize == 4):
            resolved_rule = "devex"
        else:
            resolved_rule = "dantzig"
        object.__setattr__(self, "pivot_rule_resolved", resolved_rule)

    @property
    def needs_x64(self) -> bool:
        return (self.dtype == np.float64
                or self.vector_dtype == np.float64
                or refine_enabled(self))


def refine_enabled(options: SolverOptions) -> bool:
    """Resolve ``refine``: 'auto' means the mixed production mode only
    (f32 tableau whose drift refinement erases + f64 vectors proving an
    f64 data path exists); f64 solves are already reference-exact and
    pure-f32 solves have no f64 inputs to refine against."""
    if options.refine == "auto":
        return (np.dtype(options.dtype).itemsize == 4
                and np.dtype(options.vector_dtype).itemsize == 8)
    return bool(options.refine)


def normalize_enabled(options: SolverOptions) -> bool:
    """Resolve ``normalize_costs``: 'auto' means f32 tableaus only
    (f64 keeps the reference's absolute-eps parity semantics)."""
    if options.normalize_costs == "auto":
        return np.dtype(options.dtype).itemsize == 4
    return bool(options.normalize_costs)


DEFAULT_OPTIONS = SolverOptions()
