"""simplex-tpu: dense two-phase simplex LP solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of the CUDA
reference solver rik1599/SimplexOnCuda (see SURVEY.md for the component
map). Public API:

    from simplex_tpu import Problem, solve, Status
    result = solve(problem)            # jitted two-phase simplex on device
    result = solve_oracle(problem)     # NumPy oracle (host)
"""

import os as _os
import pathlib as _pathlib

import jax as _jax

#: The persistent compilation cache used when JAX_COMPILATION_CACHE_DIR
#: is not set: one fixed, git-ignored directory inside the checkout, so
#: every process of a checkout reuses the programs an earlier one
#: compiled (the solve and refine programs compile once per shape).
DEFAULT_CACHE_DIR = _pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir(environ=_os.environ) -> str | None:
    """The directory this package sets as JAX's persistent compilation
    cache, or None when JAX_COMPILATION_CACHE_DIR is set — JAX reads
    that variable itself and the package leaves it alone."""
    if "JAX_COMPILATION_CACHE_DIR" in environ:
        return None
    return str(DEFAULT_CACHE_DIR)


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import EPS, SolverOptions, Status, compare  # noqa: F401
from .problem import (  # noqa: F401
    Problem, format_problem, read_problem, read_random_problem,
    read_seed_file, write_problem, write_seed_file)
from .generator import (  # noqa: F401
    benchmark_seed, benchmark_sizes, generate_random_problem,
    generate_random_problem_device)
from .result import SolveResult  # noqa: F401
from .oracle import solve_oracle  # noqa: F401

__version__ = "0.1.0"


def solve(problem, options=None, **kw):
    """Solve a dense LP with the jitted two-phase device solver."""
    from .two_phase import solve as _solve

    return _solve(problem, options, **kw)


def solve_batch(problems, options=None, **kw):
    """Solve a batch of equally-shaped LPs with one vmapped solve."""
    from .batch import solve_batched as _solve_batched

    return _solve_batched(problems, options, **kw)


#: Alias matching the module-level name in batch.py.
solve_batched = solve_batch


def solve_sharded(problem, mesh, options=None):
    """Solve one LP with the tableau column-sharded across a mesh."""
    from .parallel.sharded import solve_sharded as _solve_sharded

    return _solve_sharded(problem, mesh, options) if options is not None \
        else _solve_sharded(problem, mesh)


def solve_timed(problem, options=None, chrono=None, per_iteration=False,
                **kw):
    """Host-orchestrated solve with per-operation CSV timing (chrono)."""
    from .timed import solve_timed as _solve_timed

    return _solve_timed(problem, options, chrono, per_iteration, **kw)


def solve_resumable(problem, checkpoint_path, checkpoint_every=1000,
                    options=None, **kw):
    """Two-phase solve with iteration-level checkpoint/resume."""
    from .checkpoint import solve_resumable as _solve_resumable

    return _solve_resumable(problem, checkpoint_path, checkpoint_every,
                            options, **kw)


def refine_solution_host(A, b, c, base, n, m):
    """f64 basis-system refinement of a final basis against the
    original problem data, on the host (refine.py; the layer behind
    every certified result)."""
    from .refine import refine_solution_host as _r

    return _r(A, b, c, base, n, m)
