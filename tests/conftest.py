"""Test harness config: run JAX on a virtual 8-device CPU mesh with x64.

The standard JAX fake-backend pattern for testing multi-device sharding
without hardware (SURVEY.md §4d). The tests run on the CPU unless
``JAX_PLATFORMS`` names another backend: tests that need a card carry
the ``gpu`` marker, skip on the CPU, and run on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``. The main path on
the card is driven by ``python chip_smoke.py``.

CPU test executables go to their own persistent compilation cache,
``.jax_cache_cpu``, never to the package's ``.jax_cache``: XLA:CPU
entries are executables for this host's instruction set and must not
travel with the tree to another machine.
"""

import os
import pathlib

_ROOT = pathlib.Path(__file__).resolve().parent.parent

_ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if _ON_CPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(_ROOT / ".jax_cache_cpu")

import jax  # noqa: E402

if _ON_CPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

# Bare `pytest` puts tests/ on sys.path but not the repo root; make
# `import bench` / `import chip_smoke` work either way.
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "examples"


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs_between_modules():
    """Release XLA:CPU executables after each test module.

    The suite compiles hundreds of distinct programs into ONE process;
    past a threshold the accumulated loaded executables nondeterministically
    crash XLA:CPU late in the run — Segfault/Abort inside
    backend_compile_and_load or a jitted call, bisected to the point
    where the suite's compile count grew, not to any code change.
    Dropping references between modules keeps the live-executable
    population bounded; the persistent on-disk compilation cache keeps
    recompiles cheap across modules that share programs."""
    yield
    jax.clear_caches()


@pytest.fixture
def small_problem():
    from simplex_tpu import read_problem

    return read_problem(DATA / "smallProblem.txt")


@pytest.fixture
def infeasible_problem():
    from simplex_tpu import read_problem

    return read_problem(DATA / "infeasibleProblem.txt")


def assert_valid_solution(problem, result, tol=1e-6):
    """Property check (SURVEY.md §4c): x feasible and objective consistent."""
    x = result.x
    assert x is not None
    assert (x >= -tol).all(), "negative variable"
    assert (problem.A @ x <= problem.b + tol * (1 + np.abs(problem.b))).all()
    assert abs(problem.c @ x - result.objective) <= tol * (
        1 + abs(result.objective))


@pytest.fixture
def gpu():
    """The GPU a ``gpu``-marked test runs on; skips when JAX finds none
    (decided here, at run time, never at import)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {devices[0].platform!r} "
                    "(on the card: JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu)")
    return devices[0]
