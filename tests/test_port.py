"""What running on the GPU through plain XLA requires of the code: the
compile-cache rule, the CLI's platform choice, full-precision f32 dots
on the main path, no code for the retired backend, and measurement paths
that refuse to run without a GPU."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplex_tpu
from simplex_tpu import device
from simplex_tpu.config import SolverOptions

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted(
    [p for p in (ROOT / "simplex_tpu").rglob("*.py")]
    + [ROOT / "bench.py", ROOT / "chip_smoke.py",
       ROOT / "__graft_entry__.py"]
    + sorted((ROOT / "tools").glob("*.py"))
    + sorted((ROOT / "tests").glob("*.py")))


# ---------------------------------------------------------------------------
# Compile cache


def test_cache_dir_unset_is_fixed_in_checkout():
    got = simplex_tpu.compile_cache_dir({})
    assert got == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cache_dir_env_set_is_left_to_jax():
    assert simplex_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere"}) is None


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_cache_dir_seen_by_jax_on_import(env_dir, tmp_path):
    """Importing the package in a fresh process: an explicit
    JAX_COMPILATION_CACHE_DIR is what JAX uses; without it, the fixed
    directory inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".jax_cache")
    if env_dir is not None:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax, simplex_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


def test_tests_keep_out_of_the_package_cache():
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == str(
        ROOT / ".jax_cache_cpu")


# ---------------------------------------------------------------------------
# CLI platform


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cli_platform_choices(platform):
    from simplex_tpu.cli import _build_parser

    args = _build_parser().parse_args(["-f", "x.txt", "--platform",
                                       platform])
    assert args.platform == platform


def test_cli_platform_rejects_the_retired_backend(capsys):
    from simplex_tpu.cli import _build_parser

    with pytest.raises(SystemExit):
        _build_parser().parse_args(["-f", "x.txt", "--platform",
                                    "t" + "pu"])
    assert "invalid choice" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Precision: every f32 dot on the main path runs at HIGHEST (no TF32)


def _dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(x, "jaxpr"):
                    _dots(x.jaxpr, out)
                elif hasattr(x, "eqns"):
                    _dots(x, out)
    return out


def _is_highest(precision):
    if precision is None:
        return False
    ps = precision if isinstance(precision, tuple) else (precision,)
    return all(p == jax.lax.Precision.HIGHEST for p in ps)


MIXED = SolverOptions(dtype=np.float32, vector_dtype=np.float64,
                      block_pivots=8)
PURE32 = SolverOptions(dtype=np.float32, vector_dtype=np.float32)
N, M = 40, 12


def _inputs(dtype=np.float32):
    rng = np.random.default_rng(0)
    return (jnp.asarray(rng.uniform(1, 9, (M, N)), dtype),
            jnp.asarray(rng.uniform(1, 9, (M,)), np.float64),
            jnp.asarray(rng.uniform(1, 9, (N,)), np.float64))


def _program(name):
    from simplex_tpu import batch, refine, reinvert, two_phase
    from simplex_tpu.parallel import sharded

    A, b, c = _inputs()
    base = jnp.arange(M, dtype=jnp.int32)
    if name == "solve_mixed_blocked":
        return jax.make_jaxpr(lambda A, b, c: two_phase.solve_device_with_binv(
            A, b, c, N, M, MIXED))(A, b, c)
    if name == "solve_f32_sequential":
        return jax.make_jaxpr(lambda A, b, c: two_phase.solve_device(
            A, b.astype(np.float32), c.astype(np.float32), N, M,
            PURE32))(A, b, c)
    if name == "solve_f32_blocked_dantzig":
        opt = SolverOptions(dtype=np.float32, block_pivots=8,
                            pivot_rule="dantzig")
        return jax.make_jaxpr(lambda A, b, c: two_phase.solve_device(
            A, b.astype(np.float32), c.astype(np.float32), N, M,
            opt))(A, b, c)
    if name == "refine_lu":
        return jax.make_jaxpr(lambda A, b, c: refine.refine_solution(
            A, b, c, base, N, M))(A, b, c)
    if name == "refine_tableau":
        binv = jnp.eye(M, dtype=jnp.float32)
        return jax.make_jaxpr(lambda A, b, c: refine.refine_solution_tableau(
            A, b, c, base, binv, N, M))(A, b, c)
    if name == "reinvert":
        from simplex_tpu.tableau import padded_dims

        m_pad = padded_dims(N, M, MIXED)[2]
        base_pad = jnp.full((m_pad,), N + 2 * M, jnp.int32).at[:M].set(base)
        binv = jnp.eye(M, dtype=jnp.float32)
        return jax.make_jaxpr(lambda A, b, c: reinvert.restart_device(
            A, b, c, base_pad, binv, b, N, M, MIXED))(A, b, c)
    if name == "batched":
        return jax.make_jaxpr(lambda A, b, c: batch.solve_device_batched(
            A[None], b[None], c[None], N, M, MIXED))(A, b, c)
    if name == "sharded":
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:2]), ("vars",))
        fn = sharded.make_sharded_solver(mesh, N, M, MIXED, with_binv=True)
        return jax.make_jaxpr(fn)(A, b, c)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "solve_mixed_blocked", "solve_f32_sequential",
    "solve_f32_blocked_dantzig", "refine_lu", "refine_tableau",
    "reinvert", "batched", "sharded"])
def test_f32_dots_on_main_path_run_at_highest(name):
    dots = _dots(_program(name).jaxpr, [])
    assert dots, "program has no dot to check"
    f32 = [e for e in dots
           if any(v.aval.dtype == jnp.float32 for v in e.invars)]
    bad = [(str(e.invars[0].aval), str(e.invars[1].aval),
            e.params.get("precision")) for e in f32
           if not _is_highest(e.params.get("precision"))]
    assert not bad, bad


def test_reinvert_pins_highest_in_its_products():
    """Newton-Schulz and the tableau rebuild (reinvert.py) are all f32
    matrix products; each carries Precision.HIGHEST."""
    f32 = [e for e in _dots(_program("reinvert").jaxpr, [])
           if e.invars[0].aval.dtype == jnp.float32
           and e.invars[0].aval.ndim == 2 and e.invars[1].aval.ndim == 2]
    assert len(f32) >= 2 * 3 + 2
    assert all(_is_highest(e.params.get("precision")) for e in f32)


def test_mixed_matvec_accumulates_f64_exactly():
    """f32 x f32 products accumulated in f64 (preferred_element_type)
    equal NumPy's f64 product of the same f32 values."""
    from simplex_tpu.tableau import accum_matvec

    rng = np.random.default_rng(2)
    A = rng.uniform(-1, 1, (300, 70)).astype(np.float32)
    v = rng.uniform(-1, 1, 300).astype(np.float32)
    want = A.astype(np.float64).T @ v.astype(np.float64)
    got = accum_matvec(jnp.asarray(A), jnp.asarray(v, np.float64), 0,
                       np.float64)
    assert got.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-13,
                               atol=1e-13)


# ---------------------------------------------------------------------------
# No code for the retired backend


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_retired_backend_code(path):
    """No source names the retired backend's Pallas module or runtime
    library, or branches on that backend (the needles are assembled so
    this file passes too)."""
    text = path.read_text()
    retired = "t" + "pu"
    for needle in ("pallas." + retired, "pl" + retired, "lib" + retired,
                   f'default_backend() == "{retired}"',
                   f'default_backend() != "{retired}"'):
        assert needle not in text, (path, needle)


def test_importing_everything_loads_no_pallas():
    code = ("import sys, pkgutil, importlib, simplex_tpu, bench, "
            "chip_smoke, __graft_entry__\n"
            "for m in pkgutil.walk_packages(simplex_tpu.__path__, "
            "'simplex_tpu.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if 'pallas' in m]\n"
            "print(bad)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_kernels_package_is_gone():
    assert not (ROOT / "simplex_tpu" / "kernels").exists()


# ---------------------------------------------------------------------------
# Measurement paths refuse to run without a GPU


def test_require_gpu_names_the_platform_found():
    with pytest.raises(device.NoGPUError, match="'cpu'"):
        device.require_gpu()


@pytest.mark.gpu
def test_require_gpu_on_the_card(gpu):
    got = device.require_gpu()
    assert got["platform"] == "gpu" and got["kind"] == gpu.device_kind
    assert device.card_info()


@pytest.mark.gpu
def test_golden_files_on_the_card(gpu):
    import chip_smoke

    chip_smoke.phase_golden()
