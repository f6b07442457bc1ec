"""ctypes wrapper around the native XORWOW generator
(simplex_tpu/native/xorwow.cpp).

Bit-exact cuRAND XORWOW so the reference's seed-file benchmark instances
(reference data/examples/benchmark_problems/*.txt; generation protocol
src/generator.cu:9-32) regenerate identically. The shared library is
compiled on first use with the system C++ compiler and cached next to the
source; a pure-Python fallback (correct but ~1000x slower) covers
compiler-less environments and is used by the unit tests to cross-check
the native build.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[1] / "native" / "xorwow.cpp"
_LIB_CACHE: ctypes.CDLL | None = None
_BUILD_FAILED = False


def _build_library() -> ctypes.CDLL | None:
    global _BUILD_FAILED
    if _BUILD_FAILED:
        return None
    lib_path = _SRC.parent / "_xorwow.so"
    try:
        if (not lib_path.exists()
                or lib_path.stat().st_mtime < _SRC.stat().st_mtime):
            # Build inside the destination's own directory: os.replace
            # from a TemporaryDirectory in the system temp dir into the
            # tree raises EXDEV across filesystems, which would silently
            # put every regeneration on the slow pure-Python path.
            with tempfile.TemporaryDirectory(dir=_SRC.parent) as td:
                tmp = os.path.join(td, "xorwow.so")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", str(_SRC),
                     "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, subprocess.CalledProcessError) as e:
        # One-time diagnostic: the silent fallback is ~1000x slower, so a
        # reference-scale regeneration (8192x8192 = 67M draws) would look
        # like a hang with no explanation.
        import warnings

        detail = ""
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            detail = ": " + e.stderr.decode(errors="replace").strip()
        warnings.warn(
            f"native XORWOW build failed ({e.__class__.__name__}{detail}); "
            "falling back to the pure-Python generator, which is ~1000x "
            "slower — large instances will take minutes to regenerate",
            RuntimeWarning, stacklevel=3)
        _BUILD_FAILED = True
        return None
    lib.xorwow_raw.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_uint32)]
    lib.xorwow_uniform.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.POINTER(ctypes.c_double)]
    return lib


def _library() -> ctypes.CDLL | None:
    global _LIB_CACHE
    if _LIB_CACHE is None:
        _LIB_CACHE = _build_library()
    return _LIB_CACHE


# ---------------------------------------------------------------------------
# Pure-Python reference implementation (slow; tests + fallback).

def _init_state(seed: int) -> tuple[list[int], int]:
    mask = 0xFFFFFFFF
    s0 = (seed & mask) ^ 0xAAD26B49
    s1 = ((seed >> 32) & mask) ^ 0xF7DCEFDD
    t0 = (1099087573 * s0) & mask
    t1 = (2591861531 * s1) & mask
    v = [(123456789 + t0) & mask, (362436069 ^ t0) & mask,
         (521288629 + t1) & mask, (88675123 ^ t1) & mask,
         (5783321 + t0) & mask]
    d = (6615241 + t1 + t0) & mask
    return v, d


def xorwow_raw_py(seed: int, count: int) -> np.ndarray:
    mask = 0xFFFFFFFF
    v, d = _init_state(seed)
    out = np.empty(count, dtype=np.uint32)
    for i in range(count):
        t = v[0] ^ (v[0] >> 2)
        v[0], v[1], v[2], v[3] = v[1], v[2], v[3], v[4]
        v[4] = ((v[4] ^ ((v[4] << 4) & mask)) ^ (t ^ ((t << 1) & mask))) \
            & mask
        d = (d + 362437) & mask
        out[i] = (v[4] + d) & mask
    return out


def _uniform_from_raw(raw: np.ndarray, lo: float, hi: float) -> np.ndarray:
    inv = np.float32(2.3283064e-10)
    u = raw.astype(np.float32) * inv + inv / np.float32(2.0)
    return u.astype(np.float64) * (hi - lo) + lo


def xorwow_uniform_py(seed: int, count: int, lo: float,
                      hi: float) -> np.ndarray:
    return _uniform_from_raw(xorwow_raw_py(seed, count), lo, hi)


# ---------------------------------------------------------------------------
# Public API (native if available, Python otherwise).

def xorwow_raw(seed: int, count: int) -> np.ndarray:
    lib = _library()
    if lib is None:
        return xorwow_raw_py(seed, count)
    out = np.empty(count, dtype=np.uint32)
    lib.xorwow_raw(seed, count,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def xorwow_uniform(seed: int, count: int, lo: float, hi: float) -> np.ndarray:
    """The reference's draw mapping (generator.cu:18): float32
    curand_uniform in (0, 1], scaled in double to [lo, hi)."""
    lib = _library()
    if lib is None:
        return xorwow_uniform_py(seed, count, lo, hi)
    out = np.empty(count, dtype=np.float64)
    lib.xorwow_uniform(seed, count, float(lo), float(hi),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def native_available() -> bool:
    return _library() is not None
