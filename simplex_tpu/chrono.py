"""Per-operation timing to CSV.

Equivalent of the reference's chrono subsystem (reference:
include/chrono.cuh, src/chrono.cu): identical CSV schema — header
``vars,contraints,operation,elapsed_time`` (sic, the reference's typo is
kept for downstream compatibility, chrono.cu:19), one row per timed
operation, elapsed time in **microseconds** (chrono.cu:48 multiplies
CUDA-event milliseconds by 1000; relazione.Rmd:458-462). The ``vars``
column is the tableau row count *including* the cost row — n+2m+1 in
phase 1, n+m+1 in phase 2 — exactly like the reference passes
``tabular->rows`` (chrono.cu:37).

CUDA events become a device-sync (scalar readback, see timed._sync) +
``time.perf_counter`` around each jitted operation (timed.py owns the
operation boundaries).
Two file modes, as in the reference: a timestamped ad-hoc file
(``times_<stamp>.txt``, chrono.cu:8-22) and a benchmark-named file
(``benchmark_<vars>_<constraints>.txt``, chrono.cu:24-33).
"""

from __future__ import annotations

import os
import time
from typing import Optional, TextIO

HEADER = "vars,contraints,operation,elapsed_time"


class Chrono:
    """CSV op timer. Use ``start(rows, cols, op)`` / ``stop()`` around a
    blocking operation, or ``row(...)`` to record a pre-measured time."""

    def __init__(self, fh: TextIO, owns: bool = True):
        self._fh = fh
        self._owns = owns
        self._pending: Optional[float] = None
        fh.write(HEADER + "\n")

    # -- constructors matching the reference's two modes ------------------
    @classmethod
    def open_timestamped(cls, measures_dir: str) -> "Chrono":
        """times_<stamp>.txt (reference initCsv, chrono.cu:8-22)."""
        os.makedirs(measures_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d%H%M%S")
        path = os.path.join(measures_dir, f"times_{stamp}.txt")
        return cls(open(path, "w"))

    @classmethod
    def open_benchmark(cls, measures_dir: str, n_vars: int,
                       n_constraints: int) -> "Chrono":
        """benchmark_<vars>_<constraints>.txt (reference initCsvBenchmark,
        chrono.cu:24-33)."""
        os.makedirs(measures_dir, exist_ok=True)
        path = os.path.join(
            measures_dir, f"benchmark_{n_vars}_{n_constraints}.txt")
        return cls(open(path, "w"))

    # -- timing ------------------------------------------------------------
    def start(self, rows: int, cols: int, operation: str) -> None:
        # Flush the row prefix immediately: a long device call follows,
        # and a crash mid-call must leave an observable dangling row
        # (cli --resume-sweep keys off it), not an empty buffered file.
        self._fh.write(f"{rows},{cols},{operation},")
        self._fh.flush()
        self._pending = time.perf_counter()

    def stop(self) -> None:
        assert self._pending is not None, "stop() without start()"
        elapsed_us = (time.perf_counter() - self._pending) * 1e6
        self._pending = None
        self._fh.write(f"{elapsed_us:f}\n")
        self._fh.flush()

    def row(self, rows: int, cols: int, operation: str,
            seconds: float) -> None:
        """Record an already-measured duration (seconds -> µs)."""
        self._fh.write(f"{rows},{cols},{operation},{seconds * 1e6:f}\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "Chrono":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullChrono:
    """No-op stand-in when timing is disabled (the reference compiles the
    chrono calls out without -D TIMER, twoPhaseMethod.cu:5-7)."""

    def start(self, *a) -> None: ...
    def stop(self) -> None: ...
    def row(self, *a) -> None: ...
    def close(self) -> None: ...
    def __enter__(self): return self
    def __exit__(self, *exc): ...
