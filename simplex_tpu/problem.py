"""Problem model and file I/O.

Equivalent of the reference's L1 problem layer
(reference: include/problem.h:10-26, src/problem.cu:20-47,128-139,141-181).
Problems are dense canonical-form LPs::

    max  c @ x   subject to   A @ x <= b,  x >= 0

The reference stores A column-major by variable (problem.cu:41); here A is a
plain (constraints, vars) row-major NumPy array — layout is an internal
detail that the tableau builder owns (see tableau.py).

Two file formats, byte-compatible with the reference:

* **dense format** (problem.cu:20-47, README.MD:46-55)::

      n m
      c_1 ... c_n
      a_11 ... a_1n b_1
      ...
      a_m1 ... a_mn b_m

* **seed format** (problem.cu:128-139)::

      n m seed min max

  which regenerates the instance with the seeded random generator
  (generator.py).
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import TextIO, Union

import numpy as np

PathOrFile = Union[str, os.PathLike, TextIO]


@dataclasses.dataclass
class Problem:
    """A dense canonical-form LP (reference problem_t, problem.h:10-26)."""

    #: (constraints, vars) constraint matrix A.
    A: np.ndarray
    #: (constraints,) right-hand side b (reference knownTermsVector).
    b: np.ndarray
    #: (vars,) objective coefficients c (reference objectiveFunction).
    c: np.ndarray

    def __post_init__(self):
        self.A = np.ascontiguousarray(self.A, dtype=np.float64)
        self.b = np.ascontiguousarray(self.b, dtype=np.float64)
        self.c = np.ascontiguousarray(self.c, dtype=np.float64)
        m, n = self.A.shape
        if self.b.shape != (m,):
            raise ValueError(f"b has shape {self.b.shape}, expected ({m},)")
        if self.c.shape != (n,):
            raise ValueError(f"c has shape {self.c.shape}, expected ({n},)")

    @property
    def vars(self) -> int:
        return self.A.shape[1]

    @property
    def constraints(self) -> int:
        return self.A.shape[0]

    def __repr__(self) -> str:
        return (f"Problem(vars={self.vars}, constraints={self.constraints}, "
                f"dtype={self.A.dtype})")


def _opened(f: PathOrFile, mode: str):
    if hasattr(f, "read") or hasattr(f, "write"):
        return f, False
    return open(f, mode), True


def read_problem(f: PathOrFile) -> Problem:
    """Parse the dense text format (reference readProblemFromFile,
    problem.cu:20-47): whitespace-separated numbers, first ``n m``, then the
    n objective coefficients, then m rows of n matrix entries followed by
    the row's right-hand side."""
    fh, close = _opened(f, "r")
    try:
        tokens = fh.read().split()
    finally:
        if close:
            fh.close()
    if len(tokens) < 2:
        raise ValueError("problem file too short")
    n, m = int(tokens[0]), int(tokens[1])
    need = 2 + n + m * (n + 1)
    if len(tokens) < need:
        raise ValueError(
            f"problem file has {len(tokens)} numbers, expected {need} "
            f"for n={n}, m={m}")
    body = np.asarray(tokens[2:need], dtype=np.float64)
    c = body[:n]
    rows = body[n:].reshape(m, n + 1)
    return Problem(A=rows[:, :n], b=rows[:, n], c=c)


def write_problem(f: PathOrFile, problem: Problem) -> None:
    """Write the dense text format (inverse of read_problem)."""
    fh, close = _opened(f, "w")
    try:
        fh.write(f"{problem.vars} {problem.constraints}\n")
        fh.write(" ".join(repr(float(v)) for v in problem.c) + "\n")
        for i in range(problem.constraints):
            row = " ".join(repr(float(v)) for v in problem.A[i])
            fh.write(f"{row} {float(problem.b[i])!r}\n")
    finally:
        if close:
            fh.close()


def read_seed_file(f: PathOrFile) -> tuple[int, int, int, float, float]:
    """Parse a seed file ``n m seed min max`` (reference
    readRandomProblemFromFile, problem.cu:128-139)."""
    fh, close = _opened(f, "r")
    try:
        tokens = fh.read().split()
    finally:
        if close:
            fh.close()
    if len(tokens) < 5:
        raise ValueError("seed file needs 5 numbers: n m seed min max")
    n, m, seed = int(tokens[0]), int(tokens[1]), int(tokens[2])
    lo, hi = float(tokens[3]), float(tokens[4])
    return n, m, seed, lo, hi


def read_random_problem(f: PathOrFile) -> Problem:
    """Regenerate a problem from a seed file (problem.cu:128-139)."""
    from .generator import generate_random_problem

    n, m, seed, lo, hi = read_seed_file(f)
    return generate_random_problem(n, m, seed, lo, hi)


def write_seed_file(f: PathOrFile, n: int, m: int, seed: int,
                    lo: float, hi: float) -> None:
    """Write a seed file (reference saveRandomInput, main.cu:141-153)."""
    fh, close = _opened(f, "w")
    try:
        def fmt(v: float) -> str:
            return str(int(v)) if float(v).is_integer() else repr(float(v))
        fh.write(f"{n} {m} {seed} {fmt(lo)} {fmt(hi)}")
    finally:
        if close:
            fh.close()


def format_problem(problem: Problem) -> str:
    """Human-readable rendering (reference printProblemToStream,
    problem.cu:141-181)::

        max + 8.00 X1 + 10.00 X2 ...
        subject to
        + 1.00 X1 + 3.00 X2 ... <= 10.00
    """
    out = io.StringIO()

    def term(v: float, j: int) -> str:
        sign = "+" if v >= 0 else "-"
        return f"{sign} {abs(v):.2f} X{j + 1} "

    out.write("max ")
    for j, v in enumerate(problem.c):
        out.write(term(float(v), j))
    out.write("\nsubject to \n")
    for i in range(problem.constraints):
        for j in range(problem.vars):
            out.write(term(float(problem.A[i, j]), j))
        out.write(f"<= {float(problem.b[i]):.2f}\n")
    return out.getvalue()
