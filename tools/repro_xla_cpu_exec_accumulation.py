"""Standalone reproducer for the XLA:CPU executable-accumulation crash.

Background: with ~300 XLA:CPU executables alive in one process — the
shape the test suite reaches naturally, many of them while-loops — the
process segfaulted nondeterministically in late-suite modules. tests/conftest.py works around it with an autouse
module-scoped ``jax.clear_caches()``; this tool gives the mitigation a
DOCUMENTED trigger condition by compiling distinct while-loop programs
in a child process until it dies or survives the budget.

Usage:
    python tools/repro_xla_cpu_exec_accumulation.py [--budget 600]
        [--clear-every 0]

The parent forks a child per configuration and reports the executable
count at death (or survival). ``--clear-every K`` inserts the
mitigation every K compiles — with it, the child must survive any
budget; without it, death before the budget reproduces the crash.
Runs on CPU regardless of the session backend.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax import lax

budget = int(sys.argv[1])
clear_every = int(sys.argv[2])

def make(i):
    w = 128 + 8 * (i % 64)

    def f(x):
        def body(s):
            j, acc = s
            return j + 1, acc * 1.0001 + x

        return lax.while_loop(lambda s: s[0] < jnp.int32(4 + i % 7),
                              body,
                              (jnp.int32(0), x))[1]

    return jax.jit(f, static_argnums=()), jnp.ones((8, w), jnp.float32)

for i in range(budget):
    f, x = make(i)
    float(f(x).ravel()[0])
    if clear_every and (i + 1) % clear_every == 0:
        jax.clear_caches()
    if (i + 1) % 50 == 0:
        print(f"alive at {i + 1} executables", flush=True)
print(f"SURVIVED {budget}", flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=600)
    ap.add_argument("--clear-every", type=int, default=0,
                    help="insert jax.clear_caches() every K compiles "
                         "(the conftest mitigation); 0 = never")
    args = ap.parse_args()

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(args.budget),
         str(args.clear_every)],
        env=env, capture_output=True, text=True)
    tail = proc.stdout.strip().splitlines()
    last = tail[-1] if tail else "(no output)"
    if proc.returncode == 0:
        print(f"child OK: {last}")
    else:
        print(f"child DIED rc={proc.returncode} "
              f"(signal {-proc.returncode if proc.returncode < 0 else '-'}) "
              f"after: {last}")
        if proc.stderr:
            print(proc.stderr[-800:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
