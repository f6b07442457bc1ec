"""bench.py: refuses to run without a GPU; with the device check
stubbed, the measurement path runs end to end on tiny CPU shapes and
prints the card line then ONE JSON line (its numbers are CPU numbers and
mean nothing here — the contract is what is tested)."""

import io
import json
import sys
from contextlib import redirect_stdout

import pytest

import bench
from simplex_tpu import device


def run_bench(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, buf.getvalue()


def test_refuses_cpu(capsys):
    assert bench.main(["--vars", "64", "--constraints", "16"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err


@pytest.mark.parametrize("extra", [
    [],                                  # default: blocked L=128, mixed
    ["--block", "0"],                    # sequential loop
    ["--dtype", "float64"],              # exact-parity dtype
])
def test_one_json_line_contract(extra, monkeypatch):
    fake = {"platform": "gpu", "kind": "stub", "count": 1}
    monkeypatch.setattr(device, "require_gpu", lambda: fake)
    monkeypatch.setattr(device, "card_info", lambda: "stub, 700.00 W")
    rc, out = run_bench(["--vars", "1200", "--constraints", "250",
                         "--iters", "16", "--repeats", "1"] + extra)
    assert rc == 0
    lines = [l for l in out.splitlines() if l.strip()]
    assert len(lines) == 2, lines
    assert lines[0].startswith("card: stub, 700.00 W")
    rec = json.loads(lines[1])
    assert {"metric", "value", "unit", "pivot_rule", "bytes_per_pivot",
            "copy_gbs", "floor_ms_per_pivot", "card", "device",
            "build_compile_s", "loop_compile_s"} <= set(rec)
    assert rec["device"] == fake and rec["card"] == "stub, 700.00 W"
    assert rec["unit"] == "ms/pivot" and rec["value"] > 0
    assert rec["pivot_rule"] in ("dantzig", "devex", "bland")
    assert rec["bytes_per_pivot"] > 0 and rec["floor_ms_per_pivot"] > 0


def test_bytes_per_pivot_from_shapes():
    """The window terms amortise over L; the eta terms grow with L."""
    r, m = 120_000, 10_112
    b128 = bench.bytes_per_pivot(r, m, 128, 4, 8)
    assert b128 == pytest.approx(
        3 * r * m * 4 / 128 + 128 * (r + m) * 4 + 2 * (r + m) * 4
        + 4 * r * 8 + 3 * m * 8)
    assert bench.bytes_per_pivot(r, m, 128, 4, 8, repriced=False) < b128


def test_trace_summary_without_device_planes(tmp_path):
    """A CPU trace has no device plane: busy/idle are None, not a
    number taken on the host."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    got = bench.trace_summary(str(tmp_path))
    assert got["busy_share"] is None and got["top_ops"] == []
