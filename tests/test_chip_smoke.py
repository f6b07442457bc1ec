"""chip_smoke.py's phases at tiny sizes on the CPU (the card runs them at
full width), and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
import simplex_tpu as st

SEED_256 = os.path.join(chip_smoke.EXAMPLES, "benchmark_problems",
                        "random_256_256.txt")


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "no GPU" in err and "'cpu'" in err


def test_refuses_without_the_repo(tmp_path):
    """Alone in a directory it cannot import the package: non-zero exit
    and no result line."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_golden(capsys):
    chip_smoke.phase_golden()
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["ok"] and len(rec["checks"]) == 6


def test_phase_flagship_small():
    chip_smoke.phase_flagship(st.read_random_problem(SEED_256), "256x256")


def test_phase_northstar_tiny(capsys):
    chip_smoke.phase_northstar(400, 60, cap=32, block=8)
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    for key, dev in rec["max_rel_deviation"].items():
        assert dev < chip_smoke.NORTHSTAR_TOL[key]


def test_phase_northstar_rejects_early_finish():
    """A walk that ends before the cap is not the capped production
    loop the phase claims to check."""
    with pytest.raises(chip_smoke.CheckFailed, match="cap"):
        chip_smoke.phase_northstar(40, 8, cap=4096, block=8)


def test_phase_batch_tiny():
    chip_smoke.phase_batch(4, 40, 12, oracle_lanes=2)


def test_phase_cli(tmp_path):
    chip_smoke.phase_cli(str(tmp_path), seed_file=SEED_256)


def test_four_card_phases_on_cpu_mesh():
    chip_smoke.phase_four_cards_sharded(
        st.generate_random_problem(64, 20, 5, 1.0, 100.0), n_devices=4)
    chip_smoke.phase_four_cards_fleet(8, 40, 12, n_devices=4)


def test_check_raises_and_records():
    checks = []
    chip_smoke.check(True, "fine", checks)
    assert checks == ["fine"]
    with pytest.raises(chip_smoke.CheckFailed, match="broken"):
        chip_smoke.check(False, "broken", checks)
