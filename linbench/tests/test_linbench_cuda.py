"""One short run of each cell on the card; skips without one.  Whether a
card is present is decided inside the test, never at import."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["etcd-register.quorum"])
def test_one_cell_on_the_card(cell):
    _need_card()
    out = subprocess.run(
        [sys.executable, "linbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["metrics"]["setup_s"]["value"] > 0
    assert r["metrics"]["ops_verified_per_s"]["value"] > 0


def test_without_a_card_a_run_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "linbench/run.py", "--workload",
         "etcd-register.quorum", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_alone_a_run_prints_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "linbench", tmp_path / "linbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "linbench/run.py", "--workload",
         "etcd-register.quorum", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
