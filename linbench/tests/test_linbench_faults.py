"""A run driven on the CPU at a small size, past the look for a chip,
with the timed path broken underneath (``faults.py``): ``correct`` has
to come out false for every fault a cell can have, and true with none.
The control (the reference without the real-time order, in the
program's place) has to come out not correct too.

``zookeeper-register.partitioned`` is not in ``BENCHMARK.json``; its
runs here read a copy of the manifest that lists it."""

import json
from pathlib import Path

import pytest

import control
import faults
import run

ROOT = Path(__file__).resolve().parents[2]
ETCD = "etcd-register.quorum"
ZK = "zookeeper-register.partitioned"
SMALL = {ETCD: {"time_limit_s": 3, "partition_s": [1, 1], "timeout_s": 0.5,
                "stale_keys": 2, "pool": 1, "extra": 1, "warmup": []},
         ZK: {"ops_per_key": 120, "stale_checks": 1, "pool": 1, "extra": 1,
              "warmup": []}}


def small_run(cell, seed=2**32 + 17):
    args = run.parse_args(["--workload", cell, "--seed", str(seed),
                           "--seconds", "0.01", "--trace", "0"])
    return run.run(args, SMALL[cell])


def with_zookeeper(path: Path) -> Path:
    """``BENCHMARK.json`` with the zookeeper cell added, at ``path``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "zookeeper-register", "source": "jepsen.zookeeper",
        "file": "linbench/configs/zookeeper-register.json", "reduced": [],
        "why": "a single register"})
    bench["workloads"].append({
        "name": ZK, "config": "zookeeper-register",
        "traffic": "partitioned", "chips": 1, "why": "the race"})
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run, "BENCH",
                        with_zookeeper(tmp_path / "BENCHMARK.json"))


@pytest.mark.parametrize("cell", [ETCD, ZK])
def test_sound_run_is_correct(cell):
    r = small_run(cell)
    assert r["correct"] is True and r["failed"] == 0
    got = {k: v["value"] for k, v in r["compared"].items()}
    assert got["compared_checks"] == 2 and got["invalid_keys"] >= 1


def test_the_batch_calls_the_stale_keys_invalid_on_its_device_route():
    got = small_run(ETCD)["compared"]
    assert got["batch_invalid_on_device"]["value"] == \
        got["invalid_keys"]["value"] == 4


CASES = [(ETCD, "verdict_negated"), (ZK, "verdict_negated"),
         (ETCD, "half_batch"), (ETCD, "ladder_unchanged"),
         (ETCD, "ladder_all_valid")]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_makes_run_incorrect(cell, fault, monkeypatch):
    from jepsen_tpu_torch.checker import linearizable as lin

    # plant the fault where faults.plant does, undone after the test
    target, make = faults.FAULTS[fault]
    owner, attr = (lin.Linearizable, target.split(".")[1]) \
        if "." in target else (lin, target)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    r = small_run(cell)
    assert r["correct"] is False and r["failed"] >= 1


@pytest.mark.parametrize("cell", [ETCD, ZK])
def test_control_is_not_correct(cell):
    sizes = dict(SMALL[cell], pool=4, stale_checks=2)
    assert control.control_run(cell, 2**31 + 3, sizes)["correct"] is False
