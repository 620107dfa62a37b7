"""``BENCHMARK.json`` against the benchmark's contract: names, units,
keys, and a file for every name the harness looks up."""

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in BENCH["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed, m
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert layer
        for m in layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_files_found_by_name(w):
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg = configs[w["config"]]
    assert cfg["file"].startswith("linbench/configs/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    traffic = json.loads((HERE / "traffic" / f"{w['name']}.json")
                         .read_text())
    assert (HERE / "entries" / f"{traffic['entry']}.py").exists()
    assert w["name"] == f"{w['config']}.{w['traffic']}"


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s":
            assert (HERE / "metrics" / f"{m['name']}.py").exists(), m


def test_file_names_are_names():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or ".pytest_cache" in p.parts:
            continue
        rel = str(p.relative_to(ROOT))
        assert PATH.match(rel), rel
