"""The traffic generator: deterministic per seed, the same sizes for
every seed, valid by construction except for its stale reads, and at
full size the shape measured on the port's own suite."""

import json
from pathlib import Path

import gen
from reference import check as ref
from shape.etcdemo import shape

HERE = Path(__file__).resolve().parents[1]
LAT = [0.0015, 0.005, 0.01, 0.02, 0.06]
COMMON = {"n_values": 5, "mix": {"read": 1, "write": 1, "cas": 1},
          "nodes": 5, "latency_quantiles_s": LAT, "gap_overhead_s": 0.005,
          "partition_jitter_s": 0.03}
KEYED = {**COMMON, "keyed": True, "groups": 4, "threads": 10,
         "ops_per_key": 100, "rate": 10, "time_limit_s": 3,
         "timeout_s": 0.5, "partition_s": [1, 1], "stale_keys": 2}
SINGLE = {**COMMON, "keyed": False, "keys": 1, "threads": 8,
          "ops_per_key": 300, "rate": 100, "timeout_s": 0.3,
          "partition_s": [1, 0.5], "stale_checks": 2}


def test_same_seed_same_pool():
    assert gen.make_pool(2**31 + 11, KEYED, 2) == \
        gen.make_pool(2**31 + 11, KEYED, 2)
    assert gen.make_pool(5, SINGLE, 3) != gen.make_pool(6, SINGLE, 3)


def test_every_seed_the_same_sizes():
    for seed in (1, 2**33 + 5):
        pool = gen.make_pool(seed, SINGLE, 5)
        assert sorted(c["keys"][0]["stale"] for c in pool) == \
            [False, False, False, True, True]
        assert all(c["ops"] == 300 for c in pool)
        assert sum(1 for e in pool[0]["events"] if e[1] == "invoke") == 300
        keyed = gen.make_pool(seed, KEYED, 1)[0]
        assert sum(k["stale"] for k in keyed["keys"]) == 2
        assert all(k["ops"] <= 100 for k in keyed["keys"])


def test_keyed_events_form_a_jepsen_history():
    c = gen.make_pool(3, KEYED, 1)[0]
    nem = [e for e in c["events"] if e[0] == "nemesis"]
    assert nem and all(e[1] == "info" for e in nem)
    assert [e[2] for e in nem[:4]] == ["start", "start", "stop", "stop"]
    # each process alternates invoke and completion, and a crashed
    # process never comes back
    open_, gone = {}, set()
    for e in c["events"]:
        if e[0] == "nemesis":
            continue
        assert e[0] not in gone
        if e[1] == "invoke":
            assert e[0] not in open_
            open_[e[0]] = e
        else:
            assert open_.pop(e[0])[2] == e[2]
            if e[1] == "info":
                gone.add(e[0])
    assert not open_
    assert sum(k["crashes"] for k in c["keys"]) == len(gone) > 0


def test_valid_by_construction_except_stale_keys():
    for seed in (1, 2, 3):
        c = gen.make_pool(seed, KEYED, 1)[0]
        got = ref.check_keys(c["events"])
        for k in c["keys"]:
            assert got[k["key"]]["valid"] is (not k["stale"]), (seed, k)
        for s in gen.make_pool(seed, SINGLE, 3):
            want = not s["keys"][0]["stale"]
            assert ref.check(s["events"])["valid"] is want


def test_relabel_keeps_every_verdict_and_size():
    base = gen.make_pool(22, SINGLE, 4)
    for seed in (1, 2**32 + 9):
        pool = gen.relabel(base, seed, 5)
        assert sorted(len(c["events"]) for c in pool) == \
            sorted(len(c["events"]) for c in base)
        for c in pool:
            twin = next(b for b in base if b["keys"] == c["keys"]
                        and len(b["events"]) == len(c["events"]))
            assert ref.check(c["events"])["valid"] is \
                ref.check(twin["events"])["valid"] is \
                (not c["keys"][0]["stale"])
    assert gen.relabel(base, 1, 5) != gen.relabel(base, 2, 5)


def test_full_size_test_has_the_suites_shape():
    """The etcd cell's test against what the port's etcdemo suite made
    (``shape/etcdemo.py``: 159 keys, 15,629 ops, 0.03% crashed, about
    one op of the key pending at an invocation)."""
    config = json.loads((HERE / "configs" / "etcd-register.json")
                        .read_text())
    t = {**config, **gen.load_traffic("etcd-register.quorum")["params"]}
    got = shape(gen.make_pool(7, t, 1)[0]["events"])
    assert 150 <= got["keys"] <= 170
    assert 14_800 <= got["ops"] <= 16_500
    assert got["info_share"] < 0.002
    assert 0.8 <= got["pending_at_invoke"]["all"] <= 1.6
