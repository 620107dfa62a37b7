"""The port's corpus (``live/corpus.py``) and event-level shrinking
against the JAX package's: the counterparts of ``tests/test_corpus.py``'s
13 cases, each banking the same cells in both packages and comparing
the pools entry for entry (canonical ids, banked expectations, the
``minimal`` repros and their ddmin checks; only the bank timestamp may
differ), and the replay through every route (``corpus_replay``, the
JAX package's ``tools/fuzz.py --corpus``) with its teeth: an injected
divergence, a banked-verdict regression and a minimal repro that no
longer reproduces each fail it.  Then ``ddmin_list`` and
``shrink_invalid_events`` on seeded inputs.  The port replays with
``device="cpu"``."""

import json
import os
import random
import sys

import pytest
import torch

from jepsen_tpu import independent as jind
from jepsen_tpu import synth as js
from jepsen_tpu.analyze import shrink as jshrink
from jepsen_tpu.history import invoke_op, ok_op
from jepsen_tpu.live import corpus as jcorpus
from jepsen_tpu.models import cas_register as j_cas
from jepsen_tpu.models import mutex as j_mutex
from jepsen_tpu.models import register as j_register
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.analyze import dpor as tdpor
from jepsen_tpu_torch.analyze import shrink as tshrink
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.live import corpus as tcorpus
from jepsen_tpu_torch.obs.metrics import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import fuzz as fuzz_tool  # noqa: E402  (the JAX package's replay)

#: the JAX package's knobs its replay and shrink read; unset, each is on
KNOBS = ("JEPSEN_TPU_HB", "JEPSEN_TPU_DPOR", "JEPSEN_TPU_LINT",
         "JEPSEN_TPU_AUDIT", "JEPSEN_TPU_BATCH_BUCKETS")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    torch.set_num_threads(1)
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _port_ops(h):
    return [Op.from_dict(op.to_dict()) for op in h]


def _port_model(model):
    """The port's counterpart of a JAX package model (or None)."""
    if model is None:
        return None
    if model.name == "cas-register":
        return tm.cas_register(int(model.init[0]))
    if model.name == "register":
        return tm.register(int(model.init[0]))
    return tm.mutex()


class Pools:
    """One directory per package under ``tmp``; every cell banks into
    both."""

    def __init__(self, tmp):
        self.j, self.t = str(tmp / "jax"), str(tmp / "torch")

    def bank_cell(self, model, h, outcome, *, port_h=None):
        a = jcorpus.bank_cell({"model": model, "history": h}, outcome,
                              base=self.j)
        b = tcorpus.bank_cell(
            {"model": _port_model(model),
             "history": _port_ops(h) if port_h is None else port_h},
            outcome, base=self.t)
        assert a == b
        return b

    def pools(self):
        return (jcorpus.load_pool(jcorpus.corpus_dir(self.j)),
                tcorpus.load_pool(tcorpus.corpus_dir(self.t)))

    def assert_equal(self):
        jp, tp = self.pools()
        assert _strip(tp) == _strip(jp)
        return tp

    def replay(self):
        """(the JAX package's exit code, the port's replay)."""
        rc = fuzz_tool.corpus_replay(jcorpus.corpus_dir(self.j))
        out = tcorpus.corpus_replay(tcorpus.corpus_dir(self.t),
                                    device="cpu")
        return rc, out

    def write_port_pool(self, entries):
        with open(os.path.join(tcorpus.corpus_dir(self.t),
                               tcorpus.POOL), "w") as f:
            for e in entries:
                f.write(json.dumps(e) + "\n")


def _strip(pool):
    return [{k: v for k, v in e.items() if k != "banked"} for e in pool]


def _bank_register(pools, rng, *, n_ops=26, crash_p=0.1, valid=True,
                   corrupt=False, family="kv", nemesis="kill-restart"):
    h = js.sim_register_history(rng, 4, n_ops, crash_p=crash_p, cas=True)
    if corrupt:
        h = js.mutate(rng, h)
    return pools.bank_cell(j_cas(), h, {"family": family,
                                        "nemesis": nemesis,
                                        "valid": valid}), h


def test_bank_dedup_and_pool_metrics(tmp_path):
    pools = Pools(tmp_path)
    out, _h = _bank_register(pools, random.Random(0))
    assert out == {"banked": 1, "pool": 1}
    out2, h = _bank_register(pools, random.Random(0))
    assert out2 == {"banked": 0, "pool": 1}
    # a process-renamed copy is the same canonical shape
    from dataclasses import replace

    renamed = [replace(op, process=op.process + 10) for op in
               _port_ops(h)]
    entries = tcorpus.entries_from_test(
        {"model": tm.cas_register(), "history": renamed},
        {"family": "kv", "nemesis": "x", "valid": True})
    assert tcorpus.bank(entries, base=pools.t)["banked"] == 0
    assert REGISTRY.get("jtpu_corpus_pool_size").total() >= 1
    pools.assert_equal()


def test_bank_truncates_long_histories_to_wellformed_prefix():
    from jepsen_tpu_torch.history import pair_index

    h = js.sim_register_history(random.Random(1), 4, 400, crash_p=0.05,
                                cas=True)
    assert len(h) > tcorpus.MAX_OPS
    outcome = {"family": "kv", "nemesis": "pause", "valid": True}
    want = jcorpus.entries_from_test({"model": j_cas(), "history": h},
                                     outcome)
    got = tcorpus.entries_from_test(
        {"model": tm.cas_register(), "history": _port_ops(h)}, outcome)
    assert _strip(got) == _strip(want)
    [e] = got
    assert e["truncated"] is True and e["valid"] is None
    assert e["n_ops"] <= tcorpus.MAX_OPS
    pair_index([Op.from_dict(d) for d in e["ops"]])


def test_bank_demuxes_independent_keys(tmp_path):
    rng = random.Random(2)
    h0 = js.sim_register_history(rng, 2, 12, crash_p=0.0, cas=True)
    h1 = js.sim_register_history(rng, 2, 12, crash_p=0.0, cas=True)

    def keyed(tuple_, op_cls):
        return [op_cls(process=op.process + 4 * k, type=op.type, f=op.f,
                       value=tuple_(k, op.value), time=op.time)
                for k, h in ((0, h0), (1, h1)) for op in h]

    from jepsen_tpu.history import Op as JOp

    pools = Pools(tmp_path)
    pools.bank_cell(j_cas(), keyed(jind.tuple_, JOp),
                    {"family": "register", "nemesis": "pause",
                     "valid": True}, port_h=keyed(tind.tuple_, Op))
    pool = pools.assert_equal()
    assert len(pool) == 2
    for e in pool:
        assert e["routes"] == "engines" and e["valid"] is None
        assert not any(isinstance(o.value, dict) for o in
                       (Op.from_dict(d) for d in e["ops"]))


def test_bank_queue_entries_expand_drains(tmp_path):
    h = [invoke_op(0, "enqueue", 1), ok_op(0, "enqueue", 1),
         invoke_op(1, "enqueue", 2), ok_op(1, "enqueue", 2),
         invoke_op(0, "dequeue"), ok_op(0, "dequeue", 1),
         invoke_op(1, "drain"), ok_op(1, "drain", [2])]
    pools = Pools(tmp_path)
    out = pools.bank_cell(None, h, {"family": "queue",
                                    "nemesis": "kill-restart",
                                    "valid": True})
    assert out == {"banked": 1, "pool": 1}
    [e] = pools.assert_equal()
    assert e["routes"] == "queue" and e["valid"] is True
    assert not any(d["f"] == "drain" for d in e["ops"])
    r = tcorpus.replay_queue([Op.from_dict(d) for d in e["ops"]])
    assert r["valid"] is True


def test_corpus_replay_parity_on_bounded_seeded_pool(tmp_path):
    """A seeded pool (valid, corrupted, mutex and queue entries, crashed
    ops included) replays through every route in both packages, clean,
    and the port names each route's engine."""
    pools = Pools(tmp_path)
    rng = random.Random(7)
    _bank_register(pools, rng, valid=True)
    _bank_register(pools, rng, corrupt=True, valid=None,
                   nemesis="partition")
    pools.bank_cell(j_mutex(), js.sim_mutex_history(rng, 20, 3,
                                                    crash_p=0.1),
                    {"family": "lock", "nemesis": "pause", "valid": True})
    pools.bank_cell(None, [invoke_op(0, "enqueue", 5),
                           ok_op(0, "enqueue", 5), invoke_op(0, "drain"),
                           ok_op(0, "drain", [5])],
                    {"family": "replicated-queue", "nemesis": "link-bridge",
                     "valid": True})
    assert len(pools.assert_equal()) >= 4
    rc, out = pools.replay()
    assert rc == 0 and out["ok"] and out["failures"] == []
    assert out["entries"] >= 4 and len(out["engines"]) == 3
    assert {"direct", "decomposed", "bucketed", "streaming",
            "dpor"} <= set(out["engines"][0])


def test_corpus_replay_runs_hb_leg_on_decidable_entries(tmp_path):
    from jepsen_tpu_torch.analyze.hb import hb_dispose
    from jepsen_tpu_torch.history import encode_ops

    rng = random.Random(31)
    good = js.register_history(rng, n_ops=20, n_procs=3, overlap=3,
                               crash_p=0.0, cas=False, unique_writes=True)
    bad = js.swap_read_values(random.Random(32), js.register_history(
        random.Random(33), n_ops=20, n_procs=3, overlap=3, crash_p=0.0,
        cas=False, unique_writes=True))
    pools = Pools(tmp_path)
    pools.bank_cell(j_register(0), good, {"family": "register",
                                          "nemesis": "none", "valid": True})
    pools.bank_cell(j_register(0), bad, {"family": "register",
                                         "nemesis": "none", "valid": False})
    pool = pools.assert_equal()
    assert len(pool) == 2
    decided = []
    for e in pool:
        m = tcorpus.entry_model(e)
        r = hb_dispose(encode_ops([Op.from_dict(x) for x in e["ops"]],
                                  m.f_codes), m)
        assert r is not None
        decided.append(r)
    assert {r["valid"] for r in decided} == {True, False}
    rc, out = pools.replay()
    assert rc == 0 and out["ok"] and out["hb_decided"] == 2


def test_corpus_replay_runs_dpor_leg_with_teeth(tmp_path, monkeypatch):
    """The DPOR leg: a sabotaged sleep-set layer (every sibling asleep)
    flips the valid entry's host verdict, and the replay catches the
    divergence."""
    pools = Pools(tmp_path)
    rng = random.Random(61)
    _bank_register(pools, rng, n_ops=20, crash_p=0.0, valid=True)
    _bank_register(pools, rng, n_ops=20, crash_p=0.1, valid=None,
                   corrupt=True, nemesis="partition")
    pools.assert_equal()
    rc, out = pools.replay()
    assert rc == 0 and out["ok"]
    monkeypatch.setattr(tdpor.SleepSets, "child_sleep",
                        lambda self, state, taken, base: (1 << 4096) - 1)
    out = tcorpus.corpus_replay(tcorpus.corpus_dir(pools.t), device="cpu")
    assert not out["ok"]
    assert any(f.startswith("DIVERGENCE") for f in out["failures"])


def test_corpus_replay_catches_banked_verdict_regression(tmp_path):
    pools = Pools(tmp_path)
    _bank_register(pools, random.Random(9), n_ops=16, crash_p=0.0,
                   valid=True)
    [entry] = pools.assert_equal()
    entry["valid"] = False  # claim the engines should say invalid
    pools.write_port_pool([entry])
    out = tcorpus.corpus_replay(tcorpus.corpus_dir(pools.t), device="cpu")
    assert not out["ok"]
    assert [f.split()[0] for f in out["failures"]] == ["REGRESSION"]


def test_queue_replay_catches_lost_enqueue(tmp_path):
    h = [invoke_op(0, "enqueue", 1), ok_op(0, "enqueue", 1),
         invoke_op(1, "enqueue", 2), ok_op(1, "enqueue", 2),
         invoke_op(0, "drain"), ok_op(0, "drain", [2])]  # 1 lost
    pools = Pools(tmp_path)
    out = pools.bank_cell(None, h, {"family": "replicated-queue",
                                    "nemesis": "link-bridge",
                                    "seeded": True, "valid": False})
    assert out["banked"] == 1
    pools.assert_equal()
    rc, rep = pools.replay()
    assert rc == 0 and rep["ok"]  # invalid == banked


def _lost_queue_history(n_jobs=14, lost=(3,)):
    h = []
    for j in range(n_jobs):
        h += [invoke_op(j % 3, "enqueue", j), ok_op(j % 3, "enqueue", j)]
    return h + [invoke_op(0, "drain", None),
                ok_op(0, "drain", [j for j in range(n_jobs)
                                   if j not in lost])]


def test_bank_time_ddmin_attaches_minimal_repro(tmp_path):
    pools = Pools(tmp_path)
    out = pools.bank_cell(None, _lost_queue_history(),
                          {"family": "queue", "nemesis": "link-bridge",
                           "valid": False})
    assert out["banked"] == 1
    [entry] = pools.assert_equal()
    mi = entry["minimal"]
    assert mi["n_ops"] < entry["n_ops"] and mi["n_ops"] <= 6
    mops = [Op.from_dict(d) for d in mi["ops"]]
    assert tcorpus.replay_queue(mops)["valid"] is False


def test_bank_time_ddmin_skips_small_and_valid_entries(tmp_path):
    pools = Pools(tmp_path)
    pools.bank_cell(None, [invoke_op(0, "enqueue", 1),
                           ok_op(0, "enqueue", 1),
                           invoke_op(0, "drain", None),
                           ok_op(0, "drain", [])],
                    {"family": "queue", "nemesis": "x", "valid": False})
    pools.bank_cell(None, _lost_queue_history(lost=()),
                    {"family": "queue", "nemesis": "x", "valid": True})
    pool = pools.assert_equal()
    assert len(pool) == 2 and all("minimal" not in e for e in pool)


def test_bank_time_ddmin_engine_route(tmp_path):
    from jepsen_tpu_torch.checker.seq import check_opseq
    from jepsen_tpu_torch.history import encode_ops

    rng = random.Random(7)
    h = js.register_history(rng, n_ops=24, n_procs=3, cas=False,
                            unique_writes=True)
    h = js.corrupt_read(rng, h, at=0.5)
    pools = Pools(tmp_path)
    out = pools.bank_cell(j_register(0), h, {"family": "kv",
                                             "nemesis": "kill-restart",
                                             "valid": False})
    assert out["banked"] == 1
    [entry] = pools.assert_equal()
    mi = entry["minimal"]
    assert mi["n_ops"] < entry["n_ops"] and mi["checks"] > 0
    mops = [Op.from_dict(d) for d in mi["ops"]]
    m = tm.register(0)
    assert check_opseq(encode_ops(mops, m.f_codes), m,
                       max_configs=200_000)["valid"] is False


def test_corpus_replay_asserts_minimal_repro(tmp_path):
    pools = Pools(tmp_path)
    pools.bank_cell(None, _lost_queue_history(),
                    {"family": "queue", "nemesis": "link-bridge",
                     "valid": False})
    pools.assert_equal()
    rc, out = pools.replay()
    assert rc == 0 and out["ok"]
    pool = tcorpus.load_pool(tcorpus.corpus_dir(pools.t))
    # tamper: make the stored minimal repro a valid history
    pool[0]["minimal"]["ops"] = [
        {"process": 0, "type": "invoke", "f": "enqueue", "value": 1},
        {"process": 0, "type": "ok", "f": "enqueue", "value": 1},
        {"process": 1, "type": "invoke", "f": "dequeue", "value": None},
        {"process": 1, "type": "ok", "f": "dequeue", "value": 1},
    ]
    pools.write_port_pool(pool)
    out = tcorpus.corpus_replay(tcorpus.corpus_dir(pools.t), device="cpu")
    assert [f.split()[:2] for f in out["failures"]] == [["MINIMAL",
                                                         "FAILURE"]]


def test_pool_bound_compacts_the_oldest(tmp_path, monkeypatch):
    monkeypatch.setattr(jcorpus, "POOL_MAX", 3)
    monkeypatch.setattr(tcorpus, "POOL_MAX", 3)
    pools = Pools(tmp_path)
    for seed in range(5):
        _bank_register(pools, random.Random(100 + seed), n_ops=12,
                       crash_p=0.0)
    pool = pools.assert_equal()
    assert len(pool) == 3
    assert REGISTRY.get("jtpu_corpus_pool_size").total() == 3


def test_replay_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcorpus.corpus_replay(str(tmp_path))


# ---------------------------------------------------------------------------
# event-level shrinking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_checks", [200, 7])
def test_ddmin_list_matches_reference(seed, max_checks):
    """A seeded list and a failure that needs a seeded subset of it (a
    predicate that raises on some candidates counts as passing)."""
    rng = random.Random(seed)
    items = list(range(rng.randrange(0, 40)))
    need = set(rng.sample(items, min(len(items), rng.randrange(0, 4))))

    def fails(sub):
        if len(sub) == 5 and seed % 2:
            raise ValueError("a candidate that crashes")
        return need <= set(sub)

    want = jshrink.ddmin_list(items, fails, max_checks=max_checks)
    got = tshrink.ddmin_list(items, fails, max_checks=max_checks)
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_shrink_invalid_events_matches_reference(seed):
    """A corrupted register history, judged invalid by the JAX
    package's bounded oracle in both shrinks: the same units, checks and
    minimal events."""
    from jepsen_tpu.checker.seq import check_opseq
    from jepsen_tpu.history import Op as JOp
    from jepsen_tpu.history import encode_ops

    rng = random.Random(seed)
    h = js.sim_register_history(rng, 3, 24, crash_p=0.1, cas=True)
    h = js.mutate(rng, h)
    m = j_cas()

    def still_invalid(ops):
        seq = encode_ops([JOp.from_dict(o.to_dict()) for o in ops],
                         m.f_codes)
        return check_opseq(seq, m, max_configs=50_000,
                           lint=False)["valid"] is False

    want = jshrink.shrink_invalid_events(h, still_invalid, max_checks=60)
    got = tshrink.shrink_invalid_events(_port_ops(h), still_invalid,
                                        max_checks=60)
    assert [o.to_dict() for o in got.pop("ops")] == \
        [o.to_dict() for o in want.pop("ops")]
    assert got == want
