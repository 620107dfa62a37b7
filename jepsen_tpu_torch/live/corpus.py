"""The campaign-to-fuzz regression net: banked live histories.

Every completed campaign cell's history is **canonicalized** (process
renaming, event-rank erasure, value renaming: ``decompose/canonical.py``,
the verdict cache's own key space) and **appended to a pool** under
``<base>/corpus/``, which :func:`corpus_replay` runs through every
engine route (the direct device search, decomposed, bucketed,
streaming) and asserts that their verdicts agree.  A checker regression
that would misjudge a history a real fault once produced then fails a
replay, not a user.  The counterpart of the JAX package's
``live/corpus.py``; its replay is the JAX package's ``tools/fuzz.py
--corpus``, here a library function whose device routes run on the
card.

Pool layout: ``<base>/corpus/pool.jsonl``, one entry per line::

  {"id": <canonical sha256>, "family": ..., "nemesis": ...,
   "seeded": bool, "model": {"name": ..., "init"/"capacity": ...},
   "routes": "engines" | "queue", "valid": true|false|null,
   "ops": [...], "n_ops": N, "truncated": bool, "banked": <ts>}

``routes`` picks the replay: register and mutex histories ride the four
engine routes; multiset queue histories (no per-op model) replay
through the ``total_queue`` checker.  ``valid`` is the banked
expectation where it is unambiguous (the entry is the cell's whole
checked history); demuxed per-key entries leave it null and rely on the
routes agreeing.  An invalid entry carries its ``minimal`` repro,
shrunk at bank time.

Entries dedup by canonical id (re-running a campaign banks nothing
new), and the pool is bounded: past ``POOL_MAX`` the oldest entries
compact away.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import replace

from .. import independent, store
from ..history import NIL, Op, encode_ops
from ..obs import metrics as obs_metrics

log = logging.getLogger("jepsen")

POOL = "pool.jsonl"
#: ops per banked entry — longer histories bank a completed prefix
#: (marked truncated, expectation dropped); keeps every entry cheap
#: enough to replay through four engines
MAX_OPS = 240
#: pool bound: past it the oldest entries compact away
POOL_MAX = 512
#: bank-time ddmin budget (engine calls per banked invalid entry) —
#: shrinking happens once at bank time, so the repro every later
#: replay and every human reads is already minimal
SHRINK_MAX_CHECKS = 160
#: the engine re-check budget per ddmin candidate (model entries)
SHRINK_MAX_CONFIGS = 120_000
#: entries at or under this many ops are already a story — skip ddmin
SHRINK_SKIP_OPS = 10

_M_BANKED = obs_metrics.REGISTRY.counter(
    "jtpu_corpus_entries_total",
    "Histories banked into the fuzz corpus", ("family",))
_M_POOL = obs_metrics.REGISTRY.gauge(
    "jtpu_corpus_pool_size", "Current fuzz-corpus pool size")


def corpus_dir(base: str | None = None) -> str:
    """The pool's directory under ``base`` (default ``store.BASE``)."""
    return os.path.join(base or store.BASE, "corpus")


def _model_for(spec: dict):
    """Entry model dict -> ModelSpec (the replay's constructor)."""
    from ..models import cas_register, mutex, register, unordered_queue

    name = spec["name"]
    if name == "cas-register":
        return cas_register(int(spec.get("init", NIL)))
    if name == "register":
        return register(int(spec.get("init", 0)))
    if name == "mutex":
        return mutex()
    if name == "unordered-queue":
        return unordered_queue(int(spec.get("capacity", 16)))
    raise ValueError(f"corpus: unknown model {name!r}")


def entry_model(entry: dict):
    return _model_for(entry["model"])


def _model_spec(model) -> dict | None:
    """ModelSpec -> serializable entry model (register/mutex only —
    the families the engine routes can replay)."""
    if model is None:
        return None
    if model.name == "cas-register":
        return {"name": "cas-register", "init": int(model.init[0])}
    if model.name == "register":
        return {"name": "register", "init": int(model.init[0])}
    if model.name == "mutex":
        return {"name": "mutex"}
    return None


def _canon_op(op: Op) -> dict:
    """The banked op: semantics only — times, indices, and error
    strings are noise the engines never read (and the canonical id
    already erases)."""
    v = op.value
    if isinstance(v, tuple):
        v = list(v)
    return {"process": op.process, "type": op.type, "f": op.f,
            "value": v}


def _client_ops(history) -> list[Op]:
    return [op for op in (history or [])
            if isinstance(op.process, int)]


def _bounded(ops: list[Op]) -> tuple[list[Op], bool]:
    """Cap an entry at MAX_OPS, completing the prefix so it stays a
    well-formed history (pending invokes become crashed :info — a
    legal history whose verdict may differ from the full cell's, so
    truncated entries drop the banked expectation)."""
    from ..history import complete

    if len(ops) <= MAX_OPS:
        return ops, False
    return complete(ops[:MAX_OPS]), True


def _canonical_id(ops: list[Op], model) -> str:
    from ..decompose.canonical import canonical_key

    seq = encode_ops(ops, model.f_codes)
    return canonical_key(seq, model)


def _demux(ops: list[Op]) -> dict | None:
    """Split an independent-keyed history (values are [k v] tuples)
    into per-key sub-histories with raw values; None when the history
    isn't keyed."""
    if not any(independent.is_tuple(op.value) for op in ops):
        return None
    by_key: dict = {}
    for op in ops:
        v = op.value
        if not independent.is_tuple(v):
            continue  # un-keyed op in a keyed history: drop
        by_key.setdefault(v.key, []).append(replace(op, value=v.value))
    return by_key


def _queue_entry_ops(ops: list[Op]) -> list[Op] | None:
    """Queue histories bank in drain-expanded form (the shape
    ``total_queue`` checks); a crashed drain can't be expanded —
    skip."""
    from ..checker.basic import expand_queue_drain_ops

    try:
        return expand_queue_drain_ops(ops)
    except ValueError:
        return None


def entries_from_test(test: dict, outcome: dict) -> list[dict]:
    """The bankable entries of one completed cell."""
    ops = _client_ops(test.get("history"))
    if len(ops) < 4:
        return []
    model = test.get("model")
    meta = {"family": outcome.get("family"),
            "nemesis": outcome.get("nemesis"),
            "seeded": bool(outcome.get("seeded")),
            "banked": time.strftime("%Y%m%dT%H%M%S")}
    entries: list[dict] = []
    if model is None:
        # the queue families: multiset semantics, total_queue replay
        if not any(op.f in ("enqueue", "dequeue", "drain")
                   for op in ops):
            return []
        qops = _queue_entry_ops(ops)
        if qops is None:
            return []
        qops, truncated = _bounded(qops)
        from ..models import unordered_queue

        n_enq = sum(1 for op in qops
                    if op.f == "enqueue" and op.type == "invoke")
        m = unordered_queue(max(1, n_enq) + 1)
        entries.append({
            **meta, "routes": "queue",
            "model": {"name": "unordered-queue",
                      "capacity": max(1, n_enq) + 1},
            "valid": None if truncated else outcome.get("valid"),
            "ops": [_canon_op(o) for o in qops],
            "n_ops": len(qops), "truncated": truncated,
            "id": _canonical_id(qops, m)})
        attach_minimal(entries[-1], qops)
        return entries
    spec = _model_spec(model)
    if spec is None:
        return []
    demuxed = _demux(ops)
    groups = list(demuxed.values()) if demuxed else [ops]
    per_key = demuxed is not None and len(groups) > 1
    for sub in groups:
        if len(sub) < 4:
            continue
        sub, truncated = _bounded(sub)
        try:
            eid = _canonical_id(sub, model)
        except Exception:  # noqa: BLE001 — an unencodable history
            continue       # (exotic values) just doesn't bank
        entries.append({
            **meta, "routes": "engines", "model": spec,
            # a demuxed key's verdict is not the cell's: leave the
            # expectation open and rely on cross-route parity
            "valid": None if (truncated or per_key)
            else outcome.get("valid"),
            "ops": [_canon_op(o) for o in sub],
            "n_ops": len(sub), "truncated": truncated, "id": eid})
        attach_minimal(entries[-1], sub)
    return entries


# ---------------------------------------------------------------------------
# bank-time shrinking (corpus-driven ddmin)
# ---------------------------------------------------------------------------


def _still_invalid_check(entry: dict):
    """The per-route "still invalid" oracle the bank-time ddmin
    re-validates every removal against — the multiset checker for
    queue entries (deterministic), a bounded engine for model
    entries."""
    if entry.get("routes") == "queue":
        return lambda ops: replay_queue(ops).get("valid") is False
    model = entry_model(entry)

    def check(ops):
        from ..checker.seq import check_opseq

        seq = encode_ops(ops, model.f_codes)
        return check_opseq(seq, model, max_configs=SHRINK_MAX_CONFIGS,
                           lint=False).get("valid") is False

    return check


def attach_minimal(entry: dict, ops: list[Op]) -> None:
    """Bank-time corpus shrinking: ddmin a banked-invalid entry's
    history to a minimal repro, stored ALONGSIDE the full history
    (``entry["minimal"]``) so :func:`corpus_replay` can assert the
    minimal repro still reproduces the verdict and a human reads a 6-op
    story, not a 240-op dump.  Bounded budget; entries already
    at ``SHRINK_SKIP_OPS`` ops or fewer are left alone."""
    if entry.get("valid") is not False or len(ops) <= SHRINK_SKIP_OPS:
        return
    from ..analyze.shrink import shrink_invalid_events

    try:
        out = shrink_invalid_events(ops, _still_invalid_check(entry),
                                    max_checks=SHRINK_MAX_CHECKS)
    except Exception:  # noqa: BLE001 — shrinking never blocks banking
        log.warning("corpus: bank-time shrink failed", exc_info=True)
        return
    mops = out["ops"]
    if len(mops) >= len(ops) or len(mops) == 0:
        return  # nothing removed (or the re-check couldn't reproduce)
    entry["minimal"] = {
        "ops": [_canon_op(o) for o in mops],
        "n_ops": len(mops),
        "checks": out["checks"],
        "one_minimal": bool(out["minimal"]),
    }


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def load_pool(d: str) -> list[dict]:
    out: list[dict] = []
    try:
        with open(os.path.join(d, POOL)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    o = json.loads(line)
                except ValueError:
                    continue
                if isinstance(o, dict) and o.get("id"):
                    out.append(o)
    except OSError:
        pass
    return out


def _write_pool(d: str, entries: list[dict]) -> None:
    tmp = os.path.join(d, POOL + ".tmp")
    with open(tmp, "w") as f:
        for e in entries:
            f.write(json.dumps(e, default=str) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(d, POOL))


def bank(entries: list[dict], base: str | None = None) -> dict:
    """Append new entries (dedup by canonical id), compact past the
    pool bound; returns {"banked": n_new, "pool": total}."""
    d = corpus_dir(base)
    os.makedirs(d, exist_ok=True)
    pool = load_pool(d)
    seen = {e["id"] for e in pool}
    fresh = []
    for e in entries:
        if e["id"] in seen:
            continue
        seen.add(e["id"])
        fresh.append(e)
        _M_BANKED.inc(family=str(e.get("family")))
    if fresh:
        if len(pool) + len(fresh) > POOL_MAX:
            pool = (pool + fresh)[-POOL_MAX:]
            _write_pool(d, pool)
        else:
            with open(os.path.join(d, POOL), "a") as f:
                for e in fresh:
                    f.write(json.dumps(e, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())
            pool = pool + fresh
    _M_POOL.set(len(pool))
    return {"banked": len(fresh), "pool": len(pool)}


def bank_cell(test: dict, outcome: dict,
              base: str | None = None) -> dict | None:
    """Bank one completed campaign cell's history; never raises into
    the campaign (the caller guards)."""
    entries = entries_from_test(test, outcome)
    if not entries:
        return None
    out = bank(entries, base=base)
    log.info("corpus: banked %d/%d entr%s from %s×%s (pool %d)",
             out["banked"], len(entries),
             "y" if len(entries) == 1 else "ies",
             outcome.get("family"), outcome.get("nemesis"),
             out["pool"])
    return out


# ---------------------------------------------------------------------------
# the queue replay route
# ---------------------------------------------------------------------------


def replay_queue(ops: list[Op]) -> dict:
    """The multiset route: the already-drain-expanded history through
    ``total_queue`` — deterministic, so parity means equality with the
    banked verdict."""
    from ..checker.basic import total_queue

    return total_queue().check({}, ops)


# ---------------------------------------------------------------------------
# the replay through every route
# ---------------------------------------------------------------------------

#: the replay's work caps per entry, the JAX package's: the host
#: oracle's configs and the device routes' budget (an engine that runs
#: out answers "unknown", which agrees with everything)
REPLAY_ORACLE_CAP = 40_000
REPLAY_DEVICE_BUDGET = 120_000


def _replay_queue_entry(ops: list[Op]) -> tuple[dict, str | None]:
    """(verdicts, an audit failure or None) of a queue entry: the
    ``total_queue`` checker and the constraint compiler's multiset
    analysis, whose invalid evidence goes through the audit."""
    from ..analyze.audit import audit_events
    from ..analyze.constraints import analyze_queue_events

    verdicts = {"total-queue": replay_queue(ops)["valid"]}
    ca = analyze_queue_events(ops)
    verdicts["constraints"] = ca["valid"]
    if ca["valid"] is False and ca.get("evidence"):
        a = audit_events(ops, {"valid": False,
                               "queue_evidence": ca["evidence"]})
        if not a["ok"]:
            return verdicts, f"{[str(d) for d in a['diagnostics']]}"
    return verdicts, None


def _replay_engine_entry(ops: list[Op], model, device):
    """(verdicts, results) of an engine entry down every route: the
    direct device search, the decomposed engine, the bucketed batch, the
    streaming checker, the prepass where it decides, and the host oracle
    with DPOR on and off."""
    from ..analyze.hb import hb_dispose
    from ..checker import linearizable as lin
    from ..checker import seq as oracle
    from ..decompose.engine import check_opseq_decomposed
    from ..stream.checker import StreamChecker

    s = encode_ops(ops, model.f_codes)
    results = {
        "direct": lin.search_opseq(s, model, budget=REPLAY_DEVICE_BUDGET,
                                   device=device),
        "decomposed": check_opseq_decomposed(s, model, witness=True,
                                             device=device),
        "bucketed": lin.search_batch([s], model, bucket=True,
                                     budget=REPLAY_DEVICE_BUDGET,
                                     device=device)[0],
    }
    sc = StreamChecker(model, device=device)
    for op in ops:
        sc.ingest(op)
    results["streaming"] = sc.finalize()
    hbr = hb_dispose(s, model)
    if hbr is not None:
        # the prepass decided the history: its verdict joins the others
        # and its certificate is audited like theirs
        results["hb"] = hbr
    # DPOR must not move a verdict: the host oracle with the layer on
    # and off, the on side's certificate audited
    results["dpor"] = oracle.check_opseq(s, model,
                                         max_configs=REPLAY_ORACLE_CAP,
                                         dpor=True)
    verdicts = {k: r["valid"] for k, r in results.items()}
    verdicts["dpor-off"] = oracle.check_opseq(
        s, model, max_configs=REPLAY_ORACLE_CAP, dpor=False)["valid"]
    return s, verdicts, results


def _minimal_verdict(entry: dict):
    """The banked minimal repro's verdict on its entry's route."""
    from ..checker import seq as oracle

    mops = [Op.from_dict(d) for d in entry["minimal"]["ops"]]
    if entry.get("routes") == "queue":
        return replay_queue(mops)["valid"]
    m = entry_model(entry)
    return oracle.check_opseq(encode_ops(mops, m.f_codes), m,
                              max_configs=REPLAY_ORACLE_CAP)["valid"]


def corpus_replay(pool_dir: str, *, audit: bool = True,
                  max_entries: int | None = None, device="cuda") -> dict:
    """Replay a pool through every route, as the JAX package's
    ``tools/fuzz.py --corpus`` does.

    An engine entry (register or mutex model) runs the direct search
    (``search_opseq``), the decomposed engine, the bucketed batch
    (``search_batch(bucket=True)``) and a ``StreamChecker``, the device
    routes on ``device`` (a CUDA device without a card raises); the
    prepass's verdict joins them where it decides, and so does the host
    oracle's with DPOR on and off.  A queue entry runs ``total_queue``
    and the constraint compiler's multiset analysis.  Every decided
    verdict must agree, and agree with the banked one where there is
    one; a ``minimal`` repro must still reproduce; with ``audit`` every
    certificate must replay clean.  ``max_entries`` bounds the replay
    to the pool's first entries.

    Returns ``{"entries", "failures": [message...], "ok", "hb_decided",
    "unknowns", "engines": [{route: engine label} per engine entry],
    "seconds"}``; each failure is also logged."""
    from ..analyze.audit import audit as audit_fn
    from ..checker import linearizable as lin

    dev = lin._resolve_device(device)
    entries = load_pool(pool_dir)
    if max_entries is not None:
        entries = entries[:max_entries]
    t0 = time.perf_counter()
    failures: list[str] = []
    engines: list[dict] = []
    unknowns = hb_decided = 0

    def fail(msg: str) -> None:
        log.warning("corpus: %s", msg)
        failures.append(msg)

    for e in entries:
        label = (f"{e.get('family')}×{e.get('nemesis')}"
                 f"{' seeded' if e.get('seeded') else ''} "
                 f"[{e['id'][:12]}]")
        ops = [Op.from_dict(d) for d in e["ops"]]
        banked = e.get("valid")
        s = model = None
        results: dict = {}
        try:
            if e.get("routes") == "queue":
                verdicts, bad = _replay_queue_entry(ops)
                if bad is not None:
                    fail(f"AUDIT FAILURE {label}: {bad}")
                    continue
            else:
                model = entry_model(e)
                s, verdicts, results = _replay_engine_entry(ops, model, dev)
                hb_decided += "hb" in results
                engines.append({k: r.get("engine")
                                for k, r in results.items()})
        except Exception as exc:  # noqa: BLE001 — report, replay the rest
            fail(f"FAILURE {label}: replay crashed: "
                 f"{type(exc).__name__}: {exc}")
            continue
        decided = {k: v for k, v in verdicts.items() if v != "unknown"}
        unknowns += len(verdicts) - len(decided)
        if len(set(decided.values())) > 1:
            fail(f"DIVERGENCE {label}: {verdicts}")
            continue
        if banked is not None and decided \
                and set(decided.values()) != {banked}:
            fail(f"REGRESSION {label}: banked verdict {banked}, the "
                 f"engines now say {verdicts}")
            continue
        if e.get("minimal"):
            try:
                mv = _minimal_verdict(e)
            except Exception as exc:  # noqa: BLE001
                fail(f"MINIMAL FAILURE {label}: replay crashed: "
                     f"{type(exc).__name__}: {exc}")
                continue
            if mv is not False:
                fail(f"MINIMAL FAILURE {label}: the banked "
                     f"{e['minimal']['n_ops']}-op minimal repro no longer "
                     f"reproduces invalid (got {mv!r})")
                continue
        if audit:
            bad = []
            for route, r in results.items():
                a = audit_fn(s, model, r)
                if not a["ok"]:
                    bad += [f"[{route}] {d}" for d in a["diagnostics"]]
            if bad:
                fail(f"AUDIT FAILURE {label}: {bad}")
    out = {"entries": len(entries), "failures": failures,
           "ok": not failures, "hb_decided": hb_decided,
           "unknowns": unknowns, "engines": engines,
           "seconds": round(time.perf_counter() - t0, 3)}
    log.info("corpus: %d entr%s replayed through all routes, %s",
             len(entries), "y" if len(entries) == 1 else "ies",
             "CLEAN" if not failures else f"{len(failures)} FAILURE(S)")
    return out
