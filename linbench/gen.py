"""The benchmark's traffic: Jepsen register histories made from a seed.

One general generator reads a traffic file (``traffic/<cell>.json``) and
makes the cell's pool of checks.  It acts out, in simulated time, what a
Jepsen register test does against a cluster, as the port's own suites
run it (``suites/etcdemo.py``, measured by ``shape/etcdemo.py``):

* ``groups`` groups of ``threads`` worker threads, each group working
  through keys one after another (``independent.concurrent_generator``),
  ``ops_per_key`` invocations a key, r/w/cas over ``n_values`` values in
  the ``mix``; thread ``t`` talks to node ``t % nodes``;
* before each op a thread waits ``gap_overhead_s`` plus a uniform draw
  in ``[0, 2 / rate)`` (the suite's ``gen.stagger(1 / rate)``); an op
  takes a draw from ``latency_quantiles_s`` (the measured durations'
  quantiles, interpolated) and applies at its midpoint;
* a partition of random halves (``partition_s``: on, then off, each
  with up to ``partition_jitter_s`` more) cuts a minority of the nodes:
  an op that reaches a cut node waits for the heal, and where the
  client's ``timeout_s`` comes first it times out: a read fails, a
  write or cas is crashed (``:info``), takes effect at the heal on a
  coin flip, and retires its process, which ``p + groups * threads``
  replaces, as Jepsen numbers a crashed worker's successor;
* new ops stop at ``time_limit_s`` (or when ``keys`` keys are done).

Each op takes effect atomically at one instant of its interval, so a
history is linearizable by construction, except for planted stale
reads: a read that returns the value the register held before its last
change, where that change completed before the read was invoked, every
op that set the old value completed before the change was invoked, and
no crashed or pending op can set it.  No order of the ops explains such
a read, so its key is not linearizable, while a checker that drops the
real-time order accepts it.

An event is a plain tuple ``(process, type, f, value)`` with ``type``
one of ``invoke``, ``ok``, ``fail``, ``info``; a keyed event carries its
key as a fifth field; a nemesis event is ``("nemesis", "info", f,
None)``.  Nothing here imports the program: the harness turns events
into the program's ops, and the reference reads the events as they are.
"""

from __future__ import annotations

import heapq
import json
import random
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_traffic(cell: str) -> dict:
    with open(HERE / "traffic" / f"{cell}.json") as fh:
        return json.load(fh)


def _draw(rng: random.Random, qs: list[float]) -> float:
    """A draw from a distribution given by equally spaced quantiles."""
    x = rng.random() * (len(qs) - 1)
    i = int(x)
    return qs[i] + (x - i) * (qs[i + 1] - qs[i])


def _sets(f, v):
    return v if f == "write" else v[1] if f == "cas" else None


def make_check(rng: random.Random, t: dict, stale: int) -> dict:
    """One check's input: the history of one simulated test (module
    docstring) with ``stale`` planted stale reads, each on another key,
    at the first eligible read past a point of the test drawn from the
    seed.  Returns ``{"events", "keys": [{"key", "ops", "stale",
    "crashes"}], "ops"}``; events carry their key where ``t["keyed"]``."""
    tpk, groups = t["threads"], t.get("groups", 1)
    conc = tpk * groups
    fs = [f for f in ("read", "write", "cas") for _ in range(t["mix"][f])]
    lat = t["latency_quantiles_s"]
    limit = t.get("time_limit_s")
    max_keys = t.get("keys")
    on, off = t["partition_s"]
    jit = t.get("partition_jitter_s", 0.0)
    nodes = t["nodes"]

    q: list = []
    seq = 0

    def push(at, *item):
        nonlocal seq
        heapq.heappush(q, (at, seq) + item)
        seq += 1

    def think():
        return t["gap_overhead_s"] + rng.random() * 2 / t["rate"]

    # the partitions: (start, heal, cut nodes), the first after ``off``;
    # a test bounded by its keys alone is over long before the horizon
    horizon = limit if limit is not None else 3600.0
    parts = []
    at = off
    while at < horizon:
        heal = min(at + on + rng.random() * jit, horizon)
        order = rng.sample(range(nodes), nodes)
        parts.append((at, heal, set(order[:nodes // 2])))
        push(at, "nemesis", "start")
        push(heal, "nemesis", "stop")
        at = heal + off + rng.random() * jit

    def heal_of(node, at):
        for s, h, cut in parts:
            if s <= at < h and node in cut:
                return h
        return None

    def progress(now, n):
        return now / limit if limit is not None else \
            n / (max_keys * t["ops_per_key"])

    stale_from = sorted(rng.uniform(0.1, 0.8) for _ in range(stale))
    state: dict = {}          # key -> value
    prev: dict = {}           # key -> value before the last change
    change: dict = {}         # key -> [invoke, ok completion, op] of it
    set_ret: dict = {}        # (key, value) -> last ok completion
    crash_sets: set = set()   # (key, value) a crashed op may set
    ops: list[list] = []      # op -> [key, f, value, invoke, applied]
    pending: set = set()      # ops invoked and not completed
    proc = list(range(conc))  # thread -> its process
    group_key = [0] * groups
    group_left = [0] * groups
    keys: list[dict] = []
    events: list[tuple] = []
    live = conc               # op events still to come
    for th in range(conc):
        push(think(), "want", th)

    while live:
        now, _, kind, *item = heapq.heappop(q)
        if kind == "nemesis":
            events += [("nemesis", "info", item[0], None)] * 2
            continue
        live -= 1
        if kind == "apply":
            k, f, v, inv, _ = o = ops[item[0]]
            if f == "read":
                continue  # a read takes its value at its completion
            if f == "write" or state.get(k) == v[0]:
                if state.get(k) != _sets(f, v):
                    prev[k], state[k] = state.get(k), _sets(f, v)
                    change[k] = [inv, None, item[0]]
                o[4] = True
            continue
        th = item[0]
        g = th // tpk
        if kind == "want":
            if limit is not None and now >= limit:
                continue
            if group_left[g] == 0:
                if max_keys is not None and len(keys) >= max_keys:
                    continue
                group_key[g], group_left[g] = len(keys), t["ops_per_key"]
                keys.append({"key": len(keys), "ops": 0, "stale": False,
                             "crashes": 0})
            k = group_key[g]
            group_left[g] -= 1
            keys[k]["ops"] += 1
            f = rng.choice(fs)
            n_v = t["n_values"]
            v = None if f == "read" else rng.randrange(n_v) \
                if f == "write" else (rng.randrange(n_v), rng.randrange(n_v))
            oid = len(ops)
            ops.append([k, f, v, now, False])
            pending.add(oid)
            events.append((proc[th], "invoke", f, v, k))
            d = _draw(rng, lat)
            heal = heal_of(th % nodes, now + d / 2)
            live += 2
            if heal is None:
                push(now + d / 2, "apply", oid)
                push(now + d, "done", th, oid, True)
            elif heal - now < t["timeout_s"]:
                push(heal, "apply", oid)
                push(heal + d / 2, "done", th, oid, True)
            else:
                # timed out: a write or cas commits at the heal, or never
                if f != "read" and rng.random() < 0.5:
                    push(heal, "apply", oid)
                else:
                    live -= 1
                push(now + t["timeout_s"], "done", th, oid, False)
            continue
        # done: a completion, or the client's timeout
        oid, answered = item[1], item[2]
        k, f, v, inv, applied = ops[oid]
        pending.discard(oid)
        p = proc[th]
        live += 1
        push(now + think(), "want", th)
        if not answered:
            if f == "read":
                events.append((p, "fail", f, None, k))
            else:
                events.append((p, "info", f, v, k))
                crash_sets.add((k, _sets(f, v)))
                keys[k]["crashes"] += 1
                proc[th] = p + conc
            continue
        if f == "read":
            value, old, c = state.get(k), prev.get(k), change.get(k)
            if (stale_from and progress(now, len(ops)) >= stale_from[0]
                    and not keys[k]["stale"]
                    and c is not None and c[1] is not None and c[1] < inv
                    and old is not None and old != value
                    and (k, old) not in crash_sets
                    and set_ret.get((k, old), -1.0) < c[0]
                    and all(ops[x][0] != k
                            or _sets(ops[x][1], ops[x][2]) != old
                            for x in pending)):
                value = old
                stale_from.pop(0)
                keys[k]["stale"] = True
            events.append((p, "ok", f, value, k))
        elif applied:
            set_ret[(k, _sets(f, v))] = now
            c = change.get(k)
            if c is not None and c[2] == oid:
                c[1] = now
            events.append((p, "ok", f, v, k))
        else:
            events.append((p, "fail", f, v, k))
    # the heal after the main phase
    events += [("nemesis", "info", "stop", None)] * 2
    if not t["keyed"]:
        events = [e[:4] for e in events]
        keys = [{**r, "key": None} for r in keys]
    return {"events": events, "keys": keys,
            "ops": sum(r["ops"] for r in keys)}


def _check(rng: random.Random, t: dict, stale: int) -> dict:
    """:func:`make_check`, drawn again until every stale read it asks
    for is planted."""
    while True:
        c = make_check(rng, t, stale)
        if sum(k["stale"] for k in c["keys"]) == stale:
            return c


def make_pool(seed: int, t: dict, n: int, stream: str = "pool") -> list[dict]:
    """``n`` checks from ``seed`` and the name of a ``stream`` (the
    window's pool, the warm-up, the extra checks).  Keyed tests carry
    ``t["stale_keys"]`` stale keys each.  Of single histories,
    ``t["stale_checks"]`` carry a stale read, one in each of as many
    equal runs of the pool, at a place in its run drawn from the seed,
    so that a window that covers part of the pool meets its share of
    them."""
    rng = random.Random(f"linbench-{stream}-{seed}")
    if t["keyed"] or not n:
        return [_check(rng, t, t["stale_keys"]) for _ in range(n)]
    runs = max(1, min(n, t["stale_checks"]))
    size = -(-n // runs)
    pool = []
    for start in range(0, n, size):
        block = [_check(rng, t, 1 if i == start
                            and start // size < t["stale_checks"] else 0)
                 for i in range(start, min(n, start + size))]
        rng.shuffle(block)
        pool.extend(block)
    return pool


def relabel(pool: list[dict], seed: int, n_values: int) -> list[dict]:
    """The same checks for another seed: in another order, with the
    register's values permuted and the process ids shuffled, both drawn
    from ``seed``.  A bijection of values and of processes keeps every
    verdict, stale reads included, and the work a check needs."""
    rng = random.Random(f"linbench-relabel-{seed}")
    vals = list(range(n_values))
    rng.shuffle(vals)

    def v(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return (vals[x[0]], vals[x[1]])
        return vals[x]

    out = []
    for c in pool:
        procs = sorted({e[0] for e in c["events"] if e[0] != "nemesis"})
        new = list(procs)
        rng.shuffle(new)
        pmap = dict(zip(procs, new))
        events = [e if e[0] == "nemesis" else
                  (pmap[e[0]], e[1], e[2], v(e[3])) + tuple(e[4:])
                  for e in c["events"]]
        out.append({**c, "events": events})
    rng.shuffle(out)
    return out
