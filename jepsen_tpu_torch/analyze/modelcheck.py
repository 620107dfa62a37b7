"""Bounded model checker for the live backends — exhaustive
interleaving exploration with sleep-set reduction and schedule
certificates.  A copy of the JAX package's ``analyze/modelcheck.py``:
the search and the certificate lifecycle run on the host, as there, and
``dpor=None`` means on (no environment variable is read).

The live campaign only ever *samples* interleavings: real processes,
real clocks, a nemesis rolling dice.  This module lifts the SAME
state machines the daemons run — :class:`~jepsen_tpu_torch.live.
replicated_server.ReplicaCore`, :class:`~jepsen_tpu_torch.live.
replicated_queue.QueueCore`, and a localnode-style lock store — into
a single-threaded deterministic scheduler and explores every
schedule at a bounded scope (nodes x client ops x crashes x
partitions x max events), in the GPUexplore spirit
(arXiv:1801.05857): a cheap exhaustive search finds the violation, a
slow independent validator (the linearizability engine + audit)
confirms it.

**The event model.**  A schedule is a sequence of atomic events:

  ``hb i``        leader i runs one heartbeat round (step-down on an
                  expired lease, else ping fan-out + lease renewal)
  ``campaign i``  the logical clock jumps to node i's election-timer
                  expiry and i runs one full election round (ballots
                  + win/lose, winner heartbeats once)
  ``op i``        node i serves the NEXT client op of the scoped
                  program (enabled only while i believes it serves)
  ``crash i``     kill -9: node i's process state vanishes
  ``restart i``   node i boots a fresh core and replays the shared
                  oplog (which the volatile seeded mode left empty)
  ``isolate i``   the partitioner cuts every link touching i
  ``heal``        all links restored

An RPC round (ballots, ping fan-out, append replication) executes
atomically inside its event — the abstraction under-approximates
message-level interleavings but keeps every schedule the *process*
scheduler and the nemesis can produce, which is exactly the space
the live campaign samples.  Time is a logical clock that only
``campaign`` advances (to the precise instant the timer fires): the
scheduler can starve a leader's heartbeat past its lease, which is
the pause/partition behaviour the lease protocol must survive.

**Invariants** (stable MC1xx codes, :data:`MC_CODES`): election
safety under the leader lease, durability of majority-acked writes,
at-least-once redelivery without invention, no-double-grant for
locks.  State-level violations are completed into *client-visible*
histories by probe ops (a read at each offending leader, a drain at
a lossy queue leader), so every certificate renders as a jepsen
history the linearizability engine independently re-checks invalid
and ``analyze/audit.py`` confirms.

**Schedule certificates.**  Every violation emits::

    {"code": "MC1xx", "family": ..., "mode": ..., "scope": {...},
     "schedule": [["campaign", 0], ["op", 0], ...],
     "history": [op dicts], "shrunk": {ddmin stats},
     "confirm": {engine + audit verdicts}, "state": fingerprint-id}

replayable via ``python -m jepsen_tpu_torch.analyze --mc --replay CERT``
(deterministic: same schedule, same world, same violation) and
banked into live/corpus.py.  ``analyze/shrink.py``'s generic
:func:`~jepsen_tpu_torch.analyze.shrink.ddmin_list` minimizes the schedule
first — the lifecycle is explore -> confirm -> shrink -> bank.

**Reduction.**  Sleep sets with concrete commutation (clone the
world, execute both orders, compare fingerprints), composed with the
visited memo through :func:`~jepsen_tpu_torch.analyze.dpor.sleep_visit` —
the same state-caching antichain the engine DFS uses.  Sleep sets
prune *transitions*, never states, so the violation set is provably
identical with the reduction off (``dpor=False``) — the soundness
test asserts bit-identity.  Clean runs emit the explored-scope block
(states, schedules, prune ratio, completeness) and ``jtpu_mc_*``
metrics: a clean verdict names exactly what it proved.
"""

from __future__ import annotations

import hashlib
import json
from collections import OrderedDict
from dataclasses import asdict, dataclass, field, replace

from ..history import Op, fail_op, info_op, invoke_op, ok_op
from ..live.replicated_queue import QueueCore
from ..live.replicated_server import ReplicaCore
from ..obs.metrics import REGISTRY
from .dpor import resolve_dpor, sleep_visit

MC_CODES = {
    "MC101": "election safety: two serving leaders answer with "
             "divergent state on an acked key",
    "MC102": "durability: a serving leader's state lost or rewrote "
             "a majority-acked write",
    "MC103": "stale read: a client read returned a value outside "
             "the possible set (acked + indeterminate writes)",
    "MC104": "lost enqueue: a client-acked job vanished from the "
             "serving leader (not acked, not pending, not claimed)",
    "MC105": "invented delivery: a dequeue returned a job that was "
             "never added or was already acked",
    "MC106": "double grant: the lock server granted while another "
             "client still holds an unreleased grant",
    "MC201": "non-idempotent retry: one client op (one request id) "
             "committed twice across a retransmission",
    "MC202": "acked reply lost then lied: a committed write's retry "
             "was answered with a failure",
    "MC203": "proxy loop: a forwarded client request was re-forwarded "
             "past every node in the mesh",
    "MC204": "session leak: a connection reset left server-side "
             "session state (a claim) owned by a dead connection",
    "MC205": "stale-leader serving: a deposed leader answered a "
             "proxied/direct read outside the possible set",
}

_M_STATES = REGISTRY.counter(
    "jtpu_mc_states_total",
    "Model-checker states expanded across all runs")
_M_SCHED = REGISTRY.counter(
    "jtpu_mc_schedules_total",
    "Model-checker maximal schedules completed (depth bound, "
    "quiescence, or violation)")
_M_VIOL = REGISTRY.counter(
    "jtpu_mc_violations_total",
    "Model-checker invariant violations found, by MC code",
    ("code",))
_M_PRUNE = REGISTRY.counter(
    "jtpu_mc_sleep_prunes_total",
    "Model-checker transitions skipped by sleep sets (covered by an "
    "already-explored commuting sibling)")
_M_RATIO = REGISTRY.gauge(
    "jtpu_mc_prune_ratio",
    "Sleep-set prune ratio of the last model-checker run "
    "(prunes / (prunes + executed transitions))")

#: logical-time nudge past a timer threshold (strict inequalities in
#: election_due)
EPS = 1e-3

FAMILIES = ("replicated", "rqueue", "lock")
MODES = {
    "replicated": ("clean", "volatile", "split-brain"),
    "rqueue": ("clean", "volatile"),
    "lock": ("clean", "volatile"),
}

#: the shell-layer scope (analyze/simnet.py): the daemons' actual
#: request-dispatch code paths under a simulated transport.  Seeded
#: modes re-open the retry-idempotency / session-lifecycle bugs the
#: live shells fix; clean modes prove the fixed shells hold at the
#: same bounds.
SHELL_FAMILIES = ("shell-kv", "shell-queue", "shell-replicated",
                  "shell-rqueue")
SHELL_MODES = {
    "shell-kv": ("clean", "volatile"),
    "shell-queue": ("clean", "volatile", "session-leak"),
    "shell-replicated": ("clean", "proxy-loop", "stale-proxy"),
    "shell-rqueue": ("clean", "volatile"),
}
ALL_FAMILIES = FAMILIES + SHELL_FAMILIES
ALL_MODES = {**MODES, **SHELL_MODES}

#: the one key the kv program exercises — a single register is where
#: every seeded backend defect already shows
KEY = "x"

#: how an absent key renders in a certificate history.  A nil-valued
#: read is a WILDCARD to the cas-register model (knossos: unknown
#: value), so a lost write probed as None would confirm engine-valid;
#: rendering absence as the concrete 0 against ``register(initial=0)``
#: makes it count — which is why kv program write values must be
#: non-zero
ABSENT = 0


@dataclass(frozen=True)
class Scope:
    """The exploration bounds — the certificate's 'what was proven'
    block.  ``ops`` is the client program: ``("w", v)`` / ``("r",)``
    for the kv family, ``("add", body)`` / ``("get",)`` / ``("ack",)``
    for the queue, ``("lock", client)`` / ``("unlock", client)`` for
    the lock family (lock clients run their own sub-programs and
    interleave; the other families serve one sequential program)."""

    nodes: int = 3
    ops: tuple = field(default_factory=tuple)
    crashes: int = 0
    partitions: int = 0
    max_events: int = 6
    #: which nodes may crash / be isolated: "leader" bites the
    #: interesting node, "any" widens the space
    crash_targets: str = "leader"
    isolate_targets: str = "leader"
    #: exploration budget; past it the run reports complete=False
    max_states: int = 200_000

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ops"] = [list(o) for o in self.ops]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scope":
        d = dict(d)
        d["ops"] = tuple(tuple(o) for o in d.get("ops", ()))
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


def default_scope(family: str, mode: str) -> Scope:
    """The bounded scope each seeded defect is reachable in (and the
    clean twin must clear): hand-derived from the shortest known
    violating schedule per mode, one event of slack."""
    if family == "lock":
        return Scope(nodes=1,
                     ops=(("lock", 0), ("unlock", 0), ("lock", 1)),
                     crashes=1, max_events=6)
    if family == "rqueue":
        return Scope(nodes=3, ops=(("add", 1),), crashes=1,
                     max_events=6)
    if family == "shell-kv":
        # drop(reply) + retry: one partition token, depth 7
        return Scope(nodes=1, ops=(("cas", 1, 2),), crashes=0,
                     partitions=1, max_events=7)
    if family == "shell-queue":
        # MC204 needs: add acked (3) + get claimed (2) + reset (1)
        # + retry/deliver/deliver (3) = 9 events
        return Scope(nodes=1, ops=(("add", 1), ("get",)), crashes=1,
                     partitions=1, max_events=9)
    if family == "shell-rqueue":
        return Scope(nodes=2, ops=(("add", 1),), crashes=0,
                     partitions=1, max_events=7)
    if family == "shell-replicated":
        if mode == "proxy-loop":
            # elect, learn, elect, op — two leadership moves
            return Scope(nodes=3, ops=(("w", 1),), crashes=2,
                         max_events=6)
        return Scope(nodes=3, ops=(("w", 1), ("w", 2), ("r",)),
                     crashes=1, max_events=6)
    if mode == "split-brain":
        return Scope(nodes=3, ops=(("w", 1), ("w", 2)), crashes=0,
                     partitions=1, max_events=6)
    return Scope(nodes=3, ops=(("w", 1),), crashes=1, max_events=6)


# ---------------------------------------------------------------------------
# Worlds: the lifted state machines behind one scheduling protocol
# (enabled / execute / clone / fingerprint)
# ---------------------------------------------------------------------------


class ClusterWorld:
    """The replicated kv / queue cluster under the deterministic
    scheduler: N live cores, a shared in-memory oplog standing in for
    the fsync'd file (appends skipped in volatile mode, exactly like
    ``DurableLog``), a symmetric link-cut set, and the client-visible
    ledger the invariants are phrased over."""

    def __init__(self, family: str, mode: str, scope: Scope):
        self.family = family
        self.mode = mode
        self.scope = scope
        self.volatile = mode == "volatile"
        self.split_brain = mode == "split-brain"
        self.core_cls = QueueCore if family == "rqueue" \
            else ReplicaCore
        n = scope.nodes
        self.alive = [True] * n
        self.log: list[dict] = []
        self.log_pos = [0] * n
        self.cut: frozenset = frozenset()
        self.clock = 0.0
        self.op_i = 0
        self.crashes_used = 0
        self.partitions_used = 0
        self.history: list[Op] = []
        self.t = 0
        # the client-visible write ledger the invariants close over
        self.committed: dict = {}   # key -> last acked write value
        self.maybes: dict = {}      # key -> :info writes since it
        self.added_ok: dict = {}    # jid -> body, client-acked adds
        self.added_info: dict = {}  # jid -> body, indeterminate adds
        self.acked: set = set()     # jids the server acked as done
        self.last_jid: str | None = None
        self.cores = [self._fresh_core(i) for i in range(n)]

    # -- construction / cloning ---------------------------------------

    def _fresh_core(self, i: int):
        core = self.core_cls(
            i, self.scope.nodes, lease_s=1.0, volatile=self.volatile,
            split_brain=self.split_brain, now=self.clock)
        self._bind(core, i)
        return core

    def _bind(self, core, i: int) -> None:
        """The core's injected catch_up: replay the shared-log tail —
        the model-checker twin of Replica._catch_up_locked."""

        def catch_up() -> int:
            applied = 0
            while self.log_pos[i] < len(self.log):
                e = self.log[self.log_pos[i]]
                self.log_pos[i] += 1
                if core.wants(e):
                    core.apply(e)
                    applied += 1
            return applied

        core.catch_up = catch_up

    def _clone_core(self, core):
        c = object.__new__(type(core))
        c.__dict__.update(core.__dict__)
        c.state = dict(core.state)
        if isinstance(core, QueueCore):
            c.pending = OrderedDict(core.pending)
            c.claimed = dict(core.claimed)
        return c

    def clone(self) -> "ClusterWorld":
        w = object.__new__(type(self))
        w.__dict__.update(self.__dict__)
        w.alive = list(self.alive)
        w.log = list(self.log)  # entries are append-only, share refs
        w.log_pos = list(self.log_pos)
        w.history = list(self.history)
        w.committed = dict(self.committed)
        w.maybes = {k: list(v) for k, v in self.maybes.items()}
        w.added_ok = dict(self.added_ok)
        w.added_info = dict(self.added_info)
        w.acked = set(self.acked)
        w.cores = [self._clone_core(c) for c in self.cores]
        for i, c in enumerate(w.cores):
            w._bind(c, i)
        return w

    def fingerprint(self) -> tuple:
        """Hashable machine + ledger state.  Dead cores collapse to
        None (a restart rebuilds from the log, so their frozen state
        cannot influence any future) — which is also what lets a
        crash commute with events on the surviving majority."""
        return (
            tuple(c.snapshot() if a else None
                  for c, a in zip(self.cores, self.alive)),
            tuple(sorted(tuple(sorted(p)) for p in self.cut)),
            round(self.clock, 6), self.op_i,
            self.crashes_used, self.partitions_used, len(self.log),
            self.last_jid,
            tuple(sorted(self.committed.items())),
            tuple(sorted((k, tuple(v))
                         for k, v in self.maybes.items())),
            tuple(sorted(self.added_ok.items())),
            tuple(sorted(self.added_info.items())),
            tuple(sorted(self.acked)),
        )

    # -- scheduling protocol ------------------------------------------

    def _connected(self, i: int):
        return [j for j in range(len(self.cores))
                if j != i and self.alive[j]
                and frozenset((i, j)) not in self.cut]

    def _next_verb(self):
        if self.op_i < len(self.scope.ops):
            return self.scope.ops[self.op_i]
        return None

    def enabled(self) -> list[tuple]:
        evs: list[tuple] = []
        s = self.scope
        verb = self._next_verb()
        for i, core in enumerate(self.cores):
            if not self.alive[i]:
                evs.append(("restart", i))
                continue
            if core.role == "leader":
                evs.append(("hb", i))
            else:
                evs.append(("campaign", i))
            if verb is not None and core.leader_serving(self.clock) \
                    and not (verb[0] == "ack" and self.last_jid is None):
                evs.append(("op", i))
            if self.crashes_used < s.crashes and (
                    s.crash_targets == "any" or core.role == "leader"):
                evs.append(("crash", i))
            if not self.cut and self.partitions_used < s.partitions \
                    and (s.isolate_targets == "any"
                         or core.role == "leader"):
                evs.append(("isolate", i))
        if self.cut:
            evs.append(("heal", 0))
        return evs

    def execute(self, ev: tuple) -> dict | None:
        """Run one event; returns a violation dict or None.  Probe
        ops completing a state-level violation into a client-visible
        history are appended before returning."""
        kind, i = ev
        v = None
        if kind == "hb":
            self._exec_hb(i)
        elif kind == "campaign":
            self._exec_campaign(i)
        elif kind == "crash":
            self.alive[i] = False
            self.crashes_used += 1
        elif kind == "restart":
            self.alive[i] = True
            self.log_pos[i] = 0
            self.cores[i] = self._fresh_core(i)
            self.cores[i].catch_up()
        elif kind == "isolate":
            self.cut = frozenset(
                frozenset((i, j)) for j in range(len(self.cores))
                if j != i)
            self.partitions_used += 1
        elif kind == "heal":
            self.cut = frozenset()
        elif kind == "op":
            v = self._exec_op(i)
        return v or self._state_violation()

    # -- cluster event bodies -----------------------------------------

    def _exec_hb(self, i: int) -> None:
        core = self.cores[i]
        if core.step_leader_expiry(self.clock):
            return
        term = core.term
        acks = 1
        for j in self._connected(i):
            r = self.cores[j].on_ping(term, i, core.seq, self.clock)
            if r.get("granted"):
                acks += 1
        if acks >= core.majority():
            core.heartbeat_ack(term, self.clock)

    def _exec_campaign(self, i: int) -> None:
        core = self.cores[i]
        due = core.lease_until + core.election_timeout() \
            - core.lease_s + EPS
        self.clock = max(self.clock, due)
        if not core.election_due(self.clock):
            return
        term, seq = core.begin_campaign()
        votes = 1
        for j in self._connected(i):
            r = self.cores[j].on_vote(term, i, seq, self.clock)
            if r.get("granted"):
                votes += 1
        if votes >= core.majority():
            if core.win_campaign(term, self.clock):
                self._exec_hb(i)  # the shell heartbeats on a win
        else:
            core.lose_campaign(self.clock, 0.0)

    def _commit(self, i: int, entry: dict) -> bool:
        """The commit protocol under the scheduler: shared-log append
        (skipped when volatile — DurableLog's no-op), replication
        fan-out over uncut links, majority required."""
        core = self.cores[i]
        if not self.volatile:
            self.log.append(entry)
        acks = 1
        for j in self._connected(i):
            st, _ = self.cores[j].on_append(entry, self.clock)
            if st < 400:
                acks += 1
        if acks >= core.majority():
            core.apply(entry)
            return True
        return False

    # -- client ops + history rendering -------------------------------

    def _h(self, ctor, process, f, value=None) -> None:
        self.history.append(ctor(process, f, value, time=self.t))
        self.t += 1

    def _possible(self, k) -> set:
        poss = set(self.maybes.get(k, ()))
        poss.add(self.committed.get(k))  # None before any acked write
        return poss

    def _exec_op(self, i: int) -> dict | None:
        verb = self.scope.ops[self.op_i]
        self.op_i += 1
        core = self.cores[i]
        if verb[0] == "w":
            val = verb[1]
            if val == ABSENT:
                raise ValueError("kv write values must be non-zero "
                                 "(0 renders key absence)")
            self._h(invoke_op, 0, "write", val)
            st, _body, entry = core.put_prepare(KEY, val, None,
                                                self.clock)
            if entry is None:
                self._h(fail_op, 0, "write", val)
            elif self._commit(i, entry):
                self.committed[KEY] = val
                self.maybes[KEY] = []
                self._h(ok_op, 0, "write", val)
            else:
                self.maybes.setdefault(KEY, []).append(val)
                self._h(info_op, 0, "write", val)
            return None
        if verb[0] == "r":
            self._h(invoke_op, 0, "read")
            st, body = core.get(KEY, self.clock)
            if st == 503:
                self._h(fail_op, 0, "read")
                return None
            val = None if st == 404 else body["node"]["value"]
            self._h(ok_op, 0, "read",
                    ABSENT if val is None else val)
            if val not in self._possible(KEY):
                return {"code": "MC103",
                        "detail": f"node {i} served read {val!r}; "
                                  f"possible was "
                                  f"{sorted(map(repr, self._possible(KEY)))}"}
            return None
        if verb[0] == "add":
            body_v = verb[1]
            self._h(invoke_op, 0, "enqueue", body_v)
            st, jid, entry = core.addjob_prepare(body_v, 10.0,
                                                 self.clock)
            if entry is None:
                self._h(fail_op, 0, "enqueue", body_v)
            elif self._commit(i, entry):
                self.added_ok[jid] = body_v
                self._h(ok_op, 0, "enqueue", body_v)
            else:
                self.added_info[jid] = body_v
                self._h(info_op, 0, "enqueue", body_v)
            return None
        if verb[0] == "get":
            core.expire_claims(self.clock)
            got = core.claim(self.clock)
            self._h(invoke_op, 0, "dequeue")
            if got is None:
                self._h(fail_op, 0, "dequeue")
                return None
            jid, body_v = got
            self.last_jid = jid
            self._h(ok_op, 0, "dequeue", body_v)
            if jid in self.acked or (jid not in self.added_ok
                                     and jid not in self.added_info):
                return {"code": "MC105",
                        "detail": f"node {i} delivered {jid} "
                                  f"(acked or never added)"}
            return None
        if verb[0] == "ack":
            jid = self.last_jid
            st, _n, entry = core.ackjob_prepare(jid, self.clock)
            if entry is not None and self._commit(i, entry):
                self.acked.add(jid)
            return None
        raise ValueError(f"unknown program verb {verb!r}")

    # -- invariants ----------------------------------------------------

    def _probe_read(self, i: int) -> None:
        val = self.cores[i].state.get(KEY)
        self._h(invoke_op, 0, "read")
        self._h(ok_op, 0, "read", ABSENT if val is None else val)

    def _probe_drain(self, i: int) -> None:
        core = self.cores[i]
        bodies = [b for b, _ in core.pending.values()] \
            + [b for b, _r, _t in core.claimed.values()]
        self._h(invoke_op, 0, "drain")
        self._h(ok_op, 0, "drain", bodies)

    def _state_violation(self) -> dict | None:
        serving = [i for i in range(len(self.cores))
                   if self.alive[i]
                   and self.cores[i].leader_serving(self.clock)]
        if self.family == "rqueue":
            for i in serving:
                core = self.cores[i]
                lost = [j for j in self.added_ok
                        if j not in self.acked
                        and j not in core.pending
                        and j not in core.claimed]
                if lost:
                    self._probe_drain(i)
                    return {"code": "MC104",
                            "detail": f"leader {i} lost acked "
                                      f"job(s) {sorted(lost)}"}
            return None
        # kv family
        if len(serving) > 1:
            for k in self.committed:
                vals = {self.cores[i].state.get(k) for i in serving}
                if len(vals) > 1:
                    for i in serving:
                        self._probe_read(i)
                    return {"code": "MC101",
                            "detail": f"serving leaders {serving} "
                                      f"diverge on {k!r}: "
                                      f"{sorted(map(repr, vals))}"}
        for i in serving:
            for k in set(self.committed) | set(self.maybes):
                val = self.cores[i].state.get(k)
                if val not in self._possible(k):
                    self._probe_read(i)
                    return {"code": "MC102",
                            "detail": f"leader {i} holds {val!r} for "
                                      f"{k!r}; possible was "
                                      f"{sorted(map(repr, self._possible(k)))}"}
        return None


class LockWorld:
    """The localnode-style lock server under the scheduler: one
    store, a durable grant log (skipped when volatile — the seeded
    forget-on-kill defect), and per-client programs that interleave.
    Client ops stay enabled against a dead server (connection
    refused -> :fail), which is also what lets a no-op BUSY attempt
    commute with a crash."""

    family = "lock"

    def __init__(self, family: str, mode: str, scope: Scope):
        self.mode = mode
        self.scope = scope
        self.volatile = mode == "volatile"
        self.alive = True
        self.holder = None
        self.log: list[tuple] = []
        self.crashes_used = 0
        self.progs: dict[int, list] = {}
        for verb, client in scope.ops:
            self.progs.setdefault(int(client), []).append(verb)
        self.prog_i = {c: 0 for c in self.progs}
        self.believed: set = set()  # clients holding an :ok grant
        self.history: list[Op] = []
        self.t = 0

    def clone(self) -> "LockWorld":
        w = object.__new__(type(self))
        w.__dict__.update(self.__dict__)
        w.log = list(self.log)
        w.prog_i = dict(self.prog_i)
        w.believed = set(self.believed)
        w.history = list(self.history)
        return w

    def fingerprint(self) -> tuple:
        return (self.alive, self.holder, len(self.log),
                self.crashes_used,
                tuple(sorted(self.prog_i.items())),
                tuple(sorted(self.believed)))

    def enabled(self) -> list[tuple]:
        evs = [("op", c) for c in sorted(self.progs)
               if self.prog_i[c] < len(self.progs[c])]
        if self.alive:
            if self.crashes_used < self.scope.crashes:
                evs.append(("crash", 0))
        else:
            evs.append(("restart", 0))
        return evs

    def _h(self, ctor, process, f, value=None) -> None:
        self.history.append(ctor(process, f, value, time=self.t))
        self.t += 1

    def execute(self, ev: tuple) -> dict | None:
        kind, c = ev
        if kind == "crash":
            self.alive = False
            self.holder = None  # in-memory grant table gone
            self.crashes_used += 1
            return None
        if kind == "restart":
            self.alive = True
            self.holder = None
            for rec in self.log:  # durable replay; empty if volatile
                if rec[0] == "L":
                    self.holder = rec[1]
                elif rec[0] == "U":
                    self.holder = None
            return None
        verb = self.progs[c][self.prog_i[c]]
        self.prog_i[c] += 1
        if verb == "lock":
            self._h(invoke_op, c, "acquire")
            if not self.alive or self.holder is not None:
                self._h(fail_op, c, "acquire")
                return None
            if not self.volatile:
                self.log.append(("L", c))
            self.holder = c
            self._h(ok_op, c, "acquire")
            others = self.believed - {c}
            self.believed.add(c)
            if others:
                return {"code": "MC106",
                        "detail": f"granted to client {c} while "
                                  f"client(s) {sorted(others)} still "
                                  f"hold unreleased grants"}
            return None
        if verb == "unlock":
            self._h(invoke_op, c, "release")
            if not self.alive or self.holder != c:
                self._h(fail_op, c, "release")
                return None
            if not self.volatile:
                self.log.append(("U",))
            self.holder = None
            self.believed.discard(c)
            self._h(ok_op, c, "release")
            return None
        raise ValueError(f"unknown lock verb {verb!r}")


def make_world(family: str, mode: str, scope: Scope):
    if family not in ALL_FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if mode not in ALL_MODES[family]:
        raise ValueError(f"mode {mode!r} invalid for {family!r}")
    if family in SHELL_FAMILIES:
        from . import simnet
        cls = {"shell-kv": simnet.ShellKVWorld,
               "shell-queue": simnet.ShellQueueWorld,
               "shell-replicated": simnet.ShellReplWorld,
               "shell-rqueue": simnet.ShellRqueueWorld}[family]
        return cls(family, mode, scope)
    if family == "lock":
        return LockWorld(family, mode, scope)
    return ClusterWorld(family, mode, scope)


# ---------------------------------------------------------------------------
# Exploration: DFS + sleep sets over the world protocol
# ---------------------------------------------------------------------------


def _fp_id(code: str, fp: tuple) -> str:
    return hashlib.sha256(repr((code, fp)).encode()).hexdigest()[:16]


def explore(family: str, mode: str, scope: Scope, *,
            dpor: bool = True, max_violations: int = 64) -> dict:
    """Enumerate every schedule of the scoped world up to
    ``scope.max_events``, dedup states through the sleep-set
    antichain, and collect the violation set (deduped on
    (code, violating-state fingerprint) — the identity the dpor
    on/off soundness guard compares)."""
    universe: dict[tuple, int] = {}
    events: list[tuple] = []

    def bit(ev: tuple) -> int:
        b = universe.get(ev)
        if b is None:
            b = len(universe)
            universe[ev] = b
            events.append(ev)
        return b

    visited: dict = {}
    commute_memo: dict = {}
    stats = {"states": 0, "schedules": 0, "events": 0,
             "sleep_prunes": 0, "dedup": 0}
    violations: list[dict] = []
    seen: set = set()
    complete = True

    def commutes(world, a: tuple, b: tuple) -> bool:
        """Concrete commutation: both orders enabled, landing on the
        same fingerprint, and VIOLATION-FREE — a violating transition
        ends its DFS path, so its subtree never covers the sibling
        order and sleeping on it would prune a distinct violating
        state.  Conservative False on anything else."""
        key = (world.fingerprint(), a, b) if a <= b \
            else (world.fingerprint(), b, a)
        hit = commute_memo.get(key)
        if hit is not None:
            return hit
        out = False
        wa = world.clone()
        if a in wa.enabled():
            va = wa.execute(a)
            if va is None and b in wa.enabled():
                vab = wa.execute(b)
                wb = world.clone()
                if vab is None and b in wb.enabled():
                    vb = wb.execute(b)
                    if vb is None and a in wb.enabled():
                        vba = wb.execute(a)
                        out = vba is None \
                            and wa.fingerprint() == wb.fingerprint()
        commute_memo[key] = out
        return out

    def record(world, code: str, detail, schedule: list) -> None:
        vid = _fp_id(code, world.fingerprint())
        if vid in seen:
            return
        seen.add(vid)
        violations.append({"code": code, "detail": detail,
                           "schedule": list(schedule), "state": vid})
        _M_VIOL.inc(code=code)

    def dfs(world, depth: int, sleep: int, schedule: list) -> None:
        nonlocal complete
        if stats["states"] >= scope.max_states \
                or len(violations) >= max_violations:
            complete = False
            return
        key = (world.fingerprint(), depth)
        mask = sleep_visit(visited, key, sleep)
        if mask is None:
            stats["dedup"] += 1
            return
        evs = world.enabled()
        if depth >= scope.max_events or not evs:
            stats["schedules"] += 1
            return
        stats["states"] += 1
        sleep_cur = sleep
        for ev in evs:
            b = bit(ev)
            if mask and not (mask >> b) & 1:
                continue  # covered by a prior visit of this state
            if (sleep_cur >> b) & 1:
                stats["sleep_prunes"] += 1
                continue
            child_sleep = 0
            if dpor:
                scan = sleep_cur
                while scan:
                    low = scan & -scan
                    s_bit = low.bit_length() - 1
                    if commutes(world, events[s_bit], ev):
                        child_sleep |= low
                    scan &= scan - 1
            child = world.clone()
            v = child.execute(ev)
            stats["events"] += 1
            schedule.append(ev)
            if v is not None:
                stats["schedules"] += 1
                record(child, v["code"], v.get("detail"), schedule)
            else:
                dfs(child, depth + 1, child_sleep, schedule)
            schedule.pop()
            if dpor:
                sleep_cur |= 1 << b
        del evs

    dfs(make_world(family, mode, scope), 0, 0, [])
    _M_STATES.inc(stats["states"])
    _M_SCHED.inc(stats["schedules"])
    _M_PRUNE.inc(stats["sleep_prunes"])
    denom = stats["events"] + stats["sleep_prunes"]
    ratio = stats["sleep_prunes"] / denom if denom else 0.0
    _M_RATIO.set(ratio)
    return {
        "violations": violations,
        "explored": {**stats, "prune_ratio": round(ratio, 4),
                     "complete": complete},
    }


# ---------------------------------------------------------------------------
# Certificates: replay -> confirm -> shrink -> bank
# ---------------------------------------------------------------------------


def replay(family: str, mode: str, scope: Scope,
           schedule) -> tuple:
    """Deterministically re-execute a schedule -> (world,
    violation-or-None).  An event that is not enabled at its turn
    aborts (None violation): a valid certificate never hits this; a
    ddmin candidate that breaks an enabling chain is simply
    rejected."""
    world = make_world(family, mode, scope)
    for ev in schedule:
        ev = tuple(ev) if not isinstance(ev, tuple) else ev
        ev = (ev[0], int(ev[1]))
        if ev not in world.enabled():
            return world, None
        v = world.execute(ev)
        if v is not None:
            return world, v
    return world, None


def replay_certificate(cert: dict) -> dict:
    """Replay a banked/emitted certificate dict; returns
    ``{"reproduced": bool, "code": ..., "detail": ...}``."""
    scope = Scope.from_dict(cert.get("scope") or {})
    _w, v = replay(cert["family"], cert["mode"], scope,
                   cert.get("schedule") or ())
    return {
        "reproduced": v is not None and v["code"] == cert.get("code"),
        "code": v["code"] if v else None,
        "detail": v.get("detail") if v else None,
    }


def _shrink_schedule(family: str, mode: str, scope: Scope,
                     schedule: list, code: str) -> dict:
    from .shrink import ddmin_list

    def still(sub) -> bool:
        _w, v = replay(family, mode, scope, sub)
        return v is not None and v["code"] == code

    return ddmin_list([tuple(e) for e in schedule], still)


def _confirm_engine(ops: list, model) -> dict:
    """The independent validation loop for engine-route histories:
    the linearizability engine must answer invalid and the audit
    must accept its certificate."""
    from ..checker.seq import check_opseq
    from ..history import encode_ops
    from .audit import audit

    seq = encode_ops(ops, model.f_codes)
    res = check_opseq(seq, model, lint=False)
    a = audit(ops, model, res)
    return {"route": "engine", "engine_valid": res.get("valid"),
            "audit_ok": bool(a.get("ok")),
            "audit_checked": a.get("checked")}


def _confirm_kv_lock(family: str, ops: list) -> dict:
    from ..models import mutex, register

    return _confirm_engine(
        ops, mutex() if family == "lock" else register(ABSENT))


def _confirm_queue_engine(ops: list) -> dict:
    """The MC201 route: duplicate delivery is invisible to the
    tolerant total-queue multiset (at-least-once admits duplicates),
    so double-commits confirm through the ENGINE over an unordered
    queue — a dequeue with no remaining enqueue to justify it has no
    linearization."""
    from ..checker.basic import expand_queue_drain_ops
    from ..models import unordered_queue

    flat = expand_queue_drain_ops(ops)
    n_enq = sum(1 for op in flat
                if op.f == "enqueue" and op.type == "invoke")
    return _confirm_engine(flat, unordered_queue(max(2, n_enq + 1)))


def _confirm_queue(ops: list) -> dict:
    """Queue certificates confirm through multiset semantics: the
    total-queue replay answers invalid, and the W007 evidence audit
    independently re-derives the loss from the raw history."""
    from ..live.corpus import replay_queue
    from .audit import audit

    res = dict(replay_queue(ops))
    acked: dict = {}
    delivered: list = []
    for op in ops:
        if op.type != "ok":
            continue
        if op.f == "enqueue":
            acked.setdefault(op.value, []).append(True)
        elif op.f == "dequeue":
            delivered.append(op.value)
        elif op.f == "drain" and isinstance(op.value, (list, tuple)):
            delivered.extend(op.value)
    lost = {v for v in acked
            if len(acked[v]) > delivered.count(v)}
    rows = [i for i, op in enumerate(ops)
            if op.type == "ok" and op.f == "enqueue"
            and op.value in lost]
    if rows:
        res["queue_evidence"] = {"family": "queue",
                                 "kind": "lost-acked-enqueue",
                                 "rows": rows}
    a = audit(ops, None, res)
    return {"route": "queue", "engine_valid": res.get("valid"),
            "audit_ok": bool(a.get("ok")),
            "audit_checked": a.get("checked")}


def confirm_certificate(family: str, ops: list, code: str | None = None,
                        replayed: bool | None = None) -> dict:
    """Route a certificate's history to its independent validator.
    Shell codes pick their route by invariant (MC201 → engine over an
    unordered queue, MC202/MC205 → engine over a register, MC204 →
    total-queue multiset); MC203 has no invalid client history — a
    loop amplifies without lying to anyone — so deterministic replay
    IS its confirmation (route "loop")."""
    if code == "MC201":
        return _confirm_queue_engine(ops)
    if code == "MC202":
        from ..models import cas_register

        return _confirm_engine(ops, cas_register(1))
    if code == "MC203":
        return {"route": "loop", "engine_valid": False,
                "audit_ok": bool(replayed),
                "audit_checked": "loop-replay"}
    if code == "MC204":
        return _confirm_queue(ops)
    if code == "MC205":
        from ..models import register

        return _confirm_engine(ops, register(ABSENT))
    if family == "rqueue":
        return _confirm_queue(ops)
    return _confirm_kv_lock(family, ops)


def bank_certificate(family: str, mode: str, ops: list,
                     base: str) -> dict:
    """Bank the certificate's rendered history into the live corpus
    (the same pool campaign failures land in, so the corpus replayer
    regression-checks model-checker finds too)."""
    from ..live import corpus
    from ..models import cas_register, mutex, register

    if family in ("rqueue", "shell-queue", "shell-rqueue"):
        model = None  # the queue families bank through total-queue
    elif family == "lock":
        model = mutex()
    elif family == "shell-kv":
        model = cas_register(1)
    else:
        model = register(ABSENT)
    entries = corpus.entries_from_test(
        {"history": ops, "model": model},
        {"family": f"mc-{family}", "nemesis": f"mc-{mode}",
         "seeded": mode != "clean", "valid": False})
    out = corpus.bank(entries, base)
    return {"entries": len(entries), **{k: out[k] for k in out
                                        if k in ("banked", "pool")}}


def run_mc(family: str, mode: str, *, scope: Scope | None = None,
           dpor: bool | None = None, confirm: bool = True,
           shrink: bool = True, bank_base: str | None = None,
           max_violations: int = 64, max_certificates: int = 4) -> dict:
    """One model-checking run: explore the bounded scope, then take
    each violation through the confirm -> shrink -> bank lifecycle.
    Returns the result block ``--mc --json`` prints (``ok`` True
    exactly when no violation was found)."""
    dpor = resolve_dpor(dpor)
    if scope is None:
        scope = default_scope(family, mode)
    res = explore(family, mode, scope, dpor=dpor,
                  max_violations=max_violations)
    certs = []
    for v in res["violations"][:max_certificates]:
        cert = {"code": v["code"], "mc": MC_CODES[v["code"]],
                "detail": v["detail"], "family": family,
                "mode": mode, "scope": scope.to_dict(),
                "state": v["state"],
                "schedule": [list(e) for e in v["schedule"]]}
        schedule = v["schedule"]
        if shrink:
            d = _shrink_schedule(family, mode, scope, schedule,
                                 v["code"])
            schedule = d["items"]
            cert["schedule"] = [list(e) for e in schedule]
            cert["shrunk"] = {k: d[k] for k in
                              ("n_from", "n_to", "checks", "minimal")}
        world, rv = replay(family, mode, scope, schedule)
        cert["replayed"] = rv is not None and rv["code"] == v["code"]
        cert["history"] = [op.to_dict() for op in world.history]
        if confirm:
            cert["confirm"] = confirm_certificate(
                family, world.history, code=v["code"],
                replayed=cert["replayed"])
        if bank_base:
            cert["banked"] = bank_certificate(family, mode,
                                              world.history,
                                              bank_base)
        certs.append(cert)
    return {
        "family": family, "mode": mode, "dpor": dpor,
        "scope": scope.to_dict(),
        "explored": res["explored"],
        "n_violations": len(res["violations"]),
        "violations": certs,
        "ok": not res["violations"],
    }


def run_mc_sweep(families=FAMILIES, *, modes: dict | None = None,
                 dpor: bool | None = None, scope: Scope | None = None,
                 bank_base: str | None = None) -> dict:
    """The clean+seeded matrix: every family x mode at its default
    (or one shared) scope.  ``ok`` is True when every clean mode is
    violation-free AND every seeded mode is caught — the tier-1
    acceptance shape."""
    runs = []
    ok = True
    for family in families:
        for mode in (modes or ALL_MODES)[family]:
            r = run_mc(family, mode, scope=scope, dpor=dpor,
                       bank_base=bank_base if mode != "clean"
                       else None)
            runs.append(r)
            if mode == "clean":
                ok = ok and r["ok"]
            else:
                ok = ok and not r["ok"] \
                    and all(c.get("replayed") for c in r["violations"])
    return {"ok": ok, "runs": runs}


def scope_from_args(family: str, mode: str, *, nodes=None, ops=None,
                    crashes=None, partitions=None, max_events=None,
                    max_states=None) -> Scope:
    """CLI overlay: start from the family/mode default and replace
    only what was given."""
    s = default_scope(family, mode)
    over = {k: v for k, v in dict(
        nodes=nodes, ops=ops, crashes=crashes, partitions=partitions,
        max_events=max_events, max_states=max_states).items()
        if v is not None}
    return replace(s, **over) if over else s


def mc_plan_block(family: str, mode: str,
                  scope: Scope | None = None) -> dict:
    """The static 'what would --mc do' block for explain()/plan
    output: the scope bounds and invariant set, no exploration."""
    scope = scope or default_scope(family, mode)
    if family == "shell-replicated":
        events = ["op", "elect", "learn"]
    elif family in SHELL_FAMILIES:
        events = ["send", "deliver", "drop", "dup", "reset", "retry",
                  "giveup"]
    else:
        events = ["hb", "campaign", "op", "crash", "restart",
                  "isolate", "heal"]
    return {"family": family, "mode": mode, "scope": scope.to_dict(),
            "codes": sorted(MC_CODES), "events": events}


def load_certificate(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)
