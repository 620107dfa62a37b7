"""Simulated transport under the model checker — the SHELL layer of
the live daemons, explored schedule-by-schedule.  A copy of the JAX
package's ``analyze/simnet.py`` over the port's own daemons.

``modelcheck.py`` lifts the *cores* (election, replication,
durability).  This module lifts the layer above them: the
request-dispatch shells the daemons serve clients through —
:func:`jepsen_tpu_torch.live.kv_server.dispatch`,
:func:`jepsen_tpu_torch.live.queue_server.dispatch`,
:func:`jepsen_tpu_torch.live.replicated_queue.dispatch_resp`, and
:func:`jepsen_tpu_torch.live.replicated_server.handle_client_request` — by
substituting an in-memory message soup for the socket layer.  The
checked code path IS the served code path (the shell-lifting
contract, docs/analyze.md §12): the worlds here call the exact
functions the TCP handlers call, and the parity tests in
tests/test_torch_simnet.py hold the real daemons to the same
client-visible histories on fault-free schedules.

**The transport event model** (all events are ``(kind, int)`` pairs,
so modelcheck's replay/shrink machinery applies unchanged):

  ``send 0``        the client transmits its NEXT program op
                    (request message enters the soup)
  ``deliver mid``   message ``mid`` arrives: a request runs the real
                    dispatch function; a reply completes the client
                    op it answers (stale replies — an earlier attempt
                    of the op — are discarded, exactly what a client
                    that already tore down that connection does)
  ``drop mid``      the network eats message ``mid`` (budget:
                    ``scope.partitions``, shared with ``dup``)
  ``dup mid``       the network duplicates a REQUEST in flight — the
                    retransmission-race MC201 lives in
  ``reset 0``       the connection dies mid-request: every in-flight
                    message is lost and the server shell observes the
                    send failure (budget: ``scope.crashes``)
  ``retry 0``       the client retransmits the current op through
                    ``reconnect.Backoff`` (``step()``; enabled only
                    while the schedule has attempts left and the
                    current attempt is provably dead)
  ``giveup 0``      the client abandons the op: :info for mutations
                    (it may have happened), :fail for pure reads

Delivery order is unconstrained — delivering an arbitrary in-flight
``mid`` subsumes explicit reorder events.  The replicated-server
world (:class:`ShellReplWorld`) has no message soup: its ops execute
request→reply atomically through ``handle_client_request`` and the
interesting nondeterminism is leadership (``elect``/``learn``), which
is where the proxy-loop and stale-proxy defects live.

**Invariants** (MC2xx, registered in modelcheck.MC_CODES):

  MC201  non-idempotent retry double-commit: one client ADDJOB
         (one REQID) minted two jobs
  MC202  acked-reply-lost-then-lied: a committed PUT whose reply was
         lost answered the retry with a failure
  MC203  proxy loop: a forwarded request re-forwarded past every node
  MC204  session leak: a connection reset left a claim dead-owned,
         hiding an acked job from every consumer
  MC205  stale-leader serving: a read answered from a deposed
         leader's state, outside the possible set

State-level detections are completed into client-visible histories by
probe ops (a pending-only drain for MC204 — the leaked claim is the
invisibility being proven; pending+claimed for MC201 — claims
redeliver, so both copies count as deliveries), and every certificate
re-confirms through an independent route (modelcheck.confirm_
certificate): the linearizability engine over ``unordered_queue`` /
``cas_register`` / ``register``, the total-queue multiset replay, or
— for MC203, which produces no invalid client history, only an
amplification — deterministic replay itself.
"""

from __future__ import annotations

import json
import random
import threading
from collections import OrderedDict

from ..history import Op, fail_op, info_op, invoke_op, ok_op
from ..live import kv_server, queue_server
from ..live.replicated_queue import dispatch_resp
from ..live.replicated_server import PREFIX, handle_client_request
from ..reconnect import Backoff

#: the one key the shell kv programs exercise (modelcheck.KEY twin)
KEY = "x"
#: how key absence renders (see modelcheck.ABSENT)
ABSENT = 0

#: client retry budget per op: Backoff(max_attempts=3) allows the
#: original send plus two retransmissions — enough for every seeded
#: defect, small enough to keep the bounded scopes exhaustive
MAX_ATTEMPTS = 3


# ---------------------------------------------------------------------------
# No-file stores: the REAL Store classes minus the oplog fsync
# ---------------------------------------------------------------------------


class SimKVStore(kv_server.Store):
    """kv_server.Store with durability stubbed: same lock discipline,
    same put/get/dispatch code paths, no filesystem.  ``volatile``
    keeps its real meaning (reply-dedup cache skipped — the seeded
    MC202 mode)."""

    def __init__(self, volatile: bool = False):
        self.lock = threading.Lock()
        self.volatile = volatile
        self.state: dict[str, str] = {}
        self.replies: dict[str, tuple[int, dict]] = {}

    def _durable(self, entry: dict) -> None:  # no oplog in the sim
        pass

    def clone(self) -> "SimKVStore":
        s = SimKVStore(self.volatile)
        s.state = dict(self.state)
        s.replies = {k: (st, dict(b))
                     for k, (st, b) in self.replies.items()}
        return s

    def fingerprint(self) -> tuple:
        return (tuple(sorted(self.state.items())),
                tuple(sorted(
                    (k, st, json.dumps(b, sort_keys=True))
                    for k, (st, b) in self.replies.items())))


class SimQueueStore(queue_server.Store):
    """queue_server.Store with durability stubbed and the clock frozen
    at 0: claims never expire inside a schedule, so redelivery is an
    explicit transport event (reset→unclaim) instead of a wall-clock
    race, and ``getjob(0)`` polls instead of blocking."""

    def __init__(self, volatile: bool = False):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.now = lambda: 0.0
        self.volatile = volatile
        self.next_id = 0
        self.pending: OrderedDict[str, tuple[str, float]] = OrderedDict()
        self.claimed: dict[str, tuple[str, float, float]] = {}
        self.replies: dict[str, str] = {}

    def _durable(self, line: str) -> None:  # no oplog in the sim
        pass

    def clone(self) -> "SimQueueStore":
        s = SimQueueStore(self.volatile)
        s.next_id = self.next_id
        s.pending = OrderedDict(self.pending)
        s.claimed = dict(self.claimed)
        s.replies = dict(self.replies)
        return s

    def fingerprint(self) -> tuple:
        return (self.next_id, tuple(self.pending.items()),
                tuple(sorted(self.claimed.items())),
                tuple(sorted(self.replies.items())))


# ---------------------------------------------------------------------------
# The message-soup transport base
# ---------------------------------------------------------------------------


class _TransportWorld:
    """One client driving one daemon shell through an in-memory
    message soup.  Subclasses provide ``_request`` (program verb →
    request message fields), ``_serve`` (request → reply message via
    the REAL dispatch function) and ``_complete`` (reply → history
    completion + invariant checks)."""

    def __init__(self, family: str, mode: str, scope):
        self.family = family
        self.mode = mode
        self.scope = scope
        self.volatile = mode == "volatile"
        self.op_i = 0
        #: the op awaiting completion: {"op", "verb", "attempt"}
        self.cur: dict | None = None
        self.inflight: dict[int, dict] = {}
        self.next_mid = 0
        #: connection generation; bumped by reset
        self.epoch = 0
        self.drops_used = 0
        self.resets_used = 0
        #: the real client-side retry schedule (jitter 0 keeps the
        #: rng stream inert; max_attempts bounds the retry events)
        self.backoff = Backoff(base=0.05, cap=2.0, factor=2.0,
                               max_attempts=MAX_ATTEMPTS, jitter=0.0,
                               rng=random.Random(7))
        #: op index -> commit tokens the SERVER minted for it (jids /
        #: "commit" markers) — what the retry-idempotency invariants
        #: are phrased over
        self.ledger: dict[int, set] = {}
        self.history: list[Op] = []
        self.t = 0

    # -- cloning / fingerprint ----------------------------------------

    def clone(self):
        w = object.__new__(type(self))
        w.__dict__.update(self.__dict__)
        w.cur = dict(self.cur) if self.cur is not None else None
        w.inflight = {m: dict(v) for m, v in self.inflight.items()}
        w.ledger = {k: set(v) for k, v in self.ledger.items()}
        w.history = list(self.history)
        w.backoff = self.backoff.clone()
        self._clone_into(w)
        return w

    def _clone_into(self, w) -> None:
        w.store = self.store.clone()

    def _store_fp(self) -> tuple:
        return self.store.fingerprint()

    def fingerprint(self) -> tuple:
        cur = None if self.cur is None \
            else (self.cur["op"], self.cur["attempt"])
        return (
            self.op_i, cur,
            tuple(sorted(
                (m, tuple(sorted(v.items())))
                for m, v in self.inflight.items())),
            self.next_mid, self.epoch, self.drops_used,
            self.resets_used, self.backoff.attempt,
            tuple(sorted((k, tuple(sorted(v)))
                         for k, v in self.ledger.items())),
            self._store_fp(),
        )

    # -- history rendering --------------------------------------------

    def _h(self, ctor, process, f, value=None) -> None:
        self.history.append(ctor(process, f, value, time=self.t))
        self.t += 1

    # -- scheduling protocol ------------------------------------------

    def _attempt_live(self) -> bool:
        c = self.cur
        return any(m["op"] == c["op"] and m["attempt"] == c["attempt"]
                   for m in self.inflight.values())

    def enabled(self) -> list[tuple]:
        evs: list[tuple] = []
        if self.cur is None and self.op_i < len(self.scope.ops):
            evs.append(("send", 0))
        for mid in sorted(self.inflight):
            evs.append(("deliver", mid))
            if self.drops_used < self.scope.partitions:
                evs.append(("drop", mid))
                if self.inflight[mid]["kind"] == "req":
                    evs.append(("dup", mid))
        if self.inflight and self.resets_used < self.scope.crashes:
            evs.append(("reset", 0))
        if self.cur is not None and not self._attempt_live():
            if not self.backoff.exhausted():
                evs.append(("retry", 0))
            evs.append(("giveup", 0))
        return evs

    def execute(self, ev: tuple) -> dict | None:
        kind, mid = ev
        if kind == "send":
            verb = self.scope.ops[self.op_i]
            self.cur = {"op": self.op_i, "verb": verb, "attempt": 0}
            self.op_i += 1
            self.backoff.reset()
            self._invoke(verb)
            self._post_request()
            return None
        if kind == "retry":
            self.backoff.step()
            self.cur["attempt"] += 1
            self._post_request()
            return None
        if kind == "giveup":
            self._giveup()
            return None
        if kind == "dup":
            m = dict(self.inflight[mid])
            self.inflight[self.next_mid] = m
            self.next_mid += 1
            self.drops_used += 1
            return None
        if kind == "drop":
            self.inflight.pop(mid)
            self.drops_used += 1
            return None
        if kind == "reset":
            killed = list(self.inflight.values())
            self.inflight.clear()
            self.epoch += 1
            self.resets_used += 1
            return self._on_reset(killed)
        if kind == "deliver":
            m = self.inflight.pop(mid)
            if m["kind"] == "req":
                return self._serve(m)
            return self._complete(m)
        raise ValueError(f"unknown transport event {ev!r}")

    def _post_request(self) -> None:
        """Put the current attempt's request into the soup."""
        c = self.cur
        m = {"kind": "req", "op": c["op"], "attempt": c["attempt"]}
        m.update(self._request(c["verb"], c["op"]))
        self.inflight[self.next_mid] = m
        self.next_mid += 1

    def _reply(self, m: dict, **fields) -> None:
        """Queue the reply to request ``m`` (same op/attempt tags —
        what lets the client discard stale answers)."""
        r = {"kind": "reply", "op": m["op"], "attempt": m["attempt"]}
        r.update(fields)
        self.inflight[self.next_mid] = r
        self.next_mid += 1

    def _stale(self, m: dict) -> bool:
        c = self.cur
        return c is None or m["op"] != c["op"] \
            or m["attempt"] != c["attempt"]

    def _finish(self, ctor, f, value=None) -> None:
        """Complete the current op and reset the retry schedule."""
        self._h(ctor, 0, f, value)
        self.cur = None
        self.backoff.reset()

    def _giveup(self) -> None:
        verb = self.cur["verb"]
        f, value = self._render(verb)
        if verb[0] in ("r", "get"):
            self._finish(fail_op, f, value)
        else:
            # a mutation the client stops waiting for may still have
            # happened: indeterminate, never :fail
            self._finish(info_op, f, value)

    def _on_reset(self, killed: list[dict]) -> dict | None:
        return None

    # -- subclass hooks -----------------------------------------------

    def _invoke(self, verb: tuple) -> None:
        f, value = self._render(verb)
        self._h(invoke_op, 0, f, value)

    def _render(self, verb: tuple) -> tuple:
        raise NotImplementedError

    def _request(self, verb: tuple, op_index: int) -> dict:
        raise NotImplementedError

    def _serve(self, m: dict) -> dict | None:
        raise NotImplementedError

    def _complete(self, m: dict) -> dict | None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# shell-kv: the etcd-v2 shell (kv_server.dispatch) under retry
# ---------------------------------------------------------------------------


class ShellKVWorld(_TransportWorld):
    """One client retrying PUT/GET against the real
    ``kv_server.dispatch``.  Requests carry a ``reqId`` that is
    CONSTANT across retries — the idempotency key the reply-dedup
    cache closes MC202 with; ``volatile`` skips the cache (the seeded
    mode)."""

    def __init__(self, family: str, mode: str, scope):
        super().__init__(family, mode, scope)
        self.store = SimKVStore(volatile=self.volatile)
        # a CAS needs something to compare against
        self.store.state[KEY] = "1"

    def _render(self, verb: tuple) -> tuple:
        if verb[0] == "cas":
            return "cas", [verb[1], verb[2]]
        if verb[0] == "w":
            return "write", verb[1]
        return "read", None

    def _request(self, verb: tuple, op_index: int) -> dict:
        if verb[0] == "r":
            return {"method": "GET", "path": PREFIX + KEY, "body": b""}
        qs = f"reqId=op{op_index}"
        if verb[0] == "cas":
            qs = f"prevValue={verb[1]}&" + qs
        new = verb[2] if verb[0] == "cas" else verb[1]
        return {"method": "PUT", "path": f"{PREFIX}{KEY}?{qs}",
                "body": f"value={new}".encode()}

    def _serve(self, m: dict) -> dict | None:
        status, body = kv_server.dispatch(
            self.store, m["method"], m["path"], m["body"])
        if m["method"] == "PUT" and status == 200:
            self.ledger.setdefault(m["op"], set()).add("commit")
        self._reply(m, status=status,
                    body=json.dumps(body, sort_keys=True))
        return None

    def _probe_read(self) -> None:
        val = self.store.state.get(KEY)
        self._h(invoke_op, 0, "read")
        self._h(ok_op, 0, "read",
                ABSENT if val is None else int(val))

    def _complete(self, m: dict) -> dict | None:
        if self._stale(m):
            return None
        verb = self.cur["verb"]
        st = m["status"]
        if verb[0] == "r":
            if st == 200:
                val = int(json.loads(m["body"])["node"]["value"])
                self._finish(ok_op, "read", val)
            else:
                self._finish(ok_op, "read", ABSENT)
            return None
        f, value = self._render(verb)
        opi = self.cur["op"]
        if st == 200:
            self._finish(ok_op, f, value)
            return None
        self._finish(fail_op, f, value)
        if self.ledger.get(opi):
            # the server committed this op on an earlier attempt, lost
            # the reply, and just told the client it failed
            self._probe_read()
            return {"code": "MC202",
                    "detail": f"op {opi} ({f} {value!r}) committed "
                              f"server-side but the retry was answered "
                              f"{st} — the client recorded :fail for "
                              f"an applied write"}
        return None


# ---------------------------------------------------------------------------
# shell-queue: the disque-shaped shell (queue_server.dispatch)
# ---------------------------------------------------------------------------


class ShellQueueWorld(_TransportWorld):
    """One client retrying ADDJOB/GETJOB against the real
    ``queue_server.dispatch``.  ``reset`` replays the connection
    handler's reply-send-failure path: a claim whose reply died is
    returned to pending (``Store.unclaim``) — except in the seeded
    ``session-leak`` mode, which keeps the pre-fix behaviour and
    leaks the claim (MC204)."""

    def __init__(self, family: str, mode: str, scope):
        super().__init__(family, mode, scope)
        self.leak = mode == "session-leak"
        self.store = SimQueueStore(volatile=self.volatile)
        #: jid -> connection epoch that claimed it
        self.claim_epochs: dict[str, int] = {}
        #: jids whose ADDJOB ack reached the client
        self.acked_adds: set = set()

    def _clone_into(self, w) -> None:
        super()._clone_into(w)
        w.claim_epochs = dict(self.claim_epochs)
        w.acked_adds = set(self.acked_adds)

    def _store_fp(self) -> tuple:
        return (self.store.fingerprint(),
                tuple(sorted(self.claim_epochs.items())),
                tuple(sorted(self.acked_adds)))

    def _render(self, verb: tuple) -> tuple:
        if verb[0] == "add":
            return "enqueue", verb[1]
        return "dequeue", None

    def _request(self, verb: tuple, op_index: int) -> dict:
        if verb[0] == "add":
            args = ("ADDJOB", "jepsen", str(verb[1]), "0",
                    "REQID", f"op{op_index}")
        else:
            args = ("GETJOB", "TIMEOUT", "0", "COUNT", "1",
                    "FROM", "jepsen")
        return {"args": args}

    def _probe_drain(self, *, include_claimed: bool) -> None:
        bodies = [int(b) for b, _ in self.store.pending.values()]
        if include_claimed:
            bodies += [int(b) for b, _r, _t
                       in self.store.claimed.values()]
        self._h(invoke_op, 0, "drain")
        self._h(ok_op, 0, "drain", sorted(bodies))

    def _close_cur_info(self) -> None:
        """Render the open op indeterminate before probing (the
        violation fires mid-request; the client never hears back)."""
        if self.cur is not None:
            f, value = self._render(self.cur["verb"])
            self._finish(info_op, f, value)

    def _serve(self, m: dict) -> dict | None:
        payload, claimed = queue_server.dispatch(
            self.store, list(m["args"]))
        if claimed is not None:
            self.claim_epochs[claimed] = self.epoch
        self._reply(m, payload=payload, claimed=claimed or "")
        if m["args"][0] == "ADDJOB" and payload.startswith(b"+"):
            jid = payload[1:].split(b"\r")[0].decode()
            jids = self.ledger.setdefault(m["op"], set())
            jids.add(jid)
            if len(jids) > 1:
                # one client op, one REQID — two jobs minted
                self._close_cur_info()
                self._probe_drain(include_claimed=True)
                return {"code": "MC201",
                        "detail": f"ADDJOB op {m['op']} minted "
                                  f"{sorted(jids)} across retries — "
                                  f"non-idempotent retry double-"
                                  f"commit"}
        return None

    def _on_reset(self, killed: list[dict]) -> dict | None:
        for m in killed:
            if m["kind"] == "reply" and m.get("claimed"):
                if self.leak:
                    continue  # the pre-fix bug: claim stays dead-owned
                self.store.unclaim(m["claimed"])
                self.claim_epochs.pop(m["claimed"], None)
        return None

    def _zombie_claims(self) -> list[str]:
        return sorted(
            j for j, e in self.claim_epochs.items()
            if e < self.epoch and j in self.store.claimed
            and j in self.acked_adds)

    def _complete(self, m: dict) -> dict | None:
        if self._stale(m):
            return None
        verb = self.cur["verb"]
        payload = m["payload"]
        if verb[0] == "add":
            f, value = self._render(verb)
            if payload.startswith(b"+"):
                self.acked_adds.add(
                    payload[1:].split(b"\r")[0].decode())
                self._finish(ok_op, f, value)
            else:
                self._finish(fail_op, f, value)
            return None
        # GETJOB
        if payload == b"*-1\r\n":
            self._finish(fail_op, "dequeue", None)
            zombies = self._zombie_claims()
            if zombies:
                # an acked job exists but no consumer can see it: its
                # claim belongs to a connection that no longer exists
                self._probe_drain(include_claimed=False)
                return {"code": "MC204",
                        "detail": f"acked job(s) {zombies} are "
                                  f"claimed by a dead connection "
                                  f"(epoch < {self.epoch}) — invisible "
                                  f"to every consumer"}
            return None
        body = payload.split(b"\r\n")[7].decode()
        self._finish(ok_op, "dequeue", int(body))
        return None


# ---------------------------------------------------------------------------
# shell-rqueue: the replicated-queue RESP shell (dispatch_resp) with
# the follower->leader JPROXY relay in the loop
# ---------------------------------------------------------------------------


class _NoForward:
    def __call__(self, lid, args):
        raise RuntimeError("a proxied command must not re-forward")


class SimRqueueNode:
    """Duck-types the QueueReplica surface ``dispatch_resp`` and
    ``_forward_to_leader`` touch (id/lock/volatile/leader_id/
    reply_cache + addjob/getjob/ackjob) over the world's shared
    queue state — node 0 is the stable leader, node 1 the follower
    the client talks to, so every client command rides the JPROXY
    relay and the leader-side REQID dedup."""

    def __init__(self, world: "ShellRqueueWorld", node_id: int):
        self.world = world
        self.id = node_id
        self.lock = threading.Lock()
        self.volatile = world.volatile
        self.reply_cache: dict[str, bytes] = {}

    @property
    def leader_id(self) -> int:
        return self.world.beliefs[self.id]

    def addjob(self, body: str, retry_s: float):
        w = self.world
        if self.id != w.leader:
            return "noleader", None
        jid = f"D-{self.id}-{w.next_seq}"
        w.next_seq += 1
        w.pending[jid] = (body, retry_s)
        return "ok", jid

    def getjob(self, timeout_ms: int):
        w = self.world
        if self.id != w.leader:
            return "noleader", None
        if not w.pending:
            return "ok", None
        jid, (body, retry_s) = w.pending.popitem(last=False)
        w.claimed[jid] = (body, retry_s)
        return "ok", (jid, body)

    def ackjob(self, jid: str):
        w = self.world
        if self.id != w.leader:
            return "noleader", None
        known = jid in w.pending or jid in w.claimed
        w.pending.pop(jid, None)
        w.claimed.pop(jid, None)
        return "ok", 1 if known else 0


class ShellRqueueWorld(_TransportWorld):
    """The replicated queue's SHELL under the transport: the client's
    commands land on the FOLLOWER, whose real ``dispatch_resp`` relays
    them to the leader as JPROXY commands (the forward leg runs the
    leader's ``dispatch_resp`` with ``proxied=True`` — one atomic
    RPC, the same under-approximation the core checker makes).  The
    REQID dedup lives on the leader; ``volatile`` skips it — retried
    ADDJOBs then double-commit through the proxy (MC201)."""

    def __init__(self, family: str, mode: str, scope):
        super().__init__(family, mode, scope)
        self.leader = 0
        self.beliefs = [0] * scope.nodes
        self.next_seq = 0
        self.pending: OrderedDict[str, tuple[str, float]] = OrderedDict()
        self.claimed: dict[str, tuple[str, float]] = {}
        self.nodes = [SimRqueueNode(self, i)
                      for i in range(scope.nodes)]
        self.store = None  # shared state lives on the world

    def _clone_into(self, w) -> None:
        w.beliefs = list(self.beliefs)
        w.pending = OrderedDict(self.pending)
        w.claimed = dict(self.claimed)
        w.nodes = [SimRqueueNode(w, i)
                   for i in range(self.scope.nodes)]
        for old, new in zip(self.nodes, w.nodes):
            new.reply_cache = dict(old.reply_cache)

    def _store_fp(self) -> tuple:
        return (self.next_seq, tuple(self.pending.items()),
                tuple(sorted(self.claimed.items())),
                tuple(self.beliefs),
                tuple(tuple(sorted(n.reply_cache.items()))
                      for n in self.nodes))

    def _render(self, verb: tuple) -> tuple:
        if verb[0] == "add":
            return "enqueue", verb[1]
        return "dequeue", None

    def _request(self, verb: tuple, op_index: int) -> dict:
        if verb[0] == "add":
            args = ("ADDJOB", "jepsen", str(verb[1]), "0",
                    "REQID", f"op{op_index}")
        else:
            args = ("GETJOB", "TIMEOUT", "0", "COUNT", "1",
                    "FROM", "jepsen")
        return {"args": args}

    def _forward(self, lid: int, args: list[str]) -> bytes:
        return dispatch_resp(self.nodes[lid], list(args),
                             proxied=True, forward=_NoForward())

    def _probe_drain(self) -> None:
        bodies = sorted(
            [int(b) for b, _ in self.pending.values()]
            + [int(b) for b, _ in self.claimed.values()])
        self._h(invoke_op, 0, "drain")
        self._h(ok_op, 0, "drain", bodies)

    def _close_cur_info(self) -> None:
        if self.cur is not None:
            f, value = self._render(self.cur["verb"])
            self._finish(info_op, f, value)

    def _serve(self, m: dict) -> dict | None:
        entry = self.nodes[min(1, len(self.nodes) - 1)]
        payload = dispatch_resp(entry, list(m["args"]),
                                proxied=False, forward=self._forward)
        self._reply(m, payload=payload)
        if m["args"][0] == "ADDJOB" and payload.startswith(b"+"):
            jid = payload[1:].split(b"\r")[0].decode()
            jids = self.ledger.setdefault(m["op"], set())
            jids.add(jid)
            if len(jids) > 1:
                self._close_cur_info()
                self._probe_drain()
                return {"code": "MC201",
                        "detail": f"proxied ADDJOB op {m['op']} "
                                  f"minted {sorted(jids)} across "
                                  f"retries — the leader-side REQID "
                                  f"dedup did not hold"}
        return None

    def _complete(self, m: dict) -> dict | None:
        if self._stale(m):
            return None
        verb = self.cur["verb"]
        payload = m["payload"]
        f, value = self._render(verb)
        if verb[0] == "add":
            if payload.startswith(b"+"):
                self._finish(ok_op, f, value)
            elif payload.startswith(b"-NOREPL"):
                self._finish(info_op, f, value)
            else:
                self._finish(fail_op, f, value)
            return None
        if payload == b"*-1\r\n":
            self._finish(fail_op, "dequeue", None)
        elif payload.startswith(b"-NOREPL"):
            self._finish(info_op, "dequeue", None)
        elif payload.startswith(b"-"):
            self._finish(fail_op, "dequeue", None)
        else:
            body = payload.split(b"\r\n")[7].decode()
            self._finish(ok_op, "dequeue", int(body))
        return None


# ---------------------------------------------------------------------------
# shell-replicated: handle_client_request + the proxy mesh
# ---------------------------------------------------------------------------


class SimReplNode:
    """Duck-types the Replica surface ``handle_client_request``
    touches (id/lock/leader_id + get/put) over the world's
    leadership model: ``serving`` is the lease the shell trusts,
    ``beliefs[i]`` is node i's possibly-stale leader view, and only
    the ACTUAL leader can commit — a deposed-but-still-serving node
    (the seeded ``stale-proxy`` mode) answers reads from its frozen
    state and writes with 504 (it cannot reach quorum)."""

    def __init__(self, world: "ShellReplWorld", node_id: int):
        self.world = world
        self.id = node_id
        self.lock = threading.Lock()

    @property
    def leader_id(self) -> int | None:
        return self.world.beliefs[self.id]

    def get(self, key: str) -> tuple[int, dict]:
        w = self.world
        if not w.serving[self.id]:
            return 503, {"errorCode": 300, "message": "not leader"}
        val = w.states[self.id].get(key)
        if val is None:
            return 404, {"errorCode": 100,
                         "message": "Key not found", "cause": key}
        return 200, {"action": "get",
                     "node": {"key": f"/{key}", "value": val}}

    def put(self, key: str, value: str,
            prev: str | None = None) -> tuple[int, dict]:
        w = self.world
        if not w.serving[self.id]:
            return 503, {"errorCode": 300, "message": "not leader"}
        if self.id != w.actual:
            # a stale leader can accept the request but not assemble a
            # quorum: indeterminate, never a lie
            return 504, {"errorCode": 301, "message": "no quorum"}
        if prev is not None and w.states[self.id].get(key) != prev:
            return 412, {"errorCode": 101, "message": "Compare failed"}
        w.states[self.id][key] = value
        w.log_state[key] = value
        return 200, {"action": "set",
                     "node": {"key": f"/{key}", "value": value}}


class ShellReplWorld:
    """The replicated-server SHELL — the follower→leader proxy
    decision inside ``handle_client_request`` — under a leadership
    model the scheduler perturbs.  Events:

      ``op i``     the client sends its next program op to node i;
                   the request resolves atomically (local serve or
                   proxy hop via the node's leader belief)
      ``elect j``  leadership moves to node j (j catches up from the
                   replicated state); the old leader's lease is
                   revoked — except in ``stale-proxy`` mode, where it
                   keeps serving (the seeded MC205 bug)
      ``learn i``  node i refreshes its leader belief

    ``proxy-loop`` mode strips the proxied marker off forwarded
    requests (the seeded MC203 bug): two confused beliefs then
    re-forward forever; the transport raises after nodes+1 hops and
    the world reports the amplification."""

    def __init__(self, family: str, mode: str, scope):
        self.family = family
        self.mode = mode
        self.scope = scope
        n = scope.nodes
        self.states: list[dict] = [{} for _ in range(n)]
        self.log_state: dict = {}
        self.serving = [i == 0 for i in range(n)]
        self.beliefs = [0] * n
        self.actual = 0
        self.elects_used = 0
        self.op_i = 0
        self.committed: dict = {}
        self.maybes: dict = {}
        self.loop_overflow = False
        self.max_hops = 0
        self.nodes = [SimReplNode(self, i) for i in range(n)]
        self.history: list[Op] = []
        self.t = 0

    def clone(self) -> "ShellReplWorld":
        w = object.__new__(type(self))
        w.__dict__.update(self.__dict__)
        w.states = [dict(s) for s in self.states]
        w.log_state = dict(self.log_state)
        w.serving = list(self.serving)
        w.beliefs = list(self.beliefs)
        w.committed = dict(self.committed)
        w.maybes = {k: list(v) for k, v in self.maybes.items()}
        w.nodes = [SimReplNode(w, i)
                   for i in range(self.scope.nodes)]
        w.history = list(self.history)
        return w

    def fingerprint(self) -> tuple:
        return (
            tuple(tuple(sorted(s.items())) for s in self.states),
            tuple(sorted(self.log_state.items())),
            tuple(self.serving), tuple(self.beliefs),
            self.actual, self.elects_used, self.op_i,
            tuple(sorted(self.committed.items())),
            tuple(sorted((k, tuple(v))
                         for k, v in self.maybes.items())),
            self.loop_overflow,
        )

    def enabled(self) -> list[tuple]:
        evs: list[tuple] = []
        n = self.scope.nodes
        if self.op_i < len(self.scope.ops):
            evs.extend(("op", i) for i in range(n))
        if self.elects_used < self.scope.crashes:
            evs.extend(("elect", j) for j in range(n)
                       if j != self.actual)
        evs.extend(("learn", i) for i in range(n)
                   if self.beliefs[i] != self.actual)
        return evs

    def _h(self, ctor, process, f, value=None) -> None:
        self.history.append(ctor(process, f, value, time=self.t))
        self.t += 1

    def _possible(self, k) -> set:
        poss = set(self.maybes.get(k, ()))
        poss.add(self.committed.get(k))
        return poss

    def _deliver(self, i: int, method: str, path: str,
                 raw_body: bytes | None, hops: list,
                 proxied: bool) -> tuple[int, dict]:
        hops.append(i)
        self.max_hops = max(self.max_hops, len(hops))
        if len(hops) > self.scope.nodes + 1:
            # a correct proxy mesh touches at most two nodes per
            # request; past every node it can only be looping
            self.loop_overflow = True
            raise OSError("proxy loop suspected")

        def forward(lid, m, p, b):
            return self._deliver(
                lid, m, p, b, hops,
                proxied=self.mode != "proxy-loop")

        return handle_client_request(
            self.nodes[i], method, path, raw_body,
            proxied=proxied, forward=forward)

    def execute(self, ev: tuple) -> dict | None:
        kind, i = ev
        if kind == "elect":
            self.elects_used += 1
            old = self.actual
            self.actual = i
            self.serving[i] = True
            # the new leader catches up from the replicated log
            self.states[i] = dict(self.log_state)
            if self.mode != "stale-proxy":
                self.serving[old] = False
            return None
        if kind == "learn":
            self.beliefs[i] = self.actual
            return None
        # op
        verb = self.scope.ops[self.op_i]
        self.op_i += 1
        self.loop_overflow = False
        self.max_hops = 0
        hops: list = []
        if verb[0] == "w":
            val = verb[1]
            if val == ABSENT:
                raise ValueError("kv write values must be non-zero "
                                 "(0 renders key absence)")
            self._h(invoke_op, 0, "write", val)
            path = PREFIX + KEY
            body = f"value={val}".encode()
            status, _b = self._deliver(i, "PUT", path, body, hops,
                                       proxied=False)
            if status == 200:
                self.committed[KEY] = val
                self.maybes[KEY] = []
                self._h(ok_op, 0, "write", val)
            elif status == 504:
                self.maybes.setdefault(KEY, []).append(val)
                self._h(info_op, 0, "write", val)
            else:
                self._h(fail_op, 0, "write", val)
        else:  # ("r",)
            self._h(invoke_op, 0, "read")
            status, b = self._deliver(i, "GET", PREFIX + KEY, None,
                                      hops, proxied=False)
            if status == 200:
                val = int(b["node"]["value"])
                self._h(ok_op, 0, "read", val)
                if val not in self._possible(KEY):
                    return {"code": "MC205",
                            "detail": f"read at node {i} answered "
                                      f"{val!r} via {hops} — a deposed "
                                      f"leader served outside the "
                                      f"possible set "
                                      f"{sorted(map(repr, self._possible(KEY)))}"}
            elif status == 404:
                self._h(ok_op, 0, "read", ABSENT)
                if None not in self._possible(KEY):
                    return {"code": "MC205",
                            "detail": f"read at node {i} answered "
                                      f"absent via {hops}; possible "
                                      f"was "
                                      f"{sorted(map(repr, self._possible(KEY)))}"}
            elif status == 504:
                self._h(info_op, 0, "read")
            else:
                self._h(fail_op, 0, "read")
        if self.loop_overflow:
            return {"code": "MC203",
                    "detail": f"request to node {i} was re-forwarded "
                              f"through {hops} — the proxied marker "
                              f"did not stop the relay"}
        return None
