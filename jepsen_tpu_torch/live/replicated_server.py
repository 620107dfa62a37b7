"""live replicated KV node — a 3-replica etcd-v2 cluster, for real.
A copy of the JAX package's ``live/replicated_server.py``, stdlib-only.

One logical node of the live **replicated** family: a REAL OS process
serving the same etcd **v2 keys surface** as ``live/kv_server.py``
(`GET/PUT /v2/keys/<k>` with ``prevValue`` CAS — the wire protocol the
etcd suite's ``V2Client`` already speaks), but as one replica of a
small consensus group, so the kill-restart and partition nemeses bite
*consensus*, not just availability:

  * **leader lease** — one node at a time holds a time-bounded lease
    granted by a majority.  Followers refuse to vote while they honor
    a live leader, and the leader serves with a safety margin
    (``LEADER_MARGIN``) of the lease the followers honor, so a
    deposed leader stops serving *before* its successor starts — the
    stale-leader-read window is closed by construction (up to clock
    rate skew past the margin, which the clock nemesis probes).
  * **majority-ack writes** — the leader appends the entry to the
    shared oplog (durable, fsync — the commit record), then
    replicates it to every peer over the loopback wire and replies OK
    only once a majority (itself included) acknowledged.  A write
    that can't reach a majority returns 500, which ``V2Client`` maps
    to ``:info`` — exactly the "maybe happened" the checker models.
  * **follower catch-up from the shared oplog** — replica state is a
    replay of the shared oplog prefix.  A restarted (or gapped)
    follower re-reads the oplog tail; a freshly elected leader
    catches up *before* serving, so an un-acked entry a crashed
    leader left in the log is adopted consistently by everyone
    (it was ``:info``: "took effect" is legal).

The protocol brain lives in :class:`ReplicaCore` — a PURE state
machine: no clock reads (time arrives as an explicit ``now``), no
sockets, no locks, no files.  :class:`Replica` is its daemon shell:
it owns the lock, the ticker thread, the durable shared oplog, and
the peer wire, and delegates every state decision to the core.  The
split is what lets ``analyze/modelcheck.py`` lift the SAME state
machine into a deterministic single-threaded scheduler and explore
its interleavings exhaustively at bounded scope — the bugs the model
checker finds are bugs in exactly the code the daemon runs.

Seeded-bug modes, the campaign's detection targets:

  ``volatile``     mutations skip the shared oplog and elections skip
                   the log-completeness check: a kill -9'd leader
                   restarts empty, can win the next election, and
                   serves reads that un-write acked data — the
                   kill-seeded violation the streaming checker's
                   bounded `:info` lookahead must flip mid-stream.
  ``split-brain``  a leader never steps down and serves reads without
                   a live lease: partition it away (or pause it past
                   its lease) and it keeps answering from stale state
                   while the majority elects a successor — two
                   leaders, client-visible stale reads.

Status mapping on the client surface is kv_server's, plus:

  not the leader / no leader known  -> 503 {"errorCode": 300}
                                       (REJECTED before any mutation:
                                       the op definitely didn't happen)
  no quorum after the oplog append  -> 504 {"errorCode": 301}
                                       (INDETERMINATE: a successor may
                                       adopt the entry — the client
                                       must record :info)

Internal peer surface (loopback only, same port):

  GET  /_repl/status                     -> role/term/seq/leader json
  GET  /_repl/vote?term=T&cand=I&seq=S   -> {"granted": bool, ...}
  GET  /_repl/ping?term=T&leader=I       -> {"granted": bool, ...}
  POST /_repl/append   {entry json}      -> {"seq": applied}

Stdlib-only on purpose (plus live.oplog, itself stdlib-only): a
replica forks at daemon startup and must not drag the checker stack.

Usage::

  python -m jepsen_tpu_torch.live.replicated_server PORT DATA_DIR \
      --id I --peers P1,P2,P3 --oplog PATH [--lease-ms MS] \
      [--host H] [volatile] [split-brain]

``--peers`` entries are ``host:port`` (bare ports mean 127.0.0.1).
With ``--host`` every node binds its own loopback address and every
peer request is **source-bound** to it, so the per-peer-link
partitioner (live/links.py) can cut exactly the (src, dst) pairs a
grudge names — consensus traffic rides the links, client traffic
(default 127.0.0.1 source) does not.
"""

from __future__ import annotations

import json
import random
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PREFIX = "/v2/keys/"


def http_json(host: str, port: int, path: str, *, method: str = "GET",
              data: bytes | None = None, timeout: float = 0.5,
              src: str | None = None,
              headers: dict | None = None) -> tuple[int, dict]:
    """One JSON HTTP round trip with an explicit SOURCE address —
    urllib can't source-bind, and without it every peer packet leaves
    as 127.0.0.1 and no link rule can tell the peers apart.  Error
    statuses come back as values (no exception); transport failures
    raise OSError (ConnectionRefusedError when nothing accepted the
    bytes — the caller's "definitely didn't happen" case)."""
    import http.client

    conn = http.client.HTTPConnection(
        host, port, timeout=timeout,
        source_address=(src, 0) if src else None)
    try:
        try:
            conn.request(method, path, body=data, headers=headers or {})
            r = conn.getresponse()
            body = r.read()
        except http.client.HTTPException as e:
            raise OSError(f"http: {e}") from e
        try:
            return r.status, json.loads(body or b"{}")
        except ValueError as e:
            # a torn/malformed body behind a 200: the peer PROCESSED
            # the request — the caller must treat it as indeterminate,
            # never as a clean reply
            raise OSError(f"malformed reply: {e}") from e
    finally:
        conn.close()

#: the fraction of the follower-honored lease a leader trusts for its
#: own serving — the stale-read window survives only a clock *rate*
#: skew larger than 1/LEADER_MARGIN (2x at 0.5)
LEADER_MARGIN = 0.5


class ReplicaCore:
    """The pure replica state machine — every consensus decision, no
    effects.

    Time is an explicit ``now`` argument (the shell passes
    ``time.monotonic()``; the model checker passes its logical clock),
    randomness an explicit ``jitter``, and the shared oplog an
    injected zero-arg ``catch_up`` callable that replays the log tail
    through :meth:`apply` (the shell binds the fsync'd file, the model
    checker binds a plain list).  Everything else is deterministic
    arithmetic over plain attributes, which is what makes bounded
    exhaustive exploration of THIS object — not a re-implementation —
    possible."""

    #: oplog entry kinds this state machine replays (subclasses — the
    #: replicated queue — override both this and ``apply``)
    REPLAY_OPS = ("set",)

    def __init__(self, node_id: int, n_nodes: int, *,
                 lease_s: float = 0.7, volatile: bool = False,
                 split_brain: bool = False, now: float = 0.0):
        self.id = node_id
        self.n_nodes = n_nodes
        self.lease_s = lease_s
        self.volatile = volatile
        self.split_brain = split_brain

        self.state: dict[str, str] = {}
        self.seq = 0          # last applied entry seq
        self.term = 0         # highest term seen
        self.role = "follower"
        self.leader_id: int | None = None
        # the election timer starts NOW (not at epoch 0): the id
        # stagger in election_timeout differentiates who campaigns
        # first, instead of every fresh replica dueling on tick one
        self.lease_until = now
        self.granted_term = 0    # highest term this node voted in
        #: replay the shared-oplog tail through apply(); injected by
        #: the owner (Replica binds the durable file under its lock,
        #: the model checker binds a shared list) — returns the count
        #: of entries applied
        self.catch_up = lambda: 0

    # -- log replay ---------------------------------------------------

    def wants(self, e: dict) -> bool:
        """Replay filter: entry kinds this machine applies, past the
        applied prefix."""
        return e.get("op") in self.REPLAY_OPS \
            and int(e.get("seq", 0)) > self.seq

    def apply(self, e: dict) -> None:
        self.state[e["k"]] = e["v"]
        self.seq = e["seq"]

    # -- lease / election ---------------------------------------------

    def majority(self) -> int:
        return self.n_nodes // 2 + 1

    def election_timeout(self) -> float:
        # staggered by id so replicas don't duel; ~1.5-2.5 leases
        return self.lease_s * (1.5 + 0.35 * self.id)

    def step_leader_expiry(self, now: float) -> bool:
        """A leader whose serving lease lapsed steps down — except the
        split-brain seeded defect, which never concedes.  True when a
        step-down happened."""
        if self.role == "leader" and now > self.lease_until \
                and not self.split_brain:
            self.role = "follower"
            self.leader_id = None
            return True
        return False

    def election_due(self, now: float) -> bool:
        """Should a non-leader campaign now?  The follower lease must
        have lapsed AND the id-staggered election timer fired."""
        return self.role != "leader" and now > self.lease_until \
            and now - self.lease_until > \
            self.election_timeout() - self.lease_s

    def begin_campaign(self) -> tuple[int, int]:
        """Open a candidacy: catch up from the shared oplog first (so
        a won election never resurrects a stale seq in durable mode),
        bump the term, self-vote.  -> (term, seq) for the ballots."""
        self.catch_up()
        self.term += 1
        self.granted_term = self.term  # self-vote
        return self.term, self.seq

    def win_campaign(self, term: int, now: float) -> bool:
        """A majority granted ``term``: become leader (unless the term
        moved on underneath the ballots)."""
        if self.term != term:
            return False
        self.role = "leader"
        self.leader_id = self.id
        self.lease_until = now + self.lease_s * LEADER_MARGIN
        return True

    def lose_campaign(self, now: float, jitter: float = 0.0) -> None:
        """Lost ballots: back off the election timer (jittered, id-
        staggered) instead of re-campaigning every tick and ratcheting
        terms into a permanent duel.  ``jitter`` is uniform [0,1) —
        the shell passes random.random(), the model checker 0."""
        if self.role != "leader":
            self.lease_until = now + self.lease_s \
                * (0.3 + 0.3 * self.id + 0.4 * jitter)

    def heartbeat_ack(self, term: int, now: float) -> None:
        """A heartbeat round for ``term`` got majority grants:
        followers honor lease_s from *their* grant; the leader trusts
        only the margin of it."""
        if self.role == "leader" and self.term == term:
            self.lease_until = now + self.lease_s * LEADER_MARGIN

    # -- peer surface -------------------------------------------------

    def on_ping(self, term: int, leader: int, leader_seq: int,
                now: float) -> dict:
        if term < self.term:
            return {"granted": False, "term": self.term}
        if term > self.term or self.role != "leader":
            if self.role == "leader" and self.split_brain:
                # the seeded defect: never concede leadership
                return {"granted": False, "term": self.term}
            self.term = term
            self.role = "follower"
            self.leader_id = leader
            self.lease_until = now + self.lease_s
            if leader_seq > self.seq:
                # an idle cluster still converges: a healed minority
                # catches up from the shared oplog on the next
                # heartbeat, not only on the next write
                self.catch_up()
            return {"granted": True, "term": self.term,
                    "seq": self.seq}
        # same-term second leader can't exist (majority vote), so
        # this is our own echo shape — grant
        self.lease_until = now + self.lease_s
        return {"granted": True, "term": self.term, "seq": self.seq}

    def on_vote(self, term: int, cand: int, cand_seq: int,
                now: float) -> dict:
        fresh_leader = now < self.lease_until \
            and self.leader_id is not None \
            and self.leader_id != cand
        if term <= self.granted_term or term < self.term:
            return {"granted": False, "term": self.term}
        if fresh_leader and not self.volatile:
            # don't vote while honoring a live leader — the lease
            # safety rule that closes the two-leader window
            return {"granted": False, "term": self.term}
        if not self.volatile and cand_seq < self.seq:
            # log completeness: a data-losing candidate loses.
            # volatile mode SKIPS this — the seeded bug: a freshly
            # restarted empty node can win and un-write acked data
            return {"granted": False, "term": self.term,
                    "seq": self.seq}
        self.granted_term = term
        self.term = max(self.term, term)
        if self.role == "leader" and not self.split_brain:
            self.role = "follower"
        self.leader_id = None  # until the winner heartbeats
        # give the winner a full lease to establish itself before
        # this granter's own election timer can fire
        self.lease_until = now + self.lease_s
        return {"granted": True, "term": self.term}

    def on_append(self, e: dict, now: float) -> tuple[int, dict]:
        term = int(e.get("term", 0))
        if term < self.term:
            return 409, {"term": self.term}
        if self.role == "leader" and self.split_brain \
                and int(e.get("leader", -1)) != self.id:
            # the seeded defect, fully symmetric: a split-brain
            # leader not only keeps serving, it refuses a rival's
            # entries — its side of the brain stays frozen
            return 409, {"term": self.term}
        self.term = term
        self.leader_id = int(e.get("leader", -1))
        if self.role == "leader" and self.leader_id != self.id \
                and not self.split_brain:
            self.role = "follower"
        self.lease_until = now + self.lease_s
        seq = int(e["seq"])
        if seq == self.seq + 1:
            self.apply(e)
        elif seq > self.seq:
            self.catch_up()
            if seq == self.seq + 1 or (self.volatile
                                       and seq > self.seq):
                # volatile: nothing durable to catch up from — blind
                # adoption keeps the cluster moving and plants exactly
                # the ghost-state divergence the checker exists to
                # catch
                self.apply(e)
        return 200, {"seq": self.seq}

    # -- client surface (leader path) ---------------------------------

    def leader_serving(self, now: float) -> bool:
        return self.role == "leader" and (
            self.split_brain or now < self.lease_until)

    def next_seq(self) -> int:
        """The next commit's seq, with the shared-oplog tail adopted
        first: a deposed leader's un-acked append may have landed
        after this leader's election catch-up, and assigning the same
        seq to a NEW entry would fork the log (catch-up applies
        whichever came first and skips the other — an acked write
        could silently lose)."""
        self.catch_up()
        return self.seq + 1

    def get(self, key: str, now: float) -> tuple[int, dict]:
        if not self.leader_serving(now):
            return 503, {"errorCode": 300, "message": "not leader"}
        v = self.state.get(key)
        if v is None:
            return 404, {"errorCode": 100, "message": "Key not found",
                         "cause": key}
        return 200, {"action": "get",
                     "node": {"key": f"/{key}", "value": v}}

    def put_prepare(self, key: str, value: str, prev: str | None,
                    now: float) -> tuple[int, dict, dict | None]:
        """Everything of a PUT up to (not including) the commit:
        leadership check, shared-tail adoption + seq assignment, CAS
        compare, entry construction.  -> (status, body, entry);
        ``entry`` is non-None exactly when the owner must now run the
        commit protocol (and downgrade to 504/no-quorum on failure)."""
        if not self.leader_serving(now):
            return 503, {"errorCode": 300, "message": "not leader"}, \
                None
        # adopt the shared-oplog tail BEFORE the CAS compare and the
        # seq assignment, so neither reads stale state
        seq = self.next_seq()
        if prev is not None:
            cur = self.state.get(key)
            if cur is None:
                return 404, {"errorCode": 100,
                             "message": "Key not found",
                             "cause": key}, None
            if cur != prev:
                return 412, {"errorCode": 101,
                             "message": "Compare failed",
                             "cause": f"[{prev} != {cur}]"}, None
        entry = {"op": "set", "seq": seq, "term": self.term,
                 "leader": self.id, "k": key, "v": value}
        body = {"action": "compareAndSwap" if prev is not None
                else "set",
                "node": {"key": f"/{key}", "value": value}}
        return 200, body, entry

    def snapshot(self) -> tuple:
        """A hashable fingerprint of the whole machine — the model
        checker's visited-state key and commutativity witness."""
        return (self.id, self.seq, self.term, self.role,
                self.leader_id, self.granted_term,
                round(self.lease_until, 9),
                tuple(sorted(self.state.items())))

    def status(self, now: float) -> dict:
        return {"id": self.id, "role": self.role, "term": self.term,
                "seq": self.seq, "leader": self.leader_id,
                "lease_remaining_s": round(self.lease_until - now, 3),
                "volatile": self.volatile,
                "split_brain": self.split_brain}


class Replica:
    """One replica daemon: the wire, the lock, the ticker thread, and
    the durable shared oplog around a :class:`ReplicaCore`.  Every
    state decision is the core's; this shell only supplies effects
    (HTTP fan-out, fsync, real time, real randomness)."""

    #: the pure state machine this shell drives (the replicated queue
    #: swaps in QueueCore)
    CORE_CLS = ReplicaCore

    def __init__(self, node_id: int, peers: list, oplog_path: str,
                 lease_s: float = 0.7, volatile: bool = False,
                 split_brain: bool = False, host: str = "127.0.0.1"):
        import os

        from .oplog import DurableLog

        self.id = node_id
        self.host = host  # own address; peer requests source-bind it
        #: (host, port) per replica, index == node id; includes self
        self.peers = [p if isinstance(p, tuple) else ("127.0.0.1", p)
                      for p in peers]
        self.lease_s = lease_s
        self.volatile = volatile
        self.split_brain = split_brain

        self.lock = threading.RLock()
        self.core = self.CORE_CLS(
            node_id, len(self.peers), lease_s=lease_s,
            volatile=volatile, split_brain=split_brain,
            now=time.monotonic())
        # the core's log replay is THIS shell's durable tail read;
        # every core call happens under self.lock, so the binding is
        # lock-safe by construction
        self.core.catch_up = self._catch_up_locked

        self.log = DurableLog(os.path.dirname(oplog_path) or ".",
                              name=os.path.basename(oplog_path),
                              volatile=volatile)
        #: how far into the shared oplog this replica has scanned —
        #: catch-up (which runs per commit, see commit_seq_locked)
        #: reads only the tail past it, not the whole file
        self._log_pos = 0
        self._catch_up_locked()
        self.log.open()
        self._stop = threading.Event()
        self._ticker = threading.Thread(target=self._tick_loop,
                                        name="repl-tick", daemon=True)

    # -- core state, read-only (proxy + status paths) -----------------

    @property
    def leader_id(self):
        return self.core.leader_id

    @property
    def seq(self):
        return self.core.seq

    @property
    def term(self):
        return self.core.term

    @property
    def role(self):
        return self.core.role

    @property
    def state(self):
        return self.core.state

    # -- log replay / catch-up ----------------------------------------

    def _catch_up_locked(self) -> int:
        """Replay every shared-oplog entry past the applied prefix —
        restart recovery AND gap repair use the same path.  Scans only
        the file tail past ``_log_pos`` (this runs per commit)."""
        applied = 0
        lines, self._log_pos = self.log.tail(self._log_pos)
        for line in lines:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if self.core.wants(e):
                self.core.apply(e)
                applied += 1
        return applied

    # -- lease / election ---------------------------------------------

    def start(self) -> None:
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()

    def _majority(self) -> int:
        return self.core.majority()

    def _peer_get(self, peer: tuple, path: str, timeout: float = 0.4):
        host, port = peer
        status, out = http_json(host, port, path, timeout=timeout,
                                src=self.host)
        if status >= 400:
            raise OSError(f"peer {host}:{port} -> {status}")
        return out

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.lease_s / 4.0):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def _tick(self) -> None:
        now = time.monotonic()
        with self.lock:
            role, term = self.core.role, self.core.term
            campaign_due = self.core.election_due(now)
        if role == "leader":
            with self.lock:
                if self.core.step_leader_expiry(time.monotonic()):
                    return
            self._heartbeat(term)
        elif campaign_due:
            self._campaign()

    def _heartbeat(self, term: int) -> None:
        acks = 1
        with self.lock:
            seq = self.core.seq
        for i, peer in enumerate(self.peers):
            if i == self.id:
                continue
            try:
                out = self._peer_get(
                    peer, f"/_repl/ping?term={term}&leader={self.id}"
                          f"&seq={seq}")
                if out.get("granted"):
                    acks += 1
            except OSError:
                pass
        if acks >= self._majority():
            with self.lock:
                self.core.heartbeat_ack(term, time.monotonic())

    def _campaign(self) -> None:
        with self.lock:
            term, seq = self.core.begin_campaign()
        votes = 1
        for i, peer in enumerate(self.peers):
            if i == self.id:
                continue
            try:
                out = self._peer_get(
                    peer,
                    f"/_repl/vote?term={term}&cand={self.id}&seq={seq}")
                if out.get("granted"):
                    votes += 1
            except OSError:
                pass
        if votes >= self._majority():
            with self.lock:
                self.core.win_campaign(term, time.monotonic())
            self._heartbeat(term)
        else:
            with self.lock:
                self.core.lose_campaign(time.monotonic(),
                                        random.random())

    # -- peer surface --------------------------------------------------

    def on_ping(self, term: int, leader: int,
                leader_seq: int = 0) -> dict:
        with self.lock:
            return self.core.on_ping(term, leader, leader_seq,
                                     time.monotonic())

    def on_vote(self, term: int, cand: int, cand_seq: int) -> dict:
        with self.lock:
            return self.core.on_vote(term, cand, cand_seq,
                                     time.monotonic())

    def on_append(self, e: dict) -> tuple[int, dict]:
        with self.lock:
            return self.core.on_append(e, time.monotonic())

    # -- client surface (leader path) ---------------------------------

    def leader_serving(self) -> bool:
        with self.lock:
            return self.core.leader_serving(time.monotonic())

    def get(self, key: str) -> tuple[int, dict]:
        with self.lock:
            return self.core.get(key, time.monotonic())

    def put(self, key: str, value: str,
            prev: str | None = None) -> tuple[int, dict]:
        if not self.leader_serving():
            return 503, {"errorCode": 300, "message": "not leader"}
        with self.lock:
            status, body, entry = self.core.put_prepare(
                key, value, prev, time.monotonic())
            if entry is not None and not self.commit_locked(entry):
                # the entry is in the shared log — a successor will
                # adopt it — but THIS client gets indeterminacy (504,
                # NOT 503: a 503 means "definitely didn't happen")
                return 504, {"errorCode": 301, "message": "no quorum"}
            return status, body

    def _replicate_locked(self, entry: dict) -> int:
        """Fan the entry out to every peer (source-bound, so link
        grudges bite); returns the ack count, self included."""
        acks = 1
        data = json.dumps(entry).encode()
        for i, (h, p) in enumerate(self.peers):
            if i == self.id:
                continue
            try:
                status, _ = http_json(
                    h, p, "/_repl/append", method="POST", data=data,
                    timeout=0.5, src=self.host,
                    headers={"Content-Type": "application/json"})
                if status < 400:
                    acks += 1
            except OSError:
                pass
        return acks

    def commit_locked(self, entry: dict) -> bool:
        """The one commit path, shared with the replicated queue: the
        commit record first (durable before any ack can exist), then
        the wire, majority required — under the caller's lock: the
        linearization point of an acked mutation is in here.  False
        means no quorum — indeterminate, never "didn't happen" (the
        entry is in the shared log; a successor may adopt it).

        Callers build the entry with ``seq`` = ``core.seq + 1`` under
        the same lock AFTER :meth:`ReplicaCore.next_seq`, which
        re-reads the shared-oplog tail first (see its docstring for
        the log-fork hazard)."""
        self.log.append(json.dumps(entry))
        if self._replicate_locked(entry) < self._majority():
            return False
        self.core.apply(entry)
        return True

    def commit_seq_locked(self) -> int:
        """The next commit's seq (shared-oplog tail adopted first);
        caller holds the lock."""
        return self.core.next_seq()

    def status(self) -> dict:
        with self.lock:
            return self.core.status(time.monotonic())


def handle_client_request(rep: Replica, method: str, path: str,
                          raw_body: bytes | None, *, proxied: bool,
                          forward) -> tuple[int, dict]:
    """One client request (GET/PUT of a key) against a replica:
    (status, reply body).  Pure in (request, replica, forward) — the
    real HTTP handler and the model checker's simnet both call it, so
    the follower→leader proxy decision is inside the verified
    boundary (the shell-lifting contract, docs/analyze.md §12).

    ``forward(lid, method, path, raw_body) -> (status, body)`` sends
    the request to the believed leader; it raises
    ``ConnectionRefusedError`` when nothing accepted the bytes (the op
    definitely didn't happen — safe to fall back to the local 503) and
    any other ``OSError`` when the outcome is indeterminate (it may
    have fired AFTER the leader processed the op — the client gets a
    504, never a 503 that would let it record :fail for a write that
    actually committed).  A ``proxied`` request is never re-proxied,
    so confused leader views can't loop."""
    parsed = urllib.parse.urlparse(path)
    if not parsed.path.startswith(PREFIX):
        return 404, {"errorCode": 100, "message": "bad path"}
    key = urllib.parse.unquote(parsed.path[len(PREFIX):]) or None
    if key is None:
        return 404, {"errorCode": 100, "message": "bad path"}
    if method == "GET":
        status, body = rep.get(key)
    elif method == "PUT":
        try:
            form = urllib.parse.parse_qs(
                (raw_body or b"").decode("utf-8", "replace"))
            value = form["value"][0]
        except (ValueError, KeyError, IndexError):
            return 400, {"errorCode": 209, "message": "bad form"}
        prev = urllib.parse.parse_qs(parsed.query).get(
            "prevValue", [None])[0]
        status, body = rep.put(key, value, prev)
    else:
        return 404, {"errorCode": 100, "message": "bad path"}
    if status != 503 or proxied:
        return status, body
    with rep.lock:
        lid = rep.leader_id
    if lid is None or lid == rep.id:
        return status, body  # no usable leader: the local 503 stands
    try:
        return forward(lid, method, path, raw_body)
    except ConnectionRefusedError:
        return status, body
    except OSError:
        return 504, {"errorCode": 301, "message": "proxy indeterminate"}


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # -- proxy: follower forwards client ops to its leader ------------

    def _forward(self, lid: int, method: str, path: str,
                 raw_body: bytes | None) -> tuple[int, dict]:
        """The real-TCP forward leg handle_client_request drives:
        source-bound like every peer request (a proxied client op is
        inter-node traffic and must ride the same links the
        partitioner cuts)."""
        rep: Replica = self.server.replica
        host, port = rep.peers[lid]
        return http_json(
            host, port, path, method=method, data=raw_body,
            timeout=1.5, src=rep.host,
            headers={"X-Repl-Proxied": "1",
                     "Content-Type": self.headers.get("Content-Type")
                     or "application/octet-stream"})

    def _client(self, method: str, raw_body: bytes | None) -> None:
        rep: Replica = self.server.replica
        self._reply(*handle_client_request(
            rep, method, self.path, raw_body,
            proxied=bool(self.headers.get("X-Repl-Proxied")),
            forward=self._forward))

    # -- HTTP dispatch -------------------------------------------------

    def do_GET(self):  # noqa: N802 (stdlib API)
        rep: Replica = self.server.replica
        parsed = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(parsed.query)
        if parsed.path == "/_repl/status":
            self._reply(200, rep.status())
            return
        if parsed.path == "/_repl/ping":
            self._reply(200, rep.on_ping(
                int(q["term"][0]), int(q["leader"][0]),
                int(q.get("seq", ["0"])[0])))
            return
        if parsed.path == "/_repl/vote":
            self._reply(200, rep.on_vote(int(q["term"][0]),
                                         int(q["cand"][0]),
                                         int(q["seq"][0])))
            return
        self._client("GET", None)

    def do_POST(self):  # noqa: N802 (stdlib API)
        rep: Replica = self.server.replica
        parsed = urllib.parse.urlparse(self.path)
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n)
        if parsed.path == "/_repl/append":
            try:
                status, body = rep.on_append(json.loads(raw))
            except (ValueError, KeyError):
                status, body = 400, {"message": "bad entry"}
            self._reply(status, body)
            return
        self._reply(404, {"errorCode": 100, "message": "bad path"})

    def do_PUT(self):  # noqa: N802 (stdlib API)
        n = int(self.headers.get("Content-Length") or 0)
        self._client("PUT", self.rfile.read(n))


class Server(ThreadingHTTPServer):
    allow_reuse_address = True  # rebind fast after kill -9
    daemon_threads = True


def parse_peers(spec: str) -> list[tuple]:
    """``host:port`` entries (bare ports mean 127.0.0.1)."""
    peers = []
    for x in spec.split(","):
        x = x.strip()
        if not x:
            continue
        if ":" in x:
            h, p = x.rsplit(":", 1)
            peers.append((h, int(p)))
        else:
            peers.append(("127.0.0.1", int(x)))
    return peers


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {"volatile": False, "split-brain": False}
    opts = {"--id": None, "--peers": None, "--oplog": None,
            "--lease-ms": "700", "--host": "127.0.0.1"}
    pos: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in flags:
            flags[a] = True
        elif a in opts and i + 1 < len(argv):
            opts[a] = argv[i + 1]
            i += 1
        else:
            pos.append(a)
        i += 1
    if len(pos) != 2 or opts["--id"] is None or opts["--peers"] is None \
            or opts["--oplog"] is None:
        print("usage: replicated_server PORT DATA_DIR --id I "
              "--peers H1:P1,H2:P2,.. --oplog PATH [--lease-ms MS] "
              "[--host H] [volatile] [split-brain]", file=sys.stderr)
        raise SystemExit(2)
    port = int(pos[0])
    rep = Replica(int(opts["--id"]), parse_peers(opts["--peers"]),
                  opts["--oplog"],
                  lease_s=int(opts["--lease-ms"]) / 1000.0,
                  volatile=flags["volatile"],
                  split_brain=flags["split-brain"],
                  host=opts["--host"])
    srv = Server((opts["--host"], port), Handler)
    srv.replica = rep
    rep.start()
    print(f"replicated_server: id={rep.id} listening on "
          f"{opts['--host']}:{port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
