"""Nemesis layer — fault injection (reference L2).

Reference: jepsen/src/jepsen/nemesis.clj.  A Nemesis is a special client
whose ops act on the environment instead of the database (protocol at
nemesis.clj:9-12).  Grudge topology math (bisect, split-one,
complete-grudge, bridge, majorities-ring — nemesis.clj:52-149) is pure and
unit-tested (mirroring nemesis_test.clj:18-60); partitioners translate
grudges into net-layer drops; `compose` routes ops to child nemeses by :f
(nemesis.clj:151-194); plus SIGSTOP pauses (hammer-time, 250), node
start/stop (213), clock scrambling (196), and file truncation (266).
"""

from __future__ import annotations

import logging
import math
import random
import threading
import time
from dataclasses import replace
from typing import Callable, Iterable

from . import control, net as net_mod
from .history import Op
from .util import majority

log = logging.getLogger("jepsen")


class Nemesis:
    """nemesis.clj:9-12."""

    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass


class _Noop(Nemesis):
    """Does nothing (nemesis.clj:14-19)."""

    def invoke(self, test, op):
        return replace(op, type="info")


noop = _Noop()


# ---------------------------------------------------------------------------
# grudge topology math (nemesis.clj:52-149) — pure functions
# ---------------------------------------------------------------------------


def bisect(coll: list) -> tuple[list, list]:
    """Cut a sequence in half; smaller half first (nemesis.clj:52-55)."""
    mid = len(coll) // 2
    return list(coll[:mid]), list(coll[mid:])


def split_one(coll: list, loner=None) -> tuple[list, list]:
    """Split one node off from the rest (nemesis.clj:57-62)."""
    if loner is None:
        loner = random.choice(list(coll))
    return [loner], [x for x in coll if x != loner]


def complete_grudge(components: Iterable[Iterable]) -> dict:
    """Forbid all traffic across component boundaries: node -> set of
    nodes it drops (nemesis.clj:64-76)."""
    components = [set(c) for c in components]
    universe: set = set().union(*components) if components else set()
    grudge: dict = {}
    for component in components:
        for node in component:
            grudge[node] = universe - component
    return grudge


def bridge(nodes: list) -> dict:
    """Cut the network in half, except one bridge node that talks to both
    sides (nemesis.clj:78-89)."""
    a, b = bisect(list(nodes))
    bridge_node = b[0]
    grudge = complete_grudge([a, b])
    grudge.pop(bridge_node, None)
    return {n: s - {bridge_node} for n, s in grudge.items()}


def majorities_ring(nodes: list) -> dict:
    """Every node sees a majority, but no two see the same majority
    (nemesis.clj:128-143): shuffle into a ring, give each node the
    majority-window starting at its position; the grudge key is the
    *middle* member of each window."""
    nodes = list(nodes)
    u = set(nodes)
    n = len(nodes)
    m = majority(n)
    ring = random.sample(nodes, n)
    grudge = {}
    for i in range(n):
        window = [ring[(i + j) % n] for j in range(m)]
        grudge[window[len(window) // 2]] = u - set(window)
    return grudge


# ---------------------------------------------------------------------------
# per-peer-link grudges — directed (src, dst) pairs
# ---------------------------------------------------------------------------
#
# The node->dropped-peers grudges above assume a net layer that can cut
# whole node pairs.  The live harness's per-link partitioner
# (live/links.py) works one level lower: a *link* is an ordered
# ``(src, dst)`` pair meaning "traffic FROM src TO dst is dropped" —
# the dst side's inbound drop in iptables terms.  Ordered pairs are
# what make ASYMMETRIC faults (the classic split-brain stager: a
# leader whose sends are lost while its clients still reach it)
# expressible at all; the symmetric topologies are just both
# directions of each cut pair.  Pure functions, unit-tested with no
# iptables anywhere near them.


def grudge_links(grudge: dict) -> set[tuple]:
    """A node->set-of-dropped-peers grudge as directed links: node n
    dropping traffic from s is the link (s, n)."""
    return {(s, n) for n, dropped in grudge.items() for s in dropped}


def bidirectional(links: Iterable[tuple]) -> set[tuple]:
    """Close a link set under direction reversal (symmetric cut)."""
    out = set()
    for a, b in links:
        out.add((a, b))
        out.add((b, a))
    return out


def isolate_links(nodes: list, victim, *, inbound: bool = True,
                  outbound: bool = True) -> set[tuple]:
    """Cut one node's links: ``outbound`` drops victim->peer traffic,
    ``inbound`` drops peer->victim.  Both on = the symmetric
    split-one; exactly one on = the one-way asymmetric isolation."""
    peers = [n for n in nodes if n != victim]
    links: set[tuple] = set()
    if outbound:
        links |= {(victim, p) for p in peers}
    if inbound:
        links |= {(p, victim) for p in peers}
    return links


def split_one_links(nodes: list, loner=None) -> set[tuple]:
    """split-one as links: one node fully cut, both directions."""
    [loner], _rest = split_one(list(nodes), loner)
    return isolate_links(nodes, loner)


def bridge_links(nodes: list) -> set[tuple]:
    """bridge as links: halves cut except the bridge node that talks
    to both sides (majority-with-overlap — each half still reaches a
    majority THROUGH the bridge)."""
    return grudge_links(bridge(list(nodes)))


def random_halves_links(nodes: list) -> set[tuple]:
    """Random symmetric halves as links."""
    return grudge_links(
        complete_grudge(bisect(random.sample(list(nodes), len(nodes)))))


def all_peer_links(nodes: list) -> set[tuple]:
    """Every ordered peer pair — the degrade-everything target."""
    return {(a, b) for a in nodes for b in nodes if a != b}


# ---------------------------------------------------------------------------
# partitioners (nemesis.clj:91-149)
# ---------------------------------------------------------------------------


class Partitioner(Nemesis):
    """:start cuts links per (grudge nodes); :stop heals
    (nemesis.clj:91-109)."""

    def __init__(self, grudge: Callable[[list], dict]):
        self.grudge = grudge

    def setup(self, test):
        test["net"].heal(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            grudge = self.grudge(list(test["nodes"]))
            net_mod.drop_all(test, grudge)
            return replace(op, type="info",
                           value=["isolated",
                                  {k: sorted(v) for k, v in grudge.items()}])
        if op.f == "stop":
            test["net"].heal(test)
            return replace(op, type="info", value="network-healed")
        raise ValueError(f"partitioner doesn't understand f={op.f!r}")

    def teardown(self, test):
        test["net"].heal(test)


def partitioner(grudge) -> Partitioner:
    return Partitioner(grudge)


def partition_halves() -> Partitioner:
    """First half vs second half (nemesis.clj:111-116)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Partitioner:
    """Random halves (nemesis.clj:118-121)."""
    return Partitioner(
        lambda nodes: complete_grudge(bisect(random.sample(nodes,
                                                           len(nodes)))))


def partition_random_node() -> Partitioner:
    """Isolate one random node (nemesis.clj:123-126)."""
    return Partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Partitioner:
    """nemesis.clj:145-149."""
    return Partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# compose (nemesis.clj:151-194)
# ---------------------------------------------------------------------------


class Compose(Nemesis):
    """Route ops to child nemeses by :f (nemesis.clj:151-194).  Takes a
    dict (hashable routers only) or a list of (router, nemesis) pairs; a
    router is a set of fs (pass-through), a dict renaming outer f -> inner
    f (Clojure map-as-fn semantics), or a callable f -> f' | None."""

    def __init__(self, nemeses):
        self.nemeses = list(nemeses.items()) if isinstance(nemeses, dict) \
            else list(nemeses)

    def _route(self, f):
        for fs, nem in self.nemeses:
            if isinstance(fs, dict):
                if f in fs:
                    return fs[f], nem
            elif isinstance(fs, (set, frozenset, list, tuple)):
                if f in fs:
                    return f, nem
            elif callable(fs):
                f2 = fs(f)
                if f2 is not None:
                    return f2, nem
        raise ValueError(f"no nemesis can handle {f!r}")

    def setup(self, test):
        self.nemeses = [(fs, nem.setup(test) or nem)
                        for fs, nem in self.nemeses]
        return self

    def invoke(self, test, op):
        f2, nem = self._route(op.f)
        out = nem.invoke(test, replace(op, f=f2))
        return replace(out, f=op.f)

    def teardown(self, test):
        for _, nem in self.nemeses:
            nem.teardown(test)


def compose(nemeses) -> Compose:
    return Compose(nemeses)


# ---------------------------------------------------------------------------
# clock scrambling (nemesis.clj:196-211); see nemesis_time for precision
# clock faults
# ---------------------------------------------------------------------------


def set_time(sess: control.Session, t: float) -> None:
    """Set node time in POSIX seconds (nemesis.clj:196-199)."""
    sess.su().exec("date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(Nemesis):
    """Randomizes node clocks within a ±dt second window
    (nemesis.clj:201-211)."""

    def __init__(self, dt: int):
        self.dt = dt

    def invoke(self, test, op):
        def f(t, node):
            sess = control.session(node, t)
            set_time(sess, time.time() + random.randint(-self.dt, self.dt))
        control.on_nodes(test, f)
        return replace(op, type="info", value="clocks-scrambled")

    def teardown(self, test):
        def f(t, node):
            set_time(control.session(node, t), time.time())
        control.on_nodes(test, f)


def clock_scrambler(dt: int) -> ClockScrambler:
    return ClockScrambler(dt)


# ---------------------------------------------------------------------------
# node start/stop (nemesis.clj:213-264)
# ---------------------------------------------------------------------------


class NodeStartStopper(Nemesis):
    """:start runs start_fn on targeted nodes; :stop undoes it
    (nemesis.clj:213-248).  Targeter picks nodes; fresh pick per start."""

    def __init__(self, targeter: Callable, start_fn: Callable,
                 stop_fn: Callable):
        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._nodes = None
        self._lock = threading.Lock()

    def invoke(self, test, op):
        with self._lock:
            if op.f == "start":
                targets = self.targeter(list(test["nodes"]))
                if targets is None:
                    return replace(op, type="info", value="no-target")
                if not isinstance(targets, (list, tuple, set)):
                    targets = [targets]
                if self._nodes is not None:
                    return replace(
                        op, type="info",
                        value=f"nemesis already disrupting {self._nodes}")
                self._nodes = list(targets)
                value = control.on_nodes(
                    test, lambda t, n: self.start_fn(t, n), self._nodes)
                return replace(op, type="info", value=value)
            if op.f == "stop":
                if self._nodes is None:
                    return replace(op, type="info", value="not-started")
                value = control.on_nodes(
                    test, lambda t, n: self.stop_fn(t, n), self._nodes)
                self._nodes = None
                return replace(op, type="info", value=value)
            raise ValueError(f"node-start-stopper: unknown f {op.f!r}")


def node_start_stopper(targeter, start_fn, stop_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process: str, targeter: Callable = random.choice
                ) -> NodeStartStopper:
    """SIGSTOP a process on :start, SIGCONT on :stop
    (nemesis.clj:250-264)."""

    def start(test, node):
        control.session(node, test).su().exec("killall", "-s", "STOP",
                                              process)
        return ["paused", process]

    def stop(test, node):
        control.session(node, test).su().exec("killall", "-s", "CONT",
                                              process)
        return ["resumed", process]

    return NodeStartStopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """{:f truncate, :value {node: {file, drop}}} — drop the last bytes of
    a file (nemesis.clj:266-292)."""

    def invoke(self, test, op):
        assert op.f == "truncate"
        plan = op.value or {}

        def f(t, node):
            spec = plan[node]
            path, drop = spec["file"], spec["drop"]
            assert isinstance(path, str) and isinstance(drop, int)
            control.session(node, t).su().exec(
                "truncate", "-c", "-s", f"-{drop}", path)

        control.on_nodes(test, f, list(plan.keys()))
        return replace(op, type="info")


def truncate_file() -> TruncateFile:
    return TruncateFile()
