"""Network manipulation (reference L1) — partitions, latency, loss.

Reference: jepsen/src/jepsen/net.clj + net/proto.clj.  Protocol Net with
drop!/heal!/slow!/flaky!/fast! (net.clj:14-25), an iptables
implementation (net.clj:57-109) with the optional PartitionAll batch fast
path (proto.clj:5-12, net.clj:100-109), an ipfilter implementation for
SmartOS (net.clj:111-143), and `tc netem` for latency/loss shaping.
"""

from __future__ import annotations

import logging

from . import control
from .control import RemoteError, lit
from .util import real_pmap

log = logging.getLogger("jepsen")

TC = "/sbin/tc"


class Net:
    """net.clj:14-25."""

    def drop(self, test: dict, src, dest) -> None:
        """Drop traffic from src as seen by dest."""
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, mean_ms: int = 50, variance_ms: int = 10,
             distribution: str = "normal") -> None:
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        raise NotImplementedError


class PartitionAll:
    """Optional batch fast path (net/proto.clj:5-12)."""

    def drop_all(self, test: dict, grudge: dict) -> None:
        raise NotImplementedError


def drop_all(test: dict, grudge: dict) -> None:
    """Apply a grudge — {dst: [srcs to drop]} — via the test's net
    (net.clj:28-43)."""
    net = test["net"]
    if isinstance(net, PartitionAll):
        net.drop_all(test, grudge)
        return
    pairs = [(src, dst) for dst, srcs in grudge.items() for src in srcs]
    real_pmap(lambda p: net.drop(test, p[0], p[1]), pairs)


class _Noop(Net):
    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


noop = _Noop()


def ip(sess: control.Session, host: str) -> str:
    """hostname -> IP via getent (control/net.clj:21-32)."""
    out = sess.exec("getent", "ahosts", host)
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[1] == "STREAM":
            return parts[0]
    return out.split()[0]


def reachable(sess: control.Session, host: str) -> bool:
    """Can this node ping host? (control/net.clj:7-11)"""
    try:
        sess.exec("ping", "-w", "1", "-c", "1", host)
        return True
    except RemoteError:
        return False


class IPTables(Net, PartitionAll):
    """iptables DROP rules + tc netem (net.clj:57-109)."""

    def drop(self, test, src, dest):
        sess = control.session(dest, test).su()
        sess.exec("iptables", "-A", "INPUT", "-s", ip(sess, src),
                  "-j", "DROP", "-w")

    def heal(self, test):
        def f(t, node):
            s = control.session(node, t).su()
            s.exec("iptables", "-F", "-w")
            s.exec("iptables", "-X", "-w")
        control.on_nodes(test, f)

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        def f(t, node):
            control.session(node, t).su().exec(
                TC, "qdisc", "add", "dev", "eth0", "root", "netem",
                "delay", f"{mean_ms}ms", f"{variance_ms}ms",
                "distribution", distribution)
        control.on_nodes(test, f)

    def flaky(self, test):
        def f(t, node):
            control.session(node, t).su().exec(
                TC, "qdisc", "add", "dev", "eth0", "root", "netem",
                "loss", "20%", "75%")
        control.on_nodes(test, f)

    def fast(self, test):
        def f(t, node):
            try:
                control.session(node, t).su().exec(
                    TC, "qdisc", "del", "dev", "eth0", "root")
            except RemoteError as e:
                if "No such file or directory" not in str(e):
                    raise
        control.on_nodes(test, f)

    def drop_all(self, test, grudge):
        """One iptables rule per dst with a joined source list
        (net.clj:100-109)."""
        def snub(t, node):
            srcs = grudge.get(node) or []
            if not srcs:
                return
            s = control.session(node, t).su()
            s.exec("iptables", "-A", "INPUT", "-s",
                   ",".join(ip(s, src) for src in srcs), "-j", "DROP", "-w")
        control.on_nodes(test, snub, list(grudge.keys()))


iptables = IPTables()


class IPFilter(Net):
    """SmartOS ipf (net.clj:111-143)."""

    def drop(self, test, src, dest):
        control.session(dest, test).su().exec(
            "echo", "block", "in", "from", src, "to", "any",
            lit("|"), "ipf", "-f", "-")

    def heal(self, test):
        control.on_nodes(
            test, lambda t, n: control.session(n, t).su().exec("ipf", "-Fa"))

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        def f(t, node):
            control.session(node, t).su().exec(
                "tc", "qdisc", "add", "dev", "eth0", "root", "netem",
                "delay", f"{mean_ms}ms", f"{variance_ms}ms",
                "distribution", distribution)
        control.on_nodes(test, f)

    def flaky(self, test):
        def f(t, node):
            control.session(node, t).su().exec(
                "tc", "qdisc", "add", "dev", "eth0", "root", "netem",
                "loss", "20%", "75%")
        control.on_nodes(test, f)

    def fast(self, test):
        def f(t, node):
            control.session(node, t).su().exec(
                "tc", "qdisc", "del", "dev", "eth0", "root")
        control.on_nodes(test, f)


ipfilter = IPFilter()
