"""Per-peer-link network faults — asymmetric partitions that bite.

The old :class:`~.backend.PortPartitionNemesis` can only DROP a whole
node's inbound port, so the classic partition stagers (split-brain, a
bridged majority, one-way packet loss) can't be expressed: every fault
it stages is symmetric and cuts clients too.  This module gives the
live harness the reference docker harness's link model on one machine:

  * every logical node gets a **distinct loopback address**
    (``127.0.1.<i+1>`` by default — :func:`node_addr`), servers bind
    it and peer traffic is **source-bound** to it, so a net-layer rule
    can match an ``(src, dst)`` address pair — one directed *link*;
  * clients keep connecting from the default ``127.0.0.1`` source, so
    link grudges cut only inter-peer traffic — a partitioned-away
    leader still answers its clients, which is exactly the
    split-brain staging the checker exists to catch;
  * a :class:`LinkPartitionNemesis` translates **grudge topologies**
    (split-one, bridge/majority-with-overlap, isolate-leader
    one-way, random-halves, plus rate-choke degradation) into
    per-link rules through whichever **rule engine** the host offers:
    ``iptables`` (true per-link DROP) or ``tc`` (an htb class choked
    to ~1 B/s per link — u32-classified by (src, dst) — on hosts
    whose kernels ship neither netfilter tooling nor netem);
  * every installed rule is **journaled to the data root before it is
    installed** (``<data_root>/_links/rules.jsonl``), so the campaign
    runner, the per-cell watchdog, and ``python -m jepsen_tpu_torch.live
    --sweep`` can always restore connectivity — even after a
    SIGKILL'd runner whose in-process rule list died with it.  The
    same journal now also covers the port-partition nemesis.

The grudge *math* is pure and lives in :mod:`jepsen_tpu_torch.nemesis`
(``grudge_links``, ``split_one_links``, ``bridge_links``,
``isolate_links``, ...); this module owns addresses, rules, journals,
and the nemesis itself.
"""

from __future__ import annotations

import json
import logging
import os
import random
import socket
import subprocess
from dataclasses import dataclass, replace
from typing import Callable, Iterable, Optional

from .. import nemesis as nemesis_mod
from ..obs import metrics as obs_metrics

log = logging.getLogger("jepsen")

#: rules removed by journal sweeps — the fleet-health counter that
#: says "no partition rules remain installed" (the web UI's health strip)
_M_SWEPT = obs_metrics.REGISTRY.counter(
    "jtpu_link_rules_swept_total",
    "Partition/link rules removed by journal sweeps", ("kind",))


# ---------------------------------------------------------------------------
# the per-node address scheme
# ---------------------------------------------------------------------------

#: default loopback prefix; node i lives at <base><i+1>.  The whole of
#: 127/8 is local on Linux, so no interface setup is needed — binding
#: and source-binding 127.0.1.N just works, while plain clients keep
#: the kernel-chosen 127.0.0.1 source and stay outside every grudge.
ADDR_BASE = "127.0.1."


def _default_addr_base() -> str | None:
    """None = per-node addresses; a literal = every node shares it.
    Non-Linux loopbacks (macOS lo0) only have 127.0.0.1 configured, so
    binding 127.0.1.N would fail EADDRNOTAVAIL — those hosts fall back
    to the old shared-address scheme (ports still distinguish nodes;
    the link nemeses' probes fail there anyway, so nothing needed the
    per-link identity)."""
    import sys as _sys

    return None if _sys.platform.startswith("linux") else "127.0.0.1"


def node_addr(test: dict, node) -> str:
    """The node's own loopback address — its link identity."""
    base = test.get("addr_base")
    if base is None:
        base = _default_addr_base()
    if base is not None and not base.endswith("."):
        return base  # shared-address fallback (non-Linux)
    i = test["nodes"].index(node)
    if i > 253:
        raise ValueError("address scheme supports at most 254 nodes")
    return (base or ADDR_BASE) + str(i + 1)


# ---------------------------------------------------------------------------
# the crash-safe rule journal
# ---------------------------------------------------------------------------
#
# Contract: a rule line is fsync'd to the journal BEFORE the install
# command runs, and the journal is cleared only after every journaled
# rule was removed.  Worst case after a SIGKILL at any point: the
# journal lists a rule that was never installed — the sweep's remove
# is a no-op for it.  The reverse (an installed rule the journal
# doesn't know) can't happen.


def journal_path(data_root: str) -> str:
    return os.path.join(data_root, "_links", "rules.jsonl")


def journal_append(data_root: str, rule: dict) -> None:
    p = journal_path(data_root)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps(rule) + "\n")
        f.flush()
        os.fsync(f.fileno())


def journal_rules(data_root: str) -> list[dict]:
    """Every journaled rule; a torn final line (SIGKILL mid-append) is
    dropped — its install never ran."""
    out: list[dict] = []
    try:
        with open(journal_path(data_root), "rb") as f:
            data = f.read()
    except OSError:
        return out
    complete = data[:data.rfind(b"\n") + 1] if b"\n" in data else b""
    for line in complete.splitlines():
        try:
            o = json.loads(line)
        except ValueError:
            continue
        if isinstance(o, dict):
            out.append(o)
    return out


def journal_clear(data_root: str) -> None:
    try:
        os.unlink(journal_path(data_root))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# rule engines
# ---------------------------------------------------------------------------


def _run(argv: list[str], *, timeout: float = 10.0
         ) -> subprocess.CompletedProcess:
    """The one spot every net-layer command goes through — tests
    monkeypatch this to exercise engines without touching the host."""
    return subprocess.run([str(a) for a in argv], capture_output=True,
                          text=True, timeout=timeout)


def _ok(argv: list[str]) -> bool:
    try:
        return _run(argv).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


class IptablesEngine:
    """True per-link DROP via netfilter — the reference harness's
    mechanism.  A ``link`` rule is an inbound drop on the dst side
    (``-s src -d dst -j DROP``); a ``port`` rule is the legacy
    whole-port drop the port-partition nemesis stages."""

    name = "iptables"

    @staticmethod
    def probe() -> Optional[str]:
        import shutil

        if shutil.which("iptables") is None:
            return "no `iptables` binary on PATH"
        if hasattr(os, "geteuid") and os.geteuid() != 0:
            return "not root: iptables needs CAP_NET_ADMIN"
        try:
            r = _run(["iptables", "-w", "-L", "-n"])
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"iptables probe failed: {e}"
        if r.returncode != 0:
            return ("iptables unusable here: "
                    + (r.stderr or r.stdout).strip()[:120])
        return None

    def supports(self, mode: str) -> Optional[str]:
        if mode == "degrade":
            return "degradation needs tc (iptables can only DROP)"
        return None

    def _argv(self, op: str, rule: dict) -> list[str]:
        if rule.get("kind") == "port":
            return ["iptables", "-w", op, "INPUT", "-p", "tcp",
                    "-i", "lo", "--dport", str(rule["port"]),
                    "-j", "DROP"]
        return ["iptables", "-w", op, "INPUT", "-i", "lo",
                "-s", rule["src"], "-d", rule["dst"], "-j", "DROP"]

    def install(self, rule: dict) -> None:
        r = _run(self._argv("-I", rule))
        if r.returncode != 0:
            raise RuntimeError(f"iptables install failed: "
                               f"{(r.stderr or r.stdout).strip()[:200]}")

    def remove(self, rule: dict) -> bool:
        return _ok(self._argv("-D", rule))

    def sweep_engine(self) -> None:
        pass  # per-rule removal is complete for netfilter


#: our distinctive qdisc handle — sweeps delete the lo root qdisc only
#: when it carries this handle, so a host's real traffic shaping is
#: never clobbered by a jepsen sweep
TC_HANDLE = "1a94"

#: effectively-blackhole rate for dropped links: the burst bucket is
#: burned right after install (see ``_burn``), after which a 40-byte
#: SYN takes ~40 s of token accrual — every protocol timeout in the
#: harness fires long before that
TC_DROP_RATE = "8bit"
#: the degrade-mode rate: a link that works, slowly — timeouts and
#: retries fire without the link ever being fully dead
TC_DEGRADE_RATE = "4kbit"


class TcEngine:
    """Per-link choke via tc htb + u32 on the loopback egress — the
    fallback for hosts whose kernels ship neither iptables nor netem
    (minimal container kernels).  One htb root (our distinctive
    handle) whose default class passes traffic at line rate; each
    dropped link gets its own class choked to ~1 B/s plus a u32
    filter matching the (src, dst) address pair.  After install the
    class's burst credit is burned with bound UDP sends, so the choke
    is effectively a blackhole from the first real packet on."""

    name = "tc"

    @staticmethod
    def probe() -> Optional[str]:
        import shutil

        if shutil.which("tc") is None:
            return "no `tc` binary on PATH"
        if hasattr(os, "geteuid") and os.geteuid() != 0:
            return "not root: tc needs CAP_NET_ADMIN"
        try:
            r = _run(["tc", "qdisc", "show", "dev", "lo"])
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"tc probe failed: {e}"
        if r.returncode != 0:
            return ("tc unusable here: "
                    + (r.stderr or r.stdout).strip()[:120])
        out = r.stdout
        own = f"htb {TC_HANDLE}:" in out
        if not own and "noqueue" not in out:
            return ("lo already carries a foreign qdisc; refusing to "
                    "replace it")
        # htb + u32 must actually install (minimal kernels lack the
        # modules); probe with our own handle and tear it down unless
        # a live campaign already owns it
        if not own:
            if not _ok(["tc", "qdisc", "add", "dev", "lo", "root",
                        "handle", f"{TC_HANDLE}:", "htb",
                        "default", "1"]):
                return "kernel lacks sch_htb: tc choke unavailable"
            ok = _ok(["tc", "filter", "add", "dev", "lo", "parent",
                      f"{TC_HANDLE}:", "protocol", "ip", "prio",
                      "9999", "u32", "match", "ip", "src",
                      "127.0.1.254/32", "flowid", f"{TC_HANDLE}:1"])
            _run(["tc", "qdisc", "del", "dev", "lo", "root"])
            if not ok:
                return "kernel lacks cls_u32: tc choke unavailable"
        return None

    def supports(self, mode: str) -> Optional[str]:
        return None  # drop (choke) and degrade both work

    # -- id scheme: a stable class minor + filter pref per link --------

    @staticmethod
    def _link_id(rule: dict) -> int:
        """Deterministic, collision-free per-(src, dst) id, so remove
        needs no state: last address octets are node indexes + 1
        (<= 254), and 0x100 + (s << 8 | d) <= 0xFFFE fits both a tc
        class minor and a filter pref."""
        s = int(rule["src"].rsplit(".", 1)[1])
        d = int(rule["dst"].rsplit(".", 1)[1])
        return 0x100 + (s << 8 | d)

    def _ensure_root(self) -> None:
        r = _run(["tc", "qdisc", "show", "dev", "lo"])
        if f"htb {TC_HANDLE}:" in r.stdout:
            return
        for argv in (
                ["tc", "qdisc", "add", "dev", "lo", "root", "handle",
                 f"{TC_HANDLE}:", "htb", "default", "1"],
                ["tc", "class", "add", "dev", "lo", "parent",
                 f"{TC_HANDLE}:", "classid", f"{TC_HANDLE}:1", "htb",
                 "rate", "10gbit"]):
            rr = _run(argv)
            if rr.returncode != 0:
                raise RuntimeError(
                    f"tc root setup failed: "
                    f"{(rr.stderr or rr.stdout).strip()[:200]}")

    def install(self, rule: dict) -> None:
        if rule.get("kind") == "port":
            raise RuntimeError("tc engine cannot stage port grudges")
        lid = self._link_id(rule)
        rate = TC_DEGRADE_RATE if rule.get("mode") == "degrade" \
            else TC_DROP_RATE
        self._ensure_root()
        for argv in (
                ["tc", "class", "add", "dev", "lo", "parent",
                 f"{TC_HANDLE}:", "classid", f"{TC_HANDLE}:{lid:x}",
                 "htb", "rate", rate, "burst", "1b", "cburst", "1b"],
                ["tc", "filter", "add", "dev", "lo", "parent",
                 f"{TC_HANDLE}:", "protocol", "ip", "prio", str(lid),
                 "u32", "match", "ip", "src", f"{rule['src']}/32",
                 "match", "ip", "dst", f"{rule['dst']}/32",
                 "flowid", f"{TC_HANDLE}:{lid:x}"]):
            r = _run(argv)
            if r.returncode != 0:
                raise RuntimeError(
                    f"tc install failed: "
                    f"{(r.stderr or r.stdout).strip()[:200]}")
        if rule.get("mode") != "degrade":
            self._burn(rule["src"], rule["dst"])

    @staticmethod
    def _burn(src: str, dst: str, *, n: int = 4,
              size: int = 1400) -> None:
        """Drain the fresh class's burst credit so the choke starts as
        a blackhole, not a few-packet leak: a handful of src-bound UDP
        datagrams matching the filter eat the tokens.  They queue in
        the choked class and die when the qdisc is torn down."""
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setblocking(False)
            s.bind((src, 0))
            for _ in range(n):
                try:
                    s.sendto(b"\x00" * size, (dst, 9))
                except OSError:
                    break
            s.close()
        except OSError:
            pass

    def remove(self, rule: dict) -> bool:
        if rule.get("kind") == "port":
            return True
        lid = self._link_id(rule)
        a = _ok(["tc", "filter", "del", "dev", "lo", "parent",
                 f"{TC_HANDLE}:", "protocol", "ip", "prio", str(lid),
                 "u32"])
        b = _ok(["tc", "class", "del", "dev", "lo", "classid",
                 f"{TC_HANDLE}:{lid:x}"])
        return a and b

    def sweep_engine(self) -> None:
        """Delete the whole root qdisc — but only when it is OURS."""
        r = _run(["tc", "qdisc", "show", "dev", "lo"])
        if f"htb {TC_HANDLE}:" in r.stdout:
            _run(["tc", "qdisc", "del", "dev", "lo", "root"])


_ENGINES = {"iptables": IptablesEngine, "tc": TcEngine}

#: probe outcomes memoized per mode: host capabilities don't change
#: mid-process, and a tc probe has side effects (a qdisc add/del round
#: trip) the planner must not repeat per cell.  ``_reprobe()`` clears
#: it (tests that re-stage the host call it).
_pick_cache: dict = {}


def _reprobe() -> None:
    _pick_cache.clear()


def pick_engine(mode: str = "drop"
                ) -> tuple[object | None, Optional[str]]:
    """The host's best rule engine FOR THIS MODE (iptables preferred
    for drops — a true DROP beats a choke — but skipped for modes it
    can't stage, e.g. degrade) plus the combined skip reason when no
    engine fits."""
    if mode not in _pick_cache:
        reasons = []
        picked = None
        for cls in (IptablesEngine, TcEngine):
            unfit = cls().supports(mode)
            if unfit is not None:
                reasons.append(unfit)
                continue
            reason = cls.probe()
            if reason is None:
                picked = cls.name
                break
            reasons.append(reason)
        _pick_cache[mode] = (picked, None if picked
                             else "; ".join(reasons))
    name, reason = _pick_cache[mode]
    return (_ENGINES[name]() if name else None), reason


def probe_links() -> Optional[str]:
    """Matrix availability probe: some engine can cut links here."""
    _eng, reason = pick_engine()
    return reason


def probe_degrade() -> Optional[str]:
    """Degradation (rate-choke) needs an engine that can shape, not
    just DROP — tc in practice, even on hosts where iptables exists."""
    _eng, reason = pick_engine("degrade")
    return reason


# ---------------------------------------------------------------------------
# sweeps — the connectivity-restore contract
# ---------------------------------------------------------------------------


def sweep(data_root: str, engine=None) -> int:
    """Remove every rule journaled under ``data_root`` and clear the
    journal.  Safe to call any time, from anywhere (campaign start,
    cell teardown, the watchdog's escalation path, ``--sweep``): rules
    that were journaled but never installed, or already removed, make
    the per-rule delete a harmless no-op.  Returns the number of
    journal entries swept."""
    rules = journal_rules(data_root)
    if not rules:
        return 0
    by_engine: dict[str, list[dict]] = {}
    for rule in rules:
        by_engine.setdefault(rule.get("engine", "iptables"),
                             []).append(rule)
    errors = 0
    for ename, erules in by_engine.items():
        eng = engine if engine is not None \
            and getattr(engine, "name", None) == ename \
            else _ENGINES.get(ename, IptablesEngine)()
        for rule in erules:
            try:
                # False = the rule wasn't installed (the journal is
                # written BEFORE install, so that's the normal no-op
                # case); only an exception counts as a failed removal
                eng.remove(rule)
                _M_SWEPT.inc(kind=str(rule.get("kind", "link")))
            except Exception:  # noqa: BLE001 — sweep must finish
                errors += 1
                log.warning("rule remove failed during sweep: %r",
                            rule, exc_info=True)
        try:
            eng.sweep_engine()
        except Exception:  # noqa: BLE001 — sweep must finish
            errors += 1
            log.warning("engine sweep failed", exc_info=True)
    if errors:
        # keep the journal: it is the ONLY record of possibly-live
        # rules, and the next sweep (watchdog, campaign start,
        # --sweep) retries them.  Clearing here would report a clean
        # network while DROP rules survive.
        log.warning("links: sweep left %d rule(s) journaled under %s "
                    "(removal errors)", errors, data_root)
    else:
        journal_clear(data_root)
        log.info("links: swept %d journaled rule(s) under %s",
                 len(rules), data_root)
    return len(rules) - errors


def sweep_tree(base: str = "/tmp/jepsen-live", *, max_depth: int = 3
               ) -> int:
    """Sweep every rule journal under ``base`` (each campaign cell
    keeps its own data root there) — what ``python -m jepsen_tpu_torch.live
    --sweep`` and campaign start run, so a SIGKILL'd runner's leaked
    rules never outlive the next campaign."""
    total = 0
    base = os.path.abspath(base)
    for root, dirs, files in os.walk(base):
        depth = root[len(base):].count(os.sep)
        if depth >= max_depth:
            dirs[:] = []
        if os.path.basename(root) == "_links" \
                and "rules.jsonl" in files:
            total += sweep(os.path.dirname(root))
            dirs[:] = []
    return total


# ---------------------------------------------------------------------------
# the grudge menu
# ---------------------------------------------------------------------------


@dataclass
class LinkGrudge:
    """One named fault geometry: nodes -> directed (src, dst) links.
    ``pick`` gets a context dict with a ``leader()`` callable so
    leader-aware grudges can target the node that matters."""

    name: str
    pick: Callable[[list, dict], Iterable[tuple]]
    #: "drop" (blackhole) or "degrade" (rate-choke, tc only)
    mode: str = "drop"
    #: human summary for docs/--dry-run
    doc: str = ""
    asymmetric: bool = False


def _isolate_leader(nodes: list, ctx: dict) -> set[tuple]:
    leader = None
    try:
        leader = ctx.get("leader", lambda: None)()
    except Exception:  # noqa: BLE001 — fall back to a random victim
        leader = None
    if leader is None or leader not in nodes:
        leader = random.choice(list(nodes))
    # ONE-WAY: peers drop traffic FROM the leader (its heartbeats and
    # appends vanish, so the majority deposes it) while packets TO it
    # still arrive — and its clients, coming from 127.0.0.1, are never
    # cut.  The classic asymmetric split-brain stager.
    return nemesis_mod.isolate_links(nodes, leader,
                                     inbound=False, outbound=True)


GRUDGES: dict[str, LinkGrudge] = {
    "split-one": LinkGrudge(
        "split-one",
        lambda nodes, ctx: nemesis_mod.split_one_links(nodes),
        doc="one random node fully cut from its peers (symmetric)"),
    "bridge": LinkGrudge(
        "bridge",
        lambda nodes, ctx: nemesis_mod.bridge_links(nodes),
        doc="halves cut except one bridge node that talks to both — "
            "each side still reaches a majority through the overlap"),
    "random-halves": LinkGrudge(
        "random-halves",
        lambda nodes, ctx: nemesis_mod.random_halves_links(nodes),
        doc="random symmetric halves"),
    "isolate-leader": LinkGrudge(
        "isolate-leader", _isolate_leader, asymmetric=True,
        doc="one-way: peers drop traffic FROM the current leader; "
            "packets to it (and its clients) still flow"),
    "degrade": LinkGrudge(
        "degrade",
        lambda nodes, ctx: nemesis_mod.all_peer_links(nodes),
        mode="degrade",
        doc="every peer link rate-choked (tc-style slow network: "
            "alive, but every timeout fires)"),
}


# ---------------------------------------------------------------------------
# the nemesis
# ---------------------------------------------------------------------------


class LinkPartitionNemesis(nemesis_mod.Nemesis):
    """{:f start | stop}: stage one grudge's links, heal them.

    Every rule is journaled to the cell's data root before install
    (:func:`journal_append`), and heal is a full :func:`sweep` of that
    journal — so a SIGKILL landing anywhere between install and heal
    leaves a journal the next sweep (campaign start, watchdog,
    ``--sweep``) uses to restore connectivity."""

    def __init__(self, backend, grudge: str | LinkGrudge = "split-one",
                 engine=None):
        self.backend = backend
        self.grudge = GRUDGES[grudge] if isinstance(grudge, str) \
            else grudge
        self._engine = engine
        self._cut: list[tuple] = []

    def _eng(self):
        if self._engine is None:
            # picked per grudge MODE: a degrade grudge must never be
            # handed an engine that can only DROP
            self._engine, reason = pick_engine(self.grudge.mode)
            if self._engine is None:
                raise RuntimeError(f"no link rule engine: {reason}")
        return self._engine

    def _ctx(self, test: dict) -> dict:
        return {"leader": lambda: self.backend.leader(test)}

    def invoke(self, test, op):
        data_root = test.get("data_root", "/tmp/jepsen-live")
        if op.f == "start":
            if self._cut:
                return replace(op, type="info",
                               value="already-partitioned")
            eng = self._eng()
            links = sorted(self.grudge.pick(list(test["nodes"]),
                                            self._ctx(test)))
            for src, dst in links:
                rule = {"kind": "link",
                        "src": node_addr(test, src),
                        "dst": node_addr(test, dst),
                        "mode": self.grudge.mode,
                        "engine": eng.name}
                journal_append(data_root, rule)  # BEFORE the install
                eng.install(rule)
                self._cut.append((src, dst))
            return replace(op, type="info",
                           value=[f"links-{self.grudge.mode}",
                                  self.grudge.name,
                                  [f"{s}->{d}" for s, d in self._cut]])
        if op.f == "stop":
            self._heal(test)
            return replace(op, type="info", value="links-healed")
        raise ValueError(f"link-partition nemesis: unknown f {op.f!r}")

    def _heal(self, test) -> None:
        sweep(test.get("data_root", "/tmp/jepsen-live"),
              engine=self._engine)
        self._cut = []

    def teardown(self, test):
        self._heal(test)
