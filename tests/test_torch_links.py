"""The port's per-peer-link partitions (``jepsen_tpu_torch/live/links.py``
and the grudge math of ``jepsen_tpu_torch/nemesis.py``) against the JAX
package's, the cases of ``tests/test_links.py`` as differentials.

Nothing here changes the host's network: the rule engines run through a
recorder of the commands they would issue (``links._run``), so the two
packages' ``iptables``/``tc`` command lines are compared byte for byte
instead of installed, and the planner's engine pick is seeded in both
packages (``links._pick_cache``), because the ``tc`` probe adds and
deletes a qdisc on ``lo``.  The journal is byte-identical across the
packages: either package's sweep restores rules the other journaled."""

import json
import os
import random
import subprocess
import sys
from types import SimpleNamespace

import pytest

from jepsen_tpu import nemesis as jnem
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.live import links as jlinks
from jepsen_tpu_torch import nemesis as tnem
from jepsen_tpu_torch.history import Op as TOp
from jepsen_tpu_torch.live import links as tlinks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NODES = ["n1", "n2", "n3"]
PKGS = {"jax": SimpleNamespace(nemesis=jnem, links=jlinks, Op=JOp),
        "torch": SimpleNamespace(nemesis=tnem, links=tlinks, Op=TOp)}


def _both(fn):
    """``fn(package)`` for each package, with the global random state
    seeded alike before each."""
    out = {}
    for name, P in PKGS.items():
        random.seed(1234)
        out[name] = fn(P)
    return out


def _same(fn):
    out = _both(fn)
    assert out["torch"] == out["jax"], out
    return out["torch"]


@pytest.fixture(autouse=True)
def _no_probe(monkeypatch):
    """No test here runs a real engine probe: each package's engine pick
    is seeded with the same outcome (a host with no engine)."""
    for P in PKGS.values():
        monkeypatch.setattr(P.links, "_pick_cache", {
            "drop": (None, "no engine here (seeded)"),
            "degrade": (None, "no engine here (seeded)")})


class Recorder:
    """What ``links._run`` would have run, answered by ``reply(argv)``
    (default: exit 0, empty output)."""

    def __init__(self, reply=None):
        self.argv = []
        self.reply = reply or (lambda argv: (0, "", ""))

    def __call__(self, argv, *, timeout=10.0):
        argv = [str(a) for a in argv]
        self.argv.append(argv)
        rc, out, err = self.reply(argv)
        return subprocess.CompletedProcess(argv, rc, out, err)


# ---------------------------------------------------------------------------
# grudge-topology math
# ---------------------------------------------------------------------------


def test_grudge_links_directed_semantics():
    grudge = {"n1": {"n3"}, "n3": {"n1"}}
    got = _same(lambda P: (P.nemesis.grudge_links(grudge),
                           P.nemesis.grudge_links({})))
    assert got == ({("n3", "n1"), ("n1", "n3")}, set())


def test_split_one_links_full_symmetric_cut():
    links = _same(lambda P: P.nemesis.split_one_links(NODES, "n2"))
    assert links == {("n2", "n1"), ("n2", "n3"), ("n1", "n2"), ("n3", "n2")}
    # the loner drawn at random: the same draw in both packages
    for seed in range(5):
        out = {}
        for name, P in PKGS.items():
            random.seed(seed)
            out[name] = P.nemesis.split_one_links(NODES)
        assert out["torch"] == out["jax"] and len(out["torch"]) == 4


def test_bridge_links_majority_with_overlap():
    got = _same(lambda P: (P.nemesis.bridge_links(NODES),
                           P.nemesis.bridge_links(["a", "b", "c", "d", "e"])))
    assert got[0] == {("n1", "n3"), ("n3", "n1")}
    assert len(got[1]) == 8


def test_isolate_links_one_way_asymmetry():
    got = _same(lambda P: (
        P.nemesis.isolate_links(NODES, "n1", inbound=False, outbound=True),
        P.nemesis.isolate_links(NODES, "n1", inbound=True, outbound=False),
        P.nemesis.isolate_links(NODES, "n1")))
    out, inb, both = got
    assert out == {("n1", "n2"), ("n1", "n3")}
    assert inb == {("n2", "n1"), ("n3", "n1")}
    assert both == out | inb


def test_random_halves_links_symmetric_partition():
    for seed in range(5):
        out = {}
        for name, P in PKGS.items():
            random.seed(seed)
            out[name] = P.nemesis.random_halves_links(["a", "b", "c", "d"])
        assert out["torch"] == out["jax"]
        assert len(out["torch"]) == 8
        assert out["torch"] == {(b, a) for a, b in out["torch"]}


def test_all_peer_links_and_bidirectional():
    got = _same(lambda P: (P.nemesis.all_peer_links(["x", "y"]),
                           P.nemesis.bidirectional({("a", "b")})))
    assert got == ({("x", "y"), ("y", "x")}, {("a", "b"), ("b", "a")})


def test_node_addr_scheme():
    got = _same(lambda P: (
        [P.links.node_addr({"nodes": NODES}, n) for n in NODES],
        P.links.node_addr({"nodes": NODES, "addr_base": "127.0.2."}, "n2"),
        P.links.node_addr({"nodes": NODES, "addr_base": "127.0.0.1"}, "n3")))
    assert got == (["127.0.1.1", "127.0.1.2", "127.0.1.3"], "127.0.2.2",
                   "127.0.0.1")
    for P in PKGS.values():
        with pytest.raises(ValueError):
            P.links.node_addr({"nodes": list(range(300))}, 260)


# ---------------------------------------------------------------------------
# the rule journal
# ---------------------------------------------------------------------------

RULES = [{"kind": "link", "src": "127.0.1.1", "dst": "127.0.1.2",
          "mode": "drop", "engine": "iptables"},
         {"kind": "port", "port": 18100, "node": "n1",
          "engine": "iptables"},
         {"kind": "link", "src": "127.0.1.3", "dst": "127.0.1.1",
          "mode": "degrade", "engine": "tc"}]


def test_journal_append_read_clear_and_torn_tail(tmp_path):
    roots = {n: str(tmp_path / n) for n in PKGS}
    for name, P in PKGS.items():
        assert P.links.journal_rules(roots[name]) == []
        for r in RULES:
            P.links.journal_append(roots[name], r)
        assert P.links.journal_path(roots[name]).endswith(
            os.path.join("_links", "rules.jsonl"))
    raw = {n: open(PKGS[n].links.journal_path(r), "rb").read()
           for n, r in roots.items()}
    assert raw["torch"] == raw["jax"]
    for name, P in PKGS.items():
        other = roots["jax" if name == "torch" else "torch"]
        # either package reads the other's journal
        assert P.links.journal_rules(other) == RULES
        with open(P.links.journal_path(roots[name]), "a") as f:
            f.write('{"kind": "link", "src": "127.0')
        assert P.links.journal_rules(roots[name]) == RULES
    for name, P in PKGS.items():
        P.links.journal_clear(roots[name])
        assert P.links.journal_rules(roots[name]) == []


class FakeEngine:
    """Records installs and removals; never touches the host."""

    name = "iptables"

    def __init__(self, fail_remove=False):
        self.installed = []
        self.removed = []
        self.swept = 0
        self.fail_remove = fail_remove

    def supports(self, mode):
        return None

    def install(self, rule):
        self.installed.append(dict(rule))

    def remove(self, rule):
        self.removed.append(dict(rule))
        if self.fail_remove:
            raise OSError("remove failed")
        return True

    def sweep_engine(self):
        self.swept += 1


def test_sweep_removes_journaled_rules_and_counts(tmp_path):
    from jepsen_tpu_torch.obs import metrics as tm

    rules = RULES[:2]
    out = {}
    for name, P in PKGS.items():
        root = str(tmp_path / name)
        for r in rules:
            P.links.journal_append(root, r)
        eng = FakeEngine()
        n1 = P.links.sweep(root, engine=eng)
        n2 = P.links.sweep(root, engine=eng)  # idempotent
        out[name] = (n1, n2, eng.removed, eng.swept,
                     P.links.journal_rules(root))
    assert out["torch"] == out["jax"] == (2, 0, rules, 1, [])
    # the port's series is registered and counts each swept rule
    before = tm.REGISTRY.get("jtpu_link_rules_swept_total").total()
    root = str(tmp_path / "again")
    for r in rules:
        tlinks.journal_append(root, r)
    tlinks.sweep(root, engine=FakeEngine())
    after = tm.REGISTRY.get("jtpu_link_rules_swept_total").total()
    assert after - before == 2


def test_sweep_keeps_the_journal_when_a_removal_fails(tmp_path):
    out = {}
    for name, P in PKGS.items():
        root = str(tmp_path / name)
        for r in RULES[:2]:
            P.links.journal_append(root, r)
        n = P.links.sweep(root, engine=FakeEngine(fail_remove=True))
        out[name] = (n, P.links.journal_rules(root))
    assert out["torch"] == out["jax"] == (0, RULES[:2])


def test_sweep_tree_finds_nested_journals_either_package_wrote(
        tmp_path, monkeypatch):
    """Each package's tree sweep restores the rules the OTHER journaled,
    with the same engine commands (recorded, never run)."""
    out = {}
    for name, P in PKGS.items():
        writer = PKGS["jax" if name == "torch" else "torch"]
        base = tmp_path / name
        roots = [str(base / "cell-a"), str(base / "deep" / "cell-b")]
        for r in roots:
            for rule in RULES:
                writer.links.journal_append(r, rule)
        rec = Recorder(lambda argv: (1, "", "no such rule"))
        monkeypatch.setattr(P.links, "_run", rec)
        n = P.links.sweep_tree(str(base))
        out[name] = (n, [P.links.journal_rules(r) for r in roots],
                     [[a.replace(str(base), "B") for a in argv]
                      for argv in rec.argv])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 6 and out["torch"][1] == [[], []]


# ---------------------------------------------------------------------------
# the nemesis over the journal
# ---------------------------------------------------------------------------


def _op(P, f):
    return P.Op(process="nemesis", type="info", f=f, value=None)


def test_link_partition_nemesis_start_journal_heal(tmp_path):
    from jepsen_tpu.live.backend import FAMILIES as JF
    from jepsen_tpu_torch.live.backend import FAMILIES as TF

    fams = {"jax": JF, "torch": TF}
    out = {}
    for name, P in PKGS.items():
        root = str(tmp_path / name)
        test = {"nodes": NODES, "data_root": root}
        eng = FakeEngine()
        nem = P.links.LinkPartitionNemesis(fams[name]["replicated"],
                                           "bridge", engine=eng)
        start = nem.invoke(test, _op(P, "start"))
        journaled = open(P.links.journal_path(root), "rb").read()
        again = nem.invoke(test, _op(P, "start")).value
        stop = nem.invoke(test, _op(P, "stop"))
        out[name] = (start.type, start.value, eng.installed, journaled,
                     again, stop.value, eng.removed,
                     P.links.journal_rules(root))
    assert out["torch"] == out["jax"]
    typ, value, installed, _j, again, stopped, removed, left = out["torch"]
    assert typ == "info" and value[:2] == ["links-drop", "bridge"]
    assert sorted((r["src"], r["dst"]) for r in installed) == \
        [("127.0.1.1", "127.0.1.3"), ("127.0.1.3", "127.0.1.1")]
    assert again == "already-partitioned" and stopped == "links-healed"
    assert len(removed) == 2 and left == []


def test_isolate_leader_grudge_targets_backend_leader(tmp_path):
    class FakeBackend:
        name = "fake"
        peer_linked = True

        def leader(self, test):
            return "n3"

    out = {}
    for name, P in PKGS.items():
        root = str(tmp_path / name)
        test = {"nodes": NODES, "data_root": root}
        eng = FakeEngine()
        nem = P.links.LinkPartitionNemesis(FakeBackend(), "isolate-leader",
                                           engine=eng)
        nem.invoke(test, _op(P, "start"))
        nem.teardown(test)
        out[name] = (sorted((r["src"], r["dst"]) for r in eng.installed),
                     P.links.journal_rules(root))
    assert out["torch"] == out["jax"] == (
        [("127.0.1.3", "127.0.1.1"), ("127.0.1.3", "127.0.1.2")], [])


def test_degrade_grudge_uses_degrade_mode(tmp_path):
    from jepsen_tpu.live.backend import FAMILIES as JF
    from jepsen_tpu_torch.live.backend import FAMILIES as TF

    fams = {"jax": JF, "torch": TF}
    out = {}
    for name, P in PKGS.items():
        test = {"nodes": NODES, "data_root": str(tmp_path / name)}
        eng = FakeEngine()
        nem = P.links.LinkPartitionNemesis(fams[name]["replicated"],
                                           "degrade", engine=eng)
        nem.invoke(test, _op(P, "start"))
        nem.teardown(test)
        out[name] = eng.installed
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) == 6
    assert all(r["mode"] == "degrade" for r in out["torch"])


def test_grudge_menu_as_reference():
    got = _same(lambda P: [(g.name, g.mode, g.doc, g.asymmetric)
                           for g in P.links.GRUDGES.values()])
    assert [g[0] for g in got] == ["split-one", "bridge", "random-halves",
                                   "isolate-leader", "degrade"]
    assert (tlinks.TC_HANDLE, tlinks.TC_DROP_RATE, tlinks.TC_DEGRADE_RATE) \
        == (jlinks.TC_HANDLE, jlinks.TC_DROP_RATE, jlinks.TC_DEGRADE_RATE)


# ---------------------------------------------------------------------------
# the rule engines, recorded: the commands each package would run
# ---------------------------------------------------------------------------


def _tc_reply(own: bool):
    """A ``tc`` that answers ``qdisc show`` with our htb root or none."""
    def reply(argv):
        if argv[:3] == ["tc", "qdisc", "show"]:
            return (0, f"qdisc htb {jlinks.TC_HANDLE}: root\n" if own
                    else "qdisc noqueue 0: root refcnt 2\n", "")
        return (0, "", "")
    return reply


@pytest.mark.parametrize("engine", ["iptables", "tc"])
def test_engine_install_remove_sweep_commands(monkeypatch, engine):
    """The real-engine round trip of the reference's tests, as the
    commands it issues: install, remove and sweep of a link rule (and a
    port rule for iptables), in both packages, equal argv by argv; the
    tc engine's burn sends its UDP datagrams to a loopback discard
    port, stubbed out here."""
    rule = {"kind": "link", "src": "127.0.1.1", "dst": "127.0.1.2",
            "mode": "drop", "engine": engine}
    out = {}
    for name, P in PKGS.items():
        rec = Recorder(_tc_reply(own=False))
        monkeypatch.setattr(P.links, "_run", rec)
        burns = []
        monkeypatch.setattr(P.links.TcEngine, "_burn",
                            staticmethod(lambda s, d, **k: burns.append(
                                (s, d))))
        eng = P.links._ENGINES[engine]()
        eng.install(rule)
        eng.install(dict(rule, mode="degrade", src="127.0.1.3"))
        removed = eng.remove(rule)
        if engine == "iptables":
            port = {"kind": "port", "port": 18100, "engine": engine}
            eng.install(port)
            eng.remove(port)
        rec.reply = _tc_reply(own=True)
        eng.sweep_engine()
        out[name] = (rec.argv, removed, burns,
                     eng.supports("drop"), eng.supports("degrade"))
    assert out["torch"] == out["jax"]
    assert out["torch"][1] is True


def test_engine_install_failure_raises_alike(monkeypatch):
    rule = {"kind": "link", "src": "127.0.1.1", "dst": "127.0.1.2",
            "mode": "drop", "engine": "iptables"}
    out = {}
    for name, P in PKGS.items():
        monkeypatch.setattr(P.links, "_run", Recorder(
            lambda argv: (4, "", "iptables: Permission denied")))
        errors = []
        for eng, r in ((P.links.IptablesEngine(), rule),
                       (P.links.TcEngine(), dict(rule, engine="tc")),
                       (P.links.TcEngine(), {"kind": "port", "port": 1})):
            with pytest.raises(RuntimeError) as e:
                eng.install(r)
            errors.append(str(e.value))
        out[name] = errors
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("host", [
    "bare", "iptables-user", "iptables-root", "tc-root",
    "tc-foreign", "tc-no-htb"])
def test_engine_probes_and_pick_as_reference(monkeypatch, host):
    """The probes and the per-mode pick on a host staged through
    ``shutil.which``, ``os.geteuid`` and the command recorder: the same
    reasons, the same engine, the same commands."""
    import shutil

    tools = {"bare": (), "iptables-user": ("iptables",),
             "iptables-root": ("iptables", "tc"), "tc-root": ("tc",),
             "tc-foreign": ("tc",), "tc-no-htb": ("tc",)}[host]
    root = host != "iptables-user"

    def reply(argv):
        if argv[:3] == ["tc", "qdisc", "show"]:
            return (0, "qdisc fq_codel 0: root\n" if host == "tc-foreign"
                    else "qdisc noqueue 0: root refcnt 2\n", "")
        if host == "tc-no-htb" and argv[:3] == ["tc", "qdisc", "add"]:
            return (2, "", "Error: Specified qdisc kind is unknown.")
        return (0, "", "")

    monkeypatch.setattr(shutil, "which",
                        lambda b: f"/usr/sbin/{b}" if b in tools else None)
    monkeypatch.setattr(os, "geteuid", lambda: 0 if root else 1000)
    out = {}
    for name, P in PKGS.items():
        rec = Recorder(reply)
        monkeypatch.setattr(P.links, "_run", rec)
        monkeypatch.setattr(P.links, "_pick_cache", {})
        drop_eng, drop_reason = P.links.pick_engine("drop")
        deg_eng, deg_reason = P.links.pick_engine("degrade")
        out[name] = (getattr(drop_eng, "name", None), drop_reason,
                     getattr(deg_eng, "name", None), deg_reason,
                     P.links.probe_links(), P.links.probe_degrade(),
                     rec.argv)
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# the matrix on the command line: --dry-run spawns nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engines", ["none", "tc"])
def test_dry_run_validates_family_nemesis_grudge_matrix(
        monkeypatch, capsys, engines):
    """``python -m jepsen_tpu_torch.live --dry-run --json`` (in process,
    with each package's engine pick seeded: no probe runs) prints the
    JAX package's plan, and the plan has the reference's shape."""
    from jepsen_tpu.live.campaign import SEEDED, plan
    from jepsen_tpu_torch.live import __main__ as cli
    from jepsen_tpu_torch.live.backend import FAMILIES
    from jepsen_tpu_torch.live.matrix import standard_matrix

    if engines == "tc":
        for P in PKGS.values():
            monkeypatch.setattr(P.links, "_pick_cache", {
                "drop": ("tc", None), "degrade": ("tc", None)})
    assert cli.main(["--dry-run", "--json"]) == 0
    cells = json.loads(capsys.readouterr().out)
    assert cells == plan()
    matrix = standard_matrix()
    base = [c for c in cells if not c["seeded"]]
    assert {(c["family"], c["nemesis"]) for c in base} == \
        {(f, n) for f in FAMILIES for n in matrix}
    assert len(base) == len(FAMILIES) * len(matrix)
    link_rows = [n for n in matrix if n.startswith("link-")]
    assert set(link_rows) == {f"link-{g}" for g in tlinks.GRUDGES}
    engine_reason = tlinks.probe_links()
    by_coord = {(c["family"], c["nemesis"]): c for c in base}
    for fname, fam in FAMILIES.items():
        for n in link_rows:
            cell = by_coord[(fname, n)]
            if engine_reason is not None:
                # the host's probe speaks first (plan's order of reasons)
                assert cell["skip"] == engine_reason, cell
            elif not fam.peer_linked:
                assert "no inter-node links" in cell["skip"], cell
            else:
                assert cell["skip"] is None, cell
    seeded = {(c["family"], c["nemesis"]) for c in cells if c["seeded"]}
    for coord in (("replicated", "link-isolate-leader"),
                  ("replicated-queue", "link-bridge")):
        assert coord in SEEDED
        assert (coord in seeded) == (engine_reason is None)
    assert all(by_coord[(f, "kill-restart")]["skip"] is None
               for f in FAMILIES)


def test_render_plan_covers_grudge_columns():
    from jepsen_tpu.live.campaign import plan as jplan
    from jepsen_tpu.live.campaign import render_plan as jrender
    from jepsen_tpu_torch.live.campaign import plan, render_plan

    out = render_plan(plan())
    assert out == jrender(jplan())
    assert "link-bridge" in out and "link-isolate-leader" in out
    assert "replicated-queue" in out and "pgwire" in out


def test_sweep_cli_restores_what_the_reference_journaled(tmp_path):
    """``python -m jepsen_tpu_torch.live --sweep ROOT`` clears a journal
    the JAX package wrote (an iptables rule: the binary is absent here
    or the rule is not installed, so its removal changes nothing)."""
    root = str(tmp_path / "nodes" / "live-cell")
    jlinks.journal_append(root, RULES[0])
    r = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.live", "--sweep",
         str(tmp_path / "nodes")], capture_output=True, text=True,
        cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == \
        f"swept 1 journaled rule(s) under {tmp_path / 'nodes'}"
    assert jlinks.journal_rules(root) == []
