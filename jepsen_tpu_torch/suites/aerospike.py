"""Aerospike suite — strong-consistency (CP-mode) key-value store.

Reference: aerospike/ (1,262 LoC).  Db automation installs local .deb
packages, templates aerospike.conf with the mesh address of the primary
and a replication factor, starts the service, then drives the
*roster* workflow over asinfo: wait for every node to be observed, set
the roster, recluster, and wait for migrations to settle
(aerospike/src/aerospike/support.clj:226-300).  The signature nemesis is
the capped kill/restart/revive/recluster menu
(aerospike/src/aerospike/nemesis.clj:17-57) composed with partitions and
clock faults (nemesis.clj:96-126).  Workloads: independent-key CAS
register (cas_register.clj:43-104), counter (counter.clj:43-78), and an
append-based set (set.clj:11-72).

Record clients are gated on the `aerospike` python driver (the wire
protocol is binary and proprietary); everything the harness itself needs
— db automation, roster management, the full nemesis menu — speaks
asinfo/asadm over SSH and is unit-testable against DummyRemote.

The CP-mode roster/recluster/revive protocol is modeled in
``native/spec/aerospike_cp.tla`` (the analog of the reference's
aerospike/spec/aerospike.tla TLA+ spec).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                db as db_mod, fixtures, generator as gen, independent,
                nemesis as nemesis_mod, net as net_mod)
from ..checker import basic, linearizable as lin, perf as perf_mod, timeline
from ..models import cas_register as cas_register_model
from ..os import debian

log = logging.getLogger("jepsen")

NAMESPACE = "jepsen"
PACKAGE_DIR = "/tmp/packages"
CONF = "/etc/aerospike/aerospike.conf"
LOG_FILE = "/var/log/aerospike/aerospike.log"


# ---------------------------------------------------------------------------
# asinfo plumbing (support.clj:53-73 kv-split/split-*)
# ---------------------------------------------------------------------------


def parse_kv(s: str, sep: str = ";") -> dict:
    """'a=1;b=x,y' -> {'a': '1', 'b': 'x,y'} (support.clj:53-57)."""
    out = {}
    for part in str(s).strip().split(sep):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def asinfo(sess, command: str) -> str:
    """Run one asinfo command on the node (support.clj:146-152)."""
    return str(sess.su().exec("asinfo", "-v", command)).strip()


def roster(sess, namespace: str = NAMESPACE) -> dict:
    """Parse `roster:namespace=...` into lists (support.clj:154-160).

    Reply shape: 'roster=A,B:pending_roster=A,B:observed_nodes=A,B,C'."""
    raw = asinfo(sess, f"roster:namespace={namespace}")
    kv = parse_kv(raw, sep=":")
    return {k: [x for x in v.split(",") if x and x != "null"]
            for k, v in kv.items()}


def roster_set(sess, nodes: list[str],
               namespace: str = NAMESPACE) -> None:
    """support.clj:163-167."""
    asinfo(sess, f"roster-set:namespace={namespace};nodes="
                 + ",".join(nodes))


def recluster(sess) -> None:
    """Recluster the local node (support.clj:148-152)."""
    asinfo(sess, "recluster:")


def recluster_all(sess) -> None:
    """asadm fans recluster out to every clustered node
    (support.clj:136-141)."""
    sess.su().exec("asadm", "-e", "asinfo -v recluster:")


def revive(sess, namespace: str = NAMESPACE) -> None:
    """Revive dead partitions on the local node (support.clj:142-146)."""
    asinfo(sess, f"revive:namespace={namespace}")


def statistics(sess) -> dict:
    return parse_kv(asinfo(sess, "statistics"))


def poll(fn, pred, tries: int = 30, sleep_s: float = 1.0):
    """support.clj:169-181."""
    for _ in range(tries):
        v = fn()
        if pred(v):
            return v
        time.sleep(sleep_s)
    raise TimeoutError("aerospike poll timed out")


def wait_all_observed(sess, test, namespace: str = NAMESPACE):
    return poll(lambda: roster(sess, namespace).get("observed_nodes", []),
                lambda v: len(v) == len(test["nodes"]))


def wait_all_pending(sess, test, namespace: str = NAMESPACE):
    return poll(lambda: roster(sess, namespace).get("pending_roster", []),
                lambda v: len(v) == len(test["nodes"]))


def wait_all_active(sess, test, namespace: str = NAMESPACE):
    return poll(lambda: roster(sess, namespace).get("roster", []),
                lambda v: len(v) == len(test["nodes"]))


def wait_migrations(sess):
    """support.clj:203-208."""
    return poll(
        lambda: statistics(sess),
        lambda st: (st.get("migrate_allowed") == "true"
                    and st.get("migrate_partitions_remaining") == "0"))


# ---------------------------------------------------------------------------
# db automation (support.clj:226-343)
# ---------------------------------------------------------------------------


def config_template(node_addr: str, mesh_addr: str, *,
                    replication_factor: int, heartbeat_interval: int,
                    commit_to_device: bool) -> str:
    """The conf the reference templates from resources/aerospike.conf
    (support.clj:259-283): mesh heartbeats to the primary, a
    strong-consistency namespace, memory storage."""
    return "\n".join([
        "service {",
        "    proto-fd-max 15000",
        "    node-id-interface eth0",
        "}",
        f"logging {{ file {LOG_FILE} {{ context any info }} }}",
        "network {",
        "    service { address any; port 3000; access-address "
        + node_addr + " }",
        "    heartbeat {",
        "        mode mesh",
        f"        address {node_addr}",
        "        port 3002",
        f"        mesh-seed-address-port {mesh_addr} 3002",
        f"        interval {heartbeat_interval}",
        "        timeout 10",
        "    }",
        "    fabric { port 3001 }",
        "    info { port 3003 }",
        "}",
        f"namespace {NAMESPACE} {{",
        "    replication-factor %d" % replication_factor,
        "    memory-size 512M",
        "    strong-consistency true",
        ("    storage-engine device {\n"
         "        file /opt/aerospike/data/jepsen.dat\n"
         "        filesize 128M\n"
         "        commit-to-device true\n    }"
         if commit_to_device else
         "    storage-engine memory"),
        "}",
        ""])


def install(sess) -> None:
    """dpkg -i the server+tools debs from the package dir
    (support.clj:229-250)."""
    su = sess.su()
    debian.install(sess, ["python"])
    su.exec("mkdir", "-p", PACKAGE_DIR)
    su.exec("chmod", "a+rwx", PACKAGE_DIR)
    debs = str(su.exec("ls", PACKAGE_DIR)).split()
    assert any("aerospike-server" in d for d in debs), (
        f"expected an aerospike-server .deb uploaded to {PACKAGE_DIR}")
    for deb in sorted(debs):
        if deb.endswith(".deb"):
            su.exec("dpkg", "-i", "--force-confnew",
                    f"{PACKAGE_DIR}/{deb}")
    su.exec("systemctl", "daemon-reload")
    for d, owner in (("/var/log/aerospike", "aerospike:aerospike"),
                     ("/var/run/aerospike", "aerospike:aerospike")):
        su.exec("mkdir", "-p", d)
        su.exec("chown", owner, d)


def configure(sess, test, node, opts) -> None:
    """support.clj:252-283."""
    node_addr = net_mod.ip(sess, str(node)) or str(node)
    from .. import core as core_mod

    mesh = str(core_mod.primary(test))
    mesh_addr = net_mod.ip(sess, mesh) or mesh
    conf = config_template(
        node_addr, mesh_addr,
        replication_factor=opts.get("replication_factor", 3),
        heartbeat_interval=opts.get("heartbeat_interval", 150),
        commit_to_device=opts.get("commit_to_device", False))
    sess.su().exec("echo", conf, control.lit(">"), CONF)


def start(sess, test, node) -> None:
    """Start + the roster dance (support.clj:285-300): primary waits for
    all nodes observed, sets the roster, and reclusters; everyone waits
    for the roster to go active and migrations to drain."""
    from .. import core as core_mod

    core_mod.synchronize(test)
    sess.su().exec("service", "aerospike", "start")
    core_mod.synchronize(test)
    if node == core_mod.primary(test):
        observed = wait_all_observed(sess, test)
        roster_set(sess, observed)
        wait_all_pending(sess, test)
        recluster_all(sess)
    core_mod.synchronize(test)
    wait_all_active(sess, test)
    wait_migrations(sess)
    core_mod.synchronize(test)


def stop(sess) -> None:
    """support.clj:302-308."""
    su = sess.su()
    try:
        su.exec("service", "aerospike", "stop")
    except control.RemoteError:
        pass
    try:
        su.exec("killall", "-9", "asd")
    except control.RemoteError:
        pass


def wipe(sess) -> None:
    """support.clj:310-321."""
    stop(sess)
    su = sess.su()
    try:
        su.exec("truncate", "--size", "0", LOG_FILE)
    except control.RemoteError:
        pass
    for d in ("data", "smd", "udf"):
        su.exec("rm", "-rf", control.lit(f"/opt/aerospike/{d}/*"))


class AerospikeDB(db_mod.DB, db_mod.LogFiles):
    """support.clj:325-343."""

    def __init__(self, opts: dict | None = None):
        self.opts = opts or {}

    def setup(self, test, node):
        sess = control.session(node, test)
        install(sess)
        configure(sess, test, node, self.opts)
        start(sess, test, node)

    def teardown(self, test, node):
        wipe(control.session(node, test))

    def log_files(self, test, node):
        return [LOG_FILE]


def db(opts: dict | None = None) -> AerospikeDB:
    return AerospikeDB(opts)


# ---------------------------------------------------------------------------
# kill / revive / recluster nemesis (nemesis.clj:17-91)
# ---------------------------------------------------------------------------


def capped_conj(s: set, x, cap: int) -> set:
    """nemesis.clj:12-16: add x only while |s| stays <= cap."""
    s2 = s | {x}
    return s if len(s2) > cap else s2


class KillNemesis(nemesis_mod.Nemesis):
    """kill (capped at max_dead), restart, revive, recluster
    (nemesis.clj:17-57).  op.value is the node subset to hit."""

    def __init__(self, max_dead: int = 1, signal: int = 9):
        self.max_dead = max_dead
        self.signal = signal
        self.dead: set = set()
        self._lock = threading.Lock()

    def _kill(self, test, node):
        with self._lock:
            self.dead = capped_conj(self.dead, node, self.max_dead)
            allowed = node in self.dead
        if not allowed:
            return "still-alive"
        sess = control.session(node, test).su()
        try:
            sess.exec("killall", f"-{self.signal}", "asd")
        except control.RemoteError:
            pass
        return "killed"

    def _restart(self, test, node):
        control.session(node, test).su().exec(
            "service", "aerospike", "restart")
        with self._lock:
            self.dead.discard(node)
        return "started"

    def _asinfo_op(self, test, node, fn, label):
        try:
            fn(control.session(node, test))
            return label
        except control.RemoteError as e:
            if "Could not connect" in str(e):
                return "not-running"
            raise

    def invoke(self, test, op):
        nodes = op.value or list(test["nodes"])
        fns = {
            "kill": self._kill,
            "restart": self._restart,
            "revive": lambda t, n: self._asinfo_op(
                t, n, revive, "revived"),
            "recluster": lambda t, n: self._asinfo_op(
                t, n, recluster, "reclustered"),
        }
        f = fns.get(op.f)
        if f is None:
            raise ValueError(f"kill-nemesis: unknown f {op.f!r}")
        value = control.on_nodes(test, f, nodes)
        return replace(op, type="info", value=value)


def kill_gen(test, process):
    from ..util import random_nonempty_subset

    return {"type": "info", "f": "kill",
            "value": random_nonempty_subset(list(test["nodes"]))}


def restart_gen(test, process):
    from ..util import random_nonempty_subset

    return {"type": "info", "f": "restart",
            "value": random_nonempty_subset(list(test["nodes"]))}


def revive_gen(test, process):
    return {"type": "info", "f": "revive", "value": list(test["nodes"])}


def recluster_gen(test, process):
    return {"type": "info", "f": "recluster",
            "value": list(test["nodes"])}


def killer_gen(no_revives: bool = False) -> gen.Generator:
    """Random mix of [kill], [restart], [revive recluster] patterns
    (nemesis.clj:76-91)."""
    patterns = [[kill_gen], [restart_gen]]
    if not no_revives:
        patterns.append([revive_gen, recluster_gen])

    def seq():
        while True:
            yield from random.choice(patterns)

    return gen.seq(seq())


def full_nemesis(opts: dict | None = None) -> nemesis_mod.Nemesis:
    """kills + partitions + clock faults behind one router
    (nemesis.clj:96-110)."""
    from .. import nemesis_time

    opts = opts or {}
    return nemesis_mod.compose({
        frozenset(["kill", "restart", "revive", "recluster"]):
            KillNemesis(max_dead=opts.get("max_dead_nodes", 1),
                        signal=15 if opts.get("clean_kill") else 9),
        (lambda f: {"partition-start": "start",
                    "partition-stop": "stop"}.get(f)):
            nemesis_mod.partition_random_halves(),
        (lambda f: {"clock-reset": "reset", "clock-bump": "bump",
                    "clock-strobe": "strobe"}.get(f)):
            nemesis_time.clock_nemesis(),
    })


def full_gen(opts: dict | None = None) -> gen.Generator:
    """nemesis.clj:112-126."""
    from .. import nemesis_time

    opts = opts or {}
    srcs = []
    if not opts.get("no_clocks"):
        srcs.append(gen.f_map({"strobe": "clock-strobe",
                               "reset": "clock-reset",
                               "bump": "clock-bump"},
                              nemesis_time.clock_gen()))
    if not opts.get("no_kills"):
        srcs.append(killer_gen(opts.get("no_revives", False)))
    if not opts.get("no_partitions"):
        import itertools

        srcs.append(gen.seq(itertools.cycle(
            [{"type": "info", "f": "partition-start"},
             {"type": "info", "f": "partition-stop"}])))
    return gen.mix(srcs)


def final_gen() -> gen.Generator:
    """Heal everything: stop partition, reset clocks, restart all, then
    revive+recluster (nemesis.clj:128-145)."""
    return gen.concat(
        gen.once({"type": "info", "f": "partition-stop"}),
        gen.once({"type": "info", "f": "clock-reset"}),
        gen.once(lambda test, _p: {"type": "info", "f": "restart",
                                   "value": list(test["nodes"])}),
        gen.sleep(10),
        gen.once(revive_gen),
        gen.once(recluster_gen))


# ---------------------------------------------------------------------------
# clients (gated on the `aerospike` python driver)
# ---------------------------------------------------------------------------


class AerospikeClient(client_mod.Client):
    """Shared connection plumbing (support.clj:103-133, 422-472's
    with-errors).  Timeouts and "unavailable" CP errors map to :fail for
    reads and :info (indeterminate) for writes."""

    aset = "cats"

    def __init__(self, node=None):
        self.node = node
        self.conn = None

    def _driver(self):
        try:
            import aerospike  # type: ignore

            return aerospike
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "aerospike workloads need the `aerospike` python driver "
                "on the control node (binary wire protocol)") from e

    def open(self, test, node):
        c = type(self)(node)
        aero = c._driver()
        c.conn = aero.client(
            {"hosts": [(str(node), 3000)],
             "policies": {"total_timeout": 10000, "max_retries": 0,
                          "read": {"linearize_read": True}}}).connect()
        return c

    def _key(self, k):
        return (NAMESPACE, self.aset, k)

    def _errors(self, op, fail_fs=("read",)):
        """Context mapping driver errors like support.clj:422-472."""
        client = self

        class Ctx:
            def __enter__(self):
                return self

            def __exit__(self, et, e, tb):
                if e is None:
                    return False
                # the driver raises leaf subclasses (RecordGenerationError,
                # InvalidNodeError, ...) — walk the MRO, not the leaf name
                names = {"TimeoutError", "ClientError", "ServerError",
                         "RecordError", "AerospikeError"}
                if any(b.__name__ in names for b in type(e).__mro__):
                    client._out = replace(
                        op,
                        type="fail" if op.f in fail_fs else "info",
                        error=f"{type(e).__name__}: {e}")
                    return True
                return False

        return Ctx()

    def close(self, test):
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
            self.conn = None


class CasRegisterClient(AerospikeClient):
    """Independent-key CAS register (cas_register.clj:43-75): read the
    bin, generation-checked CAS, blind put."""

    def invoke(self, test, op):
        self._out = None
        k, v = op.value
        # only reads are determinate on generic errors; a timed-out CAS
        # put may still have committed, so it must be :info, not :fail
        with self._errors(op, fail_fs=("read",)):
            if op.f == "read":
                try:
                    _key, meta, bins = self.conn.get(self._key(k))
                    val = (bins or {}).get("value")
                except self._driver().exception.RecordNotFound:
                    val = None
                return replace(op, type="ok",
                               value=independent.tuple_(k, val))
            if op.f == "write":
                self.conn.put(self._key(k), {"value": v})
                return replace(op, type="ok")
            if op.f == "cas":
                frm, to = v
                aero = self._driver()
                try:
                    _key, meta, bins = self.conn.get(self._key(k))
                except aero.exception.RecordNotFound:
                    return replace(op, type="fail", error="not-found")
                if (bins or {}).get("value") != frm:
                    return replace(op, type="fail", error="value-mismatch")
                # generation check makes the read-modify-write atomic
                # (support.clj:376-383 EXPECT_GEN_EQUAL); a lost gen race
                # is determinate — the put did NOT apply
                try:
                    self.conn.put(
                        self._key(k), {"value": to},
                        meta={"gen": meta["gen"]},
                        policy={"gen": aero.POLICY_GEN_EQ})
                except Exception as e:
                    if "Generation" in type(e).__name__:
                        return replace(op, type="fail",
                                       error="gen-conflict")
                    raise
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        return self._out


class CounterClient(AerospikeClient):
    """counter.clj:43-66: increment + read one record."""

    aset = "counters"
    key = "pounce"

    def setup(self, test):
        # initialize once per worker BEFORE ops begin (counter.clj:45-49);
        # open() must stay state-free — it re-runs after crashed ops
        self.conn.put(self._key(self.key), {"value": 0})

    def invoke(self, test, op):
        self._out = None
        with self._errors(op):
            if op.f == "read":
                _key, _meta, bins = self.conn.get(self._key(self.key))
                return replace(op, type="ok",
                               value=(bins or {}).get("value"))
            if op.f == "add":
                self.conn.increment(self._key(self.key), "value", op.value)
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        return self._out


class SetClient(AerospikeClient):
    """set.clj:11-46: string-append adds, read splits into a set."""

    def invoke(self, test, op):
        self._out = None
        k, v = op.value
        with self._errors(op, fail_fs=()):
            if op.f == "read":
                try:
                    _key, _meta, bins = self.conn.get(self._key(k))
                    raw = (bins or {}).get("value") or ""
                except self._driver().exception.RecordNotFound:
                    raw = ""
                vals = sorted(int(x) for x in str(raw).split() if x)
                return replace(op, type="ok",
                               value=independent.tuple_(k, vals))
            if op.f == "add":
                self.conn.append(self._key(k), "value", f" {v}")
                return replace(op, type="ok")
            raise ValueError(f"unknown f {op.f!r}")
        return self._out


# ---------------------------------------------------------------------------
# workloads + tests (core.clj:36-99)
# ---------------------------------------------------------------------------


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randint(0, 4), random.randint(0, 4))}


def add(test, process):
    return {"type": "invoke", "f": "add", "value": 1}


def cas_register_workload() -> dict:
    """cas_register.clj:85-104."""
    return {
        "client": CasRegisterClient(),
        "model": cas_register_model(),
        "checker": independent.checker(checker_mod.compose({
            "linear": lin.linearizable(cas_register_model()),
            "timeline": timeline.timeline(),
        })),
        "generator": independent.concurrent_generator(
            10, _keys(), lambda k: gen.limit(
                100 + random.randint(0, 100),
                gen.stagger(1, gen.reserve(5, r,
                                           gen.mix([w, cas, cas]))))),
    }


def counter_workload() -> dict:
    """counter.clj:68-78."""
    return {
        "client": CounterClient(),
        "checker": basic.counter(),
        "generator": gen.delay(0.01, gen.mix([r] + [add] * 100)),
    }


def set_workload() -> dict:
    """set.clj:48-72."""
    def per_key(k):
        return gen.stagger(0.1, gen.seq(
            {"type": "invoke", "f": "add", "value": x}
            for x in range(10000)))

    return {
        "client": SetClient(),
        "checker": independent.checker(basic.set_checker()),
        "generator": independent.concurrent_generator(
            5, _keys(), per_key),
    }


def _keys():
    import itertools

    return itertools.count()


WORKLOADS = {
    "cas-register": cas_register_workload,
    "counter": counter_workload,
    "set": set_workload,
}


def aerospike_test(opts: dict) -> dict:
    """core.clj:36-99: workload + full nemesis + final heal phase."""
    workload = WORKLOADS[opts.get("workload", "cas-register")]()
    nem_opts = {k: opts[k] for k in
                ("max_dead_nodes", "clean_kill", "no_clocks", "no_kills",
                 "no_partitions", "no_revives") if k in opts}
    tl = opts.get("time_limit", 60)
    return fixtures.noop_test() | {
        "name": f"aerospike {opts.get('workload', 'cas-register')}",
        "os": debian.os,
        "db": db(opts),
        "client": workload["client"],
        "model": workload.get("model"),
        "nemesis": full_nemesis(nem_opts),
        "checker": checker_mod.compose({
            "workload": workload["checker"],
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(tl, gen.nemesis(
                gen.stagger(5, full_gen(nem_opts)),
                workload["generator"])),
            gen.log("Healing cluster"),
            gen.nemesis(final_gen()),
            gen.sleep(10)),
    } | {k: v for k, v in opts.items() if k not in ("workload",)}


def add_opts(p):
    p.add_argument("--workload", default="cas-register",
                   choices=sorted(WORKLOADS))
    p.add_argument("--max-dead-nodes", type=int, default=1)
    p.add_argument("--clean-kill", action="store_true")
    p.add_argument("--no-clocks", action="store_true")
    p.add_argument("--no-kills", action="store_true")
    p.add_argument("--no-partitions", action="store_true")
    p.add_argument("--no-revives", action="store_true")


def main(argv=None):
    cli.main(cli.single_test_cmd(aerospike_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
