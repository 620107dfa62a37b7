"""Chronos suite — distributed cron on Mesos.

Reference: chronos/ (847 LoC: chronos.clj, mesosphere.clj,
chronos/checker.clj).  Two layers:

  * mesosphere automation (mesosphere.clj): zookeeper + the mesosphere
    apt repo; the first 3 (sorted) nodes run mesos-master with a
    majority quorum against zk://...:2181/mesos, every node runs
    mesos-slave; both under start-stop-daemon.
  * chronos automation (chronos.clj:40-86): apt install, a 1s
    schedule_horizon, service chronos start.

Workload (chronos.clj:93-246): the generator submits jobs — repeating
ISO8601 schedules whose shell command appends (name, start, end)
timestamps to a tempfile in /tmp/chronos-test — sized so runs never
overlap; the final read cats every node's run files; the
schedule checker (checker/schedule.py, the reference's loco CSP
replaced by exact greedy interval matching) decides whether every
target got a distinct completed run.

The op client talks to chronos's REST API via stdlib urllib and reads
run files over SSH — no driver packages needed.
"""

from __future__ import annotations

import json
import logging
import random
import time
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                control_util as cu, db as db_mod, fixtures,
                generator as gen, nemesis as nemesis_mod, util)
from ..checker import perf as perf_mod, schedule
from ..os import debian
from . import zookeeper as zk_suite

log = logging.getLogger("jepsen")

PORT = 4400  # "docs say 8080 but the package binds to 4400" chronos.clj:25
JOB_DIR = "/tmp/chronos-test/"
MASTER_COUNT = 3
MASTER_PIDFILE = "/var/run/mesos/master.pid"
SLAVE_PIDFILE = "/var/run/mesos/slave.pid"
MASTER_DIR = "/var/lib/mesos/master"
SLAVE_DIR = "/var/lib/mesos/slave"
MESOS_LOG_DIR = "/var/log/mesos"


# ---------------------------------------------------------------------------
# mesosphere automation (mesosphere.clj)
# ---------------------------------------------------------------------------


def zk_uri(test) -> str:
    """zk://n1:2181,.../mesos (mesosphere.clj:38-47)."""
    hosts = ",".join(f"{n}:2181" for n in test["nodes"])
    return f"zk://{hosts}/mesos"


def masters(test) -> list:
    """First MASTER_COUNT sorted nodes run masters
    (mesosphere.clj:62-68)."""
    return sorted(str(n) for n in test["nodes"])[:MASTER_COUNT]


def install_mesos(sess, version: str) -> None:
    """mesosphere.clj:26-36."""
    debian.add_repo(sess, "mesosphere",
                    "deb http://repos.mesosphere.io/debian wheezy main",
                    keyserver="keyserver.ubuntu.com", key="E56151BF")
    debian.install(sess.su(), {"mesos": version})
    su = sess.su()
    for d in ("/var/run/mesos", MASTER_DIR, SLAVE_DIR, MESOS_LOG_DIR):
        su.exec("mkdir", "-p", d)


def configure_mesos(sess, test) -> None:
    """mesosphere.clj:49-59."""
    su = sess.su()
    su.exec("echo", zk_uri(test), control.lit(">"), "/etc/mesos/zk")
    su.exec("echo", str(util.majority(MASTER_COUNT)), control.lit(">"),
            "/etc/mesos-master/quorum")


def start_master(test, node) -> None:
    """mesosphere.clj:60-91 (only on master-eligible nodes)."""
    if str(node) not in masters(test):
        return
    sess = control.session(node, test).su()
    cu.start_daemon(
        sess, "/usr/sbin/mesos-master",
        f"--hostname={node}", f"--log_dir={MESOS_LOG_DIR}",
        f"--quorum={util.majority(MASTER_COUNT)}",
        "--registry_fetch_timeout=120secs",
        "--registry_store_timeout=5secs",
        f"--work_dir={MASTER_DIR}",
        "--offer_timeout=30secs",
        f"--zk={zk_uri(test)}",
        logfile=f"{MESOS_LOG_DIR}/master.stdout",
        pidfile=MASTER_PIDFILE, chdir=MASTER_DIR)


def start_slave(test, node) -> None:
    """mesosphere.clj:93-115."""
    sess = control.session(node, test).su()
    cu.start_daemon(
        sess, "/usr/sbin/mesos-slave",
        f"--hostname={node}", f"--log_dir={MESOS_LOG_DIR}",
        f"--master={zk_uri(test)}",
        f"--work_dir={SLAVE_DIR}",
        logfile=f"{MESOS_LOG_DIR}/slave.stdout",
        pidfile=SLAVE_PIDFILE, chdir=SLAVE_DIR)


def stop_mesos(test, node) -> None:
    sess = control.session(node, test).su()
    cu.grepkill(sess, "mesos-master")
    cu.grepkill(sess, "mesos-slave")
    for pf in (MASTER_PIDFILE, SLAVE_PIDFILE):
        sess.exec("rm", "-f", pf)


class MesosphereDB(db_mod.DB, db_mod.LogFiles):
    """zookeeper + mesos masters/slaves (mesosphere.clj:117-159)."""

    def __init__(self, version: str = "0.23.0-1.0.debian81"):
        self.version = version
        self.zk = zk_suite.db()

    def setup(self, test, node):
        self.zk.setup(test, node)
        sess = control.session(node, test)
        install_mesos(sess, self.version)
        configure_mesos(sess, test)
        start_master(test, node)
        start_slave(test, node)

    def teardown(self, test, node):
        stop_mesos(test, node)
        sess = control.session(node, test).su()
        sess.exec("rm", "-rf", control.lit(f"{MASTER_DIR}/*"),
                  control.lit(f"{SLAVE_DIR}/*"))
        self.zk.teardown(test, node)

    def log_files(self, test, node):
        return [f"{MESOS_LOG_DIR}/master.stdout",
                f"{MESOS_LOG_DIR}/slave.stdout"] + \
            list(self.zk.log_files(test, node))


# ---------------------------------------------------------------------------
# chronos automation (chronos.clj:40-86)
# ---------------------------------------------------------------------------


def start_chronos(test, node) -> None:
    """Start chronos unless already running (chronos.clj:47-54)."""
    sess = control.session(node, test).su()
    try:
        sess.exec("service", "chronos", "status")
    except control.RemoteError:
        log.info("%s starting chronos", node)
        sess.exec("service", "chronos", "start")


class ChronosDB(db_mod.DB, db_mod.LogFiles):
    """chronos.clj:56-86."""

    def __init__(self, mesos_version: str = "0.23.0-1.0.debian81",
                 chronos_version: str = "2.4.0-0.1.20150828104228.debian81"):
        self.mesosphere = MesosphereDB(mesos_version)
        self.chronos_version = chronos_version

    def setup(self, test, node):
        self.mesosphere.setup(test, node)
        sess = control.session(node, test)
        debian.install(sess.su(), {"chronos": self.chronos_version})
        # lower the scheduler horizon or chronos forgets frequent tasks
        sess.su().exec("echo", "1", control.lit(">"),
                       "/etc/chronos/conf/schedule_horizon")
        sess.su().exec("mkdir", "-p", JOB_DIR)
        start_chronos(test, node)

    def teardown(self, test, node):
        sess = control.session(node, test).su()
        try:
            sess.exec("service", "chronos", "stop")
        except control.RemoteError:
            pass
        cu.grepkill(sess, "chronos")
        self.mesosphere.teardown(test, node)
        sess.exec("rm", "-rf", JOB_DIR)

    def log_files(self, test, node):
        return self.mesosphere.log_files(test, node)


def db(mesos_version: str = "0.23.0-1.0.debian81",
       chronos_version: str = "2.4.0-0.1.20150828104228.debian81"
       ) -> ChronosDB:
    return ChronosDB(mesos_version, chronos_version)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


def interval_str(job: dict) -> str:
    """R<count>/<ISO start>/PT<interval>S (chronos.clj:103-108)."""
    start = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                          time.gmtime(job["start"]))
    return f"R{job['count']}/{start}/PT{job['interval']}S"


def job_command(job: dict) -> str:
    """Log (name, start, sleep duration, end) to a tempfile
    (chronos.clj:110-117)."""
    return (f"MEW=$(mktemp -p {JOB_DIR}); "
            f"echo \"{job['name']}\" >> $MEW; "
            "date -u -Ins >> $MEW; "
            f"sleep {job['duration']}; "
            "date -u -Ins >> $MEW;")


def job_json(job: dict) -> dict:
    """chronos.clj:119-132."""
    return {"name": str(job["name"]),
            "command": job_command(job),
            "schedule": interval_str(job),
            "scheduleTimeZone": "UTC",
            "owner": "jepsen@jepsen.io",
            "epsilon": f"PT{job['epsilon']}S",
            "mem": 1, "disk": 1, "cpus": 0.001,
            "async": False}


def parse_file_time(s: str | None) -> float | None:
    """ISO8601 with comma or dot fractional seconds → epoch seconds
    (chronos.clj:144-150)."""
    if not s:
        return None
    from datetime import datetime

    s = s.strip().replace(",", ".")
    try:
        return datetime.fromisoformat(s).timestamp()
    except ValueError:
        return None


def parse_run_file(node, text: str) -> dict:
    """(name, start, end?) tempfile → run map (chronos.clj:152-161)."""
    lines = text.split("\n")
    name = lines[0].strip() if lines else ""
    return {"node": str(node), "name": name,
            "start": parse_file_time(lines[1] if len(lines) > 1 else None),
            "end": parse_file_time(lines[2] if len(lines) > 2 else None)}


def read_runs(test) -> list:
    """cat every run file on every node (chronos.clj:163-173)."""
    out = []

    def per_node(t, n):
        sess = control.session(n, t)
        runs = []
        for f in cu.ls_full(sess, JOB_DIR):
            runs.append(parse_run_file(n, sess.exec("cat", f)))
        return runs

    for _n, runs in control.on_nodes(test, per_node).items():
        out.extend(runs)
    return [r for r in out if r["start"] is not None]


class ChronosClient(client_mod.Client):
    """add-job → POST /scheduler/iso8601; read → cat run files
    (chronos.clj:175-198)."""

    def __init__(self, node=None, timeout: float = 20.0):
        self.node = node
        self.timeout = timeout

    def open(self, test, node):
        return type(self)(node, self.timeout)

    def invoke(self, test, op):
        try:
            if op.f == "add-job":
                body = json.dumps(job_json(op.value)).encode()
                req = urllib.request.Request(
                    f"http://{self.node}:{PORT}/scheduler/iso8601",
                    data=body, method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout):
                    pass
                return replace(op, type="ok")
            if op.f == "read":
                return replace(op, type="ok", value=read_runs(test))
            raise ValueError(f"unknown f {op.f!r}")
        except Exception as e:
            # a crashed add-job is INDETERMINATE: the POST may have been
            # applied before the ack was lost, and a silently-scheduled
            # job whose submission reported :fail would run without the
            # checker expecting it.  :info keeps it out of the required
            # job set (ScheduleChecker counts ok add-jobs only) without
            # asserting it didn't happen.  Reads just cat run files —
            # effect-free, so a crashed read definitely didn't happen.
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))

    def close(self, test):
        pass


class AddJobGen(gen.Generator):
    """Non-overlapping repeating jobs a few seconds out
    (chronos.clj:200-224)."""

    def __init__(self):
        import itertools
        import threading

        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            name = next(self._ids)
        duration = random.randrange(10)
        epsilon = 10 + random.randrange(20)
        interval = (1 + duration + epsilon +
                    schedule.EPSILON_FORGIVENESS + random.randrange(30))
        return {"type": "invoke", "f": "add-job",
                "value": {"name": str(name),
                          "start": time.time() + 10,
                          "count": 1 + random.randrange(99),
                          "duration": duration,
                          "epsilon": epsilon,
                          "interval": interval}}


class ResurrectionHub(nemesis_mod.Nemesis):
    """Mesos/chronos crash constantly; :resurrect restarts everything
    on every node (chronos.clj:226-246)."""

    def __init__(self, inner: nemesis_mod.Nemesis):
        self.inner = inner

    def setup(self, test):
        self.inner.setup(test)
        return self

    def invoke(self, test, op):
        if op.f != "resurrect":
            return self.inner.invoke(test, op)

        def revive(t, n):
            start_master(t, n)
            start_slave(t, n)
            start_chronos(t, n)
            return "revived"

        control.on_nodes(test, revive)
        return replace(op, type="info", value="resurrection-complete")

    def teardown(self, test):
        self.inner.teardown(test)


def chronos_test(opts: dict) -> dict:
    """simple-test (chronos.clj:240-266): submit jobs under partitions
    with periodic resurrection; final resurrect + read."""
    import itertools

    return fixtures.noop_test() | {
        "name": "chronos",
        "os": debian.os,
        "db": db(opts.get("mesos_version", "0.23.0-1.0.debian81"),
                 opts.get("chronos_version",
                          "2.4.0-0.1.20150828104228.debian81")),
        "client": ChronosClient(),
        "nemesis": ResurrectionHub(
            nemesis_mod.partition_random_halves()),
        "checker": checker_mod.compose({
            "schedule": schedule.schedule_checker(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(
                opts.get("time_limit", 450),
                gen.nemesis(
                    gen.seq(itertools.cycle(
                        [gen.sleep(200), {"type": "info", "f": "start"},
                         gen.sleep(200), {"type": "info", "f": "stop"},
                         {"type": "info", "f": "resurrect"}])),
                    gen.stagger(30, gen.delay(30, AddJobGen())))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.nemesis(gen.once({"type": "info", "f": "resurrect"})),
            gen.log("Waiting for quiescence"),
            gen.sleep(opts.get("quiesce", 60)),
            gen.clients(gen.once({"type": "invoke", "f": "read",
                                  "value": None}))),
    } | dict(opts)


def add_opts(p):
    p.add_argument("--mesos-version", dest="mesos_version",
                   default="0.23.0-1.0.debian81")
    p.add_argument("--chronos-version", dest="chronos_version",
                   default="2.4.0-0.1.20150828104228.debian81")


def main(argv=None):
    cli.main(cli.single_test_cmd(chronos_test, add_opts=add_opts), argv)


if __name__ == "__main__":
    main()
