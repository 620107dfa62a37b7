"""Remote scripting toolkit — install/daemon utilities.

Reference: jepsen/src/jepsen/control/util.clj: exists? (18), ls (25),
tmp-dir! (43), cached-wget! (79: cache filenames are base64 URLs so
same-name different-version downloads can't alias), install-archive!
(106), ensure-user! (182), grepkill! (191), start-daemon!
(208, start-stop-daemon), stop-daemon! (238).

All functions take a :class:`control.Session` first — the reference used
ambient dynamic session state; explicit sessions compose better with the
thread-pooled runner.
"""

from __future__ import annotations

import base64
import logging
import random
from typing import Optional

from .control import Lit, RemoteError, Session, lit

log = logging.getLogger("jepsen")

TMP_DIR_BASE = "/tmp/jepsen"
WGET_CACHE_DIR = f"{TMP_DIR_BASE}/wget-cache"

STD_WGET_OPTS = ["--tries", "20", "--waitretry", "60",
                 "--retry-connrefused", "--dns-timeout", "60",
                 "--connect-timeout", "60", "--read-timeout", "60"]


def poll_until(probe, *, timeout_s: float, desc: str,
               interval: float = 0.1):
    """Readiness wait: call ``probe()`` until it returns truthy without
    raising; past the deadline raise RuntimeError(desc).  Exceptions
    from the probe are treated as not-ready-yet (it is a *readiness*
    probe: transient refusals are the expected state).  Generous
    timeouts are deliberate — a loaded single-core host can take many
    seconds to fork+exec a daemon."""
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while True:
        try:
            v = probe()
            if v:
                return v
        except Exception:  # noqa: BLE001 — not-ready signals vary by probe
            pass
        if _time.monotonic() > deadline:
            raise RuntimeError(desc)
        _time.sleep(interval)


def exists(sess: Session, filename: str) -> bool:
    """Is a path present? (control/util.clj:18-23)"""
    try:
        sess.exec("stat", filename)
        return True
    except RemoteError:
        return False


def ls(sess: Session, d: str = ".") -> list[str]:
    out = sess.exec("ls", "-A", d)
    return [x for x in out.split("\n") if x.strip()]


def ls_full(sess: Session, d: str) -> list[str]:
    d = d if d.endswith("/") else d + "/"
    return [d + e for e in ls(sess, d)]


def tmp_dir(sess: Session) -> str:
    """A fresh directory under /tmp/jepsen (control/util.clj:43-51)."""
    while True:
        d = f"{TMP_DIR_BASE}/{random.randrange(2**31)}"
        if not exists(sess, d):
            sess.exec("mkdir", "-p", d)
            return d


def wget(sess: Session, url: str, force: bool = False) -> str:
    """Download into the cwd; skip if present (control/util.clj:62-72)."""
    filename = url.rstrip("/").rsplit("/", 1)[-1]
    if force:
        sess.exec("rm", "-f", filename)
    if not exists(sess, filename):
        sess.exec("wget", *STD_WGET_OPTS, url)
    return filename


def cached_wget(sess: Session, url: str, force: bool = False) -> str:
    """Download to the cache dir keyed by base64(url)
    (control/util.clj:79-104)."""
    encoded = base64.b64encode(url.encode()).decode()
    dest = f"{WGET_CACHE_DIR}/{encoded}"
    if force:
        log.info("Clearing cached copy of %s", url)
        sess.exec("rm", "-rf", dest)
    if not exists(sess, dest):
        log.info("Downloading %s", url)
        sess.exec("mkdir", "-p", WGET_CACHE_DIR)
        sess.cd(WGET_CACHE_DIR).exec("wget", *STD_WGET_OPTS, "-O", dest, url)
    return dest


def expand_path(sess: Session, path: str) -> str:
    if path.startswith("~"):
        return sess.exec("readlink", "-f", path)
    return path


def install_archive(sess: Session, url: str, dest: str,
                    force: bool = False) -> str:
    """Fetch a tarball/zip (cached), extract its sole top-level directory
    (or all files) to dest (control/util.clj:106-173)."""
    local = url[len("file://"):] if url.startswith("file://") else None
    f = local or cached_wget(sess, url, force)
    tmpdir = tmp_dir(sess)
    dest = expand_path(sess, dest)
    sess.exec("rm", "-rf", dest)
    parent = sess.exec("dirname", dest)
    sess.exec("mkdir", "-p", parent)
    try:
        at = sess.cd(tmpdir)
        if url.endswith(".zip"):
            at.exec("unzip", f)
        else:
            at.exec("tar", "--no-same-owner", "--no-same-permissions",
                    "--extract", "--file", f)
        if sess.sudo_user == "root":
            at.exec("chown", "-R", "root:root", ".")
        roots = ls(sess, tmpdir)
        assert roots, "Archive contained no files"
        if len(roots) == 1:
            at.exec("mv", roots[0], dest)
        else:
            sess.exec("mv", tmpdir, dest)
    except RemoteError as e:
        if "Unexpected EOF" in str(e):
            if local:
                raise RemoteError(
                    f"local archive {local} is corrupt: unexpected EOF",
                    1, "", "") from e
            log.info("Retrying corrupt archive download")
            sess.exec("rm", "-rf", f)
            return install_archive(sess, url, dest, force)
        raise
    finally:
        sess.exec("rm", "-rf", tmpdir)
    return dest


def ensure_user(sess: Session, username: str) -> str:
    """Make sure a user exists (control/util.clj:182-189)."""
    try:
        sess.su().exec("adduser", "--disabled-password", "--gecos",
                       lit("''"), username)
    except RemoteError as e:
        if "already exists" not in str(e):
            raise
    return username


def grepkill(sess: Session, pattern: str, signal: int = 9) -> None:
    """Kill processes matching a pattern (control/util.clj:191-206)."""
    try:
        sess.exec("ps", "aux", lit("|"), "grep", pattern, lit("|"),
                  "grep", "-v", "grep", lit("|"), "awk", "{print $2}",
                  lit("|"), "xargs", "kill", f"-{signal}")
    except RemoteError as e:
        if str(e.err or "").strip() or str(e.out or "").strip():
            raise


def start_daemon(sess: Session, bin_path: str, *args,
                 logfile: str, pidfile: str, chdir: str = "/",
                 background: bool = True, make_pidfile: bool = True,
                 match_executable: bool = True,
                 match_process_name: bool = False,
                 process_name: Optional[str] = None) -> None:
    """Start a daemon via start-stop-daemon, logging to logfile
    (control/util.clj:208-236)."""
    log.info("starting %s", bin_path.rsplit("/", 1)[-1])
    # stale-pidfile damage control: on hosts with no reaping init (this
    # image's containers), a kill -9'd daemon stays a ZOMBIE forever —
    # kill -0 succeeds on it and start-stop-daemon then refuses to
    # start ("process already running"), so every nemesis restart
    # silently failed.  Clear the pidfile when its process is a zombie
    # or gone; a genuinely running daemon (state R/S/D) still blocks.
    # the state field sits after the comm field, and comm may contain
    # spaces ("tmux: server") — naive $3 then reads a comm fragment,
    # mis-detects a RUNNING daemon as not-Z/not-empty... or worse, a
    # zombie as alive.  /proc(5): parse after the LAST ')' instead.
    sess.exec_raw(
        f"pid=$(cat {pidfile} 2>/dev/null); "
        f"st=$(sed -e 's/^.*) //' /proc/$pid/stat 2>/dev/null "
        f"| cut -d' ' -f1); "
        f"if [ \"$st\" = Z ] || [ -z \"$st\" ]; then rm -f {pidfile}; fi")
    sess.exec("echo", lit("`date +'%Y-%m-%d %H:%M:%S'`"),
              "Jepsen starting", bin_path, " ".join(map(str, args)),
              lit(">>"), logfile)
    argv: list = ["start-stop-daemon", "--start"]
    if background:
        argv += ["--background", "--no-close"]
    if make_pidfile:
        argv += ["--make-pidfile"]
    if match_executable:
        argv += ["--exec", bin_path]
    if match_process_name:
        argv += ["--name", process_name or bin_path.rsplit("/", 1)[-1]]
    argv += ["--pidfile", pidfile, "--chdir", chdir, "--oknodo",
             "--startas", bin_path, "--", *map(str, args),
             lit(">>"), logfile, lit("2>&1")]
    sess.exec(*argv)


def stop_daemon(sess: Session, pidfile: str, cmd: str | None = None) -> None:
    """Kill by pidfile, or by command name (control/util.clj:238-251)."""
    if cmd is not None:
        log.info("Stopping %s", cmd)
        for c in (("killall", "-9", "-w", cmd), ("rm", "-rf", pidfile)):
            try:
                sess.exec(*c)
            except RemoteError:
                pass
        return
    if exists(sess, pidfile):
        log.info("Stopping %s", pidfile)
        pid = sess.exec("cat", pidfile).strip()
        for c in (("kill", "-9", pid), ("rm", "-rf", pidfile)):
            try:
                sess.exec(*c)
            except RemoteError:
                pass


def daemon_running(sess: Session, pidfile: str) -> bool:
    """Is the pidfile's process alive?"""
    try:
        pid = sess.exec("cat", pidfile).strip()
        sess.exec("kill", "-0", pid)
        return True
    except RemoteError:
        return False


# ---------------------------------------------------------------------------
# packet capture (cockroachdb/src/jepsen/cockroach/auto.clj:67-76)
# ---------------------------------------------------------------------------

TCPDUMP_PID = "/var/run/jepsen-tcpdump.pid"


def start_tcpdump(sess: Session, pcap_file: str, *,
                  port: int | None = None,
                  filter_expr: str | None = None,
                  iface: str = "any") -> None:
    """Capture packets to pcap_file in the background — the wire-level
    debugging companion to command tracing (auto.clj:67-76 captures the
    cockroach client port during every run)."""
    expr = filter_expr if filter_expr is not None else \
        (f"port {port}" if port is not None else "")
    argv = ["start-stop-daemon", "--start", "--background",
            "--make-pidfile", "--pidfile", TCPDUMP_PID,
            "--exec", "/usr/sbin/tcpdump", "--",
            "-w", pcap_file, "-i", iface]
    if expr:
        argv += expr.split()
    sess.su().exec(*argv)


def stop_tcpdump(sess: Session) -> None:
    """auto.clj's teardown kill of the capture daemon."""
    su = sess.su()
    try:
        grepkill(su, "tcpdump")
    except RemoteError:
        pass
    try:
        su.exec("rm", "-rf", TCPDUMP_PID)
    except RemoteError:
        pass
