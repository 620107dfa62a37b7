"""Remote execution substrate (reference L0) — the "comm backend".

Reference: jepsen/src/jepsen/control.clj.  The control node drives every
db node over SSH: scoped sessions (with-ssh/with-session, control.clj:
284-331), shell command construction with sudo/cd wrapping (su/sudo/cd
macros, 226-260), scp upload/download (199-231), parallel node fan-out
(on-nodes, 357-373), retry on flaky transports (141-161), and a *dummy*
stub mode for tests with no cluster (control.clj:16, 288-300).

Design here: a :class:`Remote` interface with three implementations —

  * :class:`SSHRemote`     — drives the system ``ssh``/``scp`` binaries in
                             a subprocess (no paramiko in the image;
                             OpenSSH handles auth/agent/known-hosts better
                             than any reimplementation would)
  * :class:`DummyRemote`   — records commands, returns canned results
                             (the *dummy* analog; Tier-2 tests)
  * :class:`LocalRemote`   — runs commands on the control node itself
                             (docker exec-style single-machine testing)

Session state (current node, sudo user, working dir) is carried in
:class:`Session` objects rather than dynamic vars; `on_nodes` fans out
with one thread per node (util.real_pmap, mirroring control.clj:357).
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Optional

from .util import real_pmap


log = logging.getLogger("jepsen")


class _TraceState(threading.local):
    """Thread-scoped command tracing (the *trace* dynamic var +
    c/trace macro, control.clj:116-120,262-266)."""

    on = False


_TRACE = _TraceState()


class trace:
    """``with control.trace(): ...`` logs every command + reply run by
    the current thread (control.clj:262-266)."""

    def __enter__(self):
        self._prev = _TRACE.on
        _TRACE.on = True
        return self

    def __exit__(self, *exc):
        _TRACE.on = self._prev
        return False


class RemoteError(Exception):
    """Non-zero exit from a remote command (throw on nonzero-exit,
    control.clj:106-114)."""

    def __init__(self, cmd, exit, out, err):
        super().__init__(
            f"command {cmd!r} exited {exit}: {err.strip() or out.strip()}")
        self.cmd = cmd
        self.exit = exit
        self.out = out
        self.err = err


@dataclass
class Result:
    exit: int
    out: str
    err: str


def escape(arg) -> str:
    """Shell-escape one argument (control.clj:54-76; we defer to shlex)."""
    s = str(arg)
    return shlex.quote(s) if s else "''"


@dataclass
class SSHConfig:
    """Connection options (run! docstring, core.clj:504-510)."""

    username: str = "root"
    password: Optional[str] = None
    port: int = 22
    private_key_path: Optional[str] = None
    strict_host_key_checking: bool = False
    connect_timeout: int = 10


class Remote:
    """Transport interface."""

    def execute(self, node, cmd: str, *, timeout: float | None = None
                ) -> Result:
        raise NotImplementedError

    def upload(self, node, local: str, remote: str) -> None:
        raise NotImplementedError

    def download(self, node, remote: str, local: str) -> None:
        raise NotImplementedError

    def disconnect(self, node) -> None:
        pass


class SSHRemote(Remote):
    """OpenSSH subprocess transport with shared ControlMaster sockets so
    repeated execs reuse one TCP/auth handshake per node (the analog of
    the reference's persistent clj-ssh sessions, control.clj:268-300)."""

    def __init__(self, config: SSHConfig | None = None):
        self.config = config or SSHConfig()
        self._dir = None
        self._lock = threading.Lock()

    def _control_path(self):
        import tempfile

        with self._lock:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(prefix="jepsen-ssh-")
        return os.path.join(self._dir, "%h-%p")

    def _base(self, node) -> list[str]:
        c = self.config
        args = ["ssh", "-o", "BatchMode=yes",
                "-o", f"ConnectTimeout={c.connect_timeout}",
                "-o", "ControlMaster=auto",
                "-o", f"ControlPath={self._control_path()}",
                "-o", "ControlPersist=60",
                "-p", str(c.port)]
        if not c.strict_host_key_checking:
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if c.private_key_path:
            args += ["-i", c.private_key_path]
        return args + [f"{c.username}@{node}"]

    def execute(self, node, cmd, *, timeout=None):
        proc = subprocess.run(self._base(node) + [cmd], capture_output=True,
                              text=True, timeout=timeout)
        return Result(proc.returncode, proc.stdout, proc.stderr)

    def _scp_base(self) -> list[str]:
        c = self.config
        args = ["scp", "-P", str(c.port),
                "-o", "BatchMode=yes",
                "-o", "ControlMaster=auto",
                "-o", f"ControlPath={self._control_path()}",
                "-o", "ControlPersist=60"]
        if not c.strict_host_key_checking:
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if c.private_key_path:
            args += ["-i", c.private_key_path]
        return args

    def upload(self, node, local, remote):
        c = self.config
        proc = subprocess.run(
            self._scp_base() + ["-r", local, f"{c.username}@{node}:{remote}"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RemoteError(f"scp {local}", proc.returncode, proc.stdout,
                              proc.stderr)

    def download(self, node, remote, local):
        c = self.config
        proc = subprocess.run(
            self._scp_base() + ["-r", f"{c.username}@{node}:{remote}", local],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RemoteError(f"scp {remote}", proc.returncode, proc.stdout,
                              proc.stderr)


class DummyRemote(Remote):
    """Record commands; return canned results (control.clj *dummy*).

    ``responses`` maps substrings to (exit, out, err) or out-strings; the
    first match wins.  Every call is appended to .log as
    (node, kind, payload)."""

    def __init__(self, responses: dict | None = None):
        self.responses = responses or {}
        self.log: list = []
        self._lock = threading.Lock()

    def execute(self, node, cmd, *, timeout=None):
        with self._lock:
            self.log.append((node, "exec", cmd))
        for k, v in self.responses.items():
            if k in cmd:
                if isinstance(v, tuple):
                    return Result(*v)
                return Result(0, str(v), "")
        return Result(0, "", "")

    def upload(self, node, local, remote):
        with self._lock:
            self.log.append((node, "upload", (local, remote)))

    def download(self, node, remote, local):
        with self._lock:
            self.log.append((node, "download", (remote, local)))


class LocalRemote(Remote):
    """Run everything on this machine (for single-node smoke tests)."""

    def execute(self, node, cmd, *, timeout=None):
        proc = subprocess.run(["sh", "-c", cmd], capture_output=True,
                              text=True, timeout=timeout)
        return Result(proc.returncode, proc.stdout, proc.stderr)

    def upload(self, node, local, remote):
        subprocess.run(["cp", "-r", local, remote], check=True)

    def download(self, node, remote, local):
        subprocess.run(["cp", "-r", remote, local], check=True)


@dataclass
class Session:
    """One node's execution context: remote + sudo/cd state (the dynamic
    vars *sudo* and *dir*, control.clj:16-27)."""

    node: str
    remote: Remote
    sudo_user: Optional[str] = None
    dir: Optional[str] = None
    retries: int = 3

    def _wrap(self, cmd: str) -> str:
        if self.dir:
            cmd = f"cd {escape(self.dir)} && {cmd}"
        if self.sudo_user:
            # sudo wrapping (control.clj:235-247)
            cmd = f"sudo -S -u {escape(self.sudo_user)} sh -c {escape(cmd)}"
        return cmd

    def exec_raw(self, cmd: str, *, timeout=None) -> Result:
        return self.remote.execute(self.node, self._wrap(cmd),
                                   timeout=timeout)

    def exec(self, *args, timeout=None) -> str:
        """Build a command from escaped args, run it, throw on non-zero
        exit, return trimmed stdout (control.clj:176-197)."""
        cmd = " ".join(a.raw if isinstance(a, Lit) else escape(a)
                       for a in args)
        if _TRACE.on:
            log.info("trace %s> %s", self.node, cmd)
        last: Exception | None = None
        for _ in range(max(1, self.retries)):
            try:
                res = self.exec_raw(cmd, timeout=timeout)
                if res.exit != 0:
                    raise RemoteError(cmd, res.exit, res.out, res.err)
                if _TRACE.on:
                    log.info("trace %s< %s", self.node,
                             res.out.strip()[:200])
                return res.out.strip()
            except (subprocess.TimeoutExpired, OSError) as e:
                last = e  # transport flake: retry (control.clj:141-161)
        raise last  # type: ignore[misc]

    def su(self, user: str = "root") -> "Session":
        """Sudo-scoped copy (the su/sudo macros, control.clj:249-260)."""
        return replace(self, sudo_user=user)

    def cd(self, d: str) -> "Session":
        return replace(self, dir=d)

    def upload(self, local: str, remote_path: str) -> None:
        self.remote.upload(self.node, local, remote_path)

    def download(self, remote_path: str, local: str) -> None:
        self.remote.download(self.node, remote_path, local)


class Lit:
    """An unescaped shell literal (control.clj lit)."""

    def __init__(self, raw: str):
        self.raw = raw


lit = Lit


def session(node, test: dict) -> Session:
    """Open (or fetch) the session for a node from the test map."""
    sessions = test.get("sessions") or {}
    s = sessions.get(node)
    if s is not None:
        return s
    remote = test.get("remote") or DummyRemote()
    return Session(node=node, remote=remote)


def setup_sessions(test: dict) -> dict:
    """Open a session per node in parallel (with-resources,
    core.clj:56-77 + control/session 284)."""
    nodes = test.get("nodes") or []
    remote = test.get("remote")
    if remote is None:
        remote = SSHRemote(test.get("ssh") if isinstance(test.get("ssh"),
                                                         SSHConfig)
                           else SSHConfig(**(test.get("ssh") or {}))) \
            if test.get("ssh") is not None else DummyRemote()
        test["remote"] = remote
    test["sessions"] = {n: Session(node=n, remote=remote) for n in nodes}
    return test["sessions"]


def on_nodes(test: dict, f: Callable, nodes: Iterable | None = None) -> dict:
    """Run (f test node) on each node in parallel; map of node -> result
    (control.clj:357-373)."""
    nodes = list(nodes if nodes is not None else test.get("nodes") or [])
    results = real_pmap(lambda n: f(test, n), nodes)
    return dict(zip(nodes, results))


def on_many(test: dict, nodes: Iterable, f: Callable) -> dict:
    """Like on_nodes with an explicit node list (control.clj:345-355)."""
    return on_nodes(test, f, nodes)
