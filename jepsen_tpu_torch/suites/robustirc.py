"""RobustIRC suite — IRC network replicated over Raft.

Reference: robustirc/ (217 LoC, robustirc/src/jepsen/robustirc.clj).  Db
automation installs go, `go get`s robustirc, uploads a TLS cert pair,
boots the primary with -singlenode and joins the rest with -join
(robustirc.clj:24-84).  The workload is a *set* test smuggled through
IRC: each add posts ``TOPIC #jepsen :<n>``; the final read replays the
session's full message stream and extracts every TOPIC value
(robustirc.clj:110-217).  Clients speak the robustirc HTTP session API
(JSON over TLS, certificate checks disabled for the self-signed pair).
"""

from __future__ import annotations

import hashlib
import json
import logging
import random
import ssl
import urllib.error
import urllib.request
from dataclasses import replace

from .. import (checker as checker_mod, cli, client as client_mod, control,
                db as db_mod, fixtures, generator as gen,
                nemesis as nemesis_mod)
from ..checker import basic, perf as perf_mod
from ..os import debian

log = logging.getLogger("jepsen")

PORT = 13001
PASSWORD = "secret"
NETWORK = "jepsen"
CERT = "/tmp/cert.pem"
KEY = "/tmp/key.pem"
BIN = "$HOME/gocode/bin/robustirc"


def daemon_cmd(node, *, join=None, singlenode=False) -> str:
    """The start-stop-daemon line (robustirc.clj:47-75)."""
    args = [f"-listen={node}:{PORT}",
            f"-network_password={PASSWORD}",
            f"-network_name={NETWORK}",
            f"-tls_cert_path={CERT}",
            f"-tls_ca_file={CERT}",
            f"-tls_key_path={KEY}"]
    if singlenode:
        args.append("-singlenode")
    if join:
        args.append(f"-join={join}:{PORT}")
    return ("/sbin/start-stop-daemon --start --background --exec "
            f"{BIN} -- " + " ".join(args))


class RobustIRCDB(db_mod.DB):
    """robustirc.clj:24-84: primary boots -singlenode, others -join."""

    def setup(self, test, node):
        import time

        from .. import core as core_mod

        sess = control.session(node, test)
        su = sess.su()
        try:
            su.exec("killall", "robustirc")
        except control.RemoteError:
            pass
        debian.install(sess, ["golang-go", "mercurial"])
        su.exec("env", control.lit("GOPATH=$HOME/gocode"), "go", "get",
                "-u", "github.com/robustirc/robustirc")
        su.exec("rm", "-rf", "/var/lib/robustirc")
        su.exec("mkdir", "-p", "/var/lib/robustirc")
        core_mod.synchronize(test)
        primary = core_mod.primary(test)
        if node == primary:
            su.exec(control.lit(daemon_cmd(node, singlenode=True)))
            time.sleep(5)
        else:
            time.sleep(1)
        core_mod.synchronize(test)
        if node != primary:
            su.exec(control.lit(daemon_cmd(node, join=primary)))
            time.sleep(5)
        core_mod.synchronize(test)

    def teardown(self, test, node):
        try:
            control.session(node, test).su().exec("killall", "robustirc")
        except control.RemoteError:
            pass


def db() -> RobustIRCDB:
    return RobustIRCDB()


# ---------------------------------------------------------------------------
# session API client (robustirc.clj:102-180)
# ---------------------------------------------------------------------------


def message_id(ircmessage: str) -> int:
    """ClientMessageId derivation (robustirc.clj:111-113): random 31-bit
    int OR'd with md5-tail bits of the message."""
    tail = int(hashlib.md5(ircmessage.encode()).hexdigest()[17:], 16)
    return (random.getrandbits(31) | tail) & (2**63 - 1)


def parse_topic(msg: dict) -> int | None:
    """'... TOPIC #jepsen :<n>' -> n (robustirc.clj:137-148)."""
    data = msg.get("Data", "")
    parts = data.split(" ")
    if len(parts) > 1 and parts[1] == "TOPIC":
        try:
            return int(data.rsplit(":", 1)[-1])
        except ValueError:
            return None
    return None


class IRCSession:
    """POST /robustirc/v1/session + authenticated message post/stream."""

    def __init__(self, node, timeout: float = 10.0):
        self.node = str(node)
        self.timeout = timeout
        self.ctx = ssl.create_default_context()
        self.ctx.check_hostname = False
        self.ctx.verify_mode = ssl.CERT_NONE
        out = self._req("POST", "/robustirc/v1/session")
        self.session_id = out["Sessionid"]
        self.session_auth = out["Sessionauth"]

    def _req(self, method: str, path: str, body: dict | None = None,
             auth: bool = False, stream: bool = False):
        url = f"https://{self.node}:{PORT}{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if auth:
            req.add_header("X-Session-Auth", self.session_auth)
        r = urllib.request.urlopen(req, timeout=self.timeout,
                                   context=self.ctx)
        if stream:
            return r
        with r:
            raw = r.read()
        return json.loads(raw) if raw else {}

    def quit(self, message: str = "jepsen client closing") -> None:
        """DELETE the server-side session — an undeleted session holds
        server state until it times out, and the worker reopens clients
        after every crash (suite lint S004)."""
        self._req("DELETE", f"/robustirc/v1/{self.session_id}",
                  {"Quitmessage": message}, auth=True)

    def post(self, ircmessage: str) -> None:
        """robustirc.clj:110-121."""
        self._req("POST",
                  f"/robustirc/v1/{self.session_id}/message",
                  {"Data": ircmessage,
                   "ClientMessageId": message_id(ircmessage)},
                  auth=True)

    def read_all(self, timeout_s: float = 1.0) -> list[dict]:
        """Replay the message stream from the beginning
        (robustirc.clj:123-135)."""
        import time

        import socket

        out = []
        deadline = time.time() + timeout_s
        r = self._req("GET",
                      f"/robustirc/v1/{self.session_id}/messages"
                      "?lastseen=0.0", auth=True, stream=True)
        try:
            # the stream stays open once history is replayed: bound each
            # read by the remaining deadline and keep what we have on
            # timeout (the reference's jepsen.util/timeout wrapper
            # returns the accumulated atom, robustirc.clj:123-135)
            sock = getattr(r, "fp", None)
            dec = json.JSONDecoder()
            buf = ""
            while time.time() < deadline:
                remaining = deadline - time.time()
                try:
                    if sock is not None and hasattr(r, "fp") and                             r.fp is not None:
                        r.fp.raw._sock.settimeout(max(0.05, remaining))
                except Exception:
                    pass
                try:
                    chunk = r.read(4096)
                except (TimeoutError, socket.timeout, OSError):
                    break
                if not chunk:
                    break
                buf += chunk.decode()
                while buf:
                    buf = buf.lstrip()
                    try:
                        msg, idx = dec.raw_decode(buf)
                    except json.JSONDecodeError:
                        break
                    out.append(msg)
                    buf = buf[idx:]
        finally:
            r.close()
        return out


class SetClient(client_mod.Client):
    """adds → TOPIC posts; read → stream replay (robustirc.clj:149-180)."""

    def __init__(self, node=None):
        self.node = node
        self.session = None

    def open(self, test, node):
        # the session must be (re)established here: the worker reopens
        # crashed clients via open() alone, never setup()
        c = type(self)(node)
        c.session = IRCSession(node)
        c.session.post(f"NICK {node}")
        c.session.post("USER j j j j")
        c.session.post("JOIN #jepsen")
        return c

    def invoke(self, test, op):
        try:
            if op.f == "add":
                self.session.post(f"TOPIC #jepsen :{op.value}")
                return replace(op, type="ok")
            if op.f == "read":
                msgs = self.session.read_all(1.0)
                vals = sorted({v for v in map(parse_topic, msgs)
                               if v is not None})
                return replace(op, type="ok", value=vals)
            raise ValueError(f"unknown f {op.f!r}")
        except (urllib.error.URLError, OSError) as e:
            return replace(op, type="fail" if op.f == "read" else "info",
                           error=str(e))

    def close(self, test):
        # delete the server-side session open() created; the worker
        # reopens crashed clients, so leaked sessions would otherwise
        # accumulate on the server for the whole run
        if self.session is not None:
            try:
                self.session.quit()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            self.session = None


# ---------------------------------------------------------------------------
# test (robustirc.clj:86-100, 184-217)
# ---------------------------------------------------------------------------


def sets_test(opts: dict) -> dict:
    import itertools

    adds = gen.seq({"type": "invoke", "f": "add", "value": x}
                   for x in itertools.count())
    tl = opts.get("time_limit", 30)
    return fixtures.noop_test() | {
        "name": "robustirc set",
        "os": debian.os,
        "db": db(),
        "client": SetClient(),
        "nemesis": nemesis_mod.partition_random_halves(),
        "checker": checker_mod.compose({
            "set": basic.set_checker(),
            "perf": perf_mod.perf(),
        }),
        "generator": gen.phases(
            gen.time_limit(tl, gen.nemesis(
                gen.seq(itertools.cycle(
                    [gen.sleep(0), {"type": "info", "f": "start"},
                     gen.sleep(10), {"type": "info", "f": "stop"}])),
                gen.delay(0.1, adds))),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(5),
            gen.clients(gen.once(
                {"type": "invoke", "f": "read", "value": None}))),
    } | dict(opts)


def main(argv=None):
    cli.main(cli.single_test_cmd(sets_test), argv)


if __name__ == "__main__":
    main()
