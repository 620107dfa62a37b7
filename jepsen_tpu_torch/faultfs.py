"""faultfs driver — disk fault injection via the C++ FUSE filesystem.

Reference: charybdefs/src/jepsen/charybdefs.clj.  The reference clones &
cmake-builds scylladb/charybdefs on the node (after building Thrift 0.10
from source, charybdefs.clj:7-36), mounts a passthrough FUSE fs at
/faulty over /real (38-70), and drives fault recipes: break-all (EIO on
everything), break-one-percent, clear (77-92).

This driver uploads this repo's own C++ sources (native/faultfs/),
builds them on the node with cmake + libfuse3 (no Thrift: the control
plane is a unix socket), mounts, and exposes the same recipe surface,
plus a Nemesis speaking {:f break-all|break-one-percent|clear} ops.
"""

from __future__ import annotations

import logging
import os
from dataclasses import replace

from . import control
from .nemesis import Nemesis

log = logging.getLogger("jepsen")

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "faultfs")

DIR = "/opt/jepsen/faultfs"
BIN = f"{DIR}/build/faultfs"
RAW_BIN = f"{DIR}/build/faultfs_raw"
CTL = f"{DIR}/build/faultfsctl"
REAL = "/real"
FAULTY = "/faulty"
SOCK = f"{REAL}/.faultfs.sock"

SOURCES = ("faultfs.cc", "faultfs_raw.cc", "faultfs_common.h",
           "faultfsctl.cc", "CMakeLists.txt")


def install(sess: control.Session) -> None:
    """Upload, build, and mount (charybdefs.clj:40-70 surface).

    Both frontends are shipped; cmake builds the libfuse3 one only
    where fuse3 exists, and `faultfs_raw` (raw /dev/fuse protocol, no
    libfuse) everywhere — mount() prefers libfuse3, falls back to raw.
    """
    from . import control_util as cu
    from .os import debian

    su = sess.su()
    if not cu.exists(sess, RAW_BIN):
        # fuse3 packages are best-effort: the raw frontend needs none
        debian.install(sess, ["build-essential", "cmake", "pkg-config"])
        try:
            debian.install(sess, ["libfuse3-dev", "fuse3"])
        except Exception as e:
            log.info("faultfs: no fuse3 packages (%s); raw frontend only",
                     e)
        su.exec("mkdir", "-p", DIR)
        su.exec("chmod", "777", DIR)
        for f in SOURCES:
            sess.upload(os.path.join(NATIVE_DIR, f), f"{DIR}/{f}")
        at = sess.cd(DIR)
        at.exec("cmake", "-B", "build", "-DCMAKE_BUILD_TYPE=Release", ".")
        at.exec("cmake", "--build", "build", "--parallel")
    mount(sess)


def mount(sess: control.Session) -> None:
    """Mount /faulty over /real (charybdefs.clj:62-70).

    Blocks until the FUSE mount is visible in /proc/mounts: returning
    before that would let the workload write into the bare mountpoint
    directory and get shadowed when the mount lands.
    """
    from . import control_util as cu
    from .control import lit

    su = sess.su()
    su.exec("modprobe", "fuse")
    su.exec("umount", FAULTY, lit("||"), "/bin/true")
    su.exec("mkdir", "-p", REAL, FAULTY)
    if cu.exists(sess, BIN):
        su.exec(BIN, REAL, FAULTY, "-o", "allow_other")
        hint = "the libfuse3 frontend prints mount errors to stderr"
    else:
        # raw frontend mounts /dev/fuse itself and stays foreground;
        # start-stop-daemon gives us a pidfile + idempotent restart
        cu.start_daemon(su, RAW_BIN, REAL, FAULTY,
                        logfile=f"{DIR}/faultfs_raw.log",
                        pidfile=f"{DIR}/faultfs_raw.pid")
        hint = f"see {DIR}/faultfs_raw.log"
    # first field (fsname) differs between frontends; match
    # "<anything> /faulty fuse..." instead
    cu.poll_until(
        lambda: (su.exec("grep", "-q", f" {FAULTY} fuse", "/proc/mounts")
                 or True),
        timeout_s=15.0,
        desc=f"faultfs never appeared in /proc/mounts on {sess.node}; "
             f"{hint}")
    su.exec("chmod", "777", REAL, FAULTY)


def _ctl(sess: control.Session, *args) -> str:
    return sess.su().exec(CTL, SOCK, *args)


def break_all(sess: control.Session) -> str:
    """All operations fail with EIO (charybdefs.clj:77-80)."""
    return _ctl(sess, "set", "errno=EIO", "p=1.0")


def break_one_percent(sess: control.Session) -> str:
    """1% of disk operations fail (charybdefs.clj:82-85)."""
    return _ctl(sess, "set", "errno=EIO", "p=0.01")


def break_methods(sess: control.Session, methods: list[str],
                  err: str = "EIO", p: float = 1.0) -> str:
    """Targeted faults, e.g. only writes/fsyncs fail."""
    return _ctl(sess, "set", f"errno={err}", f"p={p}",
                f"methods={','.join(methods)}")


def slow(sess: control.Session, delay_us: int, p: float = 1.0) -> str:
    """Latency injection (a capability charybdefs has via its delay
    recipes)."""
    return _ctl(sess, "set", "errno=0", f"p={p}", f"delay_us={delay_us}")


def clear(sess: control.Session) -> str:
    """Stop injecting (charybdefs.clj:87-90)."""
    return _ctl(sess, "clear")


def status(sess: control.Session) -> str:
    return _ctl(sess, "status")


class FaultFSNemesis(Nemesis):
    """Ops: {:f break-all | break-one-percent | clear, :value nodes|None
    (None = all)}."""

    RECIPES = {"break-all": break_all,
               "break-one-percent": break_one_percent,
               "clear": clear}

    def setup(self, test):
        control.on_nodes(test,
                         lambda t, n: install(control.session(n, t)))
        return self

    def invoke(self, test, op):
        recipe = self.RECIPES.get(op.f)
        if recipe is None:
            raise ValueError(f"faultfs nemesis: unknown f {op.f!r}")
        nodes = op.value or test["nodes"]
        out = control.on_nodes(
            test, lambda t, n: recipe(control.session(n, t)), nodes)
        return replace(op, type="info", value=out)

    def teardown(self, test):
        try:
            control.on_nodes(test,
                             lambda t, n: clear(control.session(n, t)))
        except Exception as e:
            log.info("faultfs clear on teardown failed: %s", e)


def nemesis() -> FaultFSNemesis:
    return FaultFSNemesis()
