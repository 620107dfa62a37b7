"""SmartOS automation — pkgin.

Reference: jepsen/src/jepsen/os/smartos.clj: install (87-107), the OS
reify (109-132) which also enables ipfilter for the ipf net backend.
"""

from __future__ import annotations

import logging
import re

from .. import control, os as os_mod
from ..control import RemoteError

log = logging.getLogger("jepsen")


def installed(sess: control.Session, pkgs) -> set:
    out = sess.exec("pkgin", "list")
    have = set()
    for line in out.splitlines():
        m = re.match(r"(\S+)-[^-\s]+\s", line)
        if m:
            have.add(m.group(1))
    return set(map(str, pkgs)) & have


def install(sess: control.Session, pkgs) -> None:
    """smartos.clj:87-107."""
    su = sess.su()
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            su.exec("pkgin", "-y", "install", f"{pkg}-{version}")
        return
    pkgs = set(map(str, pkgs))
    try:
        missing = pkgs - installed(sess, pkgs)
    except RemoteError:
        missing = pkgs
    if missing:
        log.info("Installing %s", sorted(missing))
        su.exec("pkgin", "-y", "install", *sorted(missing))


BASE_PACKAGES = ["wget", "curl", "vim", "unzip", "rsyslog", "logrotate"]


class SmartOS(os_mod.OS):
    """smartos.clj:109-132."""

    def setup(self, test, node):
        log.info("%s setting up smartos", node)
        sess = control.session(node, test)
        install(sess, BASE_PACKAGES)
        sess.su().exec("svcadm", "enable", "-r", "ipfilter")
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception as e:
            log.info("net heal failed (ignored): %s", e)

    def teardown(self, test, node):
        pass


os = SmartOS()
