"""Debian OS automation — apt, hostfiles, jdk.

Reference: jepsen/src/jepsen/os/debian.clj: setup-hostfile! (24-38),
update!/maybe-update! (40-55), installed/installed-version (57-76),
install (78-98), add-key!/add-repo! (100-119), install-jdk8! (121-135),
the OS reify (137-167).
"""

from __future__ import annotations

import logging
import re

from .. import control, net as net_mod, os as os_mod
from ..control import RemoteError, lit

log = logging.getLogger("jepsen")


def setup_hostfile(sess: control.Session) -> None:
    """Makes the /etc/hosts file resolve the node's hostname to 127.0.0.1
    (debian.clj:24-38)."""
    hostname = sess.exec("hostname")
    hosts = (f"127.0.0.1 localhost\n127.0.1.1 {hostname}\n")
    cur = sess.exec("cat", "/etc/hosts")
    if cur.strip() != hosts.strip():
        sess.su().exec("echo", hosts, lit(">"), "/etc/hosts")


def update(sess: control.Session) -> None:
    sess.su().exec("apt-get", "update")


def maybe_update(sess: control.Session) -> None:
    """Apt update iff the cache is older than a day (debian.clj:46-55)."""
    try:
        age = sess.exec("stat", "-c", "%Y", "/var/cache/apt/pkgcache.bin")
        now = sess.exec("date", "+%s")
        if int(now) - int(age) < 86400:
            return
    except (RemoteError, ValueError):
        pass
    update(sess)


def installed(sess: control.Session, pkgs) -> set:
    """Which of these packages are installed? (debian.clj:57-68)"""
    out = sess.exec("dpkg", "-l", *pkgs)
    have = set()
    for line in out.splitlines():
        m = re.match(r"ii\s+(\S+)", line)
        if m:
            have.add(m.group(1).split(":")[0])
    return have


def installed_version(sess: control.Session, pkg: str):
    out = sess.exec("apt-cache", "policy", pkg)
    m = re.search(r"Installed: (\S+)", out)
    return m.group(1) if m else None


def install(sess: control.Session, pkgs) -> None:
    """Ensure packages (list, or {pkg: version} map) are installed
    (debian.clj:78-98)."""
    su = sess.su()
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(sess, pkg) != version:
                log.info("Installing %s %s", pkg, version)
                su.exec("apt-get", "install", "-y", "--force-yes",
                        f"{pkg}={version}")
        return
    pkgs = set(map(str, pkgs))
    try:
        missing = pkgs - installed(sess, sorted(pkgs))
    except RemoteError:
        missing = pkgs
    if missing:
        log.info("Installing %s", sorted(missing))
        su.exec("apt-get", "install", "-y", "--force-yes", *sorted(missing))


def add_key(sess: control.Session, keyserver: str, key: str) -> None:
    sess.su().exec("apt-key", "adv", "--keyserver", keyserver,
                   "--recv", key)


def add_repo(sess: control.Session, repo_name: str, apt_line: str,
             keyserver: str | None = None, key: str | None = None) -> None:
    """debian.clj:107-119."""
    from .. import control_util as cu

    list_file = f"/etc/apt/sources.list.d/{repo_name}.list"
    if cu.exists(sess, list_file):
        return
    log.info("setting up %s apt repo", repo_name)
    if keyserver or key:
        add_key(sess, keyserver, key)
    sess.su().exec("echo", apt_line, lit(">"), list_file)
    update(sess)


def install_jdk8(sess: control.Session) -> None:
    """debian.clj:121-135 installs Oracle jdk8 via webupd8; modern Debian
    ships openjdk, which is what anything we install actually needs."""
    install(sess, ["openjdk-8-jdk-headless"])


#: base packages every db node gets (debian.clj:146-161)
BASE_PACKAGES = ["wget", "curl", "vim", "man-db", "faketime", "ntpdate",
                 "unzip", "iptables", "psmisc", "tar", "bzip2",
                 "iputils-ping", "iproute2", "rsyslog", "logrotate"]


class Debian(os_mod.OS):
    """debian.clj:137-167."""

    def setup(self, test, node):
        log.info("%s setting up debian", node)
        sess = control.session(node, test)
        setup_hostfile(sess)
        maybe_update(sess)
        install(sess, BASE_PACKAGES)
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception as e:
            log.info("net heal failed (ignored): %s", e)

    def teardown(self, test, node):
        pass


os = Debian()
