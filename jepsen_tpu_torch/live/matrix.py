"""The nemesis matrix — named fault injectors crossed with backends.

Each :class:`MatrixNemesis` bundles a fault family the way the
cockroach runner's registry does (suites/registry.py NamedNemesis): a
constructor bound to a live backend, the op cadence to run *during* the
workload, the healing op to run after, and an **availability probe**
that returns a skip *reason* on hosts missing the capability (no
faketime binary, no iptables/NET_ADMIN, no FUSE).  The campaign runner
turns an unavailable cell into ``skipped`` + reason — never a crash:
the matrix degrades to whatever the host can actually inject.
"""

from __future__ import annotations

import itertools
import os
import shutil
from dataclasses import dataclass, field
from typing import Callable, Optional

from .. import generator as gen
from . import links as links_mod
from .backend import (ClockSkewNemesis, KillRestartNemesis, LiveBackend,
                      PauseNemesis, PortPartitionNemesis, ProcessDB)


def _cadence(f1: str, f2: str, t1: float, t2: float):
    """sleep t1 -> f1 -> sleep t2 -> f2, forever."""
    return gen.seq(itertools.cycle(
        [gen.sleep(t1), {"type": "info", "f": f1},
         gen.sleep(t2), {"type": "info", "f": f2}]))


@dataclass
class MatrixNemesis:
    """One row of the matrix: name + builder + schedule + probe."""

    name: str
    #: backend -> Nemesis
    make: Callable[[LiveBackend, ProcessDB], object]
    #: (opts) -> the during-workload op generator
    during: Callable[[dict], object]
    #: the healing op run after the time limit (None = nothing)
    final: Optional[dict] = None
    #: () -> skip reason | None (host capability)
    probe: Callable[[], Optional[str]] = field(default=lambda: None)
    #: (backend) -> skip reason | None (family applicability — e.g.
    #: per-peer-link grudges need a family whose nodes talk to each
    #: other at all)
    applies: Callable[[LiveBackend], Optional[str]] = field(
        default=lambda backend: None)

    def available(self, backend: LiveBackend | None = None
                  ) -> Optional[str]:
        reason = self.probe()
        if reason is None and backend is not None:
            reason = self.applies(backend)
        return reason


# ---------------------------------------------------------------------------
# availability probes — cheap, no side effects
# ---------------------------------------------------------------------------


def probe_faketime() -> Optional[str]:
    if shutil.which("faketime") is None:
        return "no `faketime` binary on PATH"
    return None


def probe_iptables() -> Optional[str]:
    return links_mod.IptablesEngine.probe()


def _no_peer_links(backend: LiveBackend) -> Optional[str]:
    """Per-peer-link grudges only apply to families whose nodes talk
    to each other; everything else has no links to cut."""
    if getattr(backend, "peer_linked", False):
        return None
    return (f"family `{backend.name}` has no inter-node links "
            f"(not a consensus family)")


def probe_faultfs() -> Optional[str]:
    if not os.path.exists("/dev/fuse"):
        return "no /dev/fuse: FUSE unavailable in this container"
    for tool in ("cmake", "g++"):
        if shutil.which(tool) is None:
            return f"no `{tool}`: can't build the faultfs frontend"
    if hasattr(os, "geteuid") and os.geteuid() != 0:
        return "not root: mounting FUSE needs privileges"
    return None


# ---------------------------------------------------------------------------
# the matrix rows
# ---------------------------------------------------------------------------


def _faultfs_make(backend: LiveBackend, db: ProcessDB):
    from .. import faultfs

    return faultfs.FaultFSNemesis()


def standard_matrix() -> dict[str, MatrixNemesis]:
    """The stock nemesis menu the campaign crosses with every family."""
    return {
        "kill-restart": MatrixNemesis(
            "kill-restart",
            make=lambda b, db: KillRestartNemesis(db),
            during=lambda o: _cadence("kill", "restart",
                                      o.get("kill_every", 2.0), 0.7),
            final={"type": "info", "f": "restart"}),
        "pause": MatrixNemesis(
            "pause",
            make=lambda b, db: PauseNemesis(db),
            during=lambda o: _cadence("pause", "resume",
                                      o.get("pause_every", 2.0), 0.5),
            final={"type": "info", "f": "resume"}),
        "clock-skew": MatrixNemesis(
            "clock-skew",
            make=lambda b, db: ClockSkewNemesis(db),
            during=lambda o: _cadence("skew", "unskew",
                                      o.get("skew_every", 2.0), 1.5),
            final={"type": "info", "f": "unskew"},
            probe=probe_faketime),
        "partition": MatrixNemesis(
            "partition",
            make=lambda b, db: PortPartitionNemesis(b),
            during=lambda o: _cadence("start", "stop",
                                      o.get("part_every", 2.0), 1.0),
            final={"type": "info", "f": "stop"},
            probe=probe_iptables),
        "disk-faults": MatrixNemesis(
            "disk-faults",
            make=_faultfs_make,
            during=lambda o: _cadence("break-one-percent", "clear",
                                      o.get("disk_every", 2.0), 1.0),
            final={"type": "info", "f": "clear"},
            probe=probe_faultfs),
        # per-peer-link grudges (live/links.py): one matrix row per
        # fault geometry, so each grudge gets its own /campaigns
        # column and its own verdict per family.  The engine probe
        # prefers iptables (true DROP) and falls back to a tc htb
        # choke; degradation needs tc specifically.
        **{
            f"link-{gname}": MatrixNemesis(
                f"link-{gname}",
                make=lambda b, db, g=g: links_mod.LinkPartitionNemesis(
                    b, g),
                during=lambda o: _cadence("start", "stop",
                                          o.get("part_every", 2.0),
                                          1.0),
                final={"type": "info", "f": "stop"},
                probe=links_mod.probe_degrade
                if g.mode == "degrade" else links_mod.probe_links,
                applies=_no_peer_links)
            for gname, g in links_mod.GRUDGES.items()
        },
    }


def assemble(backend: LiveBackend, entry: MatrixNemesis,
             opts: dict) -> dict:
    """One executable cell: the family's test map with the nemesis
    wired in (during-cadence under a time limit, then heal, then the
    workload's final phase — e.g. the queue drain)."""
    test = backend.build_test(opts)
    db = test["db"]
    w = test.pop("__workload__")
    tl = opts.get("time_limit", 8)
    phases = [gen.time_limit(tl, gen.nemesis(entry.during(opts),
                                             w["generator"]))]
    if entry.final is not None:
        phases += [gen.nemesis(gen.once(dict(entry.final))),
                   gen.sleep(opts.get("heal_sleep", 0.5))]
    if w.get("final_generator") is not None:
        phases.append(gen.clients(w["final_generator"]))
    test["nemesis"] = entry.make(backend, db)
    test["generator"] = gen.phases(*phases)
    test["name"] = opts.get(
        "name", f"live-{backend.name} nemesis={entry.name}")
    return test
