"""Clock-fault tooling — upload, compile, and drive the clock binaries.

Reference: jepsen/src/jepsen/nemesis/time.clj — uploads C sources,
compiles them with gcc *on each db node* (compile! 12-43, install! 36-49),
then bumps (51), strobes (56), or NTP-resets (45) clocks; clock-nemesis
(62-93) consumes {:f reset|bump|strobe} ops and generators emit random
clock-fault schedules (95-128).

The shipped sources are this repo's own C++ implementations
(native/bump_time.cc, native/strobe_time.cc,
native/strobe_time_experiment.cc — the offset-pinning strobe variant of
the reference's resources/strobe-time-experiment.c, used via
{:f strobe-pin} when drift under strobing must not accumulate).
"""

from __future__ import annotations

import logging
import math
import os
import random
from dataclasses import replace

from . import control
from .nemesis import Nemesis
from .util import random_nonempty_subset

log = logging.getLogger("jepsen")

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
OPT_DIR = "/opt/jepsen"


def compile_source(sess: control.Session, local_src: str, bin_name: str
                   ) -> str:
    """Upload a C++ source and build it on the node (time.clj:12-34)."""
    su = sess.su()
    su.exec("mkdir", "-p", OPT_DIR)
    su.exec("chmod", "a+rwx", OPT_DIR)
    sess.upload(local_src, f"{OPT_DIR}/{bin_name}.cc")
    at = su.cd(OPT_DIR)
    at.exec("g++", "-O2", "-o", bin_name, f"{bin_name}.cc")
    return bin_name


def install(sess: control.Session) -> None:
    """Build toolchain + clock binaries on a node (time.clj:36-49)."""
    from .os import debian

    debian.install(sess, ["build-essential"])
    compile_source(sess, os.path.join(NATIVE_DIR, "strobe_time.cc"),
                   "strobe-time")
    compile_source(sess,
                   os.path.join(NATIVE_DIR, "strobe_time_experiment.cc"),
                   "strobe-time-experiment")
    compile_source(sess, os.path.join(NATIVE_DIR, "bump_time.cc"),
                   "bump-time")


def reset_time(sess: control.Session) -> None:
    """NTP reset (time.clj:45-49)."""
    sess.su().exec("ntpdate", "-b", "pool.ntp.org")


def bump_time(sess: control.Session, delta_ms: int) -> None:
    """time.clj:51-54."""
    sess.su().exec(f"{OPT_DIR}/bump-time", str(delta_ms))


def strobe_time(sess: control.Session, delta_ms: int, period_ms: int,
                duration_s: float) -> None:
    """time.clj:56-60."""
    sess.su().exec(f"{OPT_DIR}/strobe-time", str(delta_ms), str(period_ms),
                   str(duration_s))


def strobe_time_pinned(sess: control.Session, delta_ms: int,
                       period_ms: int, duration_s: float) -> int:
    """Offset-pinning strobe (resources/strobe-time-experiment.c analog):
    overwrites accumulated drift each tick and restores the original
    wall-monotonic offset on exit.  Returns the adjustment count the
    binary reports."""
    out = sess.su().exec(f"{OPT_DIR}/strobe-time-experiment",
                         str(delta_ms), str(period_ms),
                         str(max(1, round(duration_s))))
    try:
        return int(str(out).strip().splitlines()[-1])
    except (ValueError, IndexError):
        return -1


class ClockNemesis(Nemesis):
    """{:f reset|bump|strobe|strobe-pin} clock manipulation
    (time.clj:62-93; strobe-pin drives the offset-pinning variant)."""

    def setup(self, test):
        control.on_nodes(test,
                         lambda t, n: install(control.session(n, t)))
        control.on_nodes(test,
                         lambda t, n: reset_time(control.session(n, t)))
        return self

    def invoke(self, test, op):
        v = op.value
        if op.f == "reset":
            control.on_nodes(
                test, lambda t, n: reset_time(control.session(n, t)), v)
        elif op.f == "bump":
            control.on_nodes(
                test,
                lambda t, n: bump_time(control.session(n, t), v[n]),
                list(v.keys()))
        elif op.f == "strobe":
            def f(t, n):
                s = v[n]
                strobe_time(control.session(n, t), s["delta"], s["period"],
                            s["duration"])
            control.on_nodes(test, f, list(v.keys()))
        elif op.f == "strobe-pin":
            counts = {}

            def f(t, n):
                s = v[n]
                counts[n] = strobe_time_pinned(
                    control.session(n, t), s["delta"], s["period"],
                    s["duration"])
            control.on_nodes(test, f, list(v.keys()))
            # the adjustment count is the experiment's observable: a 0
            # or -1 here means the strobe did NOT run as asked
            return replace(op, type="info",
                           value={n: {**v[n], "adjustments": counts[n]}
                                  for n in v})
        else:
            raise ValueError(f"clock nemesis: unknown f {op.f!r}")
        return replace(op, type="info")

    def teardown(self, test):
        control.on_nodes(test,
                         lambda t, n: reset_time(control.session(n, t)))


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


# --- random clock-fault schedules (time.clj:95-128) ------------------------


def reset_gen(test, process):
    return {"type": "info", "f": "reset",
            "value": random_nonempty_subset(test["nodes"])}


def bump_gen(test, process):
    """±4ms..±262s bumps, exponentially distributed (time.clj:101-110)."""
    nodes = random_nonempty_subset(test["nodes"])
    return {"type": "info", "f": "bump",
            "value": {n: int(random.choice([-1, 1]) *
                             math.pow(2, 2 + random.random() * 16))
                      for n in nodes}}


def strobe_gen(test, process):
    """4ms..262s strobes, 1ms..1s period, 0-32s duration
    (time.clj:112-123)."""
    nodes = random_nonempty_subset(test["nodes"])
    return {"type": "info", "f": "strobe",
            "value": {n: {"delta": int(math.pow(2,
                                                2 + random.random() * 16)),
                          "period": int(math.pow(2, random.random() * 10)),
                          "duration": random.random() * 32}
                      for n in nodes}}


def clock_gen():
    """A random mix of clock faults (time.clj:125-128)."""
    from . import generator as gen

    return gen.mix([reset_gen, bump_gen, strobe_gen])
