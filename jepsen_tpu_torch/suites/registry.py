"""Workload/nemesis registry runner — the cockroachdb-suite pattern.

Reference: cockroachdb/src/jepsen/cockroach/runner.clj (workload registry
at 25-34, option wiring 59-87) and cockroachdb/src/jepsen/cockroach/
nemesis.clj (composable *named* nemeses with :during/:final generators
and compose, nemesis.clj:63-107).  A suite registers named workloads
(client + generator + checker + model) and named nemeses; the CLI picks
one of each.
"""

from __future__ import annotations

import itertools
import logging
from typing import Callable

from .. import checker as checker_mod, cli, fixtures, generator as gen
from .. import nemesis as nemesis_mod

log = logging.getLogger("jepsen")


class NamedNemesis:
    """A nemesis bundle: the fault injector plus its op schedule
    (cockroach nemesis.clj:63-107: {:name, :nemesis, :during, :final})."""

    def __init__(self, name: str, nemesis, during=None, final=None):
        self.name = name
        self.nemesis = nemesis
        self.during = during
        self.final = final


def none() -> NamedNemesis:
    return NamedNemesis("none", nemesis_mod.noop, during=gen.void)


def start_stop_nemesis(name: str, nem, t1: float = 5, t2: float = 5
                       ) -> NamedNemesis:
    """The standard 5s/5s cadence with a final stop."""
    return NamedNemesis(
        name, nem,
        during=gen.seq(itertools.cycle(
            [gen.sleep(t1), {"type": "info", "f": "start"},
             gen.sleep(t2), {"type": "info", "f": "stop"}])),
        final=gen.once({"type": "info", "f": "stop"}))


def standard_nemeses() -> dict:
    """The stock menu (cockroach nemesis.clj:110-151 analog)."""
    return {
        "none": none(),
        "parts": start_stop_nemesis(
            "parts", nemesis_mod.partition_random_halves()),
        "majority-ring": start_stop_nemesis(
            "majority-ring", nemesis_mod.partition_majorities_ring()),
        "split": start_stop_nemesis(
            "split", nemesis_mod.partition_halves()),
        "single-node": start_stop_nemesis(
            "single-node", nemesis_mod.partition_random_node()),
    }


class Registry:
    """Named workloads + nemeses -> a CLI (runner.clj:25-87)."""

    def __init__(self, base_test: Callable[[dict], dict] | None = None):
        self.workloads: dict = {}
        self.nemeses: dict = standard_nemeses()
        self.base_test = base_test or (lambda opts: fixtures.noop_test())

    def workload(self, name: str):
        def register(fn):
            self.workloads[name] = fn
            return fn
        return register

    def nemesis(self, named: NamedNemesis):
        self.nemeses[named.name] = named
        return named

    def build_test(self, opts: dict) -> dict:
        wname = opts.get("workload")
        nname = opts.get("nemesis", "none")
        workload = self.workloads[wname](opts)
        named = self.nemeses[nname]
        phases = [gen.time_limit(
            opts.get("time_limit", 60),
            gen.nemesis(named.during or gen.void,
                        workload["generator"]))]
        if named.final is not None:
            phases += [gen.nemesis(named.final), gen.sleep(3)]
        if workload.get("final_generator") is not None:
            phases.append(gen.clients(workload["final_generator"]))
        return self.base_test(opts) | dict(opts) | {
            "name": f"{wname} nemesis={nname}",
            "client": workload["client"],
            "nemesis": named.nemesis,
            "model": workload.get("model"),
            "checker": workload["checker"],
            "generator": gen.phases(*phases),
        }

    def add_opts(self, p):
        p.add_argument("-w", "--workload", required=True,
                       choices=sorted(self.workloads),
                       help=cli.one_of(self.workloads))
        p.add_argument("--nemesis", default="none",
                       choices=sorted(self.nemeses),
                       help=cli.one_of(self.nemeses))

    def main(self, argv=None):
        cli.main(cli.single_test_cmd(self.build_test,
                                     add_opts=self.add_opts), argv)
