"""Test suites (reference L9) — per-database applications of the harness.

The JAX package ships one module per database (``jepsen_tpu/suites/``).
The port holds the suites whose whole test runs on one machine with no
cluster:

  atomdemo  — in-process atom-backed suite runnable with zero cluster
              infrastructure (the jepsen.tests/atom-db fixture promoted
              to a demo suite)
  registry  — cockroachdb-style named workload/nemesis registry runner
              (cockroachdb/src/jepsen/cockroach/runner.clj)
  hazelcast — distributed lock checked as a mutex (hazelcast/); its
              in-process lock fixture is BASELINE config 4
  localnode — every logical node a real server process
              (localnode_server.py), killed with kill -9

Each runs from the command line:

    python -m jepsen_tpu_torch.suites.atomdemo test --dummy -n n1 -n n2 \\
        -n n3 --time-limit 5
"""

from importlib import import_module

SUITES = ["atomdemo", "registry", "hazelcast", "localnode"]


def suite(name: str):
    return import_module(f"jepsen_tpu_torch.suites.{name}")
