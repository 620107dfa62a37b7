"""Test suites (reference L9) — per-database applications of the harness.

The JAX package ships one module per database (``jepsen_tpu/suites/``).
The port holds these, listed in :data:`SUITES` in the JAX package's
order:

  atomdemo  — in-process atom-backed suite runnable with zero cluster
              infrastructure (the jepsen.tests/atom-db fixture promoted
              to a demo suite)
  etcdemo   — the tutorial suite: etcd CAS register on independent keys +
              set workload (jepsen.etcdemo), over the v3 JSON gateway
  zookeeper — single linearizable CAS register (zookeeper/)
  hazelcast — distributed lock checked as a mutex (hazelcast/); its
              in-process lock fixture is BASELINE config 4
  registry  — cockroachdb-style named workload/nemesis registry runner
              (cockroachdb/src/jepsen/cockroach/runner.clj)
  consul, disque, aerospike, rethinkdb, tidb, etcd (v2), logcabin,
  raftis    — the databases' suites; a DB's commands are strings sent
              to the remote, and each register workload is checked
              through ``Linearizable``
  localnode — every logical node a real server process
              (localnode_server.py), killed with kill -9

Each runs from the command line:

    python -m jepsen_tpu_torch.suites.atomdemo test --dummy -n n1 -n n2 \\
        -n n3 --time-limit 5
"""

from importlib import import_module

SUITES = ["atomdemo", "etcdemo", "zookeeper", "hazelcast", "registry",
          "consul", "disque", "aerospike", "rethinkdb", "tidb", "etcd",
          "logcabin", "raftis", "localnode"]


def suite(name: str):
    return import_module(f"jepsen_tpu_torch.suites.{name}")
