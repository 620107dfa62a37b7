"""The port imports neither jax nor the JAX package, at any depth: every
module of ``jepsen_tpu_torch`` and ``chip_smoke`` import in a fresh
interpreter that refuses both, no source file names either, and no
string constant names a module of the JAX package (a daemon the port
spawns with ``python -m`` runs in another process, where the import
guard cannot see it)."""

import ast
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jepsen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("refused import of " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in FORBIDDEN:
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
import jepsen_tpu_torch
names = ["jepsen_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                          "jepsen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert chip_smoke.__name__ == "chip_smoke"
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print("imported", len(names), "modules:", " ".join(names))
"""

#: the modules every slice so far added; the probe must import each
MODULES = {"jepsen_tpu_torch." + m for m in (
    "history", "models", "synth", "store", "_build", "checker.encode",
    "checker.step", "checker.level_kernel", "checker.linearizable",
    "checker.seq", "checker.linear", "checker.linear_report",
    "analyze.shrink", "analyze.lint", "analyze.hb", "analyze.constraints",
    "analyze.dpor", "analyze.audit", "decompose.canonical",
    "decompose.partition", "independent", "checker.core", "checker.bucket",
    "obs", "obs.metrics", "obs.trace", "obs.telemetry", "analyze.plan",
    "decompose", "decompose.cache", "decompose.engine",
    "decompose.schedule", "checker.basic", "stream", "stream.checker",
    "stream.device", "stream.service", "stream.bench", "stream.__main__",
    "distributed", "checker.sharded", "reconnect", "analyze.devlint",
    "fleet", "fleet.warmup", "fleet.cachestore", "fleet.admission",
    "fleet.router", "fleet.bench", "fleet.__main__", "checker.shard_bench",
    "live", "live.corpus", "obs.report", "obs.__main__", "live.oplog",
    "live.kv_server", "live.queue_server", "live.replicated_server",
    "live.replicated_queue", "analyze.simnet", "analyze.modelcheck",
    "analyze.__main__", "util", "codec", "bank", "checker",
    "checker.extra", "checker.dirty", "checker.schedule",
    "checker.timeline", "checker.perf", "client", "db", "generator",
    "control", "control_util", "os", "os.debian", "os.smartos", "net",
    "nemesis", "nemesis_time", "faketime", "faultfs", "fixtures", "core",
    "report", "repl", "cli", "web", "suites", "suites.atomdemo",
    "suites.registry", "suites.localnode_server", "suites.localnode",
    "suites.hazelcast", "analyze.suites", "analyze.lint_suites",
    "suites.etcdemo", "suites.etcd", "suites.zookeeper", "suites.consul",
    "suites.logcabin", "suites.disque", "suites.raftis", "suites.rethinkdb",
    "suites.tidb", "suites.aerospike", "suites.pgwire",
    "live.pgwire_server", "suites.cockroach", "suites.mongodb",
    "suites.chronos", "suites.rabbitmq", "suites.robustirc",
    "suites.galera", "suites.percona", "suites.postgres_rds",
    "suites.crate", "suites.elasticsearch", "suites.dgraph",
    "suites.mysql_cluster", "live.links", "live.backend", "live.matrix",
    "live.campaign", "live.__main__", "checker.parallel", "fuzz")}

#: a whole string that is a dotted module path of the JAX package
REFERENCE_MODULE = re.compile(r"^jepsen_tpu(\.\w+)+$")


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_without_jax_or_reference():
    code = _PROBE.format(forbidden=FORBIDDEN, repo=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    names = set(res.stdout.split(":", 1)[1].split())
    assert MODULES <= names, sorted(MODULES - names)


def test_no_source_names_jax_or_reference():
    offenders = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}:"
                                     f"{node.lineno} {name}")
    assert not offenders, offenders


def test_no_string_names_a_reference_module():
    """No string constant of a port source is a dotted module path of the
    JAX package: a spawn target such as ``"jepsen_tpu.live.kv_server"``
    would start the JAX package's daemon.  Prose that mentions a module
    (a docstring) is not a whole path and passes."""
    offenders = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and REFERENCE_MODULE.match(node.value)):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno} "
                                 f"{node.value}")
    assert not offenders, offenders


def test_reference_module_pattern_catches_a_spawn_target():
    """The pattern of the check above on what it must and must not match."""
    assert REFERENCE_MODULE.match("jepsen_tpu.live.kv_server")
    assert REFERENCE_MODULE.match("jepsen_tpu.suites.localnode_server")
    assert not REFERENCE_MODULE.match("jepsen_tpu_torch.live.kv_server")
    assert not REFERENCE_MODULE.match("jepsen_tpu")
    assert not REFERENCE_MODULE.match(
        "the counterpart of jepsen_tpu.live, in prose")


def test_no_source_reads_the_environment():
    """The port's knobs are arguments: no source reads ``os.environ`` or
    ``os.getenv`` (the JAX package's ``JEPSEN_TPU_*`` variables
    included)."""
    offenders = []
    for path in _sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr in ("environ", "getenv")
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "os"):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not offenders, offenders


def test_kernel_sources_ship_with_the_package():
    srcs = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert srcs == ["level_loop.cu"]
