"""The port's public surface against the JAX package's, by an AST walk
of both trees (nothing is imported): every public top-level name and
public class method of each ``jepsen_tpu/`` module is defined somewhere
in ``jepsen_tpu_torch/``, or is pinned in :data:`PINNED` with the reason
the port has no such name."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "jepsen_tpu"
PORT = REPO / "jepsen_tpu_torch"

_JAX_ONLY = "JAX only: the port has no jit, jaxpr or XLA compile cache"
_KNOB = ("a reader of a JEPSEN_TPU_* knob: the port reads no environment, "
         "the switch is an argument")

#: (reference module, name) -> why the port has no name of its own
PINNED = {
    ("util.py", "enable_compilation_cache"): _JAX_ONLY,
    ("util.py", "force_cpu_platform"): _JAX_ONLY,
    ("obs/telemetry.py", "persistent_cache_configured"): _JAX_ONLY,
    ("analyze/devlint.py", "walk_jaxpr"): _JAX_ONLY,
    ("analyze/devlint.py", "lint_jaxpr"): _JAX_ONLY,
    ("analyze/devlint.py", "stage_route"): _JAX_ONLY,
    ("analyze/devlint.py", "check_donation"):
        _JAX_ONLY + " (K004 reads jax.jit's donate_argnums)",
    ("analyze/devlint.py", "lint_route_source"):
        _JAX_ONLY + " (K004 over a route's jax.jit getter)",
    ("analyze/devlint.py", "lint_trace_spans"):
        "K007 over committed JAX traces; the port's K007 reads the spans "
        "it captures (lint_compile_spans)",
    ("checker/pallas_level.py", "build_pallas_step_fn"):
        "the Pallas kernel: level_kernel.build_level_loop_fn and "
        "csrc/level_loop.cu",
    ("checker/pallas_level.py", "CLAMP_INF"):
        "the Pallas kernel's clamp of its tables into f32's exact "
        "integers for one-hot matmuls; the CUDA kernel reads int32 "
        "tables directly",
    ("analyze/audit.py", "audit_enabled"): _KNOB,
    ("analyze/dpor.py", "dpor_enabled"): _KNOB,
    ("analyze/hb.py", "hb_enabled"): _KNOB,
    ("analyze/lint.py", "lint_enabled"): _KNOB,
    ("analyze/shrink.py", "shrink_enabled"): _KNOB,
    ("checker/bucket.py", "bucketing_enabled"): _KNOB,
    ("stream/checker.py", "stream_enabled"): _KNOB,
    ("analyze/suites.py", "KNOB_PREFIX"):
        "the N-codes' environment-knob pattern; the port restates them "
        "over test-map keys",
    ("analyze/suites.py", "KNOB_INTERNAL"):
        "the N-codes' environment-knob pattern; the port restates them "
        "over test-map keys",
    ("distributed.py", "init_from_env"):
        "replaced by distributed.init_process_group (explicit address, "
        "world size and rank)",
    ("analyze/dpor.py", "SleepSets.record_prune"):
        "the port counts sleep-set prunes in dpor_stats only",
}


def _public_names(path: Path) -> set:
    """Public top-level defs, classes and assignments of one module,
    and the public methods of its classes as ``Class.method``."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out
            if not any(p.startswith("_") for p in n.split("."))}


def _modules(root: Path) -> list:
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


REF_MODULES = [p.relative_to(REF).as_posix() for p in _modules(REF)]
PORT_NAMES = set().union(*(_public_names(p) for p in _modules(PORT)))


@pytest.mark.parametrize("module", REF_MODULES)
def test_reference_public_names_exist_in_the_port(module):
    names = _public_names(REF / module)
    missing = {n for n in names if n not in PORT_NAMES}
    pinned = {n for (m, n) in PINNED if m == module}
    assert missing == pinned, (
        f"{module}: missing from the port {sorted(missing - pinned)}; "
        f"pinned but present {sorted(pinned - missing)}")


def test_pinned_names_are_reference_names_with_reasons():
    for (module, name), why in PINNED.items():
        assert name in _public_names(REF / module), (module, name)
        assert why.strip(), (module, name)
