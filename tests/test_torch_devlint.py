"""The port's device-contract lint (``jepsen_tpu_torch/analyze/devlint.py``)
and its kernel-route registry.

Each of K001-K006 fires on a seeded toy route and honours ``# devlint:
ok`` on the attributed line; the JAX package's lint fires the same code
on its own toy of the same breach (a staged program), so the two
contracts are compared code by code.  The registry lists the port's
five routes.  The shipped routes' findings are pinned: on the CPU with
the card's dispatch (``_use_kernel`` as the card decides it), the set
``chip_smoke.DEVLINT_FINDINGS`` holds on the card; the fused kernel's
routes are clean, and so are the JAX package's counterparts of the
routes it stages on this image (its ``mesh-sharded`` route fails to
stage on jax 0.9.0 and is left out).  ``python -m
jepsen_tpu_torch.analyze --devlint`` runs in a fresh process with the
reference's exit contract (1 on errors) and captures every route's
compile span."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.analyze import devlint as jdl
from jepsen_tpu_torch.analyze import devlint as tdl
from jepsen_tpu_torch.checker import level_kernel as lk
from jepsen_tpu_torch.checker import linearizable as tlin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

#: the shipped routes' findings with the card's dispatch: the torch
#: step's per-level host reads (its loop test, the crash closure's
#: start and its next round) and the sharded step's
PINNED = frozenset({
    ("single-torch", "K001", "jepsen_tpu_torch/checker/step.py:472"),
    ("single-torch", "K001", "jepsen_tpu_torch/checker/step.py:485"),
    ("single-torch", "K001", "jepsen_tpu_torch/checker/step.py:508"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:135"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:164"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:232"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:251"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:258"),
    ("window-sharded", "K001", "jepsen_tpu_torch/checker/sharded.py:284"),
})

#: on the CPU the batch getter serves the torch step key by key, so the
#: sharded batch's shards carry its reads too
CPU_EXTRA = frozenset(
    ("mesh-sharded", "K001", f"jepsen_tpu_torch/checker/step.py:{n}")
    for n in (472, 485, 508))

#: the port's route -> the JAX package's counterpart
COUNTERPART = {"single-torch": "single-xla", "cuda-fused": "pallas-fused",
               "bucketed-batch": "bucketed-batch",
               "mesh-sharded": "mesh-sharded"}

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    # the toy getters' entries: each K003 case starts from a cold key
    for key in [k for k in tlin._STEP_CACHE
                if isinstance(k[0], str) and k[0].startswith("toy")]:
        del tlin._STEP_CACHE[key]


def _codes(diags):
    return {d.code for d in diags}


# ---------------------------------------------------------------------------
# toy routes
# ---------------------------------------------------------------------------


def _toy(slice_fn, *, name="toy", request=None, build=None,
         donate_carry=False, int_only=True, getter="_toy_getter"):
    """A route over ``slice_fn(x, lvl_cap, carry)``."""
    def default_build(model, dims, device):
        return slice_fn, (torch.arange(8, dtype=torch.int32), 4,
                          torch.zeros(4, dtype=torch.int32))

    return tlin.KernelRoute(
        name=name, span_kind="solo", getter=getter,
        module=__name__, build=build or default_build,
        request=request or (lambda model, dims, device: slice_fn),
        int_only=int_only, donate_carry=donate_carry, carry_args=1,
        lvl_cap_arg=1)


def _lint(route):
    model, dims = tdl.representative_dims()
    diags, found, _spans = tdl.lint_route(route, model, dims, CPU)
    return diags, found


def _k001(x, lvl_cap, carry):
    for _ in range(lvl_cap):
        if not bool((x > -1).any()):
            break
        x = x + 1
    return x, carry


def _k001_ok(x, lvl_cap, carry):
    for _ in range(lvl_cap):
        if not bool((x > -1).any()):  # devlint: ok — fixture
            break
        x = x + 1
    return x, carry


def _k001_once(x, lvl_cap, carry):
    if bool((x > -1).any()):  # one read per slice: not per level
        x = x + lvl_cap
    return x, carry


def _k002_f64(x, lvl_cap, carry):
    return x.to(torch.float64).sum().to(torch.int32), carry


def _k002_f64_ok(x, lvl_cap, carry):
    y = x.to(torch.float64).sum().to(torch.int32)  # devlint: ok — fixture
    return y, carry


def _k002_f32(x, lvl_cap, carry):
    return (x.float() * 2).to(torch.int32), carry


def _k002_wide_carry(x, lvl_cap, carry):
    return x, carry.to(torch.int64)


def _k004(x, lvl_cap, carry):
    carry.add_(1)
    return x, carry


def _k004_ok(x, lvl_cap, carry):
    carry.add_(1)  # devlint: ok — fixture
    return x, carry


def _clean(x, lvl_cap, carry):
    return x + 1, carry + 1


def _k005(x, lvl_cap, carry):
    raise RuntimeError("the slice cannot run")


def _k006(x, lvl_cap, carry):
    for _ in range(lvl_cap):
        x = x + int(sum(x.tolist()) > -1)
    return x, carry


def _k006_ok(x, lvl_cap, carry):
    for _ in range(lvl_cap):
        x = x + int(sum(x.tolist()) > -1)  # devlint: ok — fixture
    return x, carry


def _toy_getter(model, dims, device):
    """A getter keyed on the dims' repr: a numpy-typed field splits it
    (numpy 2 prints ``np.int64(8)``)."""
    return tlin._cached(("toy", repr(dims)), lambda: _clean, model, dims,
                        False)


def _toy_getter_ok(model, dims, device):  # devlint: ok — fixture
    return tlin._cached(("toy-ok", repr(dims)), lambda: _clean, model, dims,
                        False)


def _toy_getter_sound(model, dims, device):
    return tlin._cached(("toy-sound", dims), lambda: _clean, model, dims,
                        False)


@pytest.mark.parametrize("fn,code,bad", [
    (_k001, "K001", True), (_k001_ok, "K001", False),
    (_k001_once, "K001", False),
    (_k002_f64, "K002", True), (_k002_f64_ok, "K002", False),
    (_k002_f32, "K002", True), (_k002_wide_carry, "K002", True),
    (_k004, "K004", True), (_k004_ok, "K004", False),
    (_k005, "K005", True), (_clean, "K005", False),
    (_k006, "K006", True), (_k006_ok, "K006", False),
])
def test_toy_routes(fn, code, bad):
    diags, found = _lint(_toy(fn))
    assert (code in _codes(diags)) is bad, [d.message for d in diags]
    # nothing else fires on a toy that seeds one breach
    assert _codes(diags) <= {code}, [d.message for d in diags]
    if bad and code in ("K001", "K006", "K002", "K004") \
            and fn is not _k002_wide_carry:
        site = found[0][2]
        assert site.startswith("tests/test_torch_devlint.py:"), found


def test_toy_site_is_the_line():
    import inspect

    _, found = _lint(_toy(_k001))
    src, first = inspect.getsourcelines(_k001)
    line = first + next(i for i, s in enumerate(src) if "bool(" in s)
    assert found == [("toy", "K001", f"tests/test_torch_devlint.py:{line}")]


def test_k002_floats_allowed_in_a_float_route():
    diags, _ = _lint(_toy(_k002_f32, int_only=False))
    assert diags == []
    diags, _ = _lint(_toy(_k002_f64, int_only=False))
    assert _codes(diags) == {"K002"}


def test_k004_declared_donation_that_never_happens():
    diags, _ = _lint(_toy(_clean, donate_carry=True))
    assert _codes(diags) == {"K004"}
    diags, _ = _lint(_toy(_k004, donate_carry=True))
    assert diags == []


def test_k005_when_the_build_raises():
    def build(model, dims, device):
        raise ValueError("no such dims")

    diags, found = _lint(_toy(_clean, build=build))
    assert _codes(diags) == {"K005"} and found == [("toy", "K005", None)]
    assert "ValueError: no such dims" in diags[0].message


@pytest.mark.parametrize("getter,bad", [("_toy_getter", True),
                                        ("_toy_getter_ok", False),
                                        ("_toy_getter_sound", False)])
def test_k003_value_equal_dims_split_the_cache(getter, bad):
    route = _toy(_clean, getter=getter, request=globals()[getter])
    diags, found = _lint(route)
    assert (_codes(diags) == {"K003"}) is bad, [d.message for d in diags]
    assert diags == [] or found == [("toy", "K003", None)]
    if bad:
        assert "_toy_getter at tests/test_torch_devlint.py:" in \
            diags[0].message


def test_numpy_dims_equal_in_value():
    _, dims = tdl.representative_dims()
    nd = tdl._numpy_dims(dims)
    assert nd == dims and hash(nd) == hash(dims)
    assert all(isinstance(getattr(nd, f), np.int64) for f in
               ("frontier", "window", "n_det_pad"))


# ---------------------------------------------------------------------------
# the JAX package's lint on its toys of the same breaches
# ---------------------------------------------------------------------------


def _jax_codes(kind):
    def loop(body):
        def f(x):
            out, _ = jax.lax.scan(lambda c, _: (body(c), None), x, None,
                                  length=4)
            return out
        return jax.make_jaxpr(f)(jnp.int32(1))

    if kind == "K001":
        jaxpr = loop(lambda c: c + jax.pure_callback(
            lambda v: np.asarray(v, np.int32),
            jax.ShapeDtypeStruct((), jnp.int32), c))
    elif kind == "K002":
        jaxpr = jax.make_jaxpr(lambda x: x.astype(jnp.float32) * 2)(
            jnp.arange(4, dtype=jnp.int32))
    elif kind == "K003":
        jaxpr = jax.make_jaxpr(lambda x, y: x + y)(
            jnp.arange(4, dtype=jnp.int32), 3)
    elif kind == "K006":
        def body(c):
            jax.debug.print("level {}", c)
            return c + 1
        jaxpr = loop(body)
    elif kind == "K004":
        src = ("import jax\n\ndef get_kernel(model, dims):\n"
               "    return jax.jit(step, donate_argnums=(6,))\n")
        return _codes(jdl.check_donation(src, "get_kernel",
                                         donate_carry=False))
    else:  # K005
        import types

        route = types.SimpleNamespace(name="fix", build=lambda m, d: (
            lambda x: jnp.nonzero(x)[0], (jnp.arange(8, dtype=jnp.int32),)))
        return _codes(jdl.stage_route(route, *jdl.representative_dims())[1])
    return _codes(jdl.lint_jaxpr(jaxpr, route_name="fix"))


@pytest.mark.parametrize("code,port_toy", [
    ("K001", _k001), ("K002", _k002_f32), ("K004", _k004),
    ("K005", _k005), ("K006", _k006)])
def test_same_code_as_the_reference_on_its_toy(code, port_toy):
    assert code in _jax_codes(code)
    diags, _ = _lint(_toy(port_toy))
    assert _codes(diags) == {code}


def test_k003_same_code_as_the_reference_on_its_toy():
    assert "K003" in _jax_codes("K003")
    diags, _ = _lint(_toy(_clean, request=_toy_getter))
    assert _codes(diags) == {"K003"}


def test_codes_are_the_reference_codes():
    assert set(tdl.DEVLINT_CODES) == set(jdl.DEVLINT_CODES)


# ---------------------------------------------------------------------------
# the registry and the shipped routes
# ---------------------------------------------------------------------------


def test_the_registry_lists_every_route():
    routes = tlin.kernel_routes()
    assert tuple(sorted(routes)) == chip_smoke.DEVLINT_ROUTES
    assert {r.span_kind for r in routes.values()} == {
        "solo", "batch", "batch-sharded", "window-sharded"}
    import importlib

    for r in routes.values():
        assert callable(getattr(importlib.import_module(r.module), r.getter))
        assert not r.donate_carry and r.int_only
    # bucket.py registers the two batch routes on import, as in the
    # reference; the JAX package's names are kept where the route is
    # the same
    assert routes["mesh-sharded"].lvl_cap_arg == 2
    assert set(COUNTERPART.values()) <= set(
        __import__("jepsen_tpu.checker.linearizable",
                   fromlist=["kernel_routes"]).kernel_routes())


def test_route_sample_inputs_run_every_level():
    """The sample history keeps a slice searching for 2L levels, with a
    crash closure at each: a per-level cost shows."""
    model, dims = tdl.representative_dims()
    fn, args = tlin.kernel_routes()["single-torch"].build(model, dims, CPU)
    args = list(args)
    args[20] = tdl.LEVELS[1]
    out = fn(*args)
    assert int(out[2]) == -1 and int(out[1]) > 0
    assert int(out[4]) == tdl.LEVELS[1] - 1  # depth grew every level
    assert tlin.ROUTE_SAMPLE_OPS >= tdl.LEVELS[1]


@pytest.fixture(scope="module")
def cli_sweep():
    """``python -m jepsen_tpu_torch.analyze --devlint --json --device
    cpu`` in a fresh process (a cold kernel cache, so every route's
    compile span is captured live): (exit code, result block)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze", "--devlint",
         "--json", "--device", "cpu"], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300)
    return out.returncode, json.loads(out.stdout)


def test_cli_in_a_fresh_process(cli_sweep):
    """Every route listed, its compile span captured live and K007-clean,
    exit 1 because the findings are errors (the reference's contract),
    the CPU launching nothing."""
    rc, rep = cli_sweep
    assert rc == 1 and rep["errors"] == len(rep["findings"]) > 0
    assert tuple(rep["routes"]) == chip_smoke.DEVLINT_ROUTES
    assert all(rep["spans"][r] > 0 for r in rep["routes"]), rep["spans"]
    assert not [f for f in rep["findings"] if f[1] == "K007"]
    assert set(rep) >= {"routes", "diagnostics", "errors", "warnings"}
    assert sum(rep["launches"].values()) == 0
    assert rep["device"] == "cpu"


def test_shipped_findings_are_pinned(cli_sweep):
    """On the CPU: the pinned set and the sharded batch's torch step.
    With the card's dispatch the sharded batch's shards run the fused
    kernel's grid, and it lints clean: the card's findings are the
    pinned set, ``chip_smoke.DEVLINT_FINDINGS``."""
    _rc, rep = cli_sweep
    found = [tuple(f) for f in rep["findings"]]
    assert set(found) == PINNED | CPU_EXTRA and len(found) == len(
        PINNED | CPU_EXTRA)
    assert PINNED == chip_smoke.DEVLINT_FINDINGS
    assert {d["code"] for d in rep["diagnostics"]} == {"K001"}
    saved = tlin._use_kernel
    tlin._use_kernel = (lambda model, dims, device, masked=False,
                        dedup=False: lk.eligible(model, dims, masked=masked,
                                                 dedup=dedup))
    try:
        diags, card, _spans = tdl.lint_kernel_routes(
            {"mesh-sharded": tlin.kernel_routes()["mesh-sharded"]},
            device="cpu")
    finally:
        tlin._use_kernel = saved
    assert diags == [] and card == []
    # the fused kernel's own routes lint clean on either dispatch
    assert not [f for f in found if f[0] in ("cuda-fused",
                                             "bucketed-batch")]


def test_reference_counterparts_agree(cli_sweep):
    """Route by route, the JAX package's staged lint and the port's: the
    counterparts the reference stages on this image are clean there;
    the port's are clean but for the torch step's pinned host reads (a
    jitted XLA step has none to find)."""
    from jepsen_tpu.checker.linearizable import kernel_routes

    jroutes = {k: v for k, v in kernel_routes().items()
               if k != "mesh-sharded"}
    by_route: dict = {}
    for d in jdl.lint_kernel_routes(jroutes):
        by_route.setdefault(d.f, set()).add(d.code)
    port: dict = {}
    for route, code, _site in cli_sweep[1]["findings"]:
        port.setdefault(route, set()).add(code)
    for mine, theirs in COUNTERPART.items():
        if theirs == "mesh-sharded":
            continue
        assert by_route.get(theirs, set()) == set()
        assert port.get(mine, set()) == (
            {"K001"} if mine == "single-torch" else set())
