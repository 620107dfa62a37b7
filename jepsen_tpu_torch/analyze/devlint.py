"""Device-contract lint: K-codes over one slice of every kernel route.

The JAX package's devlint stages every kernel route's jaxpr and walks
it.  The port has no staged program: a slice function is Python that
launches torch ops or one CUDA kernel.  So the port runs one slice of
each route registered in
:data:`jepsen_tpu_torch.checker.linearizable.KERNEL_ROUTES` (the torch
step, the fused CUDA level loop B1 for one key and as the bucketed
batch's grid, the sharded search B7 and the sharded batch B8), at the
representative dims and on the sample history of
:func:`~jepsen_tpu_torch.checker.linearizable.route_sample_inputs`,
under an op recorder (a ``TorchDispatchMode`` for the aten ops, their
dtypes and the tensors they write, and a ``TorchFunctionMode`` for the
calls that copy to the host).  Each op is attributed to the first line
on the Python stack outside torch and this module: the site a finding
names.  The slice runs twice, at level caps L and 2L, so that what a
slice does per level shows as a count that grows with the cap.

K-codes, stated for the port (the reference's wording where it holds):

  K001  a host read that steers control flow inside the level loop:
        ``bool()``, ``int()`` or ``.item()`` on a tensor
        (``aten._local_scalar_dense``) at a site whose count grows from
        L to 2L levels.  On the card each is a device sync per level
  K002  a 64-bit float or complex anywhere in the slice, any float in
        an ``int_only`` route, or a 64-bit integer in what the slice
        returns (the carry and the aux block, which stay on the device
        and are fed back).  Index tensors are int64 by torch's contract
        (``arange``, ``argsort``, a mask's ``cumsum``) and are not
        flagged: they are not the search's data
  K003  two requests whose dims are equal in value but not in type (a
        Python ``int`` against a ``numpy.int64``) give two cache
        entries: the second request emits a ``device.compile`` span or
        counts a cache miss.  The JAX package flags the weak-typed
        operand that splits its jit cache; the port's cache key is the
        getter's tuple, so the split shows there
  K004  carry-donation policy break: the slice writes into a carry
        argument (a carry tensor's ``_version`` moves) where the route
        declares ``donate_carry=False`` (the slice driver keeps the
        pre-overflow carry and re-feeds it after an escalation), or a
        ``donate_carry=True`` route that writes none
  K005  the route raises while it is built or while it runs one slice
        at the representative dims
  K006  a device-to-host copy inside the level loop: ``.tolist()``,
        ``.numpy()`` or ``.cpu()`` (host copies on any device), or
        ``.to()``/``copy_`` of a tensor on another device into the CPU,
        at a site whose count grows from L to 2L
  K007  compile-span cache-key coords missing or drifted versus the
        static model below: ``fleet/warmup.py``'s warm boot rebuilds
        slice functions from recorded spans through exactly these
        coords

On the CPU the fused kernel's wrappers run their plain versions (the
torch step); the recorder pauses inside them (the sweep wraps
``level_kernel.level_loop_reference`` and ``level_loop_batch_reference``
while a slice runs), so only the wrapper's host code is linted, as on
the card, where the launch is one ctypes call the dispatcher does not
see (one device op).  The batch getter serves the torch step key by
key on the CPU, so the sharded batch's findings there include the torch
step's; on the card its shards run the grid, which lints clean.

Suppression: a ``devlint: ok`` comment on the attributed line suppresses
a finding there (K003: on the route getter's ``def`` line), the same
contract as the reference's.  Suppressions are for documented false
positives only.

Wired into ``python -m jepsen_tpu_torch.analyze --devlint``.

The K007 model states the port's own spans, stamped by
``checker/linearizable.py::_cached`` (single key, ``get_kernel``; the
batch, ``get_batch_kernel``, with ``batch=True``: the port's batch
function does not key on its lanes) and by ``checker/sharded.py`` (the
sharded search, engine ``device-sharded``; the sharded batch, with
``batch=<keys per shard>``).  They differ from the JAX package's in
four ways: ``engine`` is ``cuda``, ``torch`` or ``device-sharded``;
they carry ``telemetry``; they carry no ``vt`` (the port's kernels do
not key on it); the single-device batch span says ``batch=True``.
Read with ``strict=False``, the JAX package's generations (its current
one with engines ``xla`` and ``pallas`` included) are accepted too, as
that package reads its committed traces: a trace recorded on a TPU
warms the port's counterpart slice functions.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import linecache
import os
import sys
from collections import Counter

from .lint import Diagnostic

DEVLINT_CODES = {
    "K001": "host read steering control flow inside the level loop",
    "K002": "float64/dtype-widening leak in the slice's dataflow",
    "K003": "dims equal in value but not in type split the kernel "
            "cache key",
    "K004": "carry-donation policy break: the slice writes its carry",
    "K005": "the route fails to build or to run one slice",
    "K006": "device->host copy inside the level loop",
    "K007": "compile-span cache-key coords missing/drifted vs the "
            "static model",
}

#: coords every port compile span carries: the full slice-function
#: cache key, so a recorded span alone rebuilds it
BASE_COORDS = frozenset({
    "engine", "frontier", "n_det_pad", "n_crash_pad", "window", "k",
    "masked", "masked_crash", "dedup", "telemetry",
    "model", "model_init", "model_width",
})

#: attrs ``obs/telemetry.compile_span`` itself adds: runtime facts, not
#: cache-key coords, so excluded from the model comparison
RUNTIME_COORDS = frozenset({"cache", "persistent_cache"})

#: span_kind -> required coord set of the port's spans (see
#: :func:`span_kind_for_args`)
CACHE_KEY_MODEL = {
    "solo": BASE_COORDS,
    "batch": BASE_COORDS | {"batch"},
    "batch-sharded": BASE_COORDS | {"batch", "sharded", "shards"},
    "window-sharded": BASE_COORDS | {"shards"},
}

#: the JAX package's newest generation, by span_kind: its spans carry
#: ``vt`` and no ``telemetry``
_REFERENCE_BASE = (BASE_COORDS - {"telemetry"}) | {"vt"}
REFERENCE_MODEL = {
    "solo": _REFERENCE_BASE,
    "batch": _REFERENCE_BASE | {"batch"},
    "batch-sharded": _REFERENCE_BASE | {"batch", "sharded", "shards"},
    "window-sharded": _REFERENCE_BASE | {"shards"},
}

#: the JAX package's earlier generations, oldest first (its committed
#: ``BENCH_trace_*.json`` recordings)
LEGACY_GENERATIONS = (
    # first span accounting: engine and two dims only
    frozenset({"engine", "frontier", "n_det_pad"}),
    # the fleet tier's warm boot added window, k and the crash pad
    frozenset({"engine", "frontier", "n_det_pad", "n_crash_pad",
               "window", "k"}),
)

#: engines of the port's spans, and those the JAX package's spans carry
PORT_ENGINES = ("cuda", "torch", "device-sharded")
REFERENCE_ENGINES = ("xla", "pallas", "device-sharded")


def span_kind_for_args(args: dict) -> str:
    """Classify a recorded ``device.compile`` span into the model's
    span_kind.  Legacy spans missing the batch/sharded markers classify
    as solo; their generation check still passes."""
    if args.get("engine") == "device-sharded":
        return "window-sharded"
    if "sharded" in args or args.get("shards") is not None:
        return "batch-sharded"
    if "batch" in args:
        return "batch"
    return "solo"


def _coord_domain_errors(args: dict, *, strict: bool = True) -> list[str]:
    """Value-domain checks for whatever coords are present: a coord
    carrying an impossible value is drift even when the key set
    matches."""
    errs = []

    def _int(k):
        v = args.get(k)
        if v is None:
            return None
        try:
            return int(v)
        except (TypeError, ValueError):
            errs.append(f"coord {k}={v!r} is not an integer")
            return None

    w = _int("window")
    if w is not None and (w <= 0 or w % 32):
        errs.append(f"window={w} not a positive multiple of 32")
    cp = _int("n_crash_pad")
    if cp is not None and (cp < 0 or cp % 32 or cp > 64):
        errs.append(f"n_crash_pad={cp} not a multiple of 32 in [0,64]")
    for k, lo in (("frontier", 1), ("n_det_pad", 1), ("k", 1),
                  ("batch", 1), ("shards", 1), ("model_width", 1)):
        v = _int(k)
        if v is not None and v < lo:
            errs.append(f"coord {k}={v} < {lo}")
    eng = args.get("engine")
    engines = PORT_ENGINES if strict else PORT_ENGINES + REFERENCE_ENGINES
    if eng is not None and eng not in engines:
        errs.append(f"unknown engine {eng!r}")
    mdl = args.get("model")
    if mdl is not None and not isinstance(mdl, str):
        errs.append(f"coord model={mdl!r} is not a name")
    tele = args.get("telemetry")
    if tele is not None and not isinstance(tele, bool):
        errs.append(f"coord telemetry={tele!r} is not a flag")
    return errs


def check_span_args(args: dict, *, kind: str | None = None,
                    strict: bool = True) -> list[str]:
    """K007 core: validate one ``device.compile`` span's args against
    the static cache-key model.

    ``strict=True`` (a span the port stamps, a warm shape): the coord
    key set must equal the port's for its span_kind.  ``strict=False``
    (recorded traces, the JAX package's included): one of the JAX
    package's generations is also accepted.  Returns a list of failure
    strings, empty when clean."""
    keys = frozenset(args) - RUNTIME_COORDS
    if kind is None:
        kind = span_kind_for_args(args)
    required = CACHE_KEY_MODEL.get(kind)
    if required is None:
        return [f"unknown span_kind {kind!r}"]
    failures = []
    if keys != required:
        legacy_ok = (not strict) and (keys in LEGACY_GENERATIONS
                                      or keys == REFERENCE_MODEL[kind])
        if not legacy_ok:
            missing = sorted(required - keys)
            extra = sorted(keys - required)
            parts = []
            if missing:
                parts.append(f"missing coords {missing}")
            if extra:
                parts.append(f"unmodelled coords {extra}")
            failures.append(f"[{kind}] " + ", ".join(parts))
    failures.extend(_coord_domain_errors(args, strict=strict))
    return failures


def representative_dims(model=None):
    """A small model and its SearchDims: big enough to exercise padding,
    crash lanes and the windowed frontier."""
    from ..checker.encode import SearchDims
    from ..models import register

    m = model if model is not None else register(0)
    return m, SearchDims(n_det_pad=64, n_crash_pad=32, window=32, k=2,
                         state_width=m.state_width, frontier=8)


# ---------------------------------------------------------------------------
# the op recorder
# ---------------------------------------------------------------------------

#: the level caps of the two runs of a slice: L and 2L
LEVELS = (4, 8)

_SELF = os.path.abspath(__file__)
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_SELF)))

_WIDE = ("float64", "complex128")
_WIDE_INT = ("int64", "uint64")
#: function-level calls that copy a tensor to the host (K006)
_HOST_COPIES = ("tolist", "numpy", "cpu")


def _is_cpu(dev) -> bool:
    import torch

    try:
        return torch.device(dev).type == "cpu"
    except (RuntimeError, TypeError):
        return False


class _Recorder:
    """Counts, per site, what one slice does: host reads, host copies,
    wide dtypes and the storages its in-place ops write; remembers the
    site that produced each output tensor."""

    def __init__(self, int_only: bool):
        from torch.utils.weak import WeakIdKeyDictionary

        self.int_only = int_only
        self.reads: Counter = Counter()     # K001
        self.copies: Counter = Counter()    # K006
        self.wide: dict = {}                # K002: site -> (op, dtype)
        self.writes: dict = {}              # storage ptr -> site
        self.produced = WeakIdKeyDictionary()
        #: > 0 inside a plain version of the fused kernel (one device op)
        self.paused = 0
        #: the frame that runs the slice: the stack walk stops there
        self.top = None
        self._torch_dir = os.path.dirname(os.path.abspath(
            sys.modules["torch"].__file__))

    def site(self):
        """(file, line) of the first frame outside torch and this
        module, or None (no such frame below the slice's caller)."""
        f = sys._getframe(1)
        while f is not None and f is not self.top:
            fn = f.f_code.co_filename
            if not (fn == _SELF or fn.startswith("<")
                    or fn.startswith(self._torch_dir)):
                return fn, f.f_lineno
            f = f.f_back
        return None

    def modes(self):
        import torch
        from torch.overrides import TorchFunctionMode
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class Functions(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(),
                                   kwargs=None):
                kwargs = kwargs or {}
                if rec.paused:
                    return func(*args, **kwargs)
                name = getattr(func, "__name__", "")
                host = name in _HOST_COPIES
                if name == "to":
                    host = args[0].device.type != "cpu" and any(
                        _is_cpu(a) for a in
                        list(args[1:]) + [kwargs.get("device")]
                        if isinstance(a, (str, torch.device)))
                elif name == "copy_" and len(args) > 1:
                    dst, src = args[0], args[1]
                    host = (isinstance(src, torch.Tensor)
                            and dst.device.type == "cpu"
                            and src.device.type != "cpu")
                if host:
                    site = rec.site()
                    if site is not None:
                        rec.copies[site] += 1
                return func(*args, **kwargs)

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(),
                                   kwargs=None):
                out = func(*args, **(kwargs or {}))
                site = None if rec.paused else rec.site()
                if site is None:
                    return out
                if func is torch.ops.aten._local_scalar_dense.default:
                    rec.reads[site] += 1
                for i, a in enumerate(func._schema.arguments):
                    if (a.alias_info is not None and a.alias_info.is_write
                            and i < len(args)
                            and isinstance(args[i], torch.Tensor)):
                        rec.writes.setdefault(
                            args[i].untyped_storage().data_ptr(), site)
                for t in _tensors(out):
                    rec.produced[t] = site
                    dt = str(t.dtype).replace("torch.", "")
                    if dt in _WIDE or (rec.int_only and t.is_floating_point()):
                        rec.wide.setdefault(site, (str(func), dt))
                return out

        return Functions(), Ops()


def _tensors(x):
    """The tensors of a nested tuple/list structure."""
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _where(site) -> str:
    """``file:line``, the file relative to the repository root when it
    lies inside it."""
    fn, line = site
    rel = os.path.relpath(fn, _PKG_ROOT)
    return f"{fn if rel.startswith('..') else rel}:{line}"


def _suppressed(site) -> bool:
    return site is not None and "devlint: ok" in linecache.getline(*site)


def _run_slice(route, fn, args, levels: int):
    """One slice at ``levels`` under a fresh recorder: (recorder, out,
    carry versions before, carry tensors).  The fused kernel's plain
    versions run with the recorder paused: on the card they are one
    launch, which the dispatcher does not see."""
    from ..checker import level_kernel as lk

    args = list(args)
    args[route.lvl_cap_arg] = levels
    carry = list(_tensors(args[len(args) - route.carry_args:]))
    before = [t._version for t in carry]
    rec = _Recorder(route.int_only)
    rec.top = sys._getframe()

    def opaque(plain):
        @functools.wraps(plain)
        def run(*a, **kw):
            rec.paused += 1
            try:
                return plain(*a, **kw)
            finally:
                rec.paused -= 1
        return run

    saved = lk.level_loop_reference, lk.level_loop_batch_reference
    lk.level_loop_reference, lk.level_loop_batch_reference = map(opaque,
                                                                 saved)
    fmode, dmode = rec.modes()
    try:
        with fmode, dmode:
            out = fn(*args)
    finally:
        lk.level_loop_reference, lk.level_loop_batch_reference = saved
    return rec, out, before, carry


# ---------------------------------------------------------------------------
# live span capture (K007) and the cache-key type split (K003)
# ---------------------------------------------------------------------------

_DEVLINT_RUN = "__devlint__"


def capture_compile_spans(route, model, dims, device) -> list[dict]:
    """Request the route through its real cache getter under a private
    trace recorder and return the ``device.compile`` spans it emitted.
    An already-warm cache emits none (the miss path never runs):
    callers treat that as vacuous, not clean."""
    from ..obs import trace as _trace

    prev_on = _trace.enabled()
    prev_run = _trace.current_run()
    _trace.enable(True)
    _trace.set_run(_DEVLINT_RUN)
    try:
        route.request(model, dims, device)
        rec = _trace.recorder(_DEVLINT_RUN)
        return [s for s in rec.spans() if s["name"] == "device.compile"]
    finally:
        _trace.set_run(prev_run)
        _trace.enable(prev_on)
        _trace.drop_recorder(_DEVLINT_RUN)


def lint_compile_spans(route, spans: list[dict]) -> list[Diagnostic]:
    """K007 over live-captured spans, strict: each span against the
    model of its own kind (a route's getter may request an inner
    route's function too), and at least one of the route's declared
    kind."""
    diags = []
    kinds = set()
    for s in spans:
        args = s.get("args", {})
        kind = span_kind_for_args(args)
        kinds.add(kind)
        for fail in check_span_args(args, kind=kind, strict=True):
            diags.append(Diagnostic(
                "K007", "error",
                f"{route.name}: device.compile span coords drift vs "
                f"the static cache-key model: {fail}", f=route.name))
    if spans and route.span_kind not in kinds:
        diags.append(Diagnostic(
            "K007", "error",
            f"{route.name}: no device.compile span of the route's kind "
            f"{route.span_kind!r} (got {sorted(kinds)})", f=route.name))
    return diags


def _numpy_dims(dims):
    """``dims`` with every field a ``numpy.int64``: equal in value."""
    import numpy as np

    return dataclasses.replace(dims, **{
        f.name: np.int64(getattr(dims, f.name))
        for f in dataclasses.fields(dims)})


def _getter_site(route):
    import importlib

    try:
        fn = getattr(importlib.import_module(route.module), route.getter)
        return (inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1])
    except (ImportError, AttributeError, OSError, TypeError):
        return None


def check_cache_key_types(route, model, dims, device) -> list[Diagnostic]:
    """K003: request the route at ``dims`` and again at the same dims as
    numpy integers; the second must find the first's entry."""
    from ..checker import linearizable as lin

    route.request(model, dims, device)
    misses = lin.KERNEL_CACHE_STATS["misses"]
    spans = capture_compile_spans(route, model, _numpy_dims(dims), device)
    split = len(spans) + lin.KERNEL_CACHE_STATS["misses"] - misses
    site = _getter_site(route)
    if not split or _suppressed(site):
        return []
    return [Diagnostic(
        "K003", "error",
        f"{route.name}: dims equal in value but numpy-typed gave "
        f"{split} new cache entr{'y' if split == 1 else 'ies'} in "
        f"{route.getter}" + (f" at {_where(site)}" if site else "")
        + " — the cache key splits on the type of its coordinates",
        f=route.name)]


# ---------------------------------------------------------------------------
# one route
# ---------------------------------------------------------------------------


def _finding(code, route, msg, site=None) -> Diagnostic:
    at = f" at {_where(site)}" if site else ""
    return Diagnostic(code, "error", f"{route.name}: {msg}{at}",
                      f=route.name)


def lint_route(route, model, dims, device, *, live: bool = False
               ) -> tuple[list[Diagnostic], list[tuple], int]:
    """Every K-code over one route: (diagnostics, findings, compile
    spans captured live), a finding ``(route, code, "file:line" | None)``
    per error diagnostic."""
    diags: list[Diagnostic] = []
    found: list[tuple] = []
    spans: list = []

    def add(code, msg, site=None):
        diags.append(_finding(code, route, msg, site))
        found.append((route.name, code, _where(site) if site else None))

    try:
        if live:
            spans = capture_compile_spans(route, model, dims, device)
            for d in lint_compile_spans(route, spans):
                diags.append(d)
                found.append((route.name, "K007", None))
        fn, args = route.build(model, dims, device)
        runs = [_run_slice(route, fn, args, lv) for lv in LEVELS]
        k3 = check_cache_key_types(route, model, dims, device)
    except Exception as exc:  # noqa: BLE001 — the failure IS the finding
        kind = type(exc).__name__
        msg = str(exc).splitlines()[0][:200] if str(exc) else ""
        add("K005", f"the route fails to build or to run one slice "
                    f"({kind}: {msg})")
        return diags, found, len(spans)
    for d in k3:
        diags.append(d)
        found.append((route.name, "K003", None))
    (r1, _o1, _b1, _c1), (r2, out2, before2, carry2) = runs

    for code, what, c1, c2 in (
            ("K001", "host read", r1.reads, r2.reads),
            ("K006", "device->host copy", r1.copies, r2.copies)):
        for site in sorted(c2, key=_where):
            if c2[site] > c1.get(site, 0) and not _suppressed(site):
                add(code, f"{what} per level ({c1.get(site, 0)} at "
                          f"{LEVELS[0]} levels, {c2[site]} at "
                          f"{LEVELS[1]})", site)

    wide = {**r1.wide, **r2.wide}
    for site in sorted(wide, key=_where):
        if not _suppressed(site):
            op, dt = wide[site]
            why = ("64-bit dtype" if dt in _WIDE
                   else "float dtype in an int-only route")
            add("K002", f"'{op}' produces {dt} — {why} widens the "
                        f"device dataflow", site)
    for t in _tensors(out2):
        dt = str(t.dtype).replace("torch.", "")
        if dt in _WIDE_INT or dt in _WIDE:
            site = r2.produced.get(t)
            if not _suppressed(site):
                add("K002", f"the slice returns a {dt} tensor — the "
                            f"carry it feeds back is widened", site)

    moved = [t for t, v in zip(carry2, before2) if t._version != v]
    if route.donate_carry:
        if not moved:
            add("K004", "the route declares donate_carry=True but the "
                        "slice writes none of its carry arguments")
    else:
        for t in moved:
            site = r2.writes.get(t.untyped_storage().data_ptr())
            if not _suppressed(site):
                add("K004", "the slice writes into a carry argument the "
                            "slice driver keeps and re-feeds after an "
                            "escalation (donate_carry=False)", site)
    return diags, found, len(spans)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def lint_kernel_routes(routes=None, *, live: bool = False, model=None,
                       device="cuda"):
    """Run every registered route's slice under the recorder on
    ``device`` (the package rule: "cuda" by default, which raises
    without a card).  ``live=True`` also requests each route through its
    real getter first and K007-checks the compile spans it emits
    (meaningful in a fresh process: warm caches emit no span).  Returns
    (diagnostics, findings, {route: compile spans captured})."""
    from ..checker.linearizable import _resolve_device, kernel_routes

    dev = _resolve_device(device)
    if routes is None:
        routes = kernel_routes()
    m, dims = representative_dims(model)
    diags: list[Diagnostic] = []
    found: list[tuple] = []
    spans: dict = {}
    for name in sorted(routes):
        d, f, spans[name] = lint_route(routes[name], m, dims, dev, live=live)
        diags.extend(d)
        found.extend(f)
    return diags, found, spans


def run_devlint(*, live: bool = False, device="cuda") -> dict:
    """The CLI/test entry: sweep all routes, return the result block
    ``{"routes": [names], "diagnostics": [...], "errors": n,
    "warnings": n, "findings": [[route, code, "file:line" | None]],
    "spans": {route: live compile spans}, "launches": {"single,on": n,
    ...}, "device": str}``; ``launches`` are the fused kernel's launches
    the sweep made, by form and telemetry (0 on the CPU)."""
    from ..checker import level_kernel as lk
    from ..checker.linearizable import kernel_routes

    routes = kernel_routes()
    before = dict(lk.LAUNCHES_BY_FORM)
    diags, found, spans = lint_kernel_routes(routes, live=live,
                                             device=device)
    return {
        "routes": sorted(routes),
        "diagnostics": [d.to_dict() for d in diags],
        "errors": sum(1 for d in diags if d.severity == "error"),
        "warnings": sum(1 for d in diags if d.severity == "warning"),
        "findings": [list(f) for f in found],
        "spans": spans,
        "launches": {f"{form},{'on' if tele else 'off'}":
                     n - before[form, tele]
                     for (form, tele), n in lk.LAUNCHES_BY_FORM.items()},
        "device": str(device),
    }
