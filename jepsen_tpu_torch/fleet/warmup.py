"""Warm boot: build and launch the steady-state slice functions BEFORE a
worker is admitted to the fleet.

A cold ``stream.service`` worker pays for its first kernels on the runs
the router just sent it because it looked healthy.  The warm-boot gate
turns that round: at worker start, :func:`warm_boot` warms every shape
the steady state needs (read from a recorded trace's ``device.compile``
spans, or from a shape manifest) and **verifies** the warmth by asking
for each slice function again and requiring no new miss on
``checker.linearizable.KERNEL_CACHE_STATS``.  Only a verified worker is
admitted (``fleet/__main__.py`` parses the report line that
``stream/__main__.py`` prints).

What warming means on the card: the first shape builds
``csrc/level_loop.cu`` with nvcc (``_build.py``; a library already in
the build directory loads as it is: the report's ``persistent_cache``),
loads it with ctypes and starts the CUDA context; each shape's slice
function is built into the kernel cache and **launched** once at the
shape's full padded dims, then the device synchronizes.  A shape warms
in the form its coordinates name: single key (``get_kernel``), batch
(``batch > 0``: ``get_batch_kernel`` on ``batch`` copies, B1's grid form
where the kernel takes the rung), sharded batch (``shards > 0``:
``get_sharded_batch_kernel`` over ``ShardMesh([device] * shards)``,
logical shards of one card where there is one, every shard given a live
key so that each launches).  On the CPU the same builds run the torch
step.

The slice functions are keyed by the device and the telemetry flag, so
a worker warms on the device it serves on (``_resolve_device`` makes
``"cuda"`` and ``"cuda:0"`` one key) and with telemetry on, as its folds
run (``telemetry=None`` means on, as every entry point).

Shape manifest format (JSON)::

    {"shapes": [{"model": ["register", 0, 1], "n_det_pad": 1024,
                 "n_crash_pad": 32, "window": 32, "k": 4,
                 "frontier": 128}, ...]}

with optional ``batch`` (keys) and ``shards``.  A trace is a Chrome
trace (``{"traceEvents": [...]}``) of either package: the JAX package's
spans (recorded on a TPU or its CPU) warm the port's counterpart slice
functions.  Every loaded shape is validated against the static
cache-key model (K007, ``analyze/devlint.py``): drift raises
``ValueError`` naming the span, or, when the caller passes
``diagnostics=[]``, is reported there and the shape skipped.  The
counterpart of the JAX package's ``fleet/warmup.py``.
"""

from __future__ import annotations

import dataclasses
import json
import time

#: steady-state defaults for trace spans predating the wider
#: compile-span args (window/n_crash_pad/k)
DEFAULT_WINDOW = 32
DEFAULT_N_CRASH_PAD = 32
DEFAULT_K = 4
DEFAULT_FRONTIER = 64
DEFAULT_MODEL = ("register", 0, 1)


@dataclasses.dataclass(frozen=True)
class WarmShape:
    """One slice-function shape to warm at boot (SearchDims plus the
    model and the reduction flags of the kernel cache key).  ``vt`` is
    the JAX package's coordinate, kept so that its manifests read; the
    port's kernels do not key on it."""

    model: tuple = DEFAULT_MODEL  # (name, init, width)
    n_det_pad: int = 64
    n_crash_pad: int = DEFAULT_N_CRASH_PAD
    window: int = DEFAULT_WINDOW
    k: int = DEFAULT_K
    frontier: int = DEFAULT_FRONTIER
    masked: bool = False
    masked_crash: bool = False
    dedup: bool = False
    vt: int = 8
    #: batch > 0 warms the BATCH slice function on that many keys (0 =
    #: single key); shards > 0 spreads them over that many shards
    batch: int = 0
    shards: int = 0


def _shape_span_args(s: WarmShape) -> dict:
    """A WarmShape rendered as the ``device.compile`` span args the
    port stamps when it builds that slice function on the card with
    telemetry on: the shared currency of this loader and devlint's
    static cache-key model."""
    args = {
        "engine": "cuda",
        "frontier": s.frontier, "n_det_pad": s.n_det_pad,
        "n_crash_pad": s.n_crash_pad, "window": s.window, "k": s.k,
        "masked": s.masked, "masked_crash": s.masked_crash,
        "dedup": s.dedup, "telemetry": True,
        "model": s.model[0], "model_init": s.model[1],
        "model_width": s.model[2],
    }
    if s.batch:
        args["batch"] = True
    if s.shards:
        args["sharded"] = True
        args["shards"] = s.shards
        # span convention: sharded spans record keys PER SHARD
        args["batch"] = max(1, s.batch // s.shards)
    return args


def _k007(diagnostics, where: str, errs: list[str]):
    """Report one shape's cache-key drift: append K007 diagnostics when
    the caller collects them, raise otherwise."""
    from ..analyze.lint import Diagnostic

    if diagnostics is None:
        raise ValueError(
            f"K007 {where}: cache-key coordinates drifted from the "
            f"static model (analyze/devlint.py): " + "; ".join(errs))
    for e in errs:
        diagnostics.append(Diagnostic("K007", "error", f"{where}: {e}"))


def validate_shapes(shapes, *,
                    diagnostics: list | None = None) -> list[WarmShape]:
    """Filter ``shapes`` to the ones whose coordinates satisfy the
    static cache-key model; drifted shapes raise (or, with
    ``diagnostics``, are reported as K007 and dropped)."""
    from ..analyze.devlint import check_span_args

    good = []
    for i, s in enumerate(shapes):
        errs = check_span_args(_shape_span_args(s), strict=True)
        if errs:
            _k007(diagnostics, f"warm shape #{i} ({s.model[0]})", errs)
            continue
        good.append(s)
    return good


def shapes_from_manifest(doc: dict, *,
                         diagnostics: list | None = None
                         ) -> list[WarmShape]:
    shapes = []
    for s in doc.get("shapes", []):
        m = s.get("model", list(DEFAULT_MODEL))
        shapes.append(WarmShape(
            model=(str(m[0]), int(m[1]) if len(m) > 1 else 0,
                   int(m[2]) if len(m) > 2 else 1),
            n_det_pad=int(s.get("n_det_pad", 64)),
            n_crash_pad=int(s.get("n_crash_pad",
                                  DEFAULT_N_CRASH_PAD)),
            window=int(s.get("window", DEFAULT_WINDOW)),
            k=int(s.get("k", DEFAULT_K)),
            frontier=int(s.get("frontier", DEFAULT_FRONTIER)),
            masked=bool(s.get("masked", False)),
            masked_crash=bool(s.get("masked_crash", False)),
            dedup=bool(s.get("dedup", False)),
            vt=int(s.get("vt", 8)),
            batch=int(s.get("batch", 0)),
            shards=int(s.get("shards", 0)),
        ))
    return validate_shapes(shapes, diagnostics=diagnostics)


def shapes_from_trace(doc: dict, *,
                      model: tuple = DEFAULT_MODEL,
                      diagnostics: list | None = None
                      ) -> list[WarmShape]:
    """The shapes a recorded run built: every ``device.compile`` span in
    the trace, deduplicated.  Spans whose coordinates fit no generation
    of the static model are K007: raised, or reported and skipped when
    the caller passes ``diagnostics``."""
    from ..analyze.devlint import check_span_args

    out = []
    seen = set()
    n_span = 0
    for ev in doc.get("traceEvents", []):
        if ev.get("name") != "device.compile":
            continue
        args = ev.get("args", {}) or {}
        n_span += 1
        # spans predating the engine coordinate are the JAX package's
        # XLA route; engine is not a dim, so the default loses nothing
        qargs = dict(args)
        qargs.setdefault("engine", "xla")
        errs = check_span_args(qargs, strict=False)
        if errs:
            _k007(diagnostics, f"device.compile span #{n_span}", errs)
            continue
        # sharded spans record keys per shard and the shard count; the
        # warm shape wants the total key count back (a port batch span's
        # batch=True reads as one key)
        shards = int(args.get("shards", 0) or 0)
        batch = int(args.get("batch", 0) or 0)
        mdl = tuple(model)
        if "model" in args:
            mdl = (str(args["model"]),
                   int(args.get("model_init", 0)),
                   int(args.get("model_width", 1)))
        s = WarmShape(
            model=mdl,
            n_det_pad=int(args["n_det_pad"]),
            n_crash_pad=int(args.get("n_crash_pad",
                                     DEFAULT_N_CRASH_PAD)),
            window=int(args.get("window", DEFAULT_WINDOW)),
            k=int(args.get("k", DEFAULT_K)),
            frontier=int(args.get("frontier", DEFAULT_FRONTIER)),
            masked=bool(args.get("masked", False)),
            masked_crash=bool(args.get("masked_crash", False)),
            dedup=bool(args.get("dedup", False)),
            vt=int(args.get("vt", 8)),
            batch=batch * shards if shards else batch,
            shards=shards,
        )
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def load_shapes(path: str, *,
                model: tuple = DEFAULT_MODEL,
                diagnostics: list | None = None) -> list[WarmShape]:
    """Sniff ``path``: a shape manifest (``{"shapes": [...]}``) or a
    recorded trace (``{"traceEvents": [...]}``).  Shapes are K007
    validated (see the module docstring for raise or ``diagnostics``)."""
    with open(path) as f:
        doc = json.load(f)
    if "shapes" in doc:
        return shapes_from_manifest(doc, diagnostics=diagnostics)
    if "traceEvents" in doc:
        return shapes_from_trace(doc, model=model,
                                 diagnostics=diagnostics)
    raise ValueError(
        f"{path}: neither a shape manifest ({{'shapes': [...]}}) nor "
        f"a telemetry trace ({{'traceEvents': [...]}})")


def _tiny_seq(model):
    """A minimal one-op history the model accepts: enough to launch the
    slice function once at full padded dims."""
    from ..history import encode_ops, invoke_op, ok_op

    fc = model.f_codes
    # the noop model's table is empty and accepts anything
    names = list(fc) or ["write"]
    for cand in ("write", "enqueue", "acquire"):
        if cand in names:
            f = cand
            break
    else:
        f = names[0]
    v = 1 if f in ("write", "enqueue") else None
    return encode_ops([invoke_op(0, f, v), ok_op(0, f, v)], fc)


def _compile_one(shape: WarmShape, *, telemetry: bool, device):
    """Build one slice function at the shape's dims and launch it once,
    then wait for the device.  Returns ``(dims, model, rerequest)``
    where ``rerequest`` asks the cache for the SAME function (the
    verify pass)."""
    import torch

    from ..checker import linearizable as lin
    from ..checker import sharded
    from ..checker.encode import (SearchDims, _init_carry, carry_to_device,
                                  encode_search, pad_search, search_args,
                                  stack_batch)
    from ..decompose.schedule import model_from_descriptor
    from ..distributed import ShardMesh

    name, init, width = shape.model
    model = model_from_descriptor((name, (init,), width))
    dims = SearchDims(
        n_det_pad=max(64, int(shape.n_det_pad)),
        n_crash_pad=max(32, int(shape.n_crash_pad)),
        window=max(32, int(shape.window)),
        k=max(1, int(shape.k)),
        state_width=model.state_width,
        frontier=max(8, int(shape.frontier)),
    )
    flags = dict(masked=shape.masked, masked_crash=shape.masked_crash,
                 dedup=shape.dedup, telemetry=telemetry)
    es = encode_search(_tiny_seq(model))
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    # one slice from the root: budget 64 configs, 4 levels, no bail
    run = (64, 4, False)
    b = max(1, int(shape.batch))
    if shape.batch and shape.shards and b % shape.shards == 0:
        mesh = ShardMesh([device] * shape.shards)
        per = b // shape.shards

        def getter():
            return sharded.get_sharded_batch_kernel(
                model, dims, batch=b, mesh=mesh, **flags)

        # every shard gets live keys: a shard without one is not launched
        getter()([stack_batch([esp] * per, device=d)
                  for d in mesh.devices], *run,
                 [lin._init_batch_carry(per, dims, model, d)
                  for d in mesh.devices])
    elif shape.batch:
        def getter():
            return lin.get_batch_kernel(model, dims, device, **flags)

        getter()(*stack_batch([esp] * b, device=device), *run,
                 *lin._init_batch_carry(b, dims, model, device))
    else:
        def getter():
            return lin.get_kernel(model, dims, device, **flags)

        getter()(*search_args(esp, es, device=device), *run,
                 *carry_to_device(_init_carry(dims, model), device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dims, model, getter


def warm_boot(shapes, *, device="cuda", telemetry=None,
              verify: bool = True) -> dict:
    """Warm every shape on ``device``, then verify: a second request of
    each slice function must be a hit (no miss on
    ``KERNEL_CACHE_STATS``).  ``telemetry=None`` (on) warms the builds
    the service's folds request; ``False`` the others.

    Returns the admission-gate report::

        {"shapes": N, "compiled": n_misses, "hits": n_hits,
         "verified": bool, "persistent_cache": bool, "wall_s": float}

    ``persistent_cache`` says whether the kernel libraries were already
    built when the boot began.  Shapes that fail the static cache-key
    model (K007) are not warmed; the report carries their messages under
    ``"k007"`` and ``verified`` is false, so the admission gate refuses
    the worker with a cause."""
    from .. import _build
    from ..checker import linearizable as lin

    t0 = time.perf_counter()
    dev = lin._resolve_device(device)
    persistent = _build.prebuilt()
    k007: list = []
    shapes = validate_shapes(list(shapes), diagnostics=k007)
    tele = telemetry is None or bool(telemetry)
    before = dict(lin.KERNEL_CACHE_STATS)
    warmed = [(s, *_compile_one(s, telemetry=tele, device=dev))
              for s in shapes]
    mid = dict(lin.KERNEL_CACHE_STATS)
    verified = True
    if verify:
        # each lookup must now be a hit: the slice function is resident
        for _s, _dims, _model, rerequest in warmed:
            rerequest()
        verified = lin.KERNEL_CACHE_STATS["misses"] == mid["misses"]
    rep = {
        "shapes": len(shapes),
        "compiled": mid["misses"] - before["misses"],
        "hits": mid["hits"] - before["hits"],
        "verified": bool(verified) and not k007,
        "persistent_cache": persistent,
        "wall_s": round(time.perf_counter() - t0, 6),
    }
    if k007:
        rep["k007"] = [d.message for d in k007]
    return rep


def parse_warmup_line(line: str) -> dict | None:
    """Parse the ``stream service warmup: ...`` stderr line a worker
    prints (``stream/__main__.py``) back into a report dict: the fleet
    admission gate's wire format."""
    marker = "stream service warmup:"
    if marker not in line:
        return None
    out = {}
    for tok in line.split(marker, 1)[1].split():
        if "=" not in tok:
            continue
        k, v = tok.split("=", 1)
        if v in ("true", "false"):
            out[k] = v == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out or None
