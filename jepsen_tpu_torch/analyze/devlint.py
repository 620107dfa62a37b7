"""Device-contract lint: K007, the static cache-key model.

The JAX package's devlint stages every kernel route's jaxpr and walks it
for device-contract breaches (K001-K006); those walk JAX programs and
have no counterpart here yet.  What ports is K007: the model of which
coordinates a ``device.compile`` span must carry, so that a recorded
span alone rebuilds the exact slice function it stamped
(``fleet/warmup.py``'s warm boot reads traces through it).

The model states the port's own spans, stamped by
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

DEVLINT_CODES = {
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
