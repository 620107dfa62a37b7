"""Suite and service lint — AST checks over ``jepsen_tpu_torch/suites/*``,
``live/`` and the threaded service tiers.  The port's copy of the JAX
package's ``jepsen_tpu/analyze/suites.py``: the same codes, messages
and suppression comments, every default path resolved under
``jepsen_tpu_torch/``, and the N-codes restated over the test-map keys
the port reads in place of environment variables.

The worker loop guarantees half of the client protocol at runtime
(``invoke_op`` asserts completion types, converts crashes to :info —
core.clj:248-281), but a suite bug can still poison a history in ways no
runtime assert sees: an ``except Exception`` that converts an
indeterminate crash into a determinate ``:ok``/``:fail`` teaches the
checker a lie it can never detect (a write that "failed" but actually
applied makes a LINEARIZABLE system look broken, and vice versa).  This
module lints the suite SOURCE for those patterns before any test runs.

S-codes (stable; the JAX package documents them in
docs/analyze.md):

==== ======== ==========================================================
code severity meaning
==== ======== ==========================================================
S001 error    ``invoke`` can return None / fall off the end / return
              the invocation unchanged (must return a typed completion)
S002 error    broad/bare ``except`` in ``invoke`` converts a crash to
              ``:ok`` (a crash is indeterminate: must become ``:info``)
S003 error    broad/bare ``except`` in ``invoke`` unconditionally
              converts a crash to ``:fail`` (only sound when the op
              provably did not happen — guard the return with a test of
              the exception or ``op.f``, or complete as ``:info``)
S004 warning  ``setup``/``teardown`` (or ``open``/``close``) defined
              without its pair
S005 error    a Nemesis ``invoke`` returns a completion whose type is
              not ``info`` (core.py asserts this at runtime)
==== ======== ==========================================================

B-codes (``jepsen_tpu_torch/live/`` backends; same gate, same
suppression):

==== ======== ==========================================================
B001 error    a direct ``LiveBackend`` subclass is missing a protocol
              member (``name``/``server_argv``/``workload``) — the
              campaign runner would crash mid-matrix instead of at lint
              time
B002 error    broad/bare ``except`` anywhere in a live module whose
              handler unconditionally completes as ``:fail`` — a crash
              against a REAL process is indeterminate (the op may have
              applied before the connection died) and must become
              ``:info``
B003 error    a function writes a file and then ``os.replace``/
              ``os.rename``\\ s it without an ``fsync`` in between —
              the crash-safe journal contract (live/links.py,
              live/corpus.py) is durable-BEFORE-rename; a torn rename
              after a crash silently loses the journal
==== ======== ==========================================================

T-codes (thread/lock discipline over the service tiers —
``jepsen_tpu_torch/fleet/``, ``stream/``, ``obs/``, ``decompose/cache.py``,
``checker/bucket.py`` — via :func:`lint_thread_tier`; a multi-file
pass that roots a name-based call graph at every
``threading.Thread(target=...)`` / ``executor.submit(...)`` /
socketserver ``handle()`` and lints the thread-reachable functions):

==== ======== ==========================================================
T001 error    module/instance state mutated read-modify-write
              (``+=``, self-referential assign, check-then-act) from a
              thread-reachable function without an enclosing lock —
              the admission/env-knob race class
T002 error    ``.acquire()`` / ``fcntl.flock(LOCK_EX)`` not covered by
              try/finally-release or a context manager — an exception
              between acquire and release deadlocks every other thread
T003 error    file written under a flock-style lock without
              ``os.fsync`` before release — the next holder (or a
              crash) can observe the torn tail the lock was supposed
              to serialize
T004 error    ``obs.span(...)`` emitted from a thread-reachable
              function without the ``run=`` pin — the span attributes
              to the process-wide current run, which a multiplexing
              service may have moved by the time the span closes (the
              bucket scheduler's prep-span race)
==== ======== ==========================================================

N-codes (knob threading, package-wide — via :func:`lint_knobs`).  The
JAX package's knobs are ``JEPSEN_TPU_*`` environment variables; the
port reads none, and its knobs are test-map keys: the settings
``Linearizable.resolved`` takes from the test map (a ``TEST_MAP_KEYS``
tuple), ``lin_decompose`` and ``lin_algorithm``, and the keys
``core.prepare_test`` reads (``lint``, ``stream``, ``stream_cache``,
``device``).  Every knob key the package reads must stay reachable
from the command line and the README, and no module may read the
environment:

==== ======== ==========================================================
N001 error    a toggle key (one of a ``TEST_MAP_KEYS`` tuple, or the
              harness's ``lin_decompose``/``lint``/``stream``) is read
              by the package but never written by ``cli.py`` — the
              switch cannot be flipped per run from the command line
N002 error    a module reads the process environment (``os.environ``,
              ``os.getenv``) — the port's knobs are arguments and
              test-map keys, so an environment read is a setting no
              caller can see or pass
N003 warning  a knob key the package reads is not documented (quoted
              in backticks) in the README's port section — undocumented
              knobs rot into tribal knowledge
==== ======== ==========================================================

O-codes (``jtpu_*`` metrics contract — via :func:`lint_metrics`; the
observability surfaces must agree on which series exist):

==== ======== ==========================================================
O001 error    a ``jtpu_*`` series referenced by a consumer surface
              (``web.py``, ``tools/obs_guard.py``,
              ``obs_thresholds.json``) is registered nowhere in the
              package — the dashboard panel / guard threshold gates on
              a series that can never report
O002 warning  registered series no consumer surface references
              (aggregated into one finding) — orphans are not wrong,
              but each one is either a missing dashboard panel or dead
              instrumentation
==== ======== ==========================================================

R-codes (retry idempotency — via :func:`lint_retry`; the reconnect
layer retries automatically, so whatever it retries had better be
safe to run twice):

==== ======== ==========================================================
R001 error    a non-idempotent operation (name carries a mutation
              verb: write/put/add/enqueue/...) is retried by an
              automatic construct — a ``Backoff.run(fn)`` /
              ``with_conn(f)`` call, or a loop whose broad except
              handler silently goes around again — in a function with
              no ``"info"`` completion anywhere: a retransmitted
              mutation that already applied double-commits, and the
              history can't even say "maybe"
R002 error    a bounded retry loop whose broad except handler swallows
              the exception and whose function never re-raises after
              the loop — when the budget runs out the op silently
              becomes a no-op with no completion at all
==== ======== ==========================================================

(The model checker proves the dynamic twin of R001: MC201 is this
exact double-commit, caught by running the live shell code under the
simulated transport, ``analyze/modelcheck.py``.)

False-positive escape hatch: a line containing ``suite-lint: ok``
suppresses S/B findings anchored on it; ``threadlint: ok`` suppresses
T findings; ``knoblint: ok`` suppresses N findings,
``metriclint: ok`` O findings and ``retrylint: ok`` R findings (use
sparingly, with a comment saying why the pattern is sound).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Sequence

from .lint import Diagnostic

#: exception names whose handlers catch crashes indiscriminately
BROAD_EXCEPTS = {"Exception", "BaseException"}

SUITE_CODES = {
    "S001": "invoke must return a typed completion on every path",
    "S002": "broad except converting a crash to :ok",
    "S003": "broad except unconditionally converting a crash to :fail",
    "S004": "setup/teardown (open/close) pairing",
    "S005": "nemesis completions must be :info",
    "B001": "LiveBackend subclass missing a protocol member",
    "B002": "broad except in a live module swallowing a crash to :fail",
    "B003": "file written and renamed without fsync in between",
    "T001": "shared state mutated from a thread without its lock",
    "T002": "lock acquired without try/finally or context manager",
    "T003": "file written under flock without fsync-before-release",
    "T004": "span emitted from a thread without the run= pin",
    "N001": "toggle test-map key read but written by no cli.py flag",
    "N002": "process environment read (os.environ / os.getenv)",
    "N003": "knob key read but absent from the README's port section",
    "O001": "consumer-referenced jtpu_* series registered nowhere",
    "O002": "registered jtpu_* series no consumer surface references",
    "R001": "non-idempotent op retried automatically without "
            ":info ambiguity handling",
    "R002": "bounded retry loop swallowing the final exception",
}

#: the LiveBackend protocol members a concrete family must provide
#: (live/backend.py raises NotImplementedError for the first two; a
#: family without them dies mid-campaign, not at lint time)
LIVE_PROTOCOL = ("server_argv", "workload")


def _base_names(cls: ast.ClassDef) -> list[str]:
    out = []
    for b in cls.bases:
        try:
            out.append(ast.unparse(b))
        except Exception:  # noqa: BLE001 — exotic base exprs: skip
            pass
    return out


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        name = getattr(e, "id", getattr(e, "attr", None))
        if name in BROAD_EXCEPTS:
            return True
    return False


def _return_type_consts(ret: ast.Return) -> set:
    """Constant values passed as ``type=`` anywhere in the returned
    expression (IfExp alternatives all collected)."""
    out: set = set()
    if ret.value is None:
        return out
    for node in ast.walk(ret.value):
        if isinstance(node, ast.keyword) and node.arg == "type":
            for c in ast.walk(node.value):
                if isinstance(c, ast.Constant):
                    out.add(c.value)
    return out


def _always_exits(body: Sequence[ast.stmt]) -> bool:
    """Conservative: does this statement list definitely end in a
    return/raise on every path?  Uncertain constructs answer False at
    the leaf but callers only flag when the WHOLE body is certain to
    fall through — so uncertainty never produces a finding, only
    misses one."""
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Return, ast.Raise)):
        return True
    if isinstance(last, ast.If):
        return bool(last.orelse) and _always_exits(last.body) \
            and _always_exits(last.orelse)
    if isinstance(last, ast.Try):
        handlers_exit = all(_always_exits(h.body)
                            for h in last.handlers) if last.handlers \
            else True
        body_exit = _always_exits(last.orelse) if last.orelse \
            else _always_exits(last.body)
        final_exit = _always_exits(last.finalbody) if last.finalbody \
            else False
        return final_exit or (body_exit and handlers_exit)
    if isinstance(last, ast.With):
        return _always_exits(last.body)
    if isinstance(last, ast.While):
        # while True with no top-level break never falls through
        is_true = isinstance(last.test, ast.Constant) and \
            bool(last.test.value)
        has_break = any(isinstance(n, ast.Break)
                        for n in ast.walk(last)
                        if not isinstance(n, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)))
        return is_true and not has_break
    return False


def _own_returns(fn: ast.FunctionDef) -> list[ast.Return]:
    """Return statements belonging to ``fn`` itself (nested defs
    excluded — suites wrap invoke bodies in closures)."""
    out: list[ast.Return] = []

    def prune_walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Return):
                out.append(child)
            prune_walk(child)

    prune_walk(fn)
    return out


def _assigned_names(fn: ast.FunctionDef) -> set:
    names: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


def _handler_unguarded_returns(handler: ast.ExceptHandler
                               ) -> list[ast.Return]:
    """Returns sitting at the handler body's top level (not nested under
    an If/Try that could be testing the exception or the op)."""
    return [s for s in handler.body if isinstance(s, ast.Return)]


def _handler_raises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def lint_source(src: str, filename: str = "<string>"
                ) -> list[Diagnostic]:
    """Lint one suite module's source.  Returns Diagnostics whose
    ``index`` is the 1-based source LINE."""
    diags: list[Diagnostic] = []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Diagnostic("S001", "error",
                           f"{filename}: does not parse: {e}",
                           index=e.lineno)]
    lines = src.splitlines()

    def suppressed(lineno: int | None) -> bool:
        if lineno is None or not 1 <= lineno <= len(lines):
            return False
        return "suite-lint: ok" in lines[lineno - 1]

    def add(code, sev, msg, lineno, **kw):
        if not suppressed(lineno):
            diags.append(Diagnostic(code, sev, f"{filename}:{lineno}: "
                                    f"{msg}", index=lineno, **kw))

    for cls in [n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)]:
        bases = _base_names(cls)
        is_client = any(b.endswith("Client") for b in bases) or (
            cls.name.endswith("Client") and not bases)
        is_nemesis = any(b.endswith("Nemesis") for b in bases)
        is_db = any(b.endswith("DB") or b.endswith("db_mod.DB")
                    for b in bases)
        methods = {m.name: m for m in cls.body
                   if isinstance(m, ast.FunctionDef)}

        # --- S004: lifecycle pairing ------------------------------------
        # DB classes own node state: a setup without a teardown leaks it
        # across runs.  CLIENT setup-without-teardown is idiomatic here
        # (logical state is wiped by the DB teardown), so clients are
        # only checked for the connection pair (open without close).
        if is_db:
            for a, b in (("setup", "teardown"),):
                if (a in methods) != (b in methods):
                    have, miss = (a, b) if a in methods else (b, a)
                    add("S004", "warning",
                        f"{cls.name} defines {have}() without {miss}() "
                        f"(lifecycle pairing — state made in one phase "
                        f"should be unmade in its pair)",
                        methods[have].lineno)
        elif is_client and "open" in methods and "close" not in methods:
            # only flag when open() plausibly acquires a resource (it
            # does more than construct-and-return)
            opens = methods["open"]
            if len(opens.body) > 1:
                add("S004", "warning",
                    f"{cls.name} defines open() that builds client "
                    f"state but no close() — if open() acquires a "
                    f"connection or server-side session it leaks on "
                    f"every crash/reopen cycle", opens.lineno)

        if not (is_client or is_nemesis) or "invoke" not in methods:
            continue
        fn = methods["invoke"]
        args = [a.arg for a in fn.args.args]
        op_name = args[2] if len(args) > 2 else "op"
        reassigned = _assigned_names(fn)
        returns = _own_returns(fn)

        # --- S001: every return is a typed completion -------------------
        for ret in returns:
            if ret.value is None or (isinstance(ret.value, ast.Constant)
                                     and ret.value.value is None):
                add("S001", "error",
                    f"{cls.name}.invoke returns None — it must return "
                    f"a completion Op with type ok/fail/info",
                    ret.lineno)
            elif isinstance(ret.value, ast.Name) and \
                    ret.value.id == op_name and op_name not in reassigned:
                add("S001", "error",
                    f"{cls.name}.invoke returns the invocation "
                    f"unchanged — complete it with an explicit type",
                    ret.lineno)
        if not _always_exits(fn.body):
            add("S001", "error",
                f"{cls.name}.invoke can fall off the end (implicit "
                f"None) — every path must return a typed completion "
                f"or raise", fn.lineno)

        # --- S005: nemesis completions are :info ------------------------
        if is_nemesis:
            for ret in returns:
                consts = _return_type_consts(ret)
                bad = consts - {"info"}
                if bad:
                    add("S005", "error",
                        f"{cls.name}.invoke returns type={sorted(bad)!r}"
                        f" — nemesis completions must be :info "
                        f"(core.py asserts this at runtime)",
                        ret.lineno)
            continue  # S002/S003 are about client determinism

        # --- S002/S003: crash-to-determinate conversion -----------------
        for handler in [n for n in ast.walk(fn)
                        if isinstance(n, ast.ExceptHandler)]:
            if not _is_broad(handler):
                continue
            for ret in [r for r in returns
                        if handler.lineno <= r.lineno <=
                        (handler.end_lineno or r.lineno)]:
                consts = _return_type_consts(ret)
                if "ok" in consts:
                    add("S002", "error",
                        f"{cls.name}.invoke converts a broad-except "
                        f"crash to :ok — a crash is indeterminate and "
                        f"must complete as :info",
                        ret.lineno)
            if _handler_raises(handler):
                continue  # narrow cases re-raised: the rest is vetted
            for ret in _handler_unguarded_returns(handler):
                consts = _return_type_consts(ret)
                if consts == {"fail"}:
                    add("S003", "error",
                        f"{cls.name}.invoke unconditionally converts a "
                        f"broad-except crash to :fail — :fail asserts "
                        f"the op definitely did NOT happen; guard on "
                        f"the exception/op.f or complete as :info",
                        ret.lineno)
    return diags


def _fn_calls(fn: ast.FunctionDef) -> list[ast.Call]:
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            out.append(node)
    return out


def _call_name(c: ast.Call) -> str:
    try:
        return ast.unparse(c.func)
    except Exception:  # noqa: BLE001 — exotic callee exprs
        return ""


def lint_live_source(src: str, filename: str = "<string>"
                     ) -> list[Diagnostic]:
    """B-code lint for one ``jepsen_tpu_torch/live/`` module (run on top of
    :func:`lint_source`, whose Client/Nemesis S-codes apply to live
    wire shims unchanged)."""
    diags: list[Diagnostic] = []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Diagnostic("B001", "error",
                           f"{filename}: does not parse: {e}",
                           index=e.lineno)]
    lines = src.splitlines()

    def suppressed(lineno: int | None) -> bool:
        if lineno is None or not 1 <= lineno <= len(lines):
            return False
        return "suite-lint: ok" in lines[lineno - 1]

    def add(code, msg, lineno):
        if not suppressed(lineno):
            diags.append(Diagnostic(code, "error",
                                    f"{filename}:{lineno}: {msg}",
                                    index=lineno))

    classes = [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]

    # --- B001: LiveBackend protocol conformance ----------------------
    # A class that SETS a family `name` declares itself a concrete
    # campaign family: it must define (or inherit through an in-file
    # base chain) the protocol members LiveBackend only raises for.
    # Classes without `name` are abstract intermediates (e.g. the
    # replicated consensus core) and are exempt; chains through bases
    # defined in other modules are unprovable here and skipped.
    by_name = {c.name: c for c in classes}

    def own(cls):
        members = {m.name for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        assigns = {t.id for m in cls.body if isinstance(m, ast.Assign)
                   for t in m.targets if isinstance(t, ast.Name)}
        assigns |= {m.target.id for m in cls.body
                    if isinstance(m, ast.AnnAssign)
                    and isinstance(m.target, ast.Name)
                    and m.value is not None}
        return members, assigns

    def chain_has(cls, member: str):
        """True / False / None (= unprovable) walking in-file bases,
        stopping at LiveBackend (whose defs just raise)."""
        seen = set()
        stack = [cls]
        unprovable = False
        while stack:
            c = stack.pop()
            if c.name in seen:
                continue
            seen.add(c.name)
            if c.name != "LiveBackend" and member in own(c)[0]:
                return True
            for b in _base_names(c):
                leaf = b.split(".")[-1]
                if leaf == "LiveBackend":
                    continue
                if leaf in by_name:
                    stack.append(by_name[leaf])
                else:
                    unprovable = True
        return None if unprovable else False

    def is_backend(cls) -> bool:
        seen = set()
        stack = [cls]
        while stack:
            c = stack.pop()
            if c.name in seen:
                continue
            seen.add(c.name)
            for b in _base_names(c):
                leaf = b.split(".")[-1]
                if leaf == "LiveBackend":
                    return True
                if leaf in by_name:
                    stack.append(by_name[leaf])
        return False

    for cls in classes:
        if not is_backend(cls):
            continue
        members, assigns = own(cls)
        if "name" not in assigns:
            if all(m in members for m in LIVE_PROTOCOL):
                add("B001",
                    f"{cls.name} implements the LiveBackend protocol "
                    f"but does not set `name` — campaign cell keys "
                    f"would collide on '?'", cls.lineno)
            continue  # no name: an abstract intermediate
        for req in LIVE_PROTOCOL:
            if chain_has(cls, req) is False:
                add("B001",
                    f"{cls.name} subclasses LiveBackend but neither "
                    f"defines nor inherits {req}() — the campaign "
                    f"runner would raise NotImplementedError "
                    f"mid-matrix", cls.lineno)

    # --- B002: crash swallowed into :fail anywhere in a live module --
    # The S003 beat covers *Client.invoke; live modules also complete
    # ops in helpers and ported shims, where the same conversion is the
    # same lie (a crash against a real process may have applied).
    client_invokes = set()
    for cls in classes:
        bases = _base_names(cls)
        is_client = any(b.endswith("Client") for b in bases) or (
            cls.name.endswith("Client") and not bases)
        if is_client:
            for m in cls.body:
                if isinstance(m, ast.FunctionDef) and \
                        m.name == "invoke":
                    client_invokes.add(id(m))
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)]:
        if id(fn) in client_invokes:
            continue  # S003's beat — don't double-report
        for handler in [n for n in ast.walk(fn)
                        if isinstance(n, ast.ExceptHandler)]:
            if not _is_broad(handler) or _handler_raises(handler):
                continue
            for ret in _handler_unguarded_returns(handler):
                if _return_type_consts(ret) == {"fail"}:
                    add("B002",
                        f"{fn.name}() unconditionally converts a "
                        f"broad-except crash to :fail — against a real "
                        f"process the op may have applied; complete as "
                        f":info or guard on the exception", ret.lineno)

    # --- B003: rename without fsync ----------------------------------
    # The journal contract (live/links.py rules.jsonl, live/corpus.py
    # pool.jsonl, oplog.py): bytes are durable BEFORE the rename
    # publishes them.  Flag any function that opens a file for writing
    # and renames/replaces one without an os.fsync between.
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef)]:
        calls = _fn_calls(fn)
        renames = [c for c in calls
                   if _call_name(c) in ("os.replace", "os.rename")]
        if not renames:
            continue
        writes = []
        for c in calls:
            if _call_name(c) != "open" or len(c.args) < 2:
                continue
            mode = c.args[1]
            if isinstance(mode, ast.Constant) and \
                    isinstance(mode.value, str) and \
                    ("w" in mode.value or "a" in mode.value):
                writes.append(c)
        if not writes:
            continue
        fsyncs = [c for c in calls if _call_name(c) == "os.fsync"]
        for rn in renames:
            covered = any(w.lineno < f.lineno < rn.lineno
                          for w in writes for f in fsyncs)
            if not covered:
                add("B003",
                    f"{fn.name}() writes a file and then "
                    f"{_call_name(rn)}()s without an os.fsync in "
                    f"between — a crash can publish a torn or empty "
                    f"journal (durable-before-rename contract)",
                    rn.lineno)
    return diags


def lint_file(path: str | Path) -> list[Diagnostic]:
    p = Path(path)
    src = p.read_text()
    diags = lint_source(src, filename=str(p))
    if p.parent.name == "live":
        diags = diags + lint_live_source(src, filename=str(p))
    return diags


def lint_paths(paths: Sequence[str | Path] | None = None
               ) -> dict[str, list[Diagnostic]]:
    """Lint suite files.  ``paths`` may mix files and directories;
    default: the bundled ``jepsen_tpu_torch/suites`` AND
    ``jepsen_tpu_torch/live``
    (files under a ``live`` directory additionally get the B-code
    backend lint).  Returns {filename: diagnostics} for files with
    findings only."""
    if not paths:
        pkg = Path(__file__).resolve().parent.parent
        paths = [pkg / "suites", pkg / "live"]
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.glob("*.py")))
        else:
            files.append(p)
    out: dict[str, list[Diagnostic]] = {}
    for f in files:
        diags = lint_file(f)
        if diags:
            out[str(f)] = diags
    return out


# ---------------------------------------------------------------------------
# T-codes — thread/lock discipline over the service tiers
# ---------------------------------------------------------------------------
#
# The fleet/stream tiers grew threads fast: socketserver
# connection handlers, probe/pump/reaper loops, the bucket scheduler's
# prep pipeline.  The races they invite (unlocked read-modify-write of
# admission state, env-knob caches, span attribution to a moved
# current-run) are exactly the ones the runtime gates can't see — a
# torn counter doesn't fail a bench.  This pass is deliberately
# tier-LEVEL, not file-level: thread reachability crosses files (a
# router handler thread calls into admission.py), so the call graph is
# built over the whole tier at once, name-based and over-approximate
# (a lint, not an alias analysis).

#: the default tier: every package that runs code on threads, relative
#: to the jepsen_tpu_torch package root
THREAD_TIER = ("fleet", "stream", "obs", "decompose/cache.py",
               "checker/bucket.py")

#: substrings marking a with-item's context expr as a lock
_LOCKISH = ("lock", "mutex", "locked")

#: method names too generic to be call-graph edges — ``self._runs.get``
#: must not make every function named ``get`` thread-reachable (the
#: name-based graph has no receiver types, so ubiquitous
#: container/stdlib names are excluded from edges entirely)
_GENERIC_NAMES = frozenset({
    "get", "put", "set", "add", "pop", "append", "extend", "update",
    "clear", "copy", "close", "open", "read", "write", "send", "recv",
    "start", "join", "submit", "result", "items", "keys", "values",
    "setdefault", "discard", "remove", "insert", "index", "count",
    "inc", "observe", "acquire", "release", "wait", "notify", "run",
})


def _is_lockish(expr: str) -> bool:
    e = expr.lower()
    return any(t in e for t in _LOCKISH)


def _last_seg(expr_str: str) -> str:
    return expr_str.split(".")[-1].split("(")[0].strip()


def _target_name(node) -> str | None:
    """Callable-reference name: ``Name`` / ``Attribute`` last segment."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class _FnInfo:
    __slots__ = ("node", "filename", "lines", "cls")

    def __init__(self, node, filename, lines, cls=None):
        self.node = node
        self.filename = filename
        self.lines = lines
        self.cls = cls


def thread_tier_files() -> list[Path]:
    pkg = Path(__file__).resolve().parent.parent
    files: list[Path] = []
    for rel in THREAD_TIER:
        p = pkg / rel
        if p.is_dir():
            files.extend(sorted(p.glob("*.py")))
        elif p.exists():
            files.append(p)
    return files


def _index_tier(files: Sequence[Path]):
    """One parse pass: function defs by bare name, thread-root names,
    and the name-based call graph."""
    fns: dict[str, list[_FnInfo]] = {}
    roots: set[str] = set()
    calls: dict[int, set[str]] = {}  # id(fn node) -> callee names
    trees = []
    for path in files:
        src = Path(path).read_text()
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError:
            continue
        lines = src.splitlines()
        trees.append((path, tree, lines))
        # class membership for handler-root detection
        cls_of: dict[int, ast.ClassDef] = {}
        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            for m in cls.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    cls_of[id(m)] = cls
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]:
            info = _FnInfo(fn, str(path), lines, cls_of.get(id(fn)))
            fns.setdefault(fn.name, []).append(info)
            callees = set()
            for c in [n for n in ast.walk(fn)
                      if isinstance(n, ast.Call)]:
                leaf = _last_seg(_call_name(c))
                if leaf and leaf not in _GENERIC_NAMES:
                    callees.add(leaf)
            calls[id(fn)] = callees
        for c in [n for n in ast.walk(tree) if isinstance(n, ast.Call)]:
            cname = _call_name(c)
            leaf = _last_seg(cname)
            if leaf == "Thread":
                for kw in c.keywords:
                    if kw.arg == "target":
                        t = _target_name(kw.value)
                        if t:
                            roots.add(t)
            elif leaf == "submit" and c.args:
                t = _target_name(c.args[0])
                if t:
                    roots.add(t)
        # socketserver: ThreadingTCPServer runs each connection's
        # handler on its own thread — handle() is a thread root
        for cls in [n for n in ast.walk(tree)
                    if isinstance(n, ast.ClassDef)]:
            if any("RequestHandler" in b for b in _base_names(cls)):
                for m in cls.body:
                    if isinstance(m, ast.FunctionDef) and \
                            m.name == "handle":
                        roots.add("handle")
    return fns, roots, calls, trees


def _reachable_names(fns, roots, calls) -> set[str]:
    seen: set[str] = set()
    stack = [r for r in roots if r in fns]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        for info in fns[name]:
            for callee in calls.get(id(info.node), ()):
                if callee in fns and callee not in seen:
                    stack.append(callee)
    return seen


def _fn_call_edges(fn) -> list[tuple[str, bool]]:
    """(callee name, call site is inside a lock context) for every
    call in ``fn`` — the raw material for the caller-holds-lock
    fixpoint (a function whose every in-tier call site holds a lock is
    as protected as one that takes the lock itself)."""
    out: list[tuple[str, bool]] = []

    def exprs_calls(node, in_lock):
        if node is None:
            return
        for c in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
            leaf = _last_seg(_call_name(c))
            if leaf and leaf not in _GENERIC_NAMES:
                out.append((leaf, in_lock))

    def scan(stmts, in_lock):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                locky = False
                for it in st.items:
                    exprs_calls(it.context_expr, in_lock)
                    try:
                        locky = locky or _is_lockish(
                            ast.unparse(it.context_expr))
                    except Exception:  # noqa: BLE001
                        pass
                scan(st.body, in_lock or locky)
            elif isinstance(st, ast.Try):
                scan(st.body, in_lock)
                for h in st.handlers:
                    scan(h.body, in_lock)
                scan(st.orelse, in_lock)
                scan(st.finalbody, in_lock)
            elif isinstance(st, ast.If):
                exprs_calls(st.test, in_lock)
                scan(st.body, in_lock)
                scan(st.orelse, in_lock)
            elif isinstance(st, ast.While):
                exprs_calls(st.test, in_lock)
                scan(st.body, in_lock)
                scan(st.orelse, in_lock)
            elif isinstance(st, (ast.For, ast.AsyncFor)):
                exprs_calls(st.iter, in_lock)
                scan(st.body, in_lock)
                scan(st.orelse, in_lock)
            else:
                exprs_calls(st, in_lock)

    scan(fn.body, False)
    return out


def _lock_covered(fns, roots, edges: list[tuple[str, str, bool]]
                  ) -> set[str]:
    """Greatest fixpoint of "every in-tier call site holds a lock":
    start from every called name, drop thread roots (they start on a
    bare thread), then drop any callee with an unlocked call site from
    an uncovered caller, until stable."""
    covered = {callee for _, callee, _ in edges} - set(roots)
    changed = True
    while changed:
        changed = False
        for caller, callee, locked in edges:
            if callee in covered and not locked \
                    and caller not in covered:
                covered.discard(callee)
                changed = True
    return covered


def _is_acquire(call: ast.Call) -> bool:
    name = _call_name(call)
    if name.endswith(".acquire"):
        return True
    if _last_seg(name) == "flock":
        return any("LOCK_EX" in ast.unparse(a) for a in call.args)
    return False


def _try_releases(node: ast.Try) -> bool:
    for st in node.finalbody:
        for c in [n for n in ast.walk(st) if isinstance(n, ast.Call)]:
            name = _call_name(c)
            if name.endswith(".release") or (
                    _last_seg(name) == "flock"
                    and any("LOCK_UN" in ast.unparse(a)
                            for a in c.args)):
                return True
    return False


def _scan_thread_fn(info: _FnInfo, reachable: bool, add, *,
                    covered: bool = False) -> None:
    """Walk one function's statements tracking lock context; emit
    T001/T002/T003/T004 through ``add(code, msg, lineno)``.
    ``covered`` means every in-tier call site holds a lock, so the
    T001 shared-state checks are moot."""
    fn = info.node
    global_names = {n for node in ast.walk(fn)
                    if isinstance(node, ast.Global) for n in node.names}
    # T002 release heuristic is function-scoped: a lock taken in one
    # branch and released in an enclosing finally (depth-counted CMs
    # like VerdictCache._locked) is disciplined even though the
    # acquire's own statement list has no Try sibling
    fn_releases = any(_try_releases(t) for t in ast.walk(fn)
                      if isinstance(t, ast.Try))

    def stmt_calls(st):
        return [n for n in ast.walk(st) if isinstance(n, ast.Call)]

    def is_shared_target(t) -> tuple[bool, str]:
        """(is shared state, display name) — instance/class attrs and
        declared-global module names; subscripts of those too."""
        if isinstance(t, ast.Subscript):
            return is_shared_target(t.value)
        if isinstance(t, ast.Attribute):
            try:
                return True, ast.unparse(t)
            except Exception:  # noqa: BLE001
                return True, t.attr
        if isinstance(t, ast.Name) and t.id in global_names:
            return True, t.id
        return False, ""

    def check_t001(st, in_lock, if_tests):
        if not reachable or in_lock or covered:
            return
        if isinstance(st, ast.AugAssign):
            shared, name = is_shared_target(st.target)
            if shared:
                add("T001",
                    f"{fn.name}() read-modify-writes {name} from a "
                    f"thread-reachable path without holding a lock — "
                    f"concurrent updates lose increments", st.lineno)
            return
        if isinstance(st, ast.Assign) and len(st.targets) == 1:
            shared, name = is_shared_target(st.targets[0])
            if not shared:
                return
            try:
                val = ast.unparse(st.value)
            except Exception:  # noqa: BLE001
                val = ""
            rmw = name in val
            check_act = any(name in test for test in if_tests)
            if rmw or check_act:
                how = ("self-referential assign" if rmw
                       else "check-then-act")
                add("T001",
                    f"{fn.name}() {how} on {name} from a "
                    f"thread-reachable path without holding a lock — "
                    f"two threads can interleave between read and "
                    f"write", st.lineno)

    def check_t004(st, in_lock):
        if not reachable:
            return
        for c in stmt_calls(st):
            if _last_seg(_call_name(c)) != "span":
                continue
            if not any(kw.arg == "run" for kw in c.keywords):
                add("T004",
                    f"{fn.name}() emits a span from a thread-reachable "
                    f"path without the run= pin — it attributes to the "
                    f"process-wide current run, which another thread "
                    f"may have moved", c.lineno)

    def check_t003_with(st: ast.With | ast.AsyncWith):
        """Write under a flock-style lock without fsync before the
        lock releases at the with-exit."""
        ctxs = []
        for it in st.items:
            try:
                ctxs.append(ast.unparse(it.context_expr))
            except Exception:  # noqa: BLE001
                pass
        if not any("flock" in c.lower() or "locked" in c.lower()
                   for c in ctxs):
            return
        writes = []
        has_fsync = False
        for sub in st.body:
            for c in stmt_calls(sub):
                name = _call_name(c)
                if name.endswith((".write", ".writelines")):
                    writes.append(c)
                if _last_seg(name) == "fsync":
                    has_fsync = True
        if writes and not has_fsync:
            add("T003",
                f"{fn.name}() writes a file under {ctxs[0]} without "
                f"os.fsync before the lock releases — the next holder "
                f"(or a crash) can observe the torn tail the lock was "
                f"meant to serialize", writes[0].lineno)

    def scan(stmts, in_lock, if_tests, protected):
        for i, st in enumerate(stmts):
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs are their own entries
            # T002: bare acquire must be covered by try/finally
            acquires = [c for c in stmt_calls(st)
                        if isinstance(st, ast.Expr) and _is_acquire(c)]
            for c in acquires:
                nxt = stmts[i + 1] if i + 1 < len(stmts) else None
                ok = protected or fn_releases or (
                    isinstance(nxt, ast.Try) and _try_releases(nxt))
                if not ok:
                    add("T002",
                        f"{fn.name}() acquires a lock with no "
                        f"try/finally release and no context manager "
                        f"— an exception here deadlocks every other "
                        f"thread", c.lineno)
            if isinstance(st, (ast.With, ast.AsyncWith)):
                locky = any(_is_lockish(ast.unparse(it.context_expr))
                            for it in st.items)
                check_t003_with(st)
                check_t004(st, in_lock)
                scan(st.body, in_lock or locky, if_tests, protected)
            elif isinstance(st, ast.Try):
                body_protected = protected or _try_releases(st)
                scan(st.body, in_lock, if_tests, body_protected)
                for h in st.handlers:
                    scan(h.body, in_lock, if_tests, protected)
                scan(st.orelse, in_lock, if_tests, protected)
                scan(st.finalbody, in_lock, if_tests, protected)
            elif isinstance(st, ast.If):
                try:
                    test = ast.unparse(st.test)
                except Exception:  # noqa: BLE001
                    test = ""
                scan(st.body, in_lock, if_tests + [test], protected)
                scan(st.orelse, in_lock, if_tests, protected)
            elif isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                scan(st.body, in_lock, if_tests, protected)
                scan(st.orelse, in_lock, if_tests, protected)
            else:
                check_t001(st, in_lock, if_tests)
                check_t004(st, in_lock)

    scan(fn.body, False, [], False)


def lint_thread_tier(paths: Sequence[str | Path] | None = None
                     ) -> dict[str, list[Diagnostic]]:
    """The T-code pass: build the tier-wide call graph, mark
    thread-reachable functions, lint them for lock discipline.
    Returns {filename: diagnostics} for files with findings only."""
    files = ([Path(p) for p in paths] if paths
             else thread_tier_files())
    all_files: list[Path] = []
    for p in files:
        if p.is_dir():
            all_files.extend(sorted(p.glob("*.py")))
        else:
            all_files.append(p)
    fns, roots, calls, _trees = _index_tier(all_files)
    reachable = _reachable_names(fns, roots, calls)
    edges = [(name, callee, locked)
             for name, infos in fns.items()
             for info in infos
             for callee, locked in _fn_call_edges(info.node)
             if callee in fns]
    covered = _lock_covered(fns, roots, edges)
    out: dict[str, list[Diagnostic]] = {}
    for name, infos in fns.items():
        for info in infos:
            lines = info.lines

            def add(code, msg, lineno, _info=info, _lines=lines):
                # line suppression, or a whole-function suppression on
                # the def line or in the contiguous comment block just
                # above it — single-owner-thread functions document
                # their ownership argument once, not per statement
                cand = [lineno, _info.node.lineno]
                ln = _info.node.lineno - 1
                while 1 <= ln <= len(_lines) \
                        and _lines[ln - 1].lstrip().startswith("#"):
                    cand.append(ln)
                    ln -= 1
                for ln in cand:
                    if 1 <= ln <= len(_lines) and \
                            "threadlint: ok" in _lines[ln - 1]:
                        return
                out.setdefault(_info.filename, []).append(Diagnostic(
                    code, "error", f"{_info.filename}:{lineno}: {msg}",
                    index=lineno))
            _scan_thread_fn(info, name in reachable, add,
                            covered=name in covered)
    for f in out:
        out[f].sort(key=lambda d: d.index or 0)
    return out


# ---------------------------------------------------------------------------
# N-codes — knob threading (package-wide), over test-map keys
# ---------------------------------------------------------------------------
#
# The JAX package's pass locates every os.environ read of a JEPSEN_TPU_*
# literal and checks it against cli.py and docs/*.md.  The port reads no
# environment: its knobs are test-map keys that the CLI's flags write.
# This pass rebuilds the same contract over them: every read of a knob
# key is located (``test.get("k")``, ``test["k"]`` and ``"k" in test`` on
# a receiver named ``test`` or ``opts``, and each literal of a
# ``TEST_MAP_KEYS`` tuple, which ``Linearizable.resolved`` reads in a
# loop), then checked against cli.py and the README's port section; an
# environment read anywhere is an error of its own.  Name-based and
# literal-only by design, as the reference's.

#: the harness's switches beside the ``TEST_MAP_KEYS`` tuples:
#: ``Linearizable.resolved`` reads ``lin_decompose``, ``core.prepare_test``
#: reads ``lint`` and ``stream``
HARNESS_TOGGLES = ("lin_decompose", "lint", "stream")

#: knob keys that carry a value rather than a switch (the route, the
#: stream's verdict cache, the device): read and documented, but no
#: flag is required (the reference's plain, non-toggle knobs)
VALUE_KNOBS = ("lin_algorithm", "stream_cache", "device")

#: the name of a tuple whose literals are toggle keys the module reads
TOGGLE_TUPLE = "TEST_MAP_KEYS"

#: the README heading that opens the port's section (to the next ``## ``)
README_PORT_HEADING = "## The PyTorch/CUDA port"

_KNOB_RECEIVER = re.compile(r"\b(test|opts)\b")


def _str_const(n) -> str | None:
    if isinstance(n, ast.Constant) and isinstance(n.value, str):
        return n.value
    return None


def _toggle_tuples(tree) -> list[tuple[str, int]]:
    """``(key, lineno)`` for each literal of a ``TEST_MAP_KEYS = (...)``
    assignment (module or class level)."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == TOGGLE_TUPLE
                for t in n.targets) \
                and isinstance(n.value, (ast.Tuple, ast.List)):
            for e in n.value.elts:
                k = _str_const(e)
                if k is not None:
                    out.append((k, e.lineno))
    return out


def _knob_read(node, knobs) -> str | None:
    """The key when ``node`` READS a knob key from the test map or the
    CLI options (``.get``, a Load subscript, an ``in`` test), else
    None.  Writes (assignment, ``setdefault``, ``pop``) are not reads."""
    def on_receiver(key, recv) -> str | None:
        if key in knobs and _KNOB_RECEIVER.search(ast.unparse(recv)):
            return key
        return None

    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        return on_receiver(_str_const(node.args[0]), node.func.value)
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        return on_receiver(_str_const(node.slice), node.value)
    if isinstance(node, ast.Compare) and len(node.ops) == 1 \
            and isinstance(node.ops[0], (ast.In, ast.NotIn)):
        return on_receiver(_str_const(node.left), node.comparators[0])
    return None


def _env_access(node) -> bool:
    """``os.environ`` / ``os.getenv`` (or either imported from os)."""
    if isinstance(node, ast.Attribute) \
            and node.attr in ("environ", "getenv") \
            and isinstance(node.value, ast.Name) and node.value.id == "os":
        return True
    return isinstance(node, ast.ImportFrom) and node.module == "os" \
        and any(a.name in ("environ", "getenv") for a in node.names)


def _package_py_files(pkg_root: Path) -> list[Path]:
    return sorted(p for p in pkg_root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _readme_port_section(readme: Path) -> str:
    if not readme.exists():
        return ""
    text = readme.read_text()
    at = text.find(README_PORT_HEADING)
    if at < 0:
        return ""
    end = text.find("\n## ", at + len(README_PORT_HEADING))
    return text[at:] if end < 0 else text[at:end]


def lint_knobs(pkg_root: str | Path | None = None,
               cli_text: str | None = None,
               docs_text: str | None = None
               ) -> dict[str, list[Diagnostic]]:
    """The N-code knob-threading lint over every module in the
    package.  ``cli_text``/``docs_text`` are injectable for tests;
    defaults read the package's ``cli.py`` and the README's port
    section (``README_PORT_HEADING`` up to the next ``## `` heading)
    from the repo root.  Returns {filename: diagnostics} for files with
    findings only; a line containing ``knoblint: ok`` suppresses
    findings anchored on it."""
    pkg = Path(pkg_root) if pkg_root else \
        Path(__file__).resolve().parent.parent
    if cli_text is None:
        cli = pkg / "cli.py"
        cli_text = cli.read_text() if cli.exists() else ""
    if docs_text is None:
        docs_text = _readme_port_section(pkg.parent / "README.md")

    parsed = []
    for f in _package_py_files(pkg):
        src = f.read_text()
        try:
            parsed.append((f, ast.parse(src, filename=str(f)),
                           src.splitlines()))
        except SyntaxError:
            continue  # the S-lint owns parse errors
    toggles = set(HARNESS_TOGGLES)
    for _f, tree, _lines in parsed:
        toggles.update(k for k, _ in _toggle_tuples(tree))
    knobs = toggles | set(VALUE_KNOBS)

    def written(name) -> bool:
        return f'"{name}"' in cli_text or f"'{name}'" in cli_text

    out: dict[str, list[Diagnostic]] = {}
    documented: set[str] = set()  # first-anchor dedup for N003
    for f, tree, lines in parsed:
        def suppressed(lineno, _lines=lines):
            return (lineno is not None and 1 <= lineno <= len(_lines)
                    and "knoblint: ok" in _lines[lineno - 1])

        reads = _toggle_tuples(tree) + [
            (k, n.lineno) for n in ast.walk(tree)
            if (k := _knob_read(n, knobs)) is not None]
        diags: list[Diagnostic] = []
        for n in ast.walk(tree):
            if _env_access(n) and not suppressed(n.lineno):
                diags.append(Diagnostic(
                    "N002", "error",
                    f"{f}:{n.lineno}: reads the process environment — "
                    f"the port's knobs are arguments and test-map keys, "
                    f"so this setting is one no caller can see or pass",
                    index=n.lineno))
        for name, lineno in sorted(reads, key=lambda r: r[1]):
            if suppressed(lineno):
                continue
            if name in toggles and not written(name):
                diags.append(Diagnostic(
                    "N001", "error",
                    f"{f}:{lineno}: toggle key {name!r} is read here but "
                    f"never written by cli.py — the switch cannot be "
                    f"flipped per run from the command line",
                    index=lineno))
            if f"`{name}`" not in docs_text and name not in documented:
                documented.add(name)
                diags.append(Diagnostic(
                    "N003", "warning",
                    f"{f}:{lineno}: knob key {name!r} is read here but "
                    f"documented nowhere in the README's port section",
                    index=lineno))
        if diags:
            diags.sort(key=lambda d: d.index or 0)
            out[str(f)] = diags
    return out


# ---------------------------------------------------------------------------
# O-codes — jtpu_* metrics contract (registration vs consumer surfaces)
# ---------------------------------------------------------------------------

#: consumer surfaces, relative to the REPO root (pkg_root.parent):
#: the dashboard, the scrape guard, and the alert thresholds — a
#: series one of these names must exist, or the panel/threshold gates
#: on nothing
METRIC_CONSUMERS = ("jepsen_tpu_torch/web.py", "tools/obs_guard.py",
                    "obs_thresholds.json")

_METRIC_RE = re.compile(r"\bjtpu_[a-z0-9_]+\b")

#: prometheus exposition suffixes a histogram/counter family implies —
#: a consumer referencing jtpu_x_seconds_bucket is consuming the
#: registered jtpu_x_seconds
_METRIC_SUFFIXES = ("_bucket", "_sum", "_count", "_total")


def registered_metrics(pkg_root: str | Path | None = None
                       ) -> dict[str, tuple]:
    """Every ``jtpu_*`` series the package registers:
    {name: (filename, lineno)} from literal first arguments of
    ``.counter(...)``/``.gauge(...)``/``.histogram(...)`` calls."""
    pkg = Path(pkg_root) if pkg_root else \
        Path(__file__).resolve().parent.parent
    out: dict[str, tuple] = {}
    for f in _package_py_files(pkg):
        src = f.read_text()
        if "jtpu_" not in src:
            continue
        try:
            tree = ast.parse(src, filename=str(f))
        except SyntaxError:
            continue
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("counter", "gauge",
                                        "histogram") \
                    and n.args and isinstance(n.args[0], ast.Constant) \
                    and isinstance(n.args[0].value, str) \
                    and n.args[0].value.startswith("jtpu_"):
                out.setdefault(n.args[0].value, (str(f), n.lineno))
    return out


def lint_metrics(pkg_root: str | Path | None = None,
                 consumers: Sequence[str | Path] | None = None
                 ) -> dict[str, list[Diagnostic]]:
    """The O-code metrics-contract lint.  ``consumers`` overrides the
    default surface list (absolute paths; for tests).  Returns
    {filename: diagnostics}; ``metriclint: ok`` on a consumer line
    suppresses O001 findings anchored on it."""
    pkg = Path(pkg_root) if pkg_root else \
        Path(__file__).resolve().parent.parent
    if consumers is None:
        consumers = [pkg.parent / c for c in METRIC_CONSUMERS]
    registered = registered_metrics(pkg)

    def base_name(name: str) -> str:
        for suf in _METRIC_SUFFIXES:
            if name.endswith(suf) and name[:-len(suf)] in registered:
                return name[:-len(suf)]
        return name

    out: dict[str, list[Diagnostic]] = {}
    referenced: set[str] = set()
    for c in consumers:
        c = Path(c)
        if not c.exists():
            continue
        diags: list[Diagnostic] = []
        seen_here: set[str] = set()
        for lineno, line in enumerate(c.read_text().splitlines(), 1):
            for m in _METRIC_RE.finditer(line):
                name = base_name(m.group(0))
                referenced.add(name)
                if name in registered or name in seen_here \
                        or "metriclint: ok" in line:
                    continue
                seen_here.add(name)
                diags.append(Diagnostic(
                    "O001", "error",
                    f"{c}:{lineno}: {m.group(0)} is referenced here "
                    f"but registered nowhere in the package — the "
                    f"panel/threshold gates on a series that can "
                    f"never report", index=lineno))
        if diags:
            out[str(c)] = diags

    orphans = sorted(set(registered) - referenced)
    if orphans:
        shown = ", ".join(orphans[:6]) + \
            (f", … ({len(orphans)} total)" if len(orphans) > 6 else "")
        f0, l0 = registered[orphans[0]]
        out.setdefault(f0, []).append(Diagnostic(
            "O002", "warning",
            f"{len(orphans)} registered jtpu_* series no consumer "
            f"surface (web.py / obs_guard / thresholds) references: "
            f"{shown}", index=l0))
    return out


# ---------------------------------------------------------------------------
# R-codes — retry idempotency (reconnect.Backoff / with_conn / retry loops)
# ---------------------------------------------------------------------------
#
# The reconnect layer makes retries AUTOMATIC: Backoff.run(fn) calls
# fn up to max_attempts times, with_conn reopens under the caller's
# loop, and ad-hoc `while ...: try: op() except Exception: continue`
# loops go around on any crash.  A retried READ is harmless.  A
# retried MUTATION that already applied on the server is a duplicate
# commit — exactly the bug the model checker's MC201 certificate
# exhibits dynamically (a timed-out ADDJOB retransmitted after its
# first copy was delivered).  The static contract this pass enforces:
# an automatically retried mutation must live in a function that can
# complete the ambiguous outcome as :info (the repo idiom — a string
# constant "info" somewhere in the function), or carry a
# ``retrylint: ok`` waiver explaining why the op is idempotent (e.g.
# a server-side reqId dedup cache).

#: identifier segments that mark a callable as a mutation — matched
#: against whole ``_``/camelCase segments, never substrings ("address"
#: does not contain the verb "add")
RETRY_MUTATION_VERBS = frozenset({
    "write", "put", "add", "addjob", "enqueue", "dequeue", "insert",
    "update", "delete", "ack", "ackjob", "cas", "commit", "post",
    "send", "execute", "push", "create", "set", "transfer", "upsert",
})

#: wrapper callables whose FIRST argument is the thing actually
#: retried — the lint digs through them one level
_RETRY_WRAPPERS = ("with_conn", "run")


def _ident_segments(name: str) -> list[str]:
    """``addJob_once`` → ["add", "job", "once"] — underscore and
    camelCase boundaries both split."""
    snake = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name)
    return [s.lower() for s in re.split(r"[_\W]+", snake) if s]


def _is_mutation_name(name: str) -> bool:
    return any(seg in RETRY_MUTATION_VERBS
               for seg in _ident_segments(name))


def _callable_names(node) -> list[tuple[str, int]]:
    """Names a retried callable argument could invoke: a bare
    Name/Attribute is itself; a Lambda is every call in its body."""
    if isinstance(node, ast.Name):
        return [(node.id, node.lineno)]
    if isinstance(node, ast.Attribute):
        return [(node.attr, node.lineno)]
    if isinstance(node, ast.Lambda):
        out = []
        for c in ast.walk(node.body):
            if isinstance(c, ast.Call):
                n = _call_name(c).split(".")[-1]
                if n:
                    out.append((n, c.lineno))
        return out
    return []


def _retried_names_in_call(call: ast.Call) -> list[tuple[str, int]]:
    """For a retry-construct call, the names of what it retries.

    ``<backoffish>.run(fn)`` and ``*.with_conn(f)`` retry their first
    argument; anything else retries nothing."""
    if not isinstance(call.func, ast.Attribute) or not call.args:
        return []
    attr = call.func.attr
    if attr == "with_conn":
        return _callable_names(call.args[0])
    if attr == "run":
        try:
            recv = ast.unparse(call.func.value).lower()
        except Exception:  # noqa: BLE001 — exotic receiver exprs
            return []
        if "backoff" in recv:
            return _callable_names(call.args[0])
    return []


def _own_stmt_nodes(root) -> list:
    """Nodes belonging to ``root`` itself — nested function/class
    bodies excluded (they get their own scan)."""
    out: list = []

    def rec(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            out.append(child)
            rec(child)

    rec(root)
    return out


def _handler_retries(handler: ast.ExceptHandler) -> bool:
    """Does this broad handler just go around the loop again?  Any
    raise/return/break anywhere in it means the loop has an explicit
    failure path — conservative: uncertainty never produces a
    finding."""
    return not any(isinstance(n, (ast.Raise, ast.Return, ast.Break))
                   for n in ast.walk(handler))


def _handler_captured(handler: ast.ExceptHandler) -> str | None:
    """The name the handler saves the exception under
    (``except Exception as e: last = e`` → "last"), or None.  A loop
    that keeps the last error is retry-shaped, and the kept name being
    USED after the loop is the non-swallowing exit path R002 wants."""
    if not handler.name:
        return None
    for n in ast.walk(handler):
        if isinstance(n, ast.Assign) \
                and isinstance(n.value, ast.Name) \
                and n.value.id == handler.name:
            for t in n.targets:
                if isinstance(t, ast.Name):
                    return t.id
    return None


def _loop_is_retry(loop) -> bool:
    """Attempt-shaped loop header: ``for attempt in range(...)``,
    ``while not bo.exhausted()``, anything mentioning the retry
    vocabulary.  Plain per-item scans (``for f in files``) are NOT
    retry loops — a broad `continue` there skips a bad item, it does
    not re-run one."""
    parts = [loop.target, loop.iter] if isinstance(loop, ast.For) \
        else [loop.test]
    try:
        header = " ".join(ast.unparse(p) for p in parts).lower()
    except Exception:  # noqa: BLE001 — exotic header exprs
        return False
    return any(k in header for k in ("attempt", "retr", "backoff",
                                     "exhaust"))


def lint_retry_source(src: str, filename: str = "<string>"
                      ) -> list[Diagnostic]:
    """R-code lint for one module's source (see the module docstring's
    R-code table).  ``retrylint: ok`` on the anchored line
    suppresses."""
    diags: list[Diagnostic] = []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError:
        return []  # the S-lint owns parse errors
    lines = src.splitlines()

    def suppressed(lineno: int | None) -> bool:
        return (lineno is not None and 1 <= lineno <= len(lines)
                and "retrylint: ok" in lines[lineno - 1])

    def add(code, msg, lineno):
        if not suppressed(lineno):
            diags.append(Diagnostic(code, "error",
                                    f"{filename}:{lineno}: {msg}",
                                    index=lineno))

    #: scan units: every function, plus the module top level
    units = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    units.append(tree)

    for fn in units:
        fn_name = getattr(fn, "name", "<module>")
        if fn_name == "run" and isinstance(fn, ast.FunctionDef):
            # Backoff.run itself IS the retry machinery — it re-raises
            # the last error internally; linting it against itself
            # would flag the mechanism, not a use of it
            continue
        own = _own_stmt_nodes(fn)
        # the repo idiom for acknowledged ambiguity: the function
        # completes (or can complete) the op as :info somewhere
        has_info = any(isinstance(n, ast.Constant) and n.value == "info"
                       for n in ast.walk(fn))

        # --- construct A: Backoff.run(fn) / with_conn(f) -------------
        for call in [n for n in own if isinstance(n, ast.Call)]:
            for name, lineno in _retried_names_in_call(call):
                if _is_mutation_name(name) and not has_info:
                    add("R001",
                        f"{fn_name}() auto-retries {name}() (reconnect "
                        f"schedule) but can never complete :info — a "
                        f"retransmitted mutation that already applied "
                        f"double-commits; complete ambiguous outcomes "
                        f"as :info or mark the op idempotent with "
                        f"`retrylint: ok`", lineno)

        # --- construct B: retry loop + try + broad handler that
        # goes around again --------------------------------------------
        for loop in [n for n in own if isinstance(n, (ast.For,
                                                      ast.While))]:
            for tr in [n for n in ast.walk(loop)
                       if isinstance(n, ast.Try)]:
                retry_handlers = [h for h in tr.handlers
                                  if _is_broad(h) and
                                  _handler_retries(h)]
                if not retry_handlers:
                    continue
                kept = [k for k in map(_handler_captured,
                                       retry_handlers) if k]
                if not _loop_is_retry(loop) and not kept:
                    continue  # a per-item scan, not a retry loop
                # R001: a mutation inside the retried try body
                if not has_info:
                    seen: set = set()
                    for c in [n for st in tr.body
                              for n in ast.walk(st)
                              if isinstance(n, ast.Call)]:
                        names = _retried_names_in_call(c) or \
                            [(_call_name(c).split(".")[-1], c.lineno)]
                        for name, lineno in names:
                            if _is_mutation_name(name) and \
                                    name not in seen:
                                seen.add(name)
                                add("R001",
                                    f"{fn_name}() retries {name}() in "
                                    f"a broad-except loop but can "
                                    f"never complete :info — a crash "
                                    f"after the op applied retries a "
                                    f"committed mutation; complete "
                                    f"ambiguous outcomes as :info or "
                                    f"waive with `retrylint: ok`",
                                    lineno)
                # R002: a bounded loop whose budget can run out with
                # the last error discarded and never re-raised
                unbounded = isinstance(loop, ast.While) and \
                    isinstance(loop.test, ast.Constant) and \
                    bool(loop.test.value)
                if unbounded:
                    continue  # while True never exits by exhaustion
                loop_end = getattr(loop, "end_lineno", loop.lineno)
                reraises_after = any(
                    isinstance(n, ast.Raise) and n.lineno > loop_end
                    for n in ast.walk(fn))
                # the kept last-error being read after the loop is the
                # other legitimate exit: completing :info/:fail WITH
                # the error instead of raising it
                kept_used = any(
                    isinstance(n, ast.Name) and n.id in kept
                    and isinstance(n.ctx, ast.Load)
                    and n.lineno > loop_end
                    for n in ast.walk(fn))
                if not reraises_after and not kept_used:
                    h0 = retry_handlers[0]
                    add("R002",
                        f"{fn_name}()'s bounded retry loop swallows "
                        f"every crash and never re-raises after the "
                        f"loop — when the budget runs out the op "
                        f"silently becomes a no-op; keep the last "
                        f"error and raise it (Backoff.run semantics)",
                        h0.lineno)
    return diags


def lint_retry(pkg_root: str | Path | None = None
               ) -> dict[str, list[Diagnostic]]:
    """The R-code retry-idempotency lint over every module in the
    package.  Returns {filename: diagnostics} for files with findings
    only; a line containing ``retrylint: ok`` suppresses findings
    anchored on it."""
    pkg = Path(pkg_root) if pkg_root else \
        Path(__file__).resolve().parent.parent
    out: dict[str, list[Diagnostic]] = {}
    for f in _package_py_files(pkg):
        src = f.read_text()
        diags = lint_retry_source(src, filename=str(f))
        if diags:
            out[str(f)] = diags
    return out
