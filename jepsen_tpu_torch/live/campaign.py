"""Campaign runner — suite×nemesis cells over real backend processes.

A *campaign* executes the cross product of live backend families
(live/backend.py) and matrix nemeses (live/matrix.py), each cell a full
``core.run`` — real server processes, real faults, streaming checker on
(``--stream``), certificate audit on — and records per-cell outcomes
(verdict, certificate summary, audit, **detection latency** of the
streamed verdict relative to the first fault, **recovery time** from
kill to the next acked op) into ``store/campaigns/<ts>/``:

  cells.jsonl     one line per cell, appended as each finishes (a
                  crashed campaign keeps every completed cell)
  campaign.json   the final grid + summary

Degradation contract: a cell whose nemesis the host can't inject (no
faketime, no NET_ADMIN, no FUSE) or whose backend can't start reports
``skipped`` with the reason; an unexpected error reports ``failed``
with the traceback — the campaign always runs to completion.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import traceback

from .. import control, obs, store
from ..obs import metrics as obs_metrics
from ..stream.device import DeviceFoldError
from ..util import WorkerAbort
from . import links as links_mod
from .backend import FAMILIES, BackendStartError, LiveBackend
from .matrix import MatrixNemesis, assemble, standard_matrix

log = logging.getLogger("jepsen")

#: flight-recorder counters: watchdog escalations and finished cells by
#: status — the campaign half of the fleet-health /metrics surface
_M_WATCHDOG = obs_metrics.REGISTRY.counter(
    "jtpu_watchdog_total", "Cell watchdog events (fired/killed)",
    ("event",))
_M_CELLS = obs_metrics.REGISTRY.counter(
    "jtpu_campaign_cells_total", "Campaign cells finished, by status",
    ("status",))

#: faults the streamed checker should *detect* when crossed with a
#: volatile backend — the seeded-bug cells (the localnode volatile
#: lock's double grant under kill -9 is the reference finding; the
#: replicated cells stage consensus-level bugs: a volatile replica
#: that forgets acked writes across kill -9 and can still win an
#: election, and a split-brain leader that never steps down)
SEEDED = {
    ("lock", "kill-restart"): {"lock_volatile": True,
                               "seeded_lock": True, "hold": 4.0,
                               "kill_every": 1.2, "time_limit": 10},
    ("replicated", "kill-restart"): {"replicated_volatile": True,
                                     "kill_all": True, "read_weight": 4,
                                     "kill_every": 2.0, "lease_ms": 400,
                                     "rate": 20, "concurrency": 4,
                                     "time_limit": 12,
                                     "lin_budget": 3_000_000,
                                     "lin_shrink": False},
    ("replicated", "partition"): {"replicated_split_brain": True,
                                  "part_every": 2.0, "lease_ms": 500,
                                  "rate": 15, "concurrency": 4,
                                  "time_limit": 10,
                                  "lin_budget": 3_000_000,
                                  "lin_shrink": False},
    # the split-brain classic, staged the way the reference stages it:
    # an ASYMMETRIC one-way grudge on exactly the leader's outbound
    # peer links — its heartbeats vanish, the majority elects a
    # successor, and the split-brain seeded leader keeps serving its
    # (uncut) clients stale reads
    ("replicated", "link-isolate-leader"): {
        "replicated_split_brain": True, "part_every": 2.0,
        "lease_ms": 400, "rate": 15, "concurrency": 4,
        "time_limit": 10, "lin_budget": 3_000_000,
        "lin_shrink": False},
    # redelivery-under-partition: volatile replicas under the bridge
    # grudge — a cut-off replica wins an election through the overlap
    # node (completeness-free elections) and serves a pending set
    # missing acked ADDJOBs; the final drain comes up short (lost),
    # and the total-queue fold flips the live verdict AT the drain
    # event (detection.at="streamed", W007-auditable evidence)
    ("replicated-queue", "link-bridge"): {
        "rqueue_volatile": True, "part_every": 2.0, "lease_ms": 400,
        "rate": 20, "concurrency": 4, "time_limit": 12},
}


def campaign_dir(opts: dict) -> str:
    base = opts.get("store_base", store.BASE)
    return os.path.join(base, "campaigns",
                        opts.get("campaign_id") or store.time_str())


def plan(families: list[str] | None = None,
         nemeses: list[str] | None = None,
         opts: dict | None = None,
         *, seeded: bool = True) -> list[dict]:
    """The cell list with availability resolved — exactly what a
    ``--dry-run`` prints and what :func:`run_campaign` executes."""
    opts = dict(opts or {})
    matrix = standard_matrix()
    for k in families or []:
        if k not in FAMILIES:
            raise ValueError(f"unknown family {k!r}; have "
                             f"{sorted(FAMILIES)}")
    for k in nemeses or []:
        if k not in matrix:
            raise ValueError(f"unknown nemesis {k!r}; have "
                             f"{sorted(matrix)}")
    fams = {k: FAMILIES[k] for k in (families or list(FAMILIES))}
    nems = {k: matrix[k] for k in (nemeses or list(matrix))}
    # host-capability probes run ONCE per nemesis, not per cell: they
    # spawn subprocesses (and the tc probe mutates a qdisc round-trip)
    # and cannot change mid-plan; only the per-family applicability
    # check runs per cell
    nem_reason = {nname: nem.probe() for nname, nem in nems.items()}
    cells = []
    for fname, fam in fams.items():
        freason = fam.available(opts)
        for nname, nem in nems.items():
            reason = freason or nem_reason[nname] \
                or nem.applies(fam)
            cells.append({"family": fname, "nemesis": nname,
                          "seeded": False,
                          "skip": reason})
            if seeded and (fname, nname) in SEEDED \
                    and reason is None:
                cells.append({"family": fname, "nemesis": nname,
                              "seeded": True, "skip": None})
    return cells


def _walk_audits(d, out: list) -> None:
    if isinstance(d, dict):
        a = d.get("audit")
        if isinstance(a, dict) and "ok" in a:
            out.append(a)
        for v in d.values():
            _walk_audits(v, out)


def _audit_summary(results: dict) -> dict | None:
    """Aggregate every nested audit outcome (independent keys, compose
    members) into one ok/checked/codes record."""
    audits: list = []
    _walk_audits(results, audits)
    if not audits:
        return None
    codes = sorted({c for a in audits for c in (a.get("codes") or [])})
    checked = sorted({str(a.get("checked")) for a in audits})
    return {"ok": all(a.get("ok") for a in audits),
            "checked": checked,
            "certificates": len(audits), "codes": codes}


def _fault_fs(nemesis: str) -> set:
    if nemesis.startswith("link-"):
        return {"start"}
    return {"kill-restart": {"kill"}, "pause": {"pause"},
            "clock-skew": {"skew"}, "partition": {"start"},
            "disk-faults": {"break-one-percent", "break-all"}} \
        .get(nemesis, set())


def _detection(test: dict, nemesis: str) -> dict | None:
    """Streamed detection latency: the gap between the first injected
    fault and the event where the streaming checker flipped to
    invalid — the streaming checker's latency, measured on real
    crashes.  ``at`` labels *when* the verdict landed:
    ``"streamed"`` (mid-stream — an online cut, the bounded `:info`
    lookahead fork on crash-seeded cells, or the total-queue fold's
    unexpected-delivery/short-drain flip on the model-less queue
    families) vs ``"finalize"`` (only the stream's close confirmed
    it).  The old blanket model-less exemption is gone: queue cells
    stream through the total-queue fold route (stream/checker.py's
    TotalFoldStream) and grade like everyone else; the post-hoc
    fallback below only fires when streaming was off entirely."""
    hist = test.get("history") or []
    sres = test.get("stream_results")
    if not isinstance(sres, dict):
        # no streamed verdict to grade at all (streaming disabled):
        # when the final verdict is invalid, the detection still gets
        # recorded — latency against the end of the history, labelled
        # finalize with the post-hoc source so the /campaigns grading
        # stays honest about WHEN the verdict could have landed
        if (test.get("results") or {}).get("valid") is not False:
            return None
        inv = max(0, len(hist) - 1)
        out = {"invalid_event": inv, "at": "finalize",
               "source": "post-hoc"}
        return _detection_latency(out, hist, inv, nemesis)
    st = sres.get("stream") or {}
    inv = st.get("invalid_event")
    at = "streamed"
    if inv is None:
        if sres.get("valid") is not False:
            return None
        # the violation outran every online cut AND the lookahead
        # horizon (or lookahead was off/fork-capped): confirmed only
        # when the stream finalized — record the detection against the
        # end of the recorded history, honestly labelled
        inv = max(0, int(st.get("events") or 0) - 1)
        at = "finalize"
    out = {"invalid_event": inv, "at": at,
           "first_verdict_event": st.get("first_verdict_event")}
    if st.get("family"):
        out["fold"] = st["family"]
    return _detection_latency(out, hist, inv, nemesis)


def _detection_latency(out: dict, hist: list, inv: int,
                       nemesis: str) -> dict:
    fault_fs = _fault_fs(nemesis)
    fault_idx = fault_t = None
    for i, op in enumerate(hist):
        if op.process == "nemesis" and op.f in fault_fs \
                and op.type == "info":
            fault_idx, fault_t = i, op.time
            break
    if fault_idx is not None and inv >= fault_idx:
        out["fault_event"] = fault_idx
        out["latency_events"] = inv - fault_idx
        t_inv = hist[inv].time if inv < len(hist) else None
        if t_inv is not None and fault_t is not None:
            out["latency_s"] = round((t_inv - fault_t) / 1e9, 4)
    return out


def _phase_times(test: dict, nemesis: str) -> dict | None:
    """Per-cell phase wall-clock: setup/workload/check straight from
    ``core.run``'s always-on phase accounting (``test["phase_s"]``),
    nemesis/heal from the history's nemesis op pairs (the nemesis
    worker is single-threaded, so an action's invoke and completion
    are consecutive same-``f`` entries).  What makes a slow cell
    diagnosable from cells.jsonl without a rerun."""
    ph = dict(test.get("phase_s") or {})
    fault_fs = _fault_fs(nemesis)
    nem = heal = 0.0
    open_t: dict = {}
    for op in (test.get("history") or []):
        if op.process != "nemesis" or op.time is None:
            continue
        if op.f in open_t:
            dt = (op.time - open_t.pop(op.f)) / 1e9
            if op.f in fault_fs:
                nem += dt
            else:
                heal += dt
        else:
            open_t[op.f] = op.time
    out = {"setup": ph.get("setup"), "workload": ph.get("workload"),
           "nemesis": round(nem, 4) if nem else None,
           "heal": round(heal, 4) if heal else None,
           "check": ph.get("check")}
    out = {k: v for k, v in out.items() if v is not None}
    return out or None


def _recovery(test: dict) -> dict | None:
    """kill -> next acked client op AGAINST A KILLED NODE, per kill:
    how long the crashed node was dark.  On key-sharded families an
    ok op on a healthy node proves nothing, so ops are attributed via
    the backend's routing (``LiveBackend.op_node``); unattributable
    ops are skipped rather than miscounted."""
    hist = test.get("history") or []
    backend = test.get("__live_backend__")
    deltas = []
    pending: tuple | None = None  # (kill time, killed-node names)
    for op in hist:
        if op.process == "nemesis" and op.f == "kill" \
                and op.type == "info" \
                and isinstance(op.value, (list, tuple)):
            # the completion carries the killed node list (the invoke's
            # value is the generator's, usually None)
            pending = (op.time, {str(n) for n in op.value})
        elif pending is not None and isinstance(op.process, int) \
                and op.type == "ok" and op.time is not None \
                and op.time > pending[0]:
            node = None
            if backend is not None:
                try:
                    node = backend.op_node(test, op)
                except Exception:  # noqa: BLE001 — metric, not verdict
                    node = None
            if node is None or str(node) not in pending[1]:
                continue
            deltas.append((op.time - pending[0]) / 1e9)
            pending = None
    if not deltas:
        return None
    return {"n": len(deltas),
            "mean_s": round(sum(deltas) / len(deltas), 4),
            "max_s": round(max(deltas), 4)}


class _Watchdog:
    """Per-cell wall-clock watchdog with SIGKILL escalation.

    A wedged backend (a SIGSTOP'd node nobody resumes, a server stuck
    in D-state on a faulty fs) must degrade ONE cell, never hang the
    campaign.  Past the budget the watchdog sweeps every ``server.pid``
    under the cell's data root and escalates per process: SIGCONT (thaw
    a paused victim so signals can land), SIGTERM, then SIGKILL after a
    short grace — client ops then fail fast, the generator's time limit
    drains, and ``core.run`` unwinds normally.  The sweep repeats while
    the cell is still running, so a nemesis that respawns the wedged
    process doesn't escape it."""

    def __init__(self, budget_s: float, data_root: str,
                 grace_s: float = 5.0, resweep_s: float = 10.0,
                 label: str | None = None):
        self.budget_s = budget_s
        self.data_root = data_root
        self.grace_s = grace_s
        self.resweep_s = resweep_s
        #: cell-attributed logger: a fleet's watchdog warnings must
        #: name the cell they escalated on
        self.log = obs.log_ctx(log, cell=label)
        self.fired = False
        self.killed: list[int] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run,
                                   name="cell-watchdog", daemon=True)

    def start(self) -> "_Watchdog":
        self._t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=5)

    def _pids(self) -> list[int]:
        import glob

        pids = []
        for pf in glob.glob(os.path.join(self.data_root, "*",
                                         "server.pid")):
            try:
                with open(pf) as f:
                    pids.append(int(f.read().split()[0]))
            except (OSError, ValueError, IndexError):
                pass
        return pids

    def _signal(self, pid: int, sig: int) -> bool:
        try:
            os.kill(pid, sig)
            return True
        except (OSError, ProcessLookupError):
            return False

    def _sweep(self) -> None:
        import signal as _sig

        # connectivity first: a wedged cell may be wedged BECAUSE a
        # partition rule is still installed — and once the watchdog
        # starts SIGKILLing, nothing else will ever heal it.  The rule
        # journal makes this safe from a thread that knows nothing
        # about the nemesis.
        try:
            links_mod.sweep(self.data_root)
        except Exception:  # noqa: BLE001 — the watchdog never dies
            self.log.warning("watchdog rule sweep failed",
                             exc_info=True)
        victims = [p for p in self._pids() if self._signal(p, 0)]
        if not victims:
            return
        self.log.warning("cell watchdog: budget %.0fs exceeded; "
                         "escalating on pids %s", self.budget_s, victims)
        for p in victims:
            self._signal(p, _sig.SIGCONT)  # thaw: SIGTERM must land
            self._signal(p, _sig.SIGTERM)
        self._stop.wait(self.grace_s)
        for p in victims:
            if self._signal(p, 0):
                self._signal(p, _sig.SIGKILL)
            if p not in self.killed:
                self.killed.append(p)

    def _run(self) -> None:
        if self._stop.wait(self.budget_s):
            return
        self.fired = True
        while not self._stop.is_set():
            try:
                self._sweep()
            except Exception:  # noqa: BLE001 — the watchdog never dies
                self.log.warning("cell watchdog sweep failed",
                                 exc_info=True)
            if self._stop.wait(self.resweep_s):
                return


def cell_budget(opts: dict) -> float:
    """The cell's wall-clock budget: the workload time limit plus the
    harness overheads (node startup health backoffs, heal+final phase,
    analysis) with generous slack — a cell past this is wedged, not
    slow."""
    if opts.get("cell_budget"):
        return float(opts["cell_budget"])
    tl = float(opts.get("time_limit", 8))
    return max(120.0, tl * 10 + 90.0)


def run_cell(cell: dict, opts: dict) -> dict:
    """Execute one suite×nemesis cell end to end; never raises.  A
    wall-clock watchdog (:class:`_Watchdog`) guards the whole cell."""
    from .. import core

    out = dict(cell)
    if cell.get("skip"):
        out["status"] = "skipped"
        out["reason"] = cell["skip"]
        return out
    backend: LiveBackend = FAMILIES[cell["family"]]
    matrix = standard_matrix()
    entry: MatrixNemesis = matrix[cell["nemesis"]]

    copts = dict(opts)
    tag = f"{cell['family']}-{cell['nemesis']}" \
        + ("-seeded" if cell.get("seeded") else "")
    copts["name"] = f"live-{tag}"
    copts.setdefault("data_root",
                     os.path.join("/tmp/jepsen-live", tag))
    if cell.get("seeded"):
        copts.update(SEEDED[(cell["family"], cell["nemesis"])])
    if cell["nemesis"] == "disk-faults":
        # disk faults only bite when the oplog lives on the faulty fs
        from .. import faultfs

        copts["data_root"] = os.path.join(faultfs.FAULTY,
                                          "jepsen-live", tag)
    copts.setdefault("stream", True)
    # audit every live history: the campaign's point is verdicts a
    # reviewer can replay.  ``audit`` rides the test map, where every
    # checker of the cell reads it: Linearizable (the per-key checkers
    # of a lifted composition included), the independent batch and the
    # stream's finalize
    copts.setdefault("audit", True)
    # stale partition rules from a SIGKILL'd previous runner would
    # wedge this cell from its first health check — sweep the data
    # root's rule journal before any process starts
    swept_before = links_mod.sweep(copts["data_root"])
    t0 = time.monotonic()
    wd = _Watchdog(cell_budget(copts), copts["data_root"],
                   label=tag).start()
    try:
        try:
            with obs.span(f"cell:{tag}", cat="campaign",
                          family=cell["family"],
                          nemesis=cell["nemesis"],
                          seeded=bool(cell.get("seeded"))):
                test = core.run(assemble(backend, entry, copts))
        except WorkerAbort as e:
            out["status"] = "skipped"
            out["reason"] = f"backend couldn't run: {e}"
            return out
        except BackendStartError as e:
            # a server that never came up is a host capability problem
            # (port squatting, fork pressure), not a campaign failure.
            # Only that: any other RuntimeError (a failed device fold, a
            # CUDA launch error) is the cell's failure, reported below
            out["status"] = "skipped"
            out["reason"] = f"backend couldn't start: {e}"
            return out
        except control.RemoteError as e:
            # the control plane itself is missing a tool (no
            # start-stop-daemon on alpine/macOS, no mkdir perms): the
            # same degradation contract — skip with the reason
            out["status"] = "skipped"
            out["reason"] = f"control plane failed: {e}"
            return out
        except Exception as e:  # noqa: BLE001 — campaign must finish
            out["status"] = "failed"
            out["reason"] = f"{type(e).__name__}: {e}"
            out["traceback"] = traceback.format_exc()[-2000:]
            if _device_error(e):
                out["device_error"] = True
            return out
    finally:
        wd.stop()
        if wd.fired:
            out["watchdog"] = {"fired": True, "budget_s": wd.budget_s,
                               "killed": list(wd.killed)}
            _M_WATCHDOG.inc(event="fired")
            if wd.killed:
                _M_WATCHDOG.inc(len(wd.killed), event="killed")
        # the post-cell sweep: whatever happened above — a clean heal,
        # a crashed nemesis, a watchdog kill — no partition rule may
        # outlive the cell.  A clean cell's nemesis already healed, so
        # this normally sweeps nothing.
        swept_after = links_mod.sweep(copts["data_root"])
        if swept_before or swept_after:
            out["rules_swept"] = {"before": swept_before,
                                  "after": swept_after}
    res = test.get("results") or {}
    hist = test.get("history") or []
    out["status"] = "ok"
    out["valid"] = res.get("valid")
    out["ops"] = sum(1 for op in hist if isinstance(op.process, int)
                     and op.type in ("ok", "fail", "info"))
    # injected faults only (heals excluded); each nemesis action
    # journals both its invoke and its completion as 'info', hence /2
    fault_fs = _fault_fs(cell["nemesis"])
    out["faults"] = sum(1 for op in hist if op.process == "nemesis"
                        and op.f in fault_fs) // 2
    out["wall_s"] = round(time.monotonic() - t0, 2)
    out["audit"] = _audit_summary(res)
    sres = test.get("stream_results")
    if isinstance(sres, dict):
        from ..stream.service import result_summary

        summ = result_summary(sres)
        out["stream_valid"] = summ.get("valid")
        out["certificate"] = {
            k: v for k, v in summ.items()
            if k in ("witness_ops", "witness_dropped", "final_ops",
                     "frontier_ops", "frontier_dropped")}
        ev = sres.get("queue_evidence")
        if isinstance(ev, dict):
            # the streamed multiset evidence (W007-audited): what was
            # lost/unexpected, visible straight from cells.jsonl
            out["certificate"]["queue_evidence"] = {
                "kind": ev.get("kind"),
                "values": list(ev.get("values") or ())[:16]}
        if summ.get("audit") is not None:
            out["stream_audit"] = summ["audit"]
    out["detection"] = _detection(test, cell["nemesis"])
    out["recovery"] = _recovery(test)
    out["phases"] = _phase_times(test, cell["nemesis"])
    out["store"] = os.path.dirname(store.path(test, "x"))
    # feed the regression net: every completed cell's history is
    # audited, canonicalized, and banked into store/corpus/, which
    # corpus.corpus_replay replays through every engine route — each
    # live fault run permanently widens the differential-fuzz net
    if copts.get("corpus", True):
        try:
            from .corpus import bank_cell

            banked = bank_cell(test, out,
                               base=copts.get("store_base", store.BASE))
            if banked:
                out["corpus"] = banked
        except Exception:  # noqa: BLE001 — banking never fails a cell
            log.warning("corpus banking failed", exc_info=True)
    return out


def _cell_key(cell: dict) -> tuple:
    return (cell["family"], cell["nemesis"], bool(cell.get("seeded")))


def completed_cells(d: str) -> dict[tuple, dict]:
    """The terminal outcomes already recorded in a campaign dir's
    ``cells.jsonl`` (crash-safe: each line was flushed as its cell
    finished) — what ``--resume`` skips.  Later lines win (a re-run
    supersedes its predecessor), and outcomes the retry policy calls
    *retryable harness errors* (:func:`_retryable`) are dropped: a
    campaign killed right after a transient failure resumes by
    re-running that cell, not by baking the failure into the record."""
    out: dict[tuple, dict] = {}
    try:
        with open(os.path.join(d, "cells.jsonl")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    o = json.loads(line)
                    key = _cell_key(o)
                except (ValueError, KeyError):
                    continue
                if _retryable(o, o):
                    out.pop(key, None)
                else:
                    out[key] = o
    except OSError:
        pass
    return out


def _device_error(e: BaseException) -> bool:
    """Whether ``e``, or an exception it was raised from, is the
    device's: a failed device fold of the stream, the B1 kernel's
    wrapper (``level_loop ... failed``) or torch's CUDA error."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, DeviceFoldError) \
                or type(e).__name__ in ("AcceleratorError",
                                        "OutOfMemoryError") \
                or str(e).startswith(("CUDA", "level_loop ")):
            return True
        e = e.__cause__ or e.__context__
    return False


def _retryable(cell: dict, outcome: dict) -> bool:
    """Harness errors retry; verdicts never do.  A ``failed`` cell hit
    an unexpected harness exception; a runtime ``skipped`` (the plan
    predicted runnable but the backend/control plane balked — port
    squatting, fork pressure) is transient on a loaded host.  A
    planned skip (capability probe) and every real verdict are
    terminal, and so is a failure of the device (``device_error``): a
    second attempt that passes would hide it."""
    if outcome.get("status") == "failed":
        return not outcome.get("device_error")
    return outcome.get("status") == "skipped" and cell.get("skip") is None


def run_campaign(opts: dict | None = None,
                 families: list[str] | None = None,
                 nemeses: list[str] | None = None,
                 *, seeded: bool = True,
                 progress=None, resume: bool = False) -> dict:
    """Run the whole matrix; returns (and persists) the campaign
    record.  ``progress(cell_outcome)`` is called per finished cell.

    Self-healing contract: every cell runs under a wall-clock watchdog
    (:func:`run_cell`), a cell that fails on a *harness* error is
    retried up to ``opts["cell_retries"]`` times (default 1 retry;
    verdicts are never retried), and ``resume=True`` (with
    ``opts["campaign_id"]`` naming an interrupted campaign) skips every
    cell already recorded in its ``cells.jsonl`` — a killed campaign
    resumes to completion without re-running finished cells."""
    opts = dict(opts or {})
    opts.setdefault("time_limit", 8)
    # connectivity first: a SIGKILL'd previous runner may have left
    # partition rules installed under any cell data root — sweep every
    # journal before the first cell.  A caller that pinned a data root
    # runs every cell there: only that root is swept, and the default
    # tree, which other runs share, is left alone
    try:
        if opts.get("data_root"):
            links_mod.sweep(opts["data_root"])
        else:
            links_mod.sweep_tree()
    except Exception:  # noqa: BLE001 — a sweep failure must not
        log.warning("campaign-start rule sweep failed",  # block cells
                    exc_info=True)
    cells = plan(families, nemeses, opts, seeded=seeded)
    d = campaign_dir(opts)
    os.makedirs(d, exist_ok=True)
    cells_path = os.path.join(d, "cells.jsonl")
    done = completed_cells(d) if resume else {}
    retries = max(0, int(opts.get("cell_retries", 1)))

    outcomes = []
    with open(cells_path, "a") as fh:
        for cell in cells:
            prior = done.get(_cell_key(cell))
            if prior is not None:
                prior = dict(prior)
                prior["resumed"] = True
                outcomes.append(prior)
                continue
            for attempt in range(1 + retries):
                outcome = run_cell(cell, opts)
                outcome["attempts"] = attempt + 1
                if not _retryable(cell, outcome) or attempt >= retries:
                    break
                obs.log_ctx(
                    log,
                    cell=f"{cell['family']}x{cell['nemesis']}").warning(
                    "attempt %d failed (%s); retrying", attempt + 1,
                    outcome.get("reason"))
            outcomes.append(outcome)
            _M_CELLS.inc(status=str(outcome.get("status")))
            fh.write(json.dumps(
                {k: v for k, v in outcome.items()
                 if k != "traceback"}, default=str) + "\n")
            fh.flush()
            if progress is not None:
                progress(outcome)

    by_status: dict = {}
    for o in outcomes:
        by_status[o["status"]] = by_status.get(o["status"], 0) + 1
    # streamed-vs-finalize detection, PER FAMILY: the grading question
    # "which families still only detect at finalize?" answered straight
    # from campaign.json instead of by re-reading every cell line
    det_by_family: dict = {}
    for o in outcomes:
        det = o.get("detection")
        fam = o.get("family")
        if not isinstance(det, dict) or not fam:
            continue
        row = det_by_family.setdefault(fam,
                                       {"streamed": 0, "finalize": 0})
        at = det.get("at")
        if at in row:
            row[at] += 1
    record = {
        "id": os.path.basename(d),
        "started": opts.get("campaign_id") or os.path.basename(d),
        "families": sorted({c["family"] for c in cells}),
        "nemeses": sorted({c["nemesis"] for c in cells}),
        "resumed_cells": sum(1 for o in outcomes if o.get("resumed")),
        "cells": outcomes,
        "summary": {
            **by_status,
            "detected": sum(1 for o in outcomes
                            if o.get("valid") is False),
            "streamed_detections": sum(
                1 for o in outcomes
                if (o.get("detection") or {}).get("at") == "streamed"),
            "detection_by_family": det_by_family,
            "audited_ok": sum(1 for o in outcomes
                              if (o.get("audit") or {}).get("ok")),
        },
    }
    with open(os.path.join(d, "campaign.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def render_plan(cells: list[dict]) -> str:
    """The --dry-run rendering: the grid with per-cell skip reasons."""
    lines = []
    fams = sorted({c["family"] for c in cells})
    nems = []
    for c in cells:
        if c["nemesis"] not in nems:
            nems.append(c["nemesis"])
    width = max(len(f) for f in fams) + 2
    lines.append(" " * width + "  ".join(f"{n:<14}" for n in nems))
    for f in fams:
        row = [f"{f:<{width}}"]
        for n in nems:
            cell = next(c for c in cells
                        if c["family"] == f and c["nemesis"] == n
                        and not c.get("seeded"))
            row.append(f"{'run':<14}  " if cell["skip"] is None
                       else f"{'skip':<14}  ")
        lines.append("".join(row).rstrip())
    lines.append("")
    seen = set()
    for c in cells:
        if c.get("seeded"):
            lines.append(f"seeded bug cell: {c['family']} × "
                         f"{c['nemesis']} (expected invalid)")
        elif c["skip"] and c["skip"] not in seen:
            seen.add(c["skip"])
            skips = sorted({f"{x['family']}×{x['nemesis']}"
                            for x in cells if x.get("skip") == c["skip"]})
            lines.append(f"skip {', '.join(skips)}: {c['skip']}")
    return "\n".join(lines)
