"""The streaming checker: live verdicts while a test runs.

:class:`StreamChecker` is an op sink: the runner (or the stream service)
feeds it history events one at a time, in history order, and it keeps a
provisional verdict current the whole way:

  * events pair into retained rows (ok and :info; :fail drops), the
    merge ``history.encode_ops`` makes after the fact;
  * rows split into per-key cells (Herlihy-Wing locality, as
    ``decompose.partition.partition_by_key``);
  * each cell watches for **online quiescence cuts**: when a new op
    invokes while the cell has nothing pending (and has never crashed),
    every earlier op of the cell has returned, so the rows so far form
    a *closed segment* that composes with what follows only through
    its reachable-state set (P-compositionality, arXiv:1504.00204);
  * a closed segment folds the moment it closes: the canonical-hash
    verdict cache first (``decompose/cache.py``, the keys the
    decomposed engine writes), then the happens-before interval fold
    (``analyze.hb.hb_fold_states``), then, by the plan gate
    (``analyze.plan.segment_fold_route``), the host fold
    (``decompose.engine.segment_states``) or the device batch
    (``stream/device.py``: the kernel's grid over keys on the card);
  * an empty reachable set, or an :ok op on a key no model step takes,
    is **final**: later ops invoke after every op of a closed segment
    returned, so no suffix repairs it, and the stream flips to
    ``invalid`` a few events after the violating op.

``finalize()`` closes the stream (open invokes become :info rows),
checks each cell's last segment from its carried-in states, and returns
a result with the post-hoc engines' certificates: ``linearization``
(per-cell chains stitched by ``partition.merge_linearizations``) or
``witness_dropped``; ``final_ops`` or ``frontier_dropped``.  Online cuts
coarsen the post-hoc ones and every stage is exact, so the verdict is
the decomposed engine's on the same history.  A host stage that stays
inconclusive (a sub-search's budget) falls back to one direct check of
the whole history; a device-routed fold that raises is an error, never
a host fold.

:class:`TotalFoldStream` streams the model-less multiset families
(total queue, set) through ``analyze.constraints.MultisetFold``.

The counterpart of the JAX package's ``stream/checker.py``; the
runner's opt-in knob (``stream_enabled``) is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import queue as _queue
import threading
import time
from dataclasses import replace as _dc_replace

import numpy as np

from .. import obs
from ..history import INF_RET, INFO, INVOKE, NIL, OK, Op, OpSeq, ValueEncoder
from ..models import ModelSpec
from ..obs import metrics as obs_metrics
from .device import DeviceFoldError

log = logging.getLogger("jepsen")


#: flight-recorder counters (module handles — ingest is the hot path)
_M_INGESTED = obs_metrics.REGISTRY.counter(
    "jtpu_stream_ops_ingested_total",
    "History events ingested by streaming checkers")
_M_FOLDED = obs_metrics.REGISTRY.counter(
    "jtpu_stream_segments_folded_total",
    "Closed quiescence segments folded, by route", ("route",))
_M_FORKS = obs_metrics.REGISTRY.counter(
    "jtpu_stream_forks_total",
    "Bounded :info lookahead forks, spawned vs capped", ("outcome",))
_M_FOLD_S = obs_metrics.REGISTRY.histogram(
    "jtpu_fold_seconds", "Wall seconds per streamed segment fold")

#: how often (events) the live snapshot is rewritten at most
_LIVE_EVERY = 64
_LIVE_MIN_S = 0.25


class _Row:
    """One retained (or still-open) logical op."""

    __slots__ = ("inv", "ret", "process", "f", "v1", "v2", "status",
                 "op", "cell_key", "cell_pos", "g")

    def __init__(self, inv, process, f, v1, v2, op, cell_key):
        self.inv = inv
        self.ret = INF_RET
        self.process = process
        self.f = f
        self.v1 = v1
        self.v2 = v2
        self.status = "open"  # open | ok | info | fail
        self.op = op
        self.cell_key = cell_key
        self.cell_pos = None  # position in the cell's retained-row list
        self.g = None  # global row index, assigned at finalize


def _rows_opseq(rows: list[_Row], encoder, *, value_lane: bool) -> OpSeq:
    """Columnar OpSeq over retained rows (already inv-sorted).

    ``value_lane=True`` builds the *cell* shape of a multi-register
    projection (value moved from the v2 lane to v1, exactly
    ``partition.cells_from_rows``)."""
    n = len(rows)
    if value_lane:
        v1 = [r.v2 for r in rows]
        v2 = [NIL] * n
    else:
        v1 = [r.v1 for r in rows]
        v2 = [r.v2 for r in rows]
    return OpSeq(
        process=np.array([r.process for r in rows], np.int32).reshape(n),
        f=np.array([r.f for r in rows], np.int32).reshape(n),
        v1=np.array(v1, np.int32).reshape(n),
        v2=np.array(v2, np.int32).reshape(n),
        inv=np.array([r.inv for r in rows], np.int64).reshape(n),
        ret=np.array([r.ret for r in rows], np.int64).reshape(n),
        ok=np.array([r.status == "ok" for r in rows], bool).reshape(n),
        ops=[r.op for r in rows],
        encoder=encoder,
    )


class _Cell:
    """Per-key streaming state: the open segment buffer, the carried
    reachable-state frontier, and the witness chains threading it."""

    def __init__(self, key, init_state: tuple, witness: bool):
        self.key = key
        self.buf: list[_Row] = []  # rows of the still-open segment
        self.rows: list[_Row] = []  # retained rows of CLOSED segments
        self.pending = 0  # invoked, completion still unknown
        self.crashed = False  # an :info row suppresses all later cuts
        self.ok_in_buf = 0  # post-crash :ok rows (lookahead cadence)
        self.la_checked = 0  # ok_in_buf at the last speculative check
        self.states: set = {tuple(init_state)}
        # state -> cell-row chain reaching it; None once any stage drops
        self.chains: dict | None = {tuple(init_state): []} if witness \
            else None
        self.segments = 0  # closed segments folded so far
        self.fallback = False  # an inconclusive fold: direct at the end
        self.final_rows: list = []  # the unquiesced tail, at finalize


class StreamChecker:
    """Incremental checking engine; see the module docstring.

    model            the ModelSpec the history is checked against
    cache            VerdictCache, a jsonl path, or None
    witness          carry witness chains (certificate on valid)
    async_folds      fold closed segments on a background thread (the
                     runner wiring: ingest must never block a worker);
                     False folds inline at segment close (deterministic
                     — the tests' and service mode's default)
    sub_max_configs  per-sub-search budget, as the decomposed engine
    host_fold_max    override for the plan gate's host-fold cost cap
                     (``analyze.plan.segment_fold_route``)
    info_lookahead   bounded `:info` lookahead horizon: after this many
                     post-crash :ok rows accumulate at a pseudo-
                     quiescent point, the crashed cell's open segment
                     is speculatively fork-checked (each `:info` op
                     present at any frontier position vs absent) so a
                     kill-seeded violation flips the live verdict
                     mid-stream.  None = the plan default
                     (``analyze.plan.STREAM_INFO_LOOKAHEAD``); 0
                     disables (finalize-only).  Final verdicts are
                     identical either way: a speculative invalid is
                     sound (every fork fails, so no suffix can repair
                     the prefix), and anything else changes nothing.
    device_budget    config budget per device dispatch
    device           where device-routed folds search (``"cuda"``, the
                     default, or ``"cpu"``); nothing else reads it.  A
                     device-routed fold that raises is never absorbed
                     into a host fold: inline it raises out of
                     :meth:`ingest` as :class:`DeviceFoldError`, with
                     ``async_folds`` :meth:`finalize` raises it
    live_path        when set, a JSON snapshot of :meth:`verdict` is
                     rewritten there (atomically) as the stream moves —
                     the web UI's ``/api/live`` source
    run_id           label carried into the live snapshot
    """

    def __init__(self, model: ModelSpec, *,
                 cache=None, witness: bool = True,
                 async_folds: bool = False,
                 sub_max_configs: int = 50_000_000,
                 host_fold_max: int | None = None,
                 info_lookahead: int | None = None,
                 device_budget: int = 2_000_000,
                 live_path: str | None = None,
                 run_id: str | None = None,
                 hb: bool | None = None,
                 dpor: bool | None = None,
                 device="cuda"):
        from ..analyze.dpor import resolve_dpor
        from ..analyze.hb import resolve_hb
        from ..analyze.plan import STREAM_INFO_LOOKAHEAD
        from ..decompose.cache import VerdictCache

        self.model = model
        #: happens-before pre-pass (analyze/hb.py): closed crash-free
        #: segments in the decidable register class fold through the
        #: O(n log n) interval pass instead of the level sweep, and
        #: finalize's sub-searches inherit the same flag so streamed
        #: results stay bit-identical to the post-hoc engines
        self.hb = resolve_hb(hb)
        #: dynamic layer (analyze/dpor.py): finalize's sub-searches and
        #: the per-cell/whole-history direct fallbacks inherit it, so a
        #: streamed verdict's engines prune exactly like the post-hoc
        #: ones (bit-identical finals either way by construction)
        self.dpor = resolve_dpor(dpor)
        if isinstance(cache, str):
            cache = VerdictCache(cache)
        self.cache = cache
        # per-RUN cache counters, counted here rather than read off the
        # (possibly shared) VerdictCache object: concurrent streams on
        # one cache (the service, the bench fleet) must not zero or
        # inflate each other's stats
        self._cstats = {"hits": 0, "misses": 0, "inserts": 0}
        self.witness = witness
        self.sub_max_configs = sub_max_configs
        self.host_fold_max = host_fold_max
        self.info_lookahead = STREAM_INFO_LOOKAHEAD \
            if info_lookahead is None else max(0, int(info_lookahead))
        self.device_budget = device_budget
        from ..checker.linearizable import _resolve_device

        # a missing card is an error here, not at the first device fold
        self.device = _resolve_device(device)
        #: the device route's failure, raised again by finalize
        self._device_error: DeviceFoldError | None = None
        self.live_path = live_path
        self.run_id = run_id

        # three demux modes, all the same cell machinery:
        #   single       one cell, cell model = the model
        #   multi        multi-register locality: per-key register cells
        #   independent  jepsen.independent [k v] workloads: per-key
        #                cells under the TEST model (detected on the
        #                first KV-valued client op — the streamed twin
        #                of independent.checker's subhistory split)
        self._multi = model.name == "multi-register"
        self._mode = "multi" if self._multi else "single"
        if self._multi:
            from ..models import register

            self._cell_model = register(int(model.init[0]))
        else:
            self._cell_model = model
        #: client ops whose key is not yet known (non-KV invoke in an
        #: independent stream): they block every cell's cuts until
        #: their completion reveals the key
        self._floating_n = 0
        #: running count of :ok rows admitted to cells — verdict() is
        #: called per ingested event, so it must not rescan the buffers
        self._ok_rows = 0
        self._enc = ValueEncoder()
        self._lock = threading.RLock()
        self._events = 0
        self._open: dict = {}  # process -> _Row awaiting completion
        self._cells: dict = {}
        #: independent mode: key -> full per-cell result (certificates
        #: over the cell's own rows), populated at finalize
        self.cell_results: dict = {}
        self._extra: list[_Row] = []  # unsteppable-key rows (no cell)
        self._bad_ok: list[_Row] = []  # :ok rows that decide invalid
        self._invalid: dict | None = None
        self._fallback = False
        self._finalized: dict | None = None
        self._seq: OpSeq | None = None
        self._stats = {"segments": 0, "configs_searched": 0,
                       "routes": {"host": 0, "device": 0, "hb": 0},
                       "checked_rows": 0, "lookahead_checks": 0}
        self._methods: set = set()
        self._drops = {"witness": None, "frontier": None}
        if not witness:
            self._drop("witness", "witness not requested (witness=False)")
        self._first_verdict_event: int | None = None
        self._invalid_event: int | None = None
        self._live_last = (0, 0.0)
        self._live_lock = threading.Lock()  # ingest + fold thread

        self._q: _queue.Queue | None = None
        self._worker: threading.Thread | None = None
        if async_folds:
            self._q = _queue.Queue()
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="stream-fold",
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    def ingest(self, op: Op) -> None:
        """Feed the next history event (invoke or completion, client or
        nemesis — non-client events just consume their event index, so
        row ``inv``/``ret`` ranks match the post-hoc encoding)."""
        with self._lock:
            if self._finalized is not None:
                raise RuntimeError("stream already finalized")
            i = self._events
            self._events += 1
            _M_INGESTED.inc()
            if not isinstance(op.process, int):
                return  # nemesis journal entries are not client ops
            if op.type == INVOKE:
                self._on_invoke(op, i)
            else:
                self._on_complete(op, i)
        self._maybe_write_live()

    def _lanes_value(self, v):
        if isinstance(v, (tuple, list)) and len(v) == 2:
            return self._enc.encode(v[0]), self._enc.encode(v[1])
        return self._enc.encode(v), NIL

    def _lanes(self, op: Op):
        return self._lanes_value(op.value)

    @staticmethod
    def _is_kv(v) -> bool:
        from ..independent import is_tuple

        return is_tuple(v)

    def _cell(self, key) -> _Cell:
        c = self._cells.get(key)
        if c is None:
            c = _Cell(key, self._cell_model.init, self.witness)
            self._cells[key] = c
        return c

    def _cell_for(self, v1: int):
        """The cell a row belongs to, or None for an unsteppable key
        (multi-register NIL / out-of-range — ``key_partition_rows``)."""
        if not self._multi:
            key = None
        else:
            key = v1
            if key == NIL or not 0 <= key < self.model.state_width:
                return "__bad__", None
        return key, self._cell(key)

    def _admit(self, cell: _Cell, row: _Row) -> None:
        # the online cut: a fresh invoke against a cell with nothing
        # pending (and no op whose key is still unrevealed) means every
        # earlier cell op has returned — close the segment BEFORE
        # admitting the new row
        if cell.pending == 0 and not cell.crashed \
                and self._floating_n == 0 \
                and any(r.status == "ok" for r in cell.buf):
            self._close_segment(cell)
        cell.buf.append(row)
        cell.pending += 1

    def _on_invoke(self, op: Op, i: int) -> None:
        prev = self._open.pop(op.process, None)
        if prev is not None:
            # permissive double-invoke, as pair_index: the orphaned
            # invoke never pairs, i.e. it is a crashed op
            self._resolve(prev, INFO, i, None)
        if op.f not in self.model.f_codes:
            raise KeyError(f"op f={op.f!r} not in model f_codes "
                           f"{list(self.model.f_codes)}")
        fcode = self.model.f_codes[op.f]
        if self._mode == "single" and self._is_kv(op.value):
            # a jepsen.independent [k v] workload: per-key cells under
            # the test model — the streamed twin of
            # independent.checker's subhistory split
            if self._cells or self._extra:
                raise ValueError(
                    "independent [k v] op arrived after plain-valued "
                    "client ops; mixed histories are not streamable")
            self._mode = "independent"
        if self._mode == "independent":
            if self._is_kv(op.value):
                v1, v2 = self._lanes_value(op.value.value)
                row = _Row(i, op.process, fcode, v1, v2, op,
                           op.value.key)
                self._admit(self._cell(op.value.key), row)
            else:
                # key unknown until the completion reveals it: the op
                # floats, blocking every cell's cuts meanwhile
                row = _Row(i, op.process, fcode, NIL, NIL, op,
                           "__float__")
                self._floating_n += 1
        else:
            v1, v2 = self._lanes(op)
            key, cell = self._cell_for(v1)
            row = _Row(i, op.process, fcode, v1, v2, op, key)
            if cell is None:
                self._extra.append(row)
            else:
                self._admit(cell, row)
        self._open[op.process] = row

    def _on_complete(self, op: Op, i: int) -> None:
        row = self._open.pop(op.process, None)
        if row is None:
            return  # orphan completion: dropped, as pair_index does
        self._resolve(row, op.type, i, op)

    def _insert_floating(self, row: _Row) -> None:
        """Admit a just-keyed floating row into its cell's open segment
        at invocation order.  Sound because cuts need
        ``_floating_n == 0``: while this row floated no cell closed a
        segment, so every row already in a closed segment invoked (and
        returned) before this one invoked."""
        cell = self._cell(row.cell_key)
        pos = len(cell.buf)
        while pos > 0 and cell.buf[pos - 1].inv > row.inv:
            pos -= 1
        cell.buf.insert(pos, row)

    def _resolve(self, row: _Row, ctype: str, i: int, cop: Op | None):
        floating = row.cell_key == "__float__"
        cell = self._cells.get(row.cell_key) \
            if not floating and row.cell_key != "__bad__" else None
        if cell is not None:
            cell.pending -= 1
        if floating:
            self._floating_n -= 1
        if ctype == OK:
            row.status = "ok"
            row.ret = i
            if self._mode == "independent":
                if cop is None or not self._is_kv(cop.value):
                    if floating:
                        # an :ok op whose key was never revealed has no
                        # subhistory to land in — not streamable
                        raise ValueError(
                            "independent stream: :ok op without a "
                            "[k v] value")
                else:
                    row.v1, row.v2 = self._lanes_value(cop.value.value)
                    row.op = _dc_replace(row.op, value=cop.value)
                    if floating:
                        row.cell_key = cop.value.key
                        self._insert_floating(row)
            elif cop is not None and cop.value is not None:
                # the completion's value wins (history.complete: an
                # ok'd read's invocation carried nil)
                row.v1, row.v2 = self._lanes(cop)
                row.op = _dc_replace(row.op, value=cop.value)
            if row.cell_key not in ("__bad__", "__float__"):
                self._ok_rows += 1
            if row.cell_key == "__bad__":
                # an :ok op on an unsteppable key can never legally
                # step: the row itself IS the blocking frontier, and
                # the verdict is final right now
                self._bad_ok.append(row)
                if self._invalid is None:
                    self._mark_invalid({
                        "reason": "unsteppable key",
                        "cell": None, "event": i})
        elif ctype == INFO:
            row.status = "info"
            row.ret = INF_RET
            if cell is not None:
                cell.crashed = True
            # a crashed floating op never revealed its key: post-hoc it
            # is an always-legal NIL :info row in every subhistory —
            # verdict-neutral, so dropping it is exact
        else:  # fail: definitely didn't happen — drop the row
            row.status = "fail"
        c2 = self._cells.get(row.cell_key) \
            if row.cell_key not in ("__bad__", "__float__") else None
        if c2 is not None:
            if ctype == OK and c2.crashed:
                # the lookahead cadence counts POST-crash completions
                # only — the same basis stream_plan's
                # ``speculative_checks`` prediction uses
                c2.ok_in_buf += 1
            self._maybe_lookahead(c2)

    # ------------------------------------------------------------------
    # segment folding
    # ------------------------------------------------------------------

    def _close_segment(self, cell: _Cell) -> None:
        retained = [r for r in cell.buf if r.status == "ok"]
        cell.buf = []
        cell.ok_in_buf = 0
        cell.la_checked = 0
        for r in retained:
            r.cell_pos = len(cell.rows)
            cell.rows.append(r)
        if self._q is not None:
            self._q.put(("fold", cell, retained))
        else:
            self._fold(cell, retained)

    def _worker_loop(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            kind, cell, rows = task
            if kind == "spec":
                try:
                    self._speculate(cell, rows)
                except Exception:  # noqa: BLE001 — speculation must
                    # never degrade the stream; finalize still decides
                    log.debug("stream: lookahead check crashed",
                              exc_info=True)
                self._maybe_write_live()
                continue
            try:
                self._fold(cell, rows)
            except DeviceFoldError:
                pass  # kept in self._device_error; finalize raises it
            except Exception:  # noqa: BLE001 — one segment, not the run
                log.warning("stream: segment fold crashed; falling back",
                            exc_info=True)
                cell.fallback = True
                self._fallback = True
            self._maybe_write_live()

    def _fold(self, cell: _Cell, retained: list[_Row]) -> None:
        """Fold one closed, crash-free segment into the cell's carried
        state frontier — the streaming twin of the decomposed engine's
        quiescence loop."""
        t0 = time.perf_counter()
        with obs.span("stream.fold", cat="fold", run=self.run_id,
                      cell=str(cell.key), rows=len(retained)):
            self._fold_inner(cell, retained)
        _M_FOLD_S.observe(time.perf_counter() - t0)

    # threadlint: ok — single-owner: folds run only on the dedicated
    # "stream-fold" worker (or synchronously on the ingest thread when
    # async folds are off), so _stats/_cstats/cell fold-state have
    # exactly one writer until _drain_folds() joins the worker; all
    # cross-thread reads (verdict(), finalize()) take self._lock or
    # run post-join
    def _fold_inner(self, cell: _Cell, retained: list[_Row]) -> None:
        from ..decompose.canonical import canonical_payload
        from ..decompose.engine import _Inconclusive, _skey, segment_states

        if cell.fallback or self._fallback \
                or self._device_error is not None:
            return
        if self._invalid is not None and self._mode != "independent":
            # one invalid cell decides a single-object history, so
            # further folds are wasted work; independent keys keep
            # folding — the post-hoc checker reports EVERY key's
            # verdict, and so must the stream
            return
        sseq = _rows_opseq(retained, self._enc, value_lane=self._multi)
        self._methods.add("quiescence")
        skey = ren = None
        if self.cache is not None:
            payload, ren = canonical_payload(sseq, self._cell_model,
                                             instates=cell.states)
            skey = _skey(payload)
            e = self.cache.get(skey)
            if e is not None and "out" in e:
                self._cstats["hits"] += 1
                self._methods.add("cache")
                _M_FOLDED.inc(route="cache")
                states = set(ren.decode_states(e["out"]))
                if cell.chains is not None:
                    cell.chains = None
                    self._drop("witness", "segment state-set cache hit "
                               "(the cache stores states, not chains)")
                self._commit_fold(cell, retained, states, None,
                                  chains_known=False)
                return
            self._cstats["misses"] += 1
        from ..analyze.plan import segment_fold_route
        from ..history import max_concurrency

        wit = None
        states = None
        if self.hb:
            from ..analyze.hb import hb_fold_states

            out = hb_fold_states(sseq, self._cell_model, cell.states,
                                 witness=cell.chains is not None)
            if out is not None:
                if cell.chains is not None:
                    states, wit = out
                else:
                    states = out
                self._stats["routes"]["hb"] += 1
                _M_FOLDED.inc(route="hb")
                self._methods.add("hb-fold")
                if self.cache is not None:
                    self.cache.put_states(skey,
                                          ren.encode_states(states))
                    self._cstats["inserts"] += 1
                self._commit_fold(cell, retained, states, wit,
                                  chains_known=True)
                return
        route = segment_fold_route(len(sseq), max_concurrency(sseq),
                                   self._cell_model,
                                   host_fold_max=self.host_fold_max)
        if route == "device":
            from .device import device_fold_states

            try:
                out = device_fold_states(sseq, self._cell_model,
                                         cell.states,
                                         budget=self.device_budget,
                                         device=self.device)
            except Exception as e:
                # never a host fold in its place: the caller sees it
                err = DeviceFoldError(
                    f"device fold of a {len(sseq)}-row segment of cell "
                    f"{cell.key!r} on {self.device} failed: "
                    f"{type(e).__name__}: {e}")
                self._device_error = err
                raise err from e
            if out is not None:
                states, configs = out
                self._stats["routes"]["device"] += 1
                _M_FOLDED.inc(route="device")
                self._stats["configs_searched"] += configs
                self._methods.add("device")
                if cell.chains is not None:
                    cell.chains = None
                    self._drop("witness", "device-folded segment "
                               "carries states only")
        if states is None:
            self._stats["routes"]["host"] += 1
            _M_FOLDED.inc(route="host")
            try:
                if cell.chains is not None:
                    states, wit = segment_states(
                        sseq, self._cell_model, cell.states,
                        max_configs=self.sub_max_configs, witness=True)
                else:
                    states = segment_states(
                        sseq, self._cell_model, cell.states,
                        max_configs=self.sub_max_configs)
            except _Inconclusive:
                cell.fallback = True
                self._fallback = True
                return
        if self.cache is not None:
            self.cache.put_states(skey, ren.encode_states(states))
            self._cstats["inserts"] += 1
        self._commit_fold(cell, retained, states, wit, chains_known=True)

    def _commit_fold(self, cell: _Cell, retained, states, wit,
                     *, chains_known: bool) -> None:
        with self._lock:
            if chains_known and cell.chains is not None:
                if wit is None:
                    cell.chains = None
                    self._drop("witness",
                               "segment witness table exceeded its cap")
                else:
                    cell.chains = {
                        out_s: cell.chains[in_s]
                        + [retained[j].cell_pos for j in seg_chain]
                        for out_s, (in_s, seg_chain) in wit.items()}
            cell.states = states
            cell.segments += 1
            self._stats["segments"] += 1
            self._stats["checked_rows"] += len(retained)
            if not states:
                self._drop("frontier", "a quiescence segment has no "
                           "linearization (frontier not localized)")
                self._mark_invalid({
                    "reason": "segment has no linearization",
                    "cell": cell.key, "segment": cell.segments,
                    "event": self._events - 1})
            elif self._first_verdict_event is None:
                self._first_verdict_event = self._events - 1

    # ------------------------------------------------------------------
    # bounded `:info` lookahead (speculative fork check)
    # ------------------------------------------------------------------

    def _maybe_lookahead(self, cell: _Cell) -> None:
        """Schedule a speculative fork check of a crashed cell's open
        segment once a horizon's worth of post-crash :ok rows has
        accumulated at a pseudo-quiescent point (nothing pending, no
        floating keys) — the bounded-lookahead cut that lets a
        kill-seeded violation flip the live verdict mid-stream even
        though the `:info` op suppresses real quiescence cuts."""
        h = self.info_lookahead
        if not h or not cell.crashed or cell.pending != 0 \
                or self._floating_n != 0 or self._invalid is not None \
                or self._fallback or cell.fallback:
            return
        if cell.ok_in_buf - cell.la_checked < h:
            return
        cell.la_checked = cell.ok_in_buf
        from ..analyze.plan import info_fork_budget

        rows = [r for r in cell.buf if r.status in ("ok", "info")]
        n_infos = sum(1 for r in rows if r.status == "info")
        if not info_fork_budget(n_infos, len(rows)):
            # too costly to fork online — the POP-DPOR bound, now a
            # cost budget (pending infos x open-segment rows, the
            # sub-search's first-order cost) instead of a flat info
            # cap: the verdict still lands exactly at finalize
            _M_FORKS.inc(outcome="capped")
            return
        if self._q is not None:
            self._q.put(("spec", cell, rows))
        else:
            try:
                self._speculate(cell, rows)
            except Exception:  # noqa: BLE001 — speculation must never
                # degrade the stream (the op was already admitted;
                # raising here would poison ingest for a resolved row)
                log.debug("stream: lookahead check crashed",
                          exc_info=True)

    def _speculate(self, cell: _Cell, rows: list[_Row]) -> None:
        """The fork check itself: the crashed cell's open segment from
        every carried frontier state, with each `:info` op free to
        linearize at any position — or never (the sub-search already
        forks exactly present-at-each-position vs absent).  Sound as a
        FINAL verdict: later ops invoke after every retained op here
        returned, so they cannot interleave into this prefix, and the
        `:info` ops were given every placement including "later" — if
        no fork linearizes, no suffix can repair it.  A valid or
        inconclusive outcome changes nothing: the segment stays open
        and finalize folds it exactly as finalize-only mode would —
        final-verdict parity with lookahead off, by construction."""
        if self._invalid is not None or self._fallback or cell.fallback:
            return
        _M_FORKS.inc(outcome="spawned")
        with obs.span("stream.fork", cat="fold", run=self.run_id,
                      cell=str(cell.key), rows=len(rows)):
            self._speculate_inner(cell, rows)

    def _speculate_inner(self, cell: _Cell, rows: list[_Row]) -> None:
        sseq = _rows_opseq(rows, self._enc, value_lane=self._multi)
        sub = self._default_sub_check()
        with self._lock:
            self._stats["lookahead_checks"] += 1
            self._methods.add("lookahead")
        for s in sorted(cell.states):
            r = sub(sseq, _dc_replace(self._cell_model, init=tuple(s)),
                    max_configs=self.sub_max_configs)
            with self._lock:
                self._stats["configs_searched"] += int(
                    r.get("configs", 0) or 0)
            if r.get("valid") is not False:
                return  # some fork linearizes (or undecided): no news
        with self._lock:
            self._drop("frontier", "info-lookahead fork check found no "
                       "linearization (frontier spans the fork)")
            self._mark_invalid({
                "reason": "info-lookahead: no fork of the crashed "
                          "op(s) linearizes the prefix",
                "cell": cell.key, "event": self._events - 1,
                "infos": sum(1 for r in rows if r.status == "info")})

    def _mark_invalid(self, info: dict) -> None:
        if self._invalid is None:
            self._invalid = info
            self._invalid_event = self._events - 1

    def _drop(self, kind: str, reason: str) -> None:
        # first-writer-wins by design: any racing writer's reason is an
        # equally true first cause, and a lost overwrite is harmless —
        # the slot only ever goes None -> some-reason, never back
        if self._drops[kind] is None:
            self._drops[kind] = reason  # threadlint: ok — idempotent

    # ------------------------------------------------------------------
    # the live provisional verdict
    # ------------------------------------------------------------------

    def verdict(self) -> dict:
        """The current provisional verdict:

        ``status`` is ``"invalid"`` (final — a closed segment cannot
        linearize, or an :ok op can never step), ``"valid-so-far"``
        (every closed segment folded to a non-empty frontier), or
        ``"open"`` (nothing has quiesced yet: the whole prefix is the
        unquiesced tail)."""
        with self._lock:
            rows = self._ok_rows
            checked = self._stats["checked_rows"]
            if self._invalid is not None:
                status = "invalid"
            elif self._stats["segments"] > 0:
                status = "valid-so-far"
            else:
                status = "open"
            out = {
                "status": status,
                "run": self.run_id,
                "events": self._events,
                "rows": rows,
                "cells": len(self._cells),
                "segments_closed": self._stats["segments"],
                "checked_rows": checked,
                "open_rows": max(0, rows - checked),
                "routes": dict(self._stats["routes"]),
                "lookahead_checks": self._stats["lookahead_checks"],
                "fallback": self._fallback,
                "first_verdict_event": self._first_verdict_event,
                "invalid_event": self._invalid_event,
                "violation": dict(self._invalid) if self._invalid
                else None,
            }
            if self.cache is not None:
                out["cache"] = dict(self._cstats)
            return out

    def _maybe_write_live(self, force: bool = False,
                          final: dict | None = None) -> None:
        if self.live_path is None:
            return
        # one writer at a time: ingest and the fold thread both land
        # here, and two dumps into the shared tmp file would rename a
        # corrupt snapshot into place without any OSError to catch
        with self._live_lock:
            ev, t = self._live_last
            now = time.monotonic()
            # both constants are FLOORS: at least 64 events apart AND
            # at least 0.25s apart, so a hot stream never spends its
            # ingest path rewriting snapshots hundreds of times a second
            if not force and (self._events - ev < _LIVE_EVERY
                              or now - t < _LIVE_MIN_S):
                return
            self._live_last = (self._events, now)
            snap = self.verdict()
            if final is not None:
                snap["final"] = final
            tmp = self.live_path + ".tmp"
            try:
                os.makedirs(os.path.dirname(self.live_path) or ".",
                            exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(snap, f)
                os.replace(tmp, self.live_path)
            except OSError:
                log.debug("stream: live snapshot write failed",
                          exc_info=True)

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------

    def seq(self) -> OpSeq:
        """The full columnar history as streamed (available after
        :meth:`finalize`) — identical in shape to what
        ``encode_ops(history, model.f_codes)`` would build post-hoc.
        (Independent mode: the flattened per-key rows — useful for row
        accounting, but certified per cell, not as one history.)"""
        if self._seq is None:
            raise RuntimeError("seq() is available after finalize()")
        return self._seq

    def cell_seq(self, key) -> OpSeq:
        """One cell's full subhistory as streamed (after finalize) —
        the OpSeq its :attr:`cell_results` certificate indexes."""
        return _rows_opseq(self._cells[key].rows, self._enc,
                           value_lane=self._multi)

    # threadlint: ok — callers (finalize, close) serialize on
    # self._lock / the single finalize path; after the join the fold
    # worker is gone, so nulling _q/_worker has one writer
    def _drain_folds(self) -> None:
        if self._q is not None:
            self._q.put(None)
            if self._worker is not None:
                self._worker.join()
            self._q = None
            self._worker = None

    def finalize(self, *, audit: bool | None = None) -> dict:
        """Close the stream and emit the final result dict (same shape
        and certificate contract as ``check_opseq_decomposed``).  Open
        invokes become :info rows — the crashed tail of an aborted run
        still yields its verdict."""
        with self._lock:
            if self._finalized is not None:
                return self._finalized
            # crashed tail: invokes the stream never saw complete
            for row in self._open.values():
                cell = self._cells.get(row.cell_key) \
                    if row.cell_key != "__bad__" else None
                if cell is not None:
                    cell.pending -= 1
                    cell.crashed = True
                row.status = "info"
                row.ret = INF_RET
            self._open.clear()
        self._drain_folds()
        if self._device_error is not None:
            raise self._device_error
        with obs.span("stream.finalize", cat="check", run=self.run_id):
            out = self._finish(audit)
        self._finalized = out
        self._maybe_write_live(force=True, final={
            "valid": out.get("valid"), "engine": out.get("engine")})
        return out

    def _final_rows(self) -> list[_Row]:
        rows: list[_Row] = []
        for c in self._cells.values():
            rows.extend(c.rows)
        rows.extend(r for r in self._extra if r.status in ("ok", "info"))
        rows.sort(key=lambda r: r.inv)
        for g, r in enumerate(rows):
            r.g = g
        return rows

    def _finish(self, audit_flag) -> dict:
        from ..analyze.audit import maybe_audit
        from ..decompose.canonical import canonical_key, canonical_payload
        from ..decompose.engine import _skey
        from ..decompose.partition import merge_linearizations

        # final segments: whatever never quiesced (crashes included)
        for c in self._cells.values():
            final = [r for r in c.buf if r.status in ("ok", "info")]
            c.buf = []
            c.final_rows = final
            for r in final:
                r.cell_pos = len(c.rows)
                c.rows.append(r)
        rows = self._final_rows()
        self._seq = _rows_opseq(rows, self._enc, value_lane=False)
        if self._mode == "independent":
            self._methods.add("independent")
        elif self._multi and len(self._cells) > 1:
            self._methods.add("key-partition")

        stats = self._stats
        wkey = None
        if self.cache is not None and self._mode != "independent":
            # no whole-history key for independent streams: the
            # flattened [k v] rows canonically LOOK like a plain
            # register history, and caching the per-key-merged verdict
            # under that shape would poison real single-object lookups
            wkey = canonical_key(self._seq, self.model)

        # threadlint: ok — finalize path: runs strictly after
        # _drain_folds() joined the fold worker, so the process is
        # single-threaded over this state from here on
        def done(valid, extra: dict | None = None) -> dict:
            st = {
                "cells": max(1, len(self._cells)),
                "segments": stats["segments"]
                + sum(1 for c in self._cells.values() if c.final_rows),
                "rows": len(rows),
                "events": self._events,
                "checked_rows": stats["checked_rows"],
                "routes": dict(stats["routes"]),
                "lookahead_checks": stats["lookahead_checks"],
                "methods": sorted(self._methods),
                "first_verdict_event": self._first_verdict_event,
                "invalid_event": self._invalid_event,
                "fallback": self._fallback,
            }
            if stats.get("stitched"):
                st["stitched"] = True
            if self.cache is not None:
                if wkey is not None and valid in (True, False):
                    self.cache.put_verdict(wkey, valid)
                    self._cstats["inserts"] += 1
                st["cache_hits"] = self._cstats["hits"]
                st["cache_misses"] = self._cstats["misses"]
                st["cache_inserts"] = self._cstats["inserts"]
            out = {"valid": valid,
                   "configs": stats["configs_searched"],
                   "engine": "stream(%s)" % ",".join(st["methods"])
                   if self._methods else "stream",
                   "stream": st}
            if extra:
                out = {**extra, **out, "engine": out["engine"],
                       "stream": st}
            if out["valid"] is True and "linearization" not in out:
                out.setdefault("witness_dropped", self._drops["witness"]
                               or "streamed route produced no witness")
            if out["valid"] is False and "final_ops" not in out:
                out.setdefault("frontier_dropped", self._drops["frontier"]
                               or "streamed route produced no frontier")
            return maybe_audit(self._seq, self.model, out, audit_flag)

        if self._bad_ok:
            self._methods.add("key-partition")
            return done(False, extra={
                "final_ops": sorted(r.g for r in self._bad_ok)})
        if self._invalid is not None and not self._fallback \
                and self._mode != "independent":
            # final: a closed segment cannot linearize (independent
            # streams fall through — every key still gets its verdict)
            return done(False)
        if self._fallback and self._mode != "independent":
            # an inconclusive fold: one direct check of the whole
            # history (independent streams fall back per CELL below —
            # the flattened multi-key history is not one model's)
            return done(*self._finish_fallback(wkey))

        # each cell's final segment, checked from its carried frontier
        sub_check = self._default_sub_check()
        order = sorted(self._cells,
                       key=lambda k: (-len(self._cells[k].rows),
                                      str(k)))
        cell_lins: dict = {}
        invalid_frontier = None
        verdict = True
        has_unknown = False
        per_key: dict = {}
        for key in order:
            c = self._cells[key]
            v, lin, frontier = self._check_final(c, sub_check,
                                                 canonical_payload,
                                                 _skey)
            if v == "fallback":
                if self._mode == "independent":
                    v, lin, frontier = self._cell_direct(c)
                else:
                    return done(*self._finish_fallback(wkey))
            if self._mode == "independent":
                pk = {"valid": v}
                if lin is not None:
                    pk["witness_ops"] = len(lin)
                if v is False and frontier is not None:
                    pk["final_ops"] = sorted(c.rows[p].g
                                             for p in frontier)
                per_key[key] = pk
                self.cell_results[key] = {"valid": v,
                                          "linearization": lin,
                                          "final_ops": frontier}
            if v is False:
                verdict = False
                if frontier is not None and invalid_frontier is None:
                    invalid_frontier = [c.rows[p].g for p in frontier]
                if self._mode != "independent":
                    break
                continue
            if v not in (True, False):
                has_unknown = True
                continue
            if lin is not None:
                cell_lins[key] = [c.rows[p].g for p in lin]
            elif self.witness:
                self._drop("witness", self._drops["witness"]
                           or "a cell produced no witness")

        extra: dict = {}
        if self._mode == "independent":
            # the streamed twin of independent.checker's merge: False
            # wins, unknown is not a failure; certificates live per key
            if verdict is True and has_unknown:
                verdict = "unknown"
            extra["independent"] = {str(k): per_key[k] for k in order}
            self._drop("witness", "independent-key stream: witnesses "
                       "are per key (see `independent`)")
            if verdict is False and invalid_frontier is not None:
                extra["final_ops"] = sorted(invalid_frontier)
            else:
                self._drop("frontier", "independent-key stream: "
                           "frontiers are per key (see `independent`)")
            return done(verdict, extra=extra)
        if verdict is True and self.witness \
                and len(cell_lins) == len(self._cells):
            g = merge_linearizations(self._seq,
                                     [cell_lins[k] for k in order])
            if g is not None:
                extra["linearization"] = g
                if len(self._cells) > 1:
                    self._stats["stitched"] = True
            else:
                self._drop("witness", "cell-witness stitch found no "
                           "interleaving (engine bug; see W005)")
        if verdict is False and invalid_frontier is not None:
            extra["final_ops"] = sorted(invalid_frontier)
        return done(verdict, extra=extra or None)

    # threadlint: ok — finalize path (post-_drain_folds join):
    # single-threaded over _stats/_cstats/_drops by construction
    def _check_final(self, c: _Cell, sub_check, canonical_payload,
                     _skey):
        """-> (verdict | "fallback", cell-pos witness | None,
        cell-pos frontier | None) for one cell's final segment."""
        final = c.final_rows
        if c.fallback:
            return "fallback", None, None
        if not final:
            if not c.states:
                return False, None, None
            if c.chains is not None:
                return True, c.chains[min(sorted(c.states))], None
            return True, None, None
        fseq = _rows_opseq(final, self._enc, value_lane=self._multi)
        self._methods.add("sub-search")
        fkey = None
        if self.cache is not None:
            payload, _ren = canonical_payload(fseq, self._cell_model,
                                              instates=c.states)
            fkey = _skey(payload, b"fin")
            e = self.cache.get(fkey)
            if e is not None and "v" in e:
                self._cstats["hits"] += 1
                self._methods.add("cache")
                self._drop("witness", "final-segment verdict-cache hit")
                self._drop("frontier", "final-segment verdict-cache hit")
                return e["v"], None, None
            self._cstats["misses"] += 1
        v = False
        lin = frontier = None
        start = len(c.rows) - len(final)
        for s in sorted(c.states):
            r = sub_check(fseq,
                          _dc_replace(self._cell_model, init=tuple(s)),
                          max_configs=self.sub_max_configs)
            self._stats["configs_searched"] += int(r.get("configs", 0)
                                                   or 0)
            rv = r.get("valid")
            if rv is True:
                v = True
                flin = r.get("linearization")
                if c.chains is not None and flin is not None:
                    lin = c.chains[tuple(s)] + [start + j for j in flin]
                elif self.witness:
                    self._drop("witness", r.get(
                        "witness_dropped",
                        "final-segment sub-search produced no witness"))
                break
            if rv is not False:
                c.fallback = True
                return "fallback", None, None
            frontier = r.get("final_ops")
        if v is False and frontier is not None:
            frontier = [start + j for j in frontier]
        if self.cache is not None:
            self.cache.put_verdict(fkey, v)
            self._cstats["inserts"] += 1
        if v is False:
            self._drop("frontier", "final-segment sub-search produced "
                       "no frontier")
        return v, lin, (frontier if v is False else None)

    # threadlint: ok — finalize path (post-_drain_folds join):
    # single-threaded over _stats/_methods by construction
    def _cell_direct(self, c: _Cell):
        """Per-cell direct fallback (independent mode): one ordinary
        check of the cell's full recorded subhistory under the test
        model.  Row indices in the certificate are cell positions."""
        from ..checker.linear import DEFAULT_WITNESS_CAP, check_opseq_linear

        self._methods.add("direct")
        cseq = _rows_opseq(c.rows, self._enc, value_lane=False)
        r = check_opseq_linear(cseq, self._cell_model,
                               witness_cap=DEFAULT_WITNESS_CAP
                               if self.witness else 0, lint=False,
                               hb=self.hb, dpor=self.dpor)
        self._stats["configs_searched"] += int(r.get("configs", 0) or 0)
        v = r.get("valid", "unknown")
        return v, r.get("linearization"), \
            (r.get("final_ops") if v is False else None)

    # threadlint: ok — finalize path (post-_drain_folds join):
    # single-threaded over _stats/_cstats by construction
    def _finish_fallback(self, wkey):
        """One direct check of the whole recorded history — the
        streamed route hit a budget wall somewhere; the verdict must
        still be decided exactly as the post-hoc engine would."""
        from ..checker.linear import DEFAULT_WITNESS_CAP, check_opseq_linear

        self._methods.add("direct")
        r = check_opseq_linear(self._seq, self.model,
                               witness_cap=DEFAULT_WITNESS_CAP
                               if self.witness else 0, lint=False,
                               hb=self.hb, dpor=self.dpor)
        self._stats["configs_searched"] += int(r.get("configs", 0) or 0)
        if self.cache is not None and wkey is not None \
                and r.get("valid") in (True, False):
            self.cache.put_verdict(wkey, r["valid"])
            self._cstats["inserts"] += 1
        return r.get("valid", "unknown"), r

    def _default_sub_check(self):
        from ..checker.linear import DEFAULT_WITNESS_CAP, check_opseq_linear

        cap = DEFAULT_WITNESS_CAP if self.witness else 0

        def sub(sseq, smodel, *, max_configs):
            return check_opseq_linear(sseq, smodel,
                                      max_configs=max_configs,
                                      witness_cap=cap, lint=False,
                                      hb=self.hb, dpor=self.dpor)

        return sub

    def close(self) -> None:
        """Stop the fold worker without finalizing (abandoned stream)."""
        self._drain_folds()


class TotalFoldStream:
    """The total-queue (and set) fold route — streaming verdicts for
    the MODEL-LESS multiset families.

    The queue campaign families (``queue``, ``replicated-queue``)
    carry no ModelSpec: their post-hoc verdict is
    ``checker.basic.total_queue``'s multiset reduction, so until this
    class existed their cells could only ever grade
    ``detection.at="finalize"``.  This sink runs the constraint
    compiler's incremental edge form (:class:`analyze.constraints.
    MultisetFold`) per ingested event and flips the LIVE verdict the
    moment monotone evidence lands:

      * an :ok dequeue (or drained element) of a value no enqueue ever
        attempted — flagged at that event;
      * acked enqueues missing from every delivery once a drain has
        been observed at a point with no client op pending (the
        "drain-quiescent" cut — the lost-ack flip lands when the final
        drain returns short, mid-history, not at teardown).

    The mid-stream flip is *provisional* (a pathological suffix could
    re-attempt a value or deliver a missing one); :meth:`finalize`
    always recomputes the verdict with the post-hoc checker itself —
    ``total_queue`` for queues, ``set_checker`` for sets — so the
    final verdict is bit-identical to the post-hoc route by
    construction, and detection is only ever graded when finalize
    confirms.  Invalid finals carry a ``queue_evidence`` certificate
    (event rows) the independent audit re-justifies (W007).
    """

    def __init__(self, family: str = "total-queue", *,
                 live_path: str | None = None,
                 run_id: str | None = None):
        from ..analyze.constraints import MultisetFold

        self.family = family
        self.fold = MultisetFold(family)
        self.live_path = live_path
        self.run_id = run_id
        self._lock = threading.RLock()
        self._events = 0
        self._ops: list[Op] = []
        self._rows = 0
        self._invalid: dict | None = None
        self._invalid_event: int | None = None
        self._first_verdict_event: int | None = None
        self._finalized: dict | None = None
        self._live_last = (0, 0.0)
        self._live_lock = threading.Lock()

    def ingest(self, op: Op) -> None:
        with self._lock:
            if self._finalized is not None:
                raise RuntimeError("stream already finalized")
            i = self._events
            self._events += 1
            _M_INGESTED.inc()
            if not isinstance(op.process, int):
                return
            self._ops.append(op)
            if op.type != INVOKE:
                self._rows += 1
                if self._first_verdict_event is None:
                    self._first_verdict_event = i
            flip = self.fold.step(op, len(self._ops) - 1)
            if flip is not None and self._invalid is None:
                self._invalid = flip
                self._invalid_event = i
        self._maybe_write_live()

    def verdict(self) -> dict:
        with self._lock:
            if self._invalid is not None:
                status = "invalid"
            elif self._first_verdict_event is not None:
                status = "valid-so-far"
            else:
                status = "open"
            return {
                "status": status,
                "run": self.run_id,
                "family": self.family,
                "events": self._events,
                "rows": self._rows,
                "first_verdict_event": self._first_verdict_event,
                "invalid_event": self._invalid_event,
                "violation": dict(self._invalid)
                if self._invalid else None,
            }

    def _maybe_write_live(self, force: bool = False,
                          final: dict | None = None) -> None:
        if self.live_path is None:
            return
        with self._live_lock:
            ev, t = self._live_last
            now = time.monotonic()
            if not force and (self._events - ev < _LIVE_EVERY
                              or now - t < _LIVE_MIN_S):
                return
            self._live_last = (self._events, now)
            snap = self.verdict()
            if final is not None:
                snap["final"] = final
            tmp = self.live_path + ".tmp"
            try:
                os.makedirs(os.path.dirname(self.live_path) or ".",
                            exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(snap, f, default=str)
                os.replace(tmp, self.live_path)
            except OSError:
                log.debug("stream: live snapshot write failed",
                          exc_info=True)

    def finalize(self, *, audit: bool | None = None) -> dict:
        """Close the stream: the POST-HOC checker's verdict over
        exactly the recorded client ops (bit-identical to the
        authoritative route), plus the streamed detection stats and —
        on invalid — the W007-auditable evidence certificate."""
        from ..analyze.audit import maybe_audit_events
        from ..analyze.constraints import (
            analyze_queue_events,
            analyze_set_events,
        )
        from ..checker import basic

        with self._lock:
            if self._finalized is not None:
                return self._finalized
            ops = list(self._ops)
            with obs.span("stream.finalize", cat="check",
                          run=self.run_id, family=self.family):
                if self.family == "set":
                    checker = basic.set_checker()
                    evidence = analyze_set_events(ops)
                else:
                    checker = basic.total_queue()
                    evidence = analyze_queue_events(ops)
                try:
                    post = checker.check({}, ops)
                except Exception as e:  # noqa: BLE001 — same contract
                    # as check_safe: a checker crash (e.g. a crashed
                    # drain the expansion rejects) is unknown, never
                    # a stream crash
                    post = {"valid": "unknown",
                            "error": f"{type(e).__name__}: {e}"}
            out = dict(post)
            out["engine"] = f"stream({self.family})"
            out["stream"] = {
                "family": self.family,
                "events": self._events,
                "rows": self._rows,
                "segments": 1,
                "routes": {self.family: 1},
                "first_verdict_event": self._first_verdict_event,
                "invalid_event": self._invalid_event
                if out.get("valid") is False else None,
                "edges": evidence.get("edges"),
            }
            if out.get("valid") is False:
                # the RECOMPUTED full-history evidence, not the
                # provisional flip's: a mid-stream flip may have named
                # values a later drain delivered, and the certificate
                # must justify the FINAL verdict (W007 audits it)
                ev = evidence.get("evidence") or self._invalid
                if ev is not None:
                    out["queue_evidence"] = dict(ev)
            out = maybe_audit_events(ops, out, audit)
            self._finalized = out
        self._maybe_write_live(force=True, final={
            "valid": out.get("valid"), "engine": out.get("engine")})
        return out

    def close(self) -> None:
        """Nothing to stop (no fold worker); kept for sink parity."""
