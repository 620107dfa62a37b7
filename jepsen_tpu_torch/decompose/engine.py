"""The decomposed linearizability checker.

:func:`check_opseq_decomposed` runs the funnel, each stage exact:

    canonical-hash cache  ->  per-key cells  ->  per cell:
        cache -> value blocks -> quiescence segments -> sub-search

Quiescence segments compose in sequence: every op of segment i returns
before every op of segment i+1 invokes, so a linearization of the cell
is one of segment 1, then 2, and so on, coupled only by the model state
carried across each cut.  The segments before the last are crash-free
(a crashed op's infinite return suppresses every later cut), so each is
folded to the complete set of reachable final states (the interval pass
of ``analyze/hb.py`` where it decides, else a level sweep), which seeds
the next; the last segment is checked from each carried-in state by the
host engine.  Sub-results are cached by canonical hash: for a segment
its input states are part of the key and its output states the value.

Anything inconclusive (a sub-search's or the sweep's budget) falls back
to the ``direct`` engine on the whole history: decomposition only adds
decided verdicts, never changes one.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import replace as _dc_replace

from .. import obs
from ..history import OpSeq
from .cache import VerdictCache
from .canonical import canonical_key, canonical_payload
from .partition import quiescence_segments, subseq, value_block_verdict


class _Inconclusive(Exception):
    """A sub-search ran out of budget or time: fall back to direct."""


class _DirectUndecided(Exception):
    """The direct engine itself came back undecided; its result is the
    answer."""

    def __init__(self, result: dict):
        super().__init__(result.get("info", "undecided"))
        self.result = result


def _make_default_sub_check(witness: bool, hb: bool | None = None,
                            dpor: bool | None = None):
    """The host ``linear`` sweep as the engine of cells and final
    segments, lint off (projections of a linted history), ``hb`` and
    ``dpor`` passed through."""
    from ..checker.linear import DEFAULT_WITNESS_CAP, check_opseq_linear

    cap = DEFAULT_WITNESS_CAP if witness else 0

    def sub_check(sseq, smodel, *, max_configs, deadline):
        return check_opseq_linear(sseq, smodel, max_configs=max_configs,
                                  deadline=deadline, witness_cap=cap,
                                  lint=False, hb=hb, dpor=dpor)

    return sub_check


def segment_states(sseq: OpSeq, model, init_states, *,
                   max_configs: int = 50_000_000,
                   deadline: float | None = None,
                   witness: bool = False):
    """Every model state reachable by linearizing a crash-free segment
    in full, from any state of ``init_states``; the empty set means no
    linearization (the segment, and so its cell, is invalid).  The sweep
    is ``checker/linear.py``'s without the crash machinery.

    With ``witness=True`` returns ``(states, wit)``: ``wit`` maps each
    final state to ``(input state, row chain)``, one linearization of
    the segment (its own rows) from that input, or is None once the
    parent table outgrew ``DEFAULT_WITNESS_CAP`` (the states are
    unaffected)."""
    # imported here: checker/encode imports this package's canonical
    from ..checker.encode import INF32, encode_search
    from ..checker.linear import DEFAULT_WITNESS_CAP, _advance

    es = encode_search(sseq)
    if es.n_crash:
        raise ValueError("segment_states requires a crash-free segment")
    n_det, W = es.n_det, es.window
    states0 = {tuple(int(x) for x in s) for s in init_states}
    if n_det == 0:
        return (states0, {s: (s, []) for s in states0}) if witness \
            else states0

    det_inv = [int(x) for x in es.det_inv]
    det_ret = [int(x) for x in es.det_ret]
    det_f = [int(x) for x in es.det_f]
    det_v1 = [int(x) for x in es.det_v1]
    det_v2 = [int(x) for x in es.det_v2]
    sfx = [int(x) for x in es.suffix_min_ret]
    pystep = model.pystep
    INF = int(INF32)

    frames: dict[tuple, list] = {}

    def frame(p: int, win: int) -> list:
        fr = frames.get((p, win))
        if fr is not None:
            return fr
        if len(frames) > 1_000_000:
            frames.clear()
        hi = min(p + W, n_det)
        w_ret = [INF if (win >> (j - p)) & 1 else det_ret[j]
                 for j in range(p, hi)]
        tail = sfx[hi] if hi < len(sfx) else INF
        m1, m2, m1_at = tail, INF + 1, -1
        for i, r in enumerate(w_ret):
            if r < m1:
                m2, m1, m1_at = m1, r, i
            elif r < m2:
                m2 = r
        fr = []
        for i in range(hi - p):
            if (win >> i) & 1:
                continue
            j = p + i
            excl = m2 if i == m1_at else m1
            if det_inv[j] < excl:
                fr.append((i, det_f[j], det_v1[j], det_v2[j]))
        frames[(p, win)] = fr
        return fr

    level = {(0, 0, s) for s in states0}
    # (p, win, state) -> (segment row, parent); roots absent.  Det
    # positions are the segment's rows (crash-free, sorted by inv)
    parents: dict | None = {} if witness else None
    configs = 0
    for _depth in range(n_det):
        if deadline is not None and time.perf_counter() > deadline:
            raise _Inconclusive("segment sweep exceeded deadline")
        nxt = set()
        for p, win, state in level:
            for i, f, v1, v2 in frame(p, win):
                ns = pystep(state, f, v1, v2)
                if ns is None:
                    continue
                configs += 1
                if configs > max_configs:
                    raise _Inconclusive("segment sweep exceeded budget")
                p2, win2 = _advance(p, win, i, n_det)
                child = (p2, win2, ns)
                if parents is not None and child not in nxt:
                    if len(parents) >= DEFAULT_WITNESS_CAP:
                        parents = None
                    else:
                        parents.setdefault(child,
                                           (p + i, (p, win, state)))
                nxt.add(child)
        level = nxt
        if not level:
            return (set(), {}) if witness else set()
    states = {state for _p, _w, state in level}
    if not witness:
        return states
    if parents is None:
        return states, None
    wit: dict = {}
    for cfg in level:
        state = cfg[2]
        if state in wit:
            continue
        chain: list[int] = []
        node = cfg
        while node[0] != 0 or node[1] != 0:
            row, node = parents[node]
            chain.append(row)
        chain.reverse()
        wit[state] = (node[2], chain)
    return states, wit


def _skey(payload: bytes, kind: bytes = b"seg") -> str:
    """A segment entry's cache key.  ``kind`` keeps apart the two
    entries one segment payload can give, ``b"seg"`` (a reachable-state
    set) and ``b"fin"`` (a final segment's verdict), so neither
    overwrites the other."""
    return hashlib.sha256(kind + b"|" + payload).hexdigest()


def check_opseq_decomposed(seq: OpSeq, model, *,
                           cache: VerdictCache | str | None = None,
                           direct=None, sub_check=None,
                           sub_max_configs: int = 50_000_000,
                           deadline: float | None = None,
                           scheduler: str | None = None,
                           n_procs: int | None = None,
                           lint: bool | None = None,
                           witness: bool = False,
                           audit: bool | None = None,
                           hb: bool | None = None,
                           dpor: bool | None = None,
                           device="cuda",
                           telemetry: bool | None = None) -> dict:
    """Check ``seq`` by decomposition; the verdict is ``direct``'s.

    cache       a VerdictCache, a jsonl path, or None (no caching)
    direct      fn(seq) -> result; runs the whole history when nothing
                splits or a sub-search is inconclusive (None: an
                inconclusive history gives "unknown")
    sub_check   fn(sub_seq, sub_model, max_configs=, deadline=) ->
                result, the engine of final segments and unsplit cells
                (None: the host ``linear`` sweep)
    scheduler   None (in process, largest first), "pool" (a process pool
                of host engines over the cells) or "device" (the cells
                as one ``search_batch`` on ``device``)

    ``device`` (default "cuda") is resolved only where the device
    scheduler runs, so the other schedulers need no card; ``telemetry``
    reaches that batch.  The result carries a ``decompose`` dict (cells,
    segments, cache hits/misses/inserts, configs searched, the methods
    that fired).

    Certificates: a valid result carries ``linearization`` (with
    ``witness=True`` the cells' witnesses stitched into one order by
    ``partition.merge_linearizations``; ``decompose.stitched`` marks it)
    or ``witness_dropped``, the stage that could not give one; an
    invalid result carries ``final_ops`` in the parent's rows when the
    deciding cell's engine gave a frontier, else ``frontier_dropped``.
    ``audit=True`` replays the certificate.  ``lint`` (None: on) lints
    the history first, so a malformed one never reaches the cache;
    ``hb`` (None: on) answers segment folds by the interval pass where
    it decides, and with ``dpor`` reaches the default sub-engine."""
    from ..analyze.audit import maybe_audit
    from ..analyze.hb import hb_fold_states, resolve_hb
    from ..analyze.lint import maybe_lint
    from .partition import (cells_from_rows, key_partition_rows,
                            merge_linearizations, value_block_witness)

    maybe_lint(seq, model, lint)
    hb_on = resolve_hb(hb)
    if isinstance(cache, str):
        cache = VerdictCache(cache)
    if sub_check is None:
        sub_check = _make_default_sub_check(witness, hb=hb, dpor=dpor)
    stats = {"cells": 0, "segments": 0, "cache_hits": 0,
             "cache_misses": 0, "configs_searched": 0, "methods": []}
    methods: set = set()
    #: the first reason a witness / frontier could not be carried
    drops = {"witness": None, "frontier": None}

    def drop(kind: str, reason: str) -> None:
        if drops[kind] is None:
            drops[kind] = reason

    if not witness:
        drop("witness", "witness not requested (witness=False)")

    def done(valid, extra: dict | None = None) -> dict:
        if cache is not None:
            stats["cache_hits"] = cache.hits
            stats["cache_misses"] = cache.misses
            stats["cache_inserts"] = cache.inserts
        stats["methods"] = sorted(methods)
        out = {"valid": valid, "configs": stats["configs_searched"],
               "engine": "decompose(%s)" % ",".join(
                   stats["methods"]) if methods else "decompose",
               "decompose": stats}
        if extra:
            out = {**extra, **out, "engine": out["engine"],
                   "decompose": stats}
        # a decided verdict carries its evidence or says why not
        if out["valid"] is True and "linearization" not in out:
            out.setdefault("witness_dropped", drops["witness"]
                           or "decomposed route produced no witness")
        if out["valid"] is False and "final_ops" not in out:
            out.setdefault("frontier_dropped", drops["frontier"]
                           or "decomposed route produced no frontier")
        return maybe_audit(seq, model, out, audit)

    wkey = None
    if cache is not None:
        cache.reset_stats()
        # the whole history's canonical form is O(n) Python; a check
        # without a cache skips it
        wkey = canonical_key(seq, model)
        e = cache.get(wkey)
        if e is not None and "v" in e:
            methods.add("cache")
            drop("witness", "whole-history verdict-cache hit "
                            "(the cache stores verdicts, not witnesses)")
            drop("frontier", "whole-history verdict-cache hit")
            return done(e["v"])

    # one key-partition scan serves the split, the early verdict and the
    # stitcher's cell-row -> parent-row maps
    by_key, bad_rows = key_partition_rows(seq, model)
    if by_key is not None and bad_rows:
        methods.add("key-partition")
        stats["cells"] = 1
        if cache is not None:
            cache.put_verdict(wkey, False)
        # the :ok rows that can never step are the blocking frontier
        return done(False,
                    extra={"final_ops": [int(r) for r in bad_rows]})
    if by_key is None:
        cells, cell_model = {0: seq}, model
        cell_rows: dict = {0: list(range(len(seq)))}
    else:
        cells, cell_model = cells_from_rows(seq, model, by_key)
        cell_rows = by_key
        if len(cells) > 1:
            methods.add("key-partition")
    stats["cells"] = len(cells)
    order = sorted(cells, key=lambda k: -len(cells[k]))  # largest first

    def check_cell(cseq: OpSeq, is_whole: bool):
        """-> (verdict, the direct result or None, witness rows or None,
        frontier rows or None); rows index the cell, and the caller maps
        them to the parent through ``cell_rows``."""
        ckey = None
        if cache is not None:
            ckey = wkey if is_whole else canonical_key(cseq, cell_model)
            if not is_whole:
                e = cache.get(ckey)
                if e is not None and "v" in e:
                    methods.add("cache")
                    drop("witness", "cell verdict-cache hit (the cache "
                                    "stores verdicts, not witnesses)")
                    drop("frontier", "cell verdict-cache hit")
                    return e["v"], None, None, None
        vb = value_block_verdict(cseq, cell_model)
        if vb is not None:
            methods.add("value-blocks")
            if cache is not None:
                cache.put_verdict(ckey, vb)
            lin = None
            if vb is True and witness:
                lin = value_block_witness(cseq, cell_model)
                if lin is None:
                    drop("witness",
                         "value-block witness construction failed")
            if vb is False:
                drop("frontier", "cell decided invalid by the value-"
                                 "block order test (no row frontier)")
            return vb, None, lin, None
        segs = quiescence_segments(cseq)
        stats["segments"] += len(segs)
        if len(segs) <= 1:
            if is_whole and direct is not None:
                r = direct(cseq)
                methods.add("direct")
            else:
                r = sub_check(cseq, cell_model,
                              max_configs=sub_max_configs,
                              deadline=deadline)
                methods.add("sub-search")
            stats["configs_searched"] += int(r.get("configs", 0) or 0)
            v = r.get("valid")
            if v not in (True, False):
                if is_whole and direct is not None:
                    raise _DirectUndecided(r)  # nothing left to try
                raise _Inconclusive(r.get("info", "sub-search undecided"))
            if cache is not None:
                cache.put_verdict(ckey, v)
            lin = r.get("linearization")
            if v is True and lin is None:
                drop("witness", r.get("witness_dropped",
                                      "sub-search produced no witness"))
            return v, (r if is_whole else None), lin, r.get("final_ops")
        methods.add("quiescence")
        states = {tuple(cell_model.init)}
        # model state -> one cell-row chain reaching it, threaded across
        # segments; None once a stage cannot witness
        chains: dict | None = {tuple(cell_model.init): []} if witness \
            else None
        for rows in segs[:-1]:
            sseq = subseq(cseq, rows)
            e = ren = skey = None
            if cache is not None:
                payload, ren = canonical_payload(sseq, cell_model,
                                                 instates=states)
                skey = _skey(payload)
                e = cache.get(skey)
            if e is not None and "out" in e:
                states = set(ren.decode_states(e["out"]))
                if chains is not None:
                    chains = None
                    drop("witness", "segment state-set cache hit (the "
                                    "cache stores states, not chains)")
            elif chains is not None:
                with obs.span("segment.fold", cat="fold",
                              rows=len(rows)):
                    # the interval pass answers its class with the same
                    # exact states (and chains) the sweep would give
                    hbout = hb_fold_states(
                        sseq, cell_model, states,
                        witness=True) if hb_on else None
                    if hbout is not None:
                        states, wit = hbout
                        methods.add("hb-fold")
                    else:
                        states, wit = segment_states(
                            sseq, cell_model, states,
                            max_configs=sub_max_configs,
                            deadline=deadline, witness=True)
                if cache is not None:
                    cache.put_states(skey, ren.encode_states(states))
                if wit is None:
                    chains = None
                    drop("witness", "segment witness table exceeded "
                                    "its cap")
                else:
                    chains = {out_s: chains[in_s]
                              + [int(rows[j]) for j in seg_chain]
                              for out_s, (in_s, seg_chain) in wit.items()}
            else:
                with obs.span("segment.fold", cat="fold",
                              rows=len(rows)):
                    hbout = hb_fold_states(
                        sseq, cell_model, states) if hb_on else None
                    if hbout is not None:
                        states = hbout
                        methods.add("hb-fold")
                    else:
                        states = segment_states(
                            sseq, cell_model, states,
                            max_configs=sub_max_configs,
                            deadline=deadline)
                if cache is not None:
                    cache.put_states(skey, ren.encode_states(states))
            if not states:
                if cache is not None:
                    cache.put_verdict(ckey, False)
                drop("frontier", "a quiescence segment has no "
                                 "linearization (frontier not "
                                 "localized)")
                return False, None, None, None
        fseq = subseq(cseq, segs[-1])
        e = fkey = None
        if cache is not None:
            payload, _ren = canonical_payload(fseq, cell_model,
                                              instates=states)
            fkey = _skey(payload, b"fin")
            e = cache.get(fkey)
        lin = frontier = None
        if e is not None and "v" in e:
            v = e["v"]
            drop("witness", "final-segment verdict-cache hit")
            drop("frontier", "final-segment verdict-cache hit")
        else:
            v = False
            for s in sorted(states):
                r = sub_check(fseq, _dc_replace(cell_model, init=tuple(s)),
                              max_configs=sub_max_configs,
                              deadline=deadline)
                stats["configs_searched"] += int(r.get("configs", 0) or 0)
                rv = r.get("valid")
                if rv is True:
                    v = True
                    flin = r.get("linearization")
                    if chains is not None and flin is not None:
                        final_rows = segs[-1]
                        lin = chains[tuple(s)] + [int(final_rows[j])
                                                  for j in flin]
                    elif witness:
                        drop("witness", r.get(
                            "witness_dropped",
                            "final-segment sub-search produced no "
                            "witness"))
                    break
                if rv is not False:
                    raise _Inconclusive(
                        r.get("info", "final segment undecided"))
                frontier = r.get("final_ops")
            if v is False and frontier is not None:
                # frontier rows index the final segment's projection
                frontier = [int(segs[-1][j]) for j in frontier]
            if cache is not None:
                cache.put_verdict(fkey, v)
        if cache is not None:
            cache.put_verdict(ckey, v)
        return v, None, lin, frontier

    try:
        verdict = True
        last_direct = None
        cell_lins: dict = {}  # cell key -> parent-row witness
        invalid_frontier = None  # parent rows of the deciding frontier
        pending = order
        if scheduler in ("pool", "device") and len(pending) > 1:
            from . import schedule

            cell_list = [cells[k] for k in pending]
            # the budget bounds both schedulers; the deadline bounds the
            # pool, while a device batch can only refuse to start late
            left = (max(0.1, deadline - time.perf_counter())
                    if deadline is not None else None)
            if scheduler == "pool":
                with obs.span("cells.pool", cat="check",
                              cells=len(cell_list)):
                    verdicts, pool_configs = schedule.pool_check_cells(
                        cell_list, cell_model, n_procs=n_procs,
                        cache_path=getattr(cache, "path", None),
                        max_configs=sub_max_configs, deadline_s=left)
                stats["configs_searched"] += int(pool_configs)
                drop("witness",
                     "pool-scheduled cells return verdicts only")
                drop("frontier",
                     "pool-scheduled cells return verdicts only")
            else:
                if deadline is not None and \
                        time.perf_counter() >= deadline:
                    raise _Inconclusive("deadline before device batch")
                with obs.span("cells.device", cat="device",
                              cells=len(cell_list)):
                    cell_results = schedule.device_batch_cells(
                        cell_list, cell_model, budget=sub_max_configs,
                        device=device, telemetry=telemetry)
                verdicts = [r.get("valid") for r in cell_results]
                # the cells' own results keep the accounting: configs
                # billed, and the engines that ran named
                stats["configs_searched"] += sum(
                    int(r.get("configs", 0) or 0) for r in cell_results)
                stats["cell_engines"] = sorted(
                    {str(r.get("engine")) for r in cell_results})
                for k, r in zip(pending, cell_results):
                    if r.get("valid") is True:
                        clin = r.get("linearization")
                        if clin is not None:
                            cell_lins[k] = [int(cell_rows[k][j])
                                            for j in clin]
                        else:
                            drop("witness", r.get(
                                "witness_dropped",
                                "device-scheduled cell produced no "
                                "witness"))
                    elif r.get("valid") is False:
                        cfr = r.get("final_ops")
                        if cfr is not None and invalid_frontier is None:
                            invalid_frontier = [int(cell_rows[k][j])
                                                for j in cfr]
                        else:
                            drop("frontier", r.get(
                                "frontier_dropped",
                                "device-scheduled cell produced no "
                                "frontier"))
            methods.add(scheduler)
            # one invalid cell decides the history (locality), even
            # beside an undecided one
            if False in verdicts:
                verdict = False
            else:
                for v in verdicts:
                    if v is not True:
                        raise _Inconclusive("scheduled cell undecided")
        else:
            for k in pending:
                with obs.span("cell.check", cat="check", cell=str(k),
                              rows=len(cells[k])):
                    v, r, clin, cfr = check_cell(cells[k],
                                                 cells[k] is seq)
                if r is not None:
                    last_direct = r
                if clin is not None:
                    cell_lins[k] = [int(cell_rows[k][j]) for j in clin]
                if v is False:
                    verdict = False
                    if cfr is not None:
                        invalid_frontier = [int(cell_rows[k][j])
                                            for j in cfr]
                    break
    except _DirectUndecided as e:
        return done("unknown", extra=e.result)
    except _Inconclusive:
        if direct is None:
            return done("unknown")
        r = direct(seq)
        methods.add("direct")
        stats["configs_searched"] += int(r.get("configs", 0) or 0)
        if cache is not None and r.get("valid") in (True, False):
            cache.put_verdict(wkey, r["valid"])
        return done(r.get("valid", "unknown"), extra=r)

    if cache is not None:
        cache.put_verdict(wkey, verdict)
    extra = dict(last_direct) if last_direct else {}
    if verdict is True and witness and "linearization" not in extra:
        if len(cell_lins) == len(cells):
            # the P-compositional stitch: the cells' witnesses interleave
            # into one order that respects the parent's real time
            g = merge_linearizations(seq, [cell_lins[k] for k in order])
            if g is not None:
                extra["linearization"] = g
                if len(cells) > 1:
                    stats["stitched"] = True
            else:
                drop("witness", "cell-witness stitch found no "
                                "interleaving (engine bug; see W005)")
        else:
            drop("witness", drops["witness"]
                 or "some cells produced no witness")
    if verdict is False and "final_ops" not in extra \
            and invalid_frontier is not None:
        extra["final_ops"] = sorted(invalid_frontier)
    return done(verdict, extra=extra or None)
