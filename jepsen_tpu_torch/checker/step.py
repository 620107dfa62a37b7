"""One bounded slice of the breadth-first search, as plain torch ops.

This is the search engine for every frontier rung the fused CUDA level
loop does not take (``level_kernel.eligible``: other models, wider
rungs, and every search with reductions), and, unreduced and pinned to
the all-pairs prune, that kernel's plain version.  It computes bit for
bit what the JAX package's ``build_search_step_fn`` computes: same
28-argument signature, same 6-tuple carry ``(frontier, count, status,
configs, max_depth, ovf)``, the same two optional reductions, and, in
its telemetry build, the same per-level aux block as a 7th output.  ``masked``: a candidate lane is enabled only
once its must-order predecessors (``encode.attach_reductions``) are
linearized, det ones by the prefix/window test, crash ones
(``masked_crash``) by a subset test of packed words against the
configuration's crash mask.  ``dedup``: a successor state whose value
is dead at the configuration's prefix is rewritten to the dead token,
so symmetric configurations merge in the prune.

``telemetry``: the step also returns an int32 ``[TELE_ROWS, TELE_COLS]``
block (``obs/telemetry.py``), one row per level run, added at row
``min(level, TELE_ROWS - 1)``: occupancy after the closure, valid lanes
expanded, lanes the mask killed, dead-value folds (both summed over the
closure's mask phases), closure rounds, the count after the revert,
whether the level newly overflowed, and whether it found the goal.  The
row index is the loop counter, so the block adds no device-to-host read;
nothing reads it back, so the carry is the same on and off.

A level's depth counts DETERMINATE linearizations only.  Per level:

  1. mask phase: per configuration, the enabled candidates (window
     min/second-min return plus the suffix-min beyond the window), the
     model step on each, and the goal test;
  2. crash closure: while any crash successor survives the merge, merge
     crash successors into the level (dominance prune) and re-expand;
     at most ``n_crash + 1`` rounds;
  3. determinate successors into the next level, dominance-pruned and
     compacted to ``F`` rows in (row-major, lane-ascending) order.

An overflowing level under ``bail`` is uncommitted so the driver can
resume wider from the last clean carry.  ``status``: -1 running,
2 valid, 1 died out, 0 unknown.

The vmapped per-configuration functions of the JAX package become a
written-out row dimension.  The level and closure loops are Python loops
that read one device scalar per iteration to decide whether to go on.
"""

from __future__ import annotations

import torch

from ..obs.telemetry import (C_DEDUP, C_EXP, C_GOAL, C_KILL, C_NEXT,
                             C_OCC, C_OVF, C_ROUNDS, TELE_COLS, TELE_ROWS)
from .encode import (INF32, SearchDims, _pack_bits, _round_up, _u32,
                     _unpack_bits)

#: dominance-pass window of the sorted prune: each sorted row is tested
#: against this many predecessors (misses keep redundant rows, never
#: drop reachable ones)
_DOM_WINDOW = 8

#: prune implementation: "sort" (windowed sorted prune), "allpairs"
#: (exact [M, M] prune) or "auto" — allpairs on the card up to
#: _ALLPAIRS_MAX rows, sort elsewhere (the JAX package's choice, with
#: the card in the TPU's place)
_DOMINANCE_MODE = "auto"
_ALLPAIRS_MAX = 8192
_ALLPAIRS_ELEMS = 1 << 28

_MASK32 = 0xFFFFFFFF


def _use_allpairs(M: int, device: torch.device,
                  mode: str | None = None) -> bool:
    """Whether the prune over M rows is all-pairs, under ``mode``
    (default: the module's ``_DOMINANCE_MODE``)."""
    mode = _DOMINANCE_MODE if mode is None else mode
    if mode == "allpairs":
        return M * M <= _ALLPAIRS_ELEMS
    if mode == "sort":
        return False
    return (device.type == "cuda" and M <= _ALLPAIRS_MAX
            and M * M <= _ALLPAIRS_ELEMS)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for unsigned 32-bit values held in int64,
    split so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of unsigned 32-bit values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


def _hash_words(words: torch.Tensor, seed: int) -> torch.Tensor:
    """Murmur-style mix of unsigned 32-bit words [..., w] (in int64) to
    one unsigned 32-bit hash [...]."""
    h = torch.full(words.shape[:-1], seed, dtype=torch.int64,
                   device=words.device)
    for i in range(words.shape[-1]):
        h = _mul32(h ^ words[..., i], 0x85EBCA6B)
        h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _trailing_ones(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> the run of set bits from bit 0 (n when all set)."""
    n = bits.shape[-1]
    lanes = torch.arange(n, device=bits.device)
    return torch.where(bits, n, lanes).min(dim=-1).values


def _compact_indices(mask: torch.Tensor, k_out: int):
    """Indices of the first ``k_out`` set entries of a 1-D bool mask
    (stable), and the total count.  Rows past the count hold the last
    index; callers mask on the count."""
    csum = torch.cumsum(mask.to(torch.int64), 0)
    targets = torch.arange(1, k_out + 1, device=mask.device)
    idx = torch.searchsorted(csum, targets)
    return idx.clamp(max=mask.shape[0] - 1), csum[-1]


def _select_enabled(mask: torch.Tensor, k_out: int):
    """Per row of a bool [F, L] mask, the lane indices of its first
    ``k_out`` set lanes (ascending) and its count.  Slots past the
    count hold lane L-1; callers mask on the count."""
    csum = torch.cumsum(mask.to(torch.int64), 1)
    targets = torch.arange(1, k_out + 1, device=mask.device).expand(
        mask.shape[0], k_out).contiguous()
    idx = torch.searchsorted(csum, targets)
    return idx.clamp(max=mask.shape[1] - 1), csum[:, -1]


def _split_words(cfgs: torch.Tensor, dims: SearchDims):
    """(p/window/state words, crash words as unsigned) of config rows."""
    a = 1 + dims.win_words
    b = a + dims.crash_words
    pw = torch.cat([cfgs[:, :a], cfgs[:, b:]], dim=1)
    return pw, _u32(cfgs[:, a:b])


def _pw_parts(cfgs: torch.Tensor, dims: SearchDims):
    """(hash over the non-crash words, crash popcount) per row: the
    sort groups rows by (p, window, state), crash variants of one such
    configuration together, smaller masks first."""
    pw, cr = _split_words(cfgs, dims)
    return (_hash_words(_u32(pw), 0x9E3779B1),
            _popcount32(cr).sum(dim=1))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j]]`` for a ``[B, N, ...]`` tensor and ``[B, J]``
    indices."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _prune_blocks(cfgs, valid, dims: SearchDims, use_allpairs: bool,
                  R: int = _DOM_WINDOW):
    """Dominance prune of B independent blocks of M rows (``cfgs [B, M,
    WORDS]``, ``valid [B, M]``) -> (kept, cfgs_out, origin), ``[B, M]``
    each: origin[b, i] is the input row behind output row i.

    All-pairs: row i is dropped when a valid row j has the same (p,
    window, state) words and j's crash mask is a strict subset of i's,
    or is identical with j < i; input order kept.  Sort: rows sorted by
    (pw-hash, [crash popcount | full hash], index), and every row
    dominated by an earlier one (same (p, window, state) words, a crash
    mask that is a subset of this row's) dropped, tested against a
    backward window of R rows and against the run's first row.  Hashes
    only order; domination is decided on full words, and a miss keeps a
    redundant row, never drops a reachable one."""
    B, M, WORDS = cfgs.shape
    dev = cfgs.device
    iota = torch.arange(M, device=dev)

    def split(x):
        return (w.reshape(B, M, -1)
                for w in _split_words(x.reshape(B * M, WORDS), dims))

    if use_allpairs:
        pw, cr = split(cfgs)
        eq_pw = torch.ones((B, M, M), dtype=torch.bool, device=dev)
        for w in range(pw.shape[2]):
            col = pw[:, :, w]
            eq_pw &= col[:, :, None] == col[:, None, :]
        sub = torch.ones_like(eq_pw)   # sub[b, i, j]: cr_j subset of cr_i
        eq_cr = torch.ones_like(eq_pw)
        for w in range(cr.shape[2]):
            col = cr[:, :, w]
            sub &= (col[:, None, :] & ~col[:, :, None]) == 0
            eq_cr &= col[:, :, None] == col[:, None, :]
        dom = valid[:, None, :] & ((eq_pw & sub & ~eq_cr)
                                   | (eq_pw & eq_cr
                                      & (iota[None, :] < iota[:, None])))
        return valid & ~dom.any(dim=2), cfgs, iota.expand(B, M)
    pwh, popc = (x.reshape(B, M)
                 for x in _pw_parts(cfgs.reshape(B * M, WORDS), dims))
    h2 = _hash_words(_u32(cfgs), 0x7FEB352D)
    k1 = torch.where(valid, pwh, _MASK32)
    k2 = torch.where(valid, (popc << 25) | (h2 >> 7), _MASK32)
    # one int64 key ordering (k1, k2); the stable sort breaks ties by
    # input index, as a sort on (k1, k2, iota) does
    key = (k1 - 2**31) * 2**32 + k2
    perm = torch.sort(key, dim=1, stable=True).indices
    svalid = valid.gather(1, perm)
    scfgs = _rows(cfgs, perm)
    spw, scr = split(scfgs)
    drop = torch.zeros((B, M), dtype=torch.bool, device=dev)
    for o in range(1, min(R, M - 1) + 1):
        eq = (spw[:, o:] == spw[:, :-o]).all(dim=2)
        sub = ((scr[:, :-o] & ~scr[:, o:]) == 0).all(dim=2)
        drop[:, o:] |= svalid[:, :-o] & eq & sub
    boundary = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                          (spw[:, 1:] != spw[:, :-1]).any(dim=2)], dim=1)
    starts = torch.cummax(torch.where(boundary, iota, 0), dim=1).values
    fdom = (((_rows(scr, starts) & ~scr) == 0).all(dim=2)
            & (iota != starts) & svalid.gather(1, starts))
    return svalid & ~(drop | fdom), scfgs, perm


def _prune_rows(cfgs, valid, dims: SearchDims, use_allpairs: bool):
    """Dominance prune over one block of rows -> (kept, cfgs_out,
    origin): :func:`_prune_blocks` of a single block."""
    kept, scfgs, origin = _prune_blocks(cfgs[None], valid[None], dims,
                                        use_allpairs)
    return kept[0], scfgs[0], origin[0]


def _slice_tables(tables: dict, p: torch.Tensor, alive: torch.Tensor,
                  w2p: int, names: tuple):
    """The level's shared strip of the determinate tables ``names``:
    every lookup a level makes lands in [min_p, min_p + 2W + NC), so the
    strip of ``w2p`` entries from ``base`` covers it.  Positions stay
    absolute for comparisons; only table indexing is rebased."""
    n_det_pad = tables["det_f"].shape[0]
    base = torch.where(alive, p, INF32).min().clamp(0, n_det_pad - w2p)
    idx = base + torch.arange(w2p, device=p.device)
    sl = {k: tables[k][idx] for k in names}
    sl["sfx"] = tables["sfx"][base + torch.arange(w2p + 1,
                                                  device=p.device)]
    return base, sl


_DET_TABLES = ("det_f", "det_v1", "det_v2", "det_inv", "det_ret")


def _make_kernel_pieces(model, dims: SearchDims, *, masked: bool = False,
                        masked_crash: bool = False, dedup: bool = False,
                        telemetry: bool = False, row_counts: bool = False):
    """The per-level building blocks: ``expand_mask`` (enabled
    candidates, model step and goal test for every row, K lanes each;
    no successor words) and ``succ`` (a survivor's packed successor
    words from its source row, candidate lane and new state).
    ``masked``/``masked_crash``/``dedup`` add the reductions' checks;
    ``telemetry`` makes ``expand_mask`` also return the lanes the mask
    killed and the successor states the dedup folded (0-d tensors, or 0
    where the reduction is off; per row with ``row_counts``)."""
    W, K, NC = dims.window, dims.k, dims.n_crash_pad
    WW, CW, SW = dims.win_words, dims.crash_words, dims.state_width
    W2P = min(_round_up(2 * W + NC, 32), dims.n_det_pad)
    dedup = dedup and SW == 1
    sliced = _DET_TABLES + (("det_mpred", "det_cpredw") if masked else ())

    def unpack(cfgs):
        p = cfgs[:, 0].to(torch.int64)
        win = _unpack_bits(cfgs[:, 1:1 + WW], WW)
        crash = _unpack_bits(cfgs[:, 1 + WW:1 + WW + CW], CW)[:, :NC]
        return p, win, crash, cfgs[:, 1 + WW + CW:]

    def done_preds(mpred, p, win):
        """Whether each must-predecessor (det positions, -1 pads) is
        linearized: inside the prefix, or in the window with its bit
        set; past the window it cannot be yet."""
        pp = p[:, None, None]
        q = mpred.to(torch.int64) - pp
        at = win.gather(1, q.clamp(0, W - 1).reshape(q.shape[0], -1))
        return ((mpred < pp) | ((q >= 0) & (q < W)
                               & at.reshape(q.shape))).all(dim=2)

    def expand_mask(frontier, alive, tables, n_det, n_crash, dead_lo,
                    dead_tok):
        dev = frontier.device
        p, win, crash, state = unpack(frontier)
        base, t = _slice_tables(tables, p, alive, W2P, sliced)
        lanes = torch.arange(W, device=dev)
        pos = p[:, None] + lanes
        rel = (pos - base).clamp(0, W2P - 1)
        in_range = pos < n_det
        w_ret = torch.where(in_range & ~win, t["det_ret"][rel], INF32)
        w_inv = torch.where(in_range, t["det_inv"][rel], INF32)
        m1 = w_ret.min(dim=1).values
        # the lowest lane holding the minimum; the second minimum
        # excludes only that lane
        am = torch.where(w_ret == m1[:, None], lanes, W).min(dim=1).values
        m2 = torch.where(lanes == am[:, None], INF32,
                         w_ret).min(dim=1).values
        sfx = t["sfx"][(torch.clamp(p + W, max=n_det) - base)
                       .clamp(0, W2P)]
        m1_tot = torch.minimum(m1, sfx)
        excl_w = torch.where(lanes == am[:, None], m2[:, None],
                             m1[:, None])
        excl_tot = torch.minimum(excl_w, sfx[:, None])
        det_en = in_range & ~win & (w_inv < excl_tot)
        c_lanes = torch.arange(NC, device=dev)
        c_en = ((c_lanes < n_crash) & ~crash
                & (tables["crash_inv"][None, :] < m1_tot[:, None]))
        if telemetry and masked:
            # the enabled lanes before the mask, so its kills count
            pre = det_en.sum(dim=1) + c_en.sum(dim=1)
        if masked:
            det_en = det_en & done_preds(t["det_mpred"][rel], p, win)
            c_en = c_en & done_preds(
                tables["crash_mpred"][None].expand(p.shape[0], NC, -1),
                p, win)
            if masked_crash:
                # crash predecessors: their bits must be in the
                # configuration's crash mask
                held = ~_u32(frontier[:, 1 + WW:1 + WW + CW])[:, None, :]
                det_en = det_en & ((_u32(t["det_cpredw"][rel]) & held)
                                   == 0).all(dim=2)
                c_en = c_en & ((_u32(tables["crash_cpredw"])[None] & held)
                               == 0).all(dim=2)

        cand, n_en = _select_enabled(torch.cat([det_en, c_en], dim=1), K)
        cand_on = torch.arange(K, device=dev) < n_en[:, None]
        is_det = cand < W
        det_pos = (p[:, None] + cand - base).clamp(0, W2P - 1)
        c_id = (cand - W).clamp(0, NC - 1)

        def lane_op(det_tab, crash_tab):
            return torch.where(is_det, det_tab[det_pos], crash_tab[c_id])

        cf = lane_op(t["det_f"], tables["crash_f"])
        cv1 = lane_op(t["det_v1"], tables["crash_v1"])
        cv2 = lane_op(t["det_v2"], tables["crash_v2"])
        new_state, legal = model.tstep(
            state[:, None, :].expand(state.shape[0], K, SW), cf, cv1, cv2)
        valid = alive[:, None] & cand_on & legal
        if dedup:
            # the dead-value rewrite, at the configuration's prefix p
            # (deadness only grows with the prefix)
            dead_from = tables["dead_from"]
            vt = dead_from.shape[0]
            v = new_state[..., 0].to(torch.int64)
            df = dead_from[(v - dead_lo).clamp(0, vt - 1)]
            is_dead = ((v >= dead_lo) & (v < dead_lo + vt)
                       & (p[:, None] >= df))
            new_state = torch.where(is_dead[..., None], dead_tok,
                                    new_state)
        # a det candidate is a goal iff it is the last unlinearized det;
        # a crash candidate never advances p, so only if none is left
        remaining = n_det - (p + win.sum(dim=1))
        goal = valid & torch.where(is_det, remaining[:, None] <= 1,
                                   remaining[:, None] <= 0)
        if not telemetry:
            return valid, cand, new_state, goal
        killed = (torch.where(alive, pre - det_en.sum(dim=1)
                              - c_en.sum(dim=1), 0)
                  if masked else torch.zeros_like(p))
        folds = ((valid & is_dead).sum(dim=1) if dedup
                 else torch.zeros_like(p))
        if row_counts:
            return valid, cand, new_state, goal, killed, folds
        return (valid, cand, new_state, goal,
                killed.sum() if masked else 0, folds.sum() if dedup else 0)

    def succ(cfgs, lane, ns):
        dev = cfgs.device
        p, win, crash, _state = unpack(cfgs)
        is_d = lane < W
        lanes = torch.arange(W, device=dev)
        win1 = win | (is_d[:, None] & (lanes == lane[:, None]))
        shift = _trailing_ones(win1)
        src = lanes + shift[:, None]
        win2 = torch.where(src < W, win1.gather(1, src.clamp(max=W - 1)),
                           False)
        p2 = torch.where(is_d, p + shift, p)
        win_out = torch.where(is_d[:, None], win2, win)
        cl = (lane - W).clamp(0, NC - 1)
        crash_out = torch.where(
            is_d[:, None], crash,
            crash | (torch.arange(NC, device=dev) == cl[:, None]))
        return torch.cat([p2[:, None].to(torch.int32),
                          _pack_bits(win_out, WW),
                          _pack_bits(crash_out, CW),
                          ns.to(torch.int32)], dim=1)

    return {"expand_mask": expand_mask, "succ": succ}


def _succ_block(pieces, frontier, validf, cand, ns, cap: int, K: int):
    """Compact the [F*K] valid lane mask to ``cap`` survivors and build
    their successor words -> (cfgs, valid, total)."""
    vsrc, n_valid = _compact_indices(validf, cap)
    src_cfg = frontier[vsrc // K]
    src_lane = cand.reshape(-1)[vsrc]
    src_state = ns.reshape(-1, ns.shape[-1])[vsrc]
    cvalid = torch.arange(cap, device=frontier.device) < n_valid
    return pieces["succ"](src_cfg, src_lane, src_state), cvalid, n_valid


_TABLE_NAMES = ("det_f", "det_v1", "det_v2", "det_inv", "det_ret", "sfx",
                "crash_f", "crash_v1", "crash_v2", "crash_inv", "det_mpred",
                "det_cpredw", "crash_mpred", "crash_cpredw", "dead_from")


def build_search_step_fn(model, dims: SearchDims, device, *,
                         use_allpairs: bool | None = None,
                         masked: bool = False, masked_crash: bool = False,
                         dedup: bool = False, telemetry: bool = False):
    """One slice of the search for (model, dims) on ``device``.

    ``use_allpairs`` pins the prune at both sites; None picks per site
    (`_use_allpairs`) at build time.  ``masked``, ``masked_crash`` and
    ``dedup`` read the reduction planes (see the module doc); off, the
    planes are not read.  ``telemetry`` returns the aux block as a 7th
    output (module doc); off, the step is unchanged."""
    dev = torch.device(device)
    K, F, W = dims.k, dims.frontier, dims.window
    S = 4 * F
    pieces = _make_kernel_pieces(model, dims, masked=masked,
                                 masked_crash=masked_crash, dedup=dedup,
                                 telemetry=telemetry)
    ap_cl = _use_allpairs(2 * F, dev) if use_allpairs is None \
        else use_allpairs
    ap_det = _use_allpairs(S, dev) if use_allpairs is None \
        else use_allpairs

    def step(det_f, det_v1, det_v2, det_inv, det_ret, sfx_min,
             crash_f, crash_v1, crash_v2, crash_inv, det_mpred,
             det_cpredw, crash_mpred, crash_cpredw, dead_from,
             n_det, n_crash, dead_lo, dead_tok,
             budget, lvl_cap, bail,
             frontier, count, status, configs, max_depth, ovf):
        tables = dict(zip(_TABLE_NAMES, (
            det_f, det_v1, det_v2, det_inv, det_ret, sfx_min, crash_f,
            crash_v1, crash_v2, crash_inv, det_mpred, det_cpredw,
            crash_mpred, crash_cpredw, dead_from)))
        n_det, n_crash = int(n_det), int(n_crash)
        dead_lo, dead_tok = int(dead_lo), int(dead_tok)
        budget, lvl_cap, bail = int(budget), int(lvl_cap), bool(bail)
        fdev = frontier.device
        i32 = torch.int32
        count = torch.as_tensor(count, dtype=i32, device=fdev)
        status = torch.as_tensor(status, dtype=i32, device=fdev)
        configs = torch.as_tensor(configs, dtype=i32, device=fdev)
        max_depth = torch.as_tensor(max_depth, dtype=i32, device=fdev)
        ovf = torch.as_tensor(ovf, dtype=torch.bool, device=fdev)
        rows = torch.arange(F, device=fdev)
        false = torch.zeros((), dtype=torch.bool, device=fdev)
        tele = (torch.zeros((TELE_ROWS, TELE_COLS), dtype=i32, device=fdev)
                if telemetry else None)

        def mask_phase(fr, alive):
            return pieces["expand_mask"](fr, alive, tables, n_det,
                                         n_crash, dead_lo, dead_tok)

        def prune_compact(cfgs, valid, ap):
            kept, scfgs, origin = _prune_rows(cfgs, valid, dims, ap)
            src, n_kept = _compact_indices(kept, F)
            return scfgs[src], n_kept, kept, origin

        for lvl in range(lvl_cap):
            go = (status == -1) & (count > 0) & (configs < budget)
            if bail:
                go = go & ~ovf
            if not bool(go):
                break
            # entry snapshot: an overflowing level under bail is not
            # committed, so the wider re-run resumes from here
            f_in, c_in, cfg_in, md_in, ovf_in = (frontier, count,
                                                 configs, max_depth, ovf)
            valid2, cand2, ns2, goal2, *red = mask_phase(frontier,
                                                         rows < count)
            found = goal2.any()

            # crash closure within the level
            progress = false
            rounds = 0
            go_closure = bool((valid2 & (cand2 >= W)).any())
            while go_closure:
                alive = rows < count
                # crash successors are capped at F rows: more than F
                # of them overflow the merged level anyway
                ccfgs, cvalid, n_valid = _succ_block(
                    pieces, frontier, (valid2 & (cand2 >= W)).reshape(-1),
                    cand2, ns2, F, K)
                ovf = ovf | (n_valid > F)
                frontier, n_kept, kept, origin = prune_compact(
                    torch.cat([frontier, ccfgs]),
                    torch.cat([alive, cvalid]), ap_cl)
                ovf = ovf | (n_kept > F)
                count = n_kept.clamp(max=F).to(i32)
                # progress iff a successor-block row survived the merge
                progress = (kept & (origin >= F)).any()
                valid2, cand2, ns2, goal2, *red2 = mask_phase(frontier,
                                                              rows < count)
                if telemetry:
                    # kills and folds add up over the closure's rounds
                    red = [a + b for a, b in zip(red, red2)]
                found = found | goal2.any()
                rounds += 1
                go_closure = rounds < n_crash + 1 and bool(progress)
            # leaving by the round cap while still adding rows: the
            # level is not proven closed, which degrades like overflow
            ovf = ovf | progress
            alive = rows < count

            # determinate expansion to the next level
            dcfgs, dvalid, n_valid = _succ_block(
                pieces, frontier, (valid2 & (cand2 < W)).reshape(-1),
                cand2, ns2, S, K)
            ovf = ovf | (n_valid > S)
            new_frontier, n_kept, _kept, _origin = prune_compact(
                dcfgs, dvalid, ap_det)
            ovf = ovf | (n_kept > F)
            new_count = n_kept.clamp(max=F).to(i32)

            configs = configs + count
            max_depth = torch.maximum(max_depth, torch.where(
                alive, frontier[:, 0], 0).max())
            status = torch.where(found, 2, status)
            # uncommit an overflowing level when a wider re-run is
            # coming and no goal was found
            revert = (ovf & ~ovf_in & ~found) if bail else false
            occupancy = count
            frontier = torch.where(revert, f_in, new_frontier)
            count = torch.where(revert, c_in, new_count)
            configs = torch.where(revert, cfg_in, configs)
            max_depth = torch.where(revert, md_in, max_depth)
            if telemetry:
                # one row per level, built by column index so the order
                # stays the one telemetry.COLUMNS names
                cols = [None] * TELE_COLS
                cols[C_OCC] = occupancy
                cols[C_EXP] = valid2.sum()
                cols[C_KILL], cols[C_DEDUP] = red
                cols[C_ROUNDS] = rounds
                cols[C_NEXT] = count
                cols[C_OVF] = ovf & ~ovf_in
                cols[C_GOAL] = found
                tele[min(lvl, TELE_ROWS - 1)] += torch.stack(
                    [torch.as_tensor(c, device=fdev).to(i32)
                     for c in cols])
        if telemetry:
            return frontier, count, status, configs, max_depth, ovf, tele
        return frontier, count, status, configs, max_depth, ovf

    return step


def run_per_key(fn, dims: SearchDims, *args, telemetry: bool = False):
    """One slice of a stacked batch of keys through the single-key step
    ``fn``, key by key.  ``args`` is the step signature with a leading
    key axis on the 15 tables, the four per-key scalars (int32 [B]) and
    the carry ([B, F, words] and five [B] tensors); ``budget``,
    ``lvl_cap`` and ``bail`` are shared.  The return suffix table may
    carry padding past its ``n_det_pad + 1`` entries.  A key with
    nothing to do (finished, dead, over budget, or bailed) is not run:
    its step would return its carry unchanged, as a vmapped lane does.
    With ``telemetry`` (``fn`` is a telemetry build) the per-key blocks
    come back stacked ``[B, TELE_ROWS, TELE_COLS]`` as a 7th output, a
    key that did not run reading zero."""
    tables, per_key = args[:15], args[15:19]
    budget, lvl_cap, bail = int(args[19]), int(args[20]), bool(args[21])
    frontier = args[22]
    counts = [t.tolist() for t in per_key]
    scal = torch.stack([*args[23:27], args[27].to(torch.int32)],
                       dim=1).tolist()
    outs = []
    for b, (count, status, configs, _depth, ovf) in enumerate(scal):
        if not (status == -1 and count > 0 and configs < budget
                and not (bail and ovf)):
            idle = (frontier[b],) + tuple(a[b] for a in args[23:28])
            if telemetry:
                idle += (torch.zeros((TELE_ROWS, TELE_COLS),
                                     dtype=torch.int32,
                                     device=frontier.device),)
            outs.append(idle)
            continue
        key_tables = [t[b] for t in tables]
        key_tables[5] = key_tables[5][:dims.n_det_pad + 1]
        outs.append(fn(*key_tables, *(c[b] for c in counts), budget,
                       lvl_cap, bail, frontier[b],
                       *(a[b] for a in args[23:28])))
    i32 = torch.int32
    carry = (torch.stack([o[0] for o in outs]),
             *(torch.stack([torch.as_tensor(o[i], dtype=i32,
                                            device=frontier.device)
                            for o in outs]) for i in range(1, 5)),
             torch.stack([torch.as_tensor(o[5], dtype=torch.bool,
                                          device=frontier.device)
                          for o in outs]))
    if telemetry:
        return carry + (torch.stack([o[6] for o in outs]),)
    return carry
