"""Multi-device checking: one history's frontier sharded over a mesh (B7),
and the batch of independent keys sharded over it (B8).

Counterpart of the JAX package's ``build_sharded_search_step_fn``,
``search_opseq_sharded``, ``get_sharded_batch_kernel`` and
``_search_batch_sharded_fixed`` (``jepsen_tpu/checker/linearizable.py``),
as torch ops over a :class:`~..distributed.ShardMesh`: one process drives
every shard, as the reference's mesh is driven single-controller.

**The sharded frontier.**  Shard ``d`` owns the configurations whose
hash over the non-crash words is ``d`` modulo the shard count, so every
crash variant of one (p, window, state) lands on one shard and the local
dominance prune is as complete as one device's.  Per level each shard
runs the mask phase on its rows, then the crash closure, whose crash
successors go to their home shards every round, then its determinate
successors go home and are pruned into the next level.  The exchange is
the reference's ``all_to_all``: each shard compacts its rows per
destination, at most ``C_CR``/``C_DET`` each (more is a route
overflow), and a shard receives the blocks source-major.  Between shards
of one card it is a copy on the card, between cards a peer copy; no row
crosses a process.  Loop control (termination, the goal, closure
progress, overflow, configs and depth) is reduced over the shards, so
every shard runs the same levels and the same closure rounds.  The
carry is the reference's: a ``[D*F, WORDS]`` frontier, ``[D]`` counts
and replicated scalars (status, configs, max_depth, overflow, total
live rows), and the telemetry build returns one aux block per shard,
``[D*TELE_ROWS, TELE_COLS]``.  An overflow, a route overflow included,
stops the search for a wider rung; it never decides.

**The sharded batch.**  The keys are padded with inert keys to a
multiple of the shard count and split into equal blocks; each shard runs
the port's batch slice function (:func:`~.linearizable.get_batch_kernel`)
on its block and its device, at a fixed ``frontier=64`` with no
escalation ladder: on the card the fused kernel's grid form wherever it
takes the rung, else the torch step key by key.  Keys that overflow the
fixed shape are searched again alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..distributed import ShardMesh, as_sharding
from ..obs import telemetry as _tele
from ..obs.telemetry import (C_DEDUP, C_EXP, C_GOAL, C_KILL, C_NEXT, C_OCC,
                             C_OVF, C_ROUNDS, TELE_COLS, TELE_ROWS)
from . import step as _step
from .encode import SearchDims, _round_up

__all__ = ["build_sharded_search_step_fn", "get_sharded_search_kernel",
           "search_opseq_sharded", "get_sharded_batch_kernel",
           "route_capacities"]


def route_capacities(dims: SearchDims, n_shards: int) -> tuple[int, int]:
    """(C_DET, C_CR): the rows a shard sends each destination per level
    (determinate successors) and per closure round (crash successors)."""
    F = dims.frontier
    return (max(64, _round_up(4 * F // n_shards, 32)),
            max(64, _round_up(2 * F // n_shards, 32)))


def _any(flags, dev) -> torch.Tensor:
    """A replicated OR over the device groups' bool tensors, on the
    control device."""
    return torch.stack([f.any().to(dev) for f in flags]).any()


def _sum(vals, dev) -> torch.Tensor:
    return torch.stack([v.sum().to(dev) for v in vals]).sum()


def build_sharded_search_step_fn(model, dims: SearchDims, mesh: ShardMesh,
                                 axis: str = "shard", *,
                                 masked: bool = False,
                                 masked_crash: bool = False,
                                 dedup: bool = False,
                                 telemetry: bool = False):
    """One slice of a search whose frontier is sharded over ``mesh``
    (module doc).  The step takes the single-device step's 22 leading
    arguments, then the carry ``(frontier [D*F, WORDS], count [D],
    status, configs, max_depth, any_ovf, total)``, and returns the carry
    (plus the ``[D*TELE_ROWS, TELE_COLS]`` aux blocks with
    ``telemetry``) on the mesh's first device.  ``dims.frontier`` is the
    per-shard width.  The prune of each merge site is chosen here, for
    one instance per shard (``step._use_allpairs``).

    The shards of one device run as one stacked tensor, ``[shards, F,
    WORDS]``, each shard's rows a block of its own: the mask phase runs
    over all of them at once (its rows are independent), and the
    compactions, routing and prunes run per block."""
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    ctl = mesh.devices[0]  # where the replicated scalars live
    D = mesh.size
    # the shards by device: (device, shard indices), in first-seen order
    groups: dict = {}
    for i, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(i)
    groups = list(groups.items())
    order = [i for _dev, idx in groups for i in idx]
    # received blocks arrive group by group; this puts them in shard
    # (source) order, or None when they already are
    src_perm = (None if order == list(range(D))
                else torch.as_tensor(np.argsort(order)))
    # sel[g][h]: group h's shard indices, on group g's device
    sel = [[torch.as_tensor(ih, device=dg) for _dh, ih in groups]
           for dg, _ig in groups]
    K, F, W, WORDS = dims.k, dims.frontier, dims.window, dims.words
    SW = dims.state_width
    S = 4 * F
    C_DET, C_CR = route_capacities(dims, D)
    pieces = _step._make_kernel_pieces(model, dims, masked=masked,
                                       masked_crash=masked_crash,
                                       dedup=dedup, telemetry=telemetry,
                                       row_counts=True)
    ap_cl = _step._use_allpairs(F + D * C_CR, ctl)
    ap_det = _step._use_allpairs(D * C_DET, ctl)
    i32 = torch.int32

    def succ_block(fr, mp, det: bool, cap: int):
        """Each shard's successors of one kind, compacted to at most
        ``cap`` (``step._succ_block`` per block): ``[n, c, WORDS]`` rows
        with c the most any shard has, their validity, and each shard's
        full count."""
        n, fm = fr.shape[:2]
        valid2, cand2, ns2 = mp[:3]
        lanes = valid2 & ((cand2 < W) if det else (cand2 >= W))
        lanes = lanes.reshape(n, fm * K)
        n_valid = lanes.sum(dim=1)
        c = max(1, min(cap, int(n_valid.max())))
        vsrc, _ = _step._select_enabled(lanes, c)
        src_cfg = _step._rows(fr, vsrc // K)
        src_lane = cand2.reshape(n, fm * K).gather(1, vsrc)
        src_state = _step._rows(ns2.reshape(n, fm * K, SW), vsrc)
        cfgs = pieces["succ"](src_cfg.reshape(n * c, WORDS),
                              src_lane.reshape(-1),
                              src_state.reshape(n * c, SW))
        cvalid = torch.arange(c, device=fr.device)[None, :] \
            < n_valid[:, None]
        return cfgs.reshape(n, c, WORDS), cvalid, n_valid

    def route_masks(cfgs, valid):
        """Each shard's rows by home shard: ``[n, D, N]`` masks and
        ``[n, D]`` counts."""
        n, N = valid.shape
        pwh, _popc = _step._pw_parts(cfgs.reshape(n * N, WORDS), dims)
        owner = (pwh % D).reshape(n, 1, N)
        dest = torch.arange(D, device=cfgs.device).reshape(1, D, 1)
        masks = valid[:, None, :] & (owner == dest)
        return masks, masks.sum(dim=2)

    def exchange(succs, cap: int):
        """Route every group's successors home: the all-to-all.  Each
        source sends each destination at most ``cap`` rows (more is a
        route overflow).  Returns per group the received ``[n, D*c,
        WORDS]`` rows, source-major, their validity, and each source
        shard's route overflow flag."""
        routed = [route_masks(cf, cv) for cf, cv, _nv in succs]
        c = max(1, min(cap, max(int(cnt.max()) for _m, cnt in routed)))
        sends = []
        for (cf, _cv, _nv), (masks, cnt) in zip(succs, routed):
            n, N = masks.shape[0], masks.shape[2]
            idx, _ = _step._select_enabled(masks.reshape(n * D, N), c)
            sends.append((_step._rows(cf, idx.reshape(n, D * c))
                          .reshape(n, D, c, WORDS), cnt.clamp(max=cap)))
        out = []
        for h, (dh, ih) in enumerate(groups):
            blk = torch.cat([s[0][:, sel[g][h]].to(dh)
                             for g, s in enumerate(sends)])
            cnt = torch.cat([s[1][:, sel[g][h]].to(dh)
                             for g, s in enumerate(sends)])
            if src_perm is not None:
                blk, cnt = blk[src_perm.to(dh)], cnt[src_perm.to(dh)]
            n = len(ih)
            rcfgs = blk.transpose(0, 1).reshape(n, D * c, WORDS)
            lane = torch.arange(D * c, device=dh) % c
            rvalid = lane[None, :] < cnt.t().repeat_interleave(c, dim=1)
            out.append((rcfgs, rvalid))
        return out, [(cnt > cap).any(dim=1) for _m, cnt in routed]

    def merge(local, lvalid, inc, ivalid, use_ap):
        """Prune each shard's resident plus received rows into F rows:
        (frontier, count, overflow, whether a received row survived)."""
        kept, scfgs, origin = _step._prune_blocks(
            torch.cat([local, inc], dim=1), torch.cat([lvalid, ivalid], 1),
            dims, use_ap)
        src, n = _step._select_enabled(kept, F)
        progress = (kept & (origin >= local.shape[1])).any(dim=1)
        return (_step._rows(scfgs, src), n.clamp(max=F).to(i32), n > F,
                progress)

    def step(det_f, det_v1, det_v2, det_inv, det_ret, sfx_min,
             crash_f, crash_v1, crash_v2, crash_inv, det_mpred,
             det_cpredw, crash_mpred, crash_cpredw, dead_from,
             n_det, n_crash, dead_lo, dead_tok,
             budget, lvl_cap, bail,
             frontier, count, status, configs, max_depth, any_ovf, total):
        tabs = (det_f, det_v1, det_v2, det_inv, det_ret, sfx_min,
                crash_f, crash_v1, crash_v2, crash_inv, det_mpred,
                det_cpredw, crash_mpred, crash_cpredw, dead_from)
        tables = [dict(zip(_step._TABLE_NAMES, (t.to(dg) for t in tabs)))
                  for dg, _ig in groups]
        n_det, n_crash = int(n_det), int(n_crash)
        dead_lo, dead_tok = int(dead_lo), int(dead_tok)
        budget, lvl_cap, bail = int(budget), int(lvl_cap), bool(bail)

        def scalar(x, dtype=i32):
            return torch.as_tensor(x, device=ctl).to(dtype).reshape(())

        fr3 = frontier.reshape(D, F, WORDS)
        count = count.reshape(D).to(i32)
        fr = [fr3[ig].to(dg) for dg, ig in groups]
        cnt = [count[ig].to(dg) for dg, ig in groups]
        status, configs = scalar(status), scalar(configs, torch.int64)
        max_depth, total = scalar(max_depth), scalar(total)
        any_ovf = scalar(any_ovf, torch.bool)
        rows = torch.arange(F, device=ctl)
        tele = ([torch.zeros((len(ig), TELE_ROWS, TELE_COLS), dtype=i32,
                             device=dg) for dg, ig in groups]
                if telemetry else None)
        G = range(len(groups))

        def mask_phase():
            """Every shard's live rows (a prefix of its block; ``fm``
            the longest) through the mask phase: per group (the live
            rows, their liveness, the mask phase's outputs)."""
            fm = max(1, max(int(c.max()) for c in cnt))
            out = []
            for g, (dg, _ig) in enumerate(groups):
                frt = fr[g][:, :fm]
                alive = rows[:fm].to(dg)[None, :] < cnt[g][:, None]
                mp = pieces["expand_mask"](frt.reshape(-1, WORDS),
                                           alive.reshape(-1), tables[g],
                                           n_det, n_crash, dead_lo,
                                           dead_tok)
                out.append((frt, alive, mp))
            return out

        def per_shard(x, g):
            return x.reshape(len(groups[g][1]), -1).sum(dim=1)

        for lvl in range(lvl_cap):
            go = (status == -1) & (total > 0) & (configs < budget)
            if bail:
                go = go & ~any_ovf
            if not bool(go):
                break
            ovf = [any_ovf.to(dg).expand(len(ig)).clone()
                   for dg, ig in groups]
            ph = mask_phase()
            found = [per_shard(ph[g][2][3], g) > 0 for g in G]
            red = [[per_shard(x, g) for x in ph[g][2][4:]] for g in G]
            crash_any = bool(_any([mp[0] & (mp[1] >= W)
                                   for _f, _a, mp in ph], ctl))

            # crash closure: replicated control, crash successors routed
            # home every round
            progress = torch.zeros((), dtype=torch.bool, device=ctl)
            rounds = 0
            go_closure = crash_any
            while go_closure:
                succs = [succ_block(frt, mp, False, F) for frt, _a, mp in ph]
                recv, r_ovf = exchange(succs, C_CR)
                prog = []
                for g in G:
                    frt, alive, _mp = ph[g]
                    fr[g], cnt[g], m_ovf, p = merge(frt, alive, *recv[g],
                                                    ap_cl)
                    ovf[g] = ovf[g] | (succs[g][2] > F) | r_ovf[g] | m_ovf
                    prog.append(p)
                ph = mask_phase()
                for g in G:
                    found[g] = found[g] | (per_shard(ph[g][2][3], g) > 0)
                    if telemetry:
                        red[g] = [a + per_shard(b, g)
                                  for a, b in zip(red[g], ph[g][2][4:])]
                progress = _any(prog, ctl)
                rounds += 1
                go_closure = rounds < n_crash + 1 and bool(progress)
            # leaving by the round cap while still adding rows: the level
            # is not proven closed, which degrades like an overflow
            succs = [succ_block(frt, mp, True, S) for frt, _a, mp in ph]
            recv, r_ovf = exchange(succs, C_DET)
            nxt = []
            for g, (dg, ig) in enumerate(groups):
                empty = torch.zeros((len(ig), 0, WORDS), dtype=i32,
                                    device=dg)
                nf, nc, m_ovf, _p = merge(
                    empty, torch.zeros((len(ig), 0), dtype=torch.bool,
                                       device=dg), *recv[g], ap_det)
                ovf[g] = (ovf[g] | progress.to(dg) | (succs[g][2] > S)
                          | r_ovf[g] | m_ovf)
                nxt.append((nf, nc))

            configs = configs + _sum(cnt, ctl)
            depth = torch.stack([torch.where(alive, frt[:, :, 0], 0)
                                 .max().to(ctl) for frt, alive, _mp in ph])
            max_depth = torch.maximum(max_depth, depth.max())
            status = torch.where(_any(found, ctl), 2, status)
            if telemetry:
                for g, (dg, _ig) in enumerate(groups):
                    cols = [None] * TELE_COLS
                    cols[C_OCC] = cnt[g]
                    cols[C_EXP] = per_shard(ph[g][2][0], g)
                    cols[C_KILL], cols[C_DEDUP] = red[g]
                    cols[C_ROUNDS] = torch.full_like(cnt[g], rounds)
                    cols[C_NEXT] = nxt[g][1]
                    cols[C_OVF] = ovf[g] & ~any_ovf.to(dg)
                    cols[C_GOAL] = found[g]
                    tele[g][:, min(lvl, TELE_ROWS - 1)] += torch.stack(
                        [c.to(i32) for c in cols], dim=1)
            total = _sum([nc for _nf, nc in nxt], ctl).to(i32)
            any_ovf = _any(ovf, ctl)
            fr = [nf for nf, _nc in nxt]
            cnt = [nc for _nf, nc in nxt]

        def gather(parts):
            # the groups' blocks back in shard order, on the control
            # device
            x = torch.cat([p.to(ctl) for p in parts])
            return x if src_perm is None else x[src_perm.to(ctl)]

        out = (gather(fr).reshape(D * F, WORDS), gather(cnt), status,
               configs.to(i32), max_depth.to(i32), any_ovf, total)
        if telemetry:
            out = out + (gather(tele).reshape(D * TELE_ROWS, TELE_COLS),)
        return out

    return step


def _widen_sharded_carry(carry, d: int, old_f: int, new_f: int):
    """A sharded carry's ``[D*F, WORDS]`` frontier widened to
    ``[D*F', WORDS]``, each shard's rows kept in its own block."""
    fr = carry[0].reshape(d, old_f, -1)
    out = torch.zeros((d, new_f, fr.shape[2]), dtype=fr.dtype,
                      device=fr.device)
    out[:, :old_f] = fr
    return (out.reshape(d * new_f, -1),) + tuple(carry[1:])


def _drive_slices(call, carry, is_active, *, on_slice=None,
                  deadline: float | None = None, stop=None):
    """The host loop of the fixed-width sharded routes: slices of
    ``call(carry, lvl_cap)`` until ``is_active(carry)`` is False, the
    deadline passes or ``stop`` is set; ``on_slice(carry)`` after each.
    The level cap adapts from the first slice on, as the single search's
    driver does (the first slice pays for warm-up)."""
    from . import linearizable as lin

    lvl_cap = lin._SLICE_LEVELS0
    first = True
    while True:
        t0 = time.perf_counter()
        with obs.span("device.slice", cat="device", levels=lvl_cap,
                      first=first):
            carry = call(carry, lvl_cap)
        dt = time.perf_counter() - t0
        _tele.record_device_seconds(dt)
        if on_slice is not None:
            on_slice(carry)
        if not is_active(carry):
            return carry
        if deadline is not None and time.perf_counter() > deadline:
            return carry
        if stop is not None and stop.is_set():
            return carry
        if not first:
            lvl_cap = lin._adapt_lvl_cap(lvl_cap, dt)
        first = False


def get_sharded_search_kernel(model, dims: SearchDims, mesh: ShardMesh,
                              axis: str = "shard", *, masked: bool = False,
                              masked_crash: bool = False, dedup: bool = False,
                              telemetry: bool = False):
    """The cached slice function of :func:`build_sharded_search_step_fn`,
    built inside a ``device.compile`` span of engine ``device-sharded``
    with the shard count among its coordinates."""
    from . import linearizable as lin

    key = ("sharded", model.name, dims, axis, mesh.key,
           _step._DOMINANCE_MODE, masked, masked_crash, dedup, telemetry)
    return lin._cached(key, lambda: build_sharded_search_step_fn(
        model, dims, mesh, axis, masked=masked, masked_crash=masked_crash,
        dedup=dedup, telemetry=telemetry), model, dims, False,
        engine="device-sharded", shards=mesh.size, masked=masked,
        masked_crash=masked_crash, dedup=dedup, telemetry=telemetry)


def search_opseq_sharded(seq, model, mesh: ShardMesh, *,
                         axis: str = "shard", budget: int = 20_000_000,
                         frontier_per_device: int = 1024,
                         deadline: float | None = None, stop=None,
                         on_slice=None, lint: bool | None = None,
                         audit: bool | None = None, hb: bool | None = None,
                         dpor: bool | None = None,
                         telemetry: bool | None = None) -> dict:
    """Check one history with its frontier sharded over ``mesh``.

    As :func:`~.linearizable.search_opseq` in front of the engine: the
    lint, the prepass (a decided history returns at once), the trivial
    and greedy-witness verdicts, and the host ``linear`` sweep past the
    device encoding; DPOR's mask and dedup planes ride the device search
    (the dead-token rewrite comes before routing, so copies of one
    collapsed state share a home shard).  The search starts at
    ``frontier_per_device`` rows per shard and, on an overflow, resumes
    4x wider from the last clean carry, each shard's block zero-padded.
    ``deadline``, ``stop`` and ``on_slice(carry, dims)`` as in
    ``search_opseq``; the sharded carry is not a checkpoint.  The result
    is ``{"valid", "configs", "max_depth", "engine":
    "device-sharded-x<D>", "frontier_per_device"}`` with the device
    certificates' drop reasons, the prepass's stats and, with
    ``telemetry`` (None: on), the ``search_telemetry`` block (the
    shards' blocks summed per level)."""
    from ..analyze.audit import maybe_audit
    from ..analyze.dpor import resolve_dpor
    from ..analyze.hb import attach, maybe_hb
    from ..analyze.lint import maybe_lint
    from . import linearizable as lin
    from .encode import (MAX_CRASH, MAX_FRONTIER, MAX_WINDOW, _grid_width,
                         _init_config, attach_reductions, choose_dims,
                         encode_search, pad_search, search_args)
    from .linear import check_opseq_linear

    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    devs = [lin._resolve_device(d) for d in mesh.devices]
    ctl = devs[0]
    tele_on = _tele.resolve(telemetry)
    maybe_lint(seq, model, lint)
    hbres = maybe_hb(seq, model, hb, dpor)

    def finish(out: dict) -> dict:
        return maybe_audit(seq, model, attach(out, hbres), audit)

    if hbres is not None and hbres.decided is not None:
        return _tele.emit_decided(
            maybe_audit(seq, model, dict(hbres.decided), audit),
            hbres=hbres, telemetry=tele_on)
    es = encode_search(seq)
    if es.n_det == 0 and es.n_crash == 0:
        return finish({"valid": True, "configs": 0, "max_depth": 0,
                       "engine": "trivial", "linearization": []})
    if lin.greedy_witness(seq, model):
        return finish({"valid": True, "configs": es.n_det,
                       "max_depth": es.n_det, "engine": "greedy-witness",
                       "linearization": lin.greedy_linearization(seq)})
    if es.window > MAX_WINDOW or es.n_crash > MAX_CRASH:
        out = check_opseq_linear(seq, model, deadline=deadline, cancel=stop,
                                 lint=False, hb=hb, dpor=dpor)
        out["engine"] = "host-linear(fallback)"
        return finish(out)

    dims = choose_dims(es, model, device=ctl, frontier=frontier_per_device)
    if resolve_dpor(dpor):
        attach_reductions(es, seq, model,
                          hbres.must_pred if hbres is not None else None,
                          dedup=True)
    esp = pad_search(es, dims.n_det_pad, dims.n_crash_pad)
    masked, masked_crash, dedup = lin._reduction_key(esp)
    D = mesh.size
    acc = _tele.SearchTelemetry("device-sharded") if tele_on else None
    args = search_args(esp, es, device=ctl)
    resume = None
    while True:
        bail = dims.frontier < MAX_FRONTIER
        fn = get_sharded_search_kernel(
            model, dims, mesh, axis, masked=masked, masked_crash=masked_crash,
            dedup=dedup, telemetry=tele_on)
        if resume is not None:
            carry0 = resume
        else:
            # the root starts on shard 0, whatever its hash
            frontier0 = np.zeros((D * dims.frontier, dims.words), np.int32)
            frontier0[0] = _init_config(dims, model)
            count0 = np.zeros(D, np.int32)
            count0[0] = 1
            carry0 = (torch.as_tensor(frontier0, device=ctl),
                      torch.as_tensor(count0, device=ctl),
                      *(torch.tensor(v, dtype=torch.int32, device=ctl)
                        for v in (-1, 0, 0)),
                      torch.tensor(False, device=ctl),
                      torch.tensor(1, dtype=torch.int32, device=ctl))
        width = dims.frontier

        def call(carry, lvl_cap):
            t0 = time.perf_counter()
            res = fn(*args, budget, lvl_cap, bail, *carry)
            if acc is not None:
                # the shards' blocks summed per level: levels run in
                # lockstep under replicated loop control
                blk = res[7].reshape(D, TELE_ROWS, TELE_COLS).sum(dim=0)
                acc.add_slice(blk.cpu().numpy(), t0, time.perf_counter(),
                              frontier=width)
            return res[:7]

        def is_active(c):
            return (int(c[2]) == -1 and int(c[6]) > 0
                    and int(c[3]) < budget and not (bail and bool(c[5])))

        prev = [carry0]

        def track(c):
            if not bool(c[5]):  # a clean (pre-overflow) carry
                prev[0] = c
            if on_slice is not None:
                on_slice(c, dims)

        carry = _drive_slices(call, carry0, is_active, on_slice=track,
                              deadline=deadline, stop=stop)
        status, configs = int(carry[2]), int(carry[3])
        ovf, total = bool(carry[5]), int(carry[6])
        timed_out = ((deadline is not None
                      and time.perf_counter() > deadline)
                     or (stop is not None and stop.is_set()))
        if status == -1:
            status = (lin.UNKNOWN if ovf else lin.INVALID) if total <= 0 \
                else lin.UNKNOWN
        if (status == lin.UNKNOWN and ovf and not timed_out
                and dims.frontier < MAX_FRONTIER):
            # resume 4x wider from the last clean carry
            new_f = _grid_width(dims.frontier * 4, ctl)
            resume = _widen_sharded_carry(prev[0], D, dims.frontier, new_f)
            dims = SearchDims(**{**dims.__dict__, "frontier": new_f})
            continue
        break
    out = {"valid": lin._STATUS[status], "configs": configs,
           "max_depth": int(carry[4]), "engine": f"device-sharded-x{D}",
           "frontier_per_device": dims.frontier}
    if out["valid"] is True:
        out["witness_dropped"] = lin.WITNESS_DROPPED_DEVICE
    elif out["valid"] is False:
        out["frontier_dropped"] = lin.FRONTIER_DROPPED_DEVICE
    _tele.finalize_result(out, acc, hbres=hbres, device=ctl)
    return finish(out)


# ---------------------------------------------------------------------------
# the key-sharded batch
# ---------------------------------------------------------------------------


def get_sharded_batch_kernel(model, dims: SearchDims, *, batch: int,
                             mesh: ShardMesh, masked: bool = False,
                             masked_crash: bool = False,
                             dedup: bool = False, telemetry: bool = False):
    """The mesh form of :func:`~.linearizable.get_batch_kernel`: one slice
    of a ``batch``-key batch (a multiple of the shard count), each shard
    running the batch slice function at ``batch // D`` keys on its
    device.  The returned function takes and returns per-shard lists
    ``fn(shard_args, budget, lvl_cap, bail, shard_carries)``; a shard
    with no running key is not launched (its carry comes back as it
    was, its aux block zero).  Cached under the mesh's devices and the
    reductions."""
    from . import linearizable as lin

    D = mesh.size
    if batch % D:
        raise ValueError(f"batch {batch} does not cover {D} shards evenly")
    per = batch // D
    key = ("batch-sharded", model.name, dims, per, mesh.key,
           _step._DOMINANCE_MODE, masked, masked_crash, dedup, telemetry)

    def build():
        fns = [lin.get_batch_kernel(model, dims, dev, masked=masked,
                                    masked_crash=masked_crash, dedup=dedup,
                                    telemetry=telemetry)
               for dev in mesh.devices]

        def run(shard_args, budget, lvl_cap, bail, shard_carries):
            out = []
            for fn, a, c in zip(fns, shard_args, shard_carries):
                live = ((c[2] == -1) & (c[1] > 0) & (c[3] < budget)).any()
                if bool(live):
                    out.append(tuple(fn(*a, budget, lvl_cap, bail, *c)))
                else:
                    idle = tuple(c)
                    if telemetry:
                        idle += (torch.zeros((per, TELE_ROWS, TELE_COLS),
                                             dtype=torch.int32,
                                             device=c[0].device),)
                    out.append(idle)
            return out
        return run

    use_k = lin._use_kernel(model, dims, mesh.devices[0], masked=masked,
                            dedup=dedup)
    return lin._cached(key, build, model, dims, use_k, sharded=True,
                       shards=D, batch=per, masked=masked,
                       masked_crash=masked_crash, dedup=dedup,
                       telemetry=telemetry)


def search_batch_sharded_fixed(seqs: list, esps: list, model,
                               dims: SearchDims, sharding, budget: int, *,
                               tele_acc=None, telemetry: bool = True):
    """One fixed-shape sharded batch at ``dims`` (both sharded batch
    routes: the fused one over global dims, and each bucket of the
    bucketed one at its own).  The keys pad with inert keys (no ops,
    status already valid) to a multiple of the shard count; pad keys
    bill no configs and no telemetry.  ``esps`` are the keys' encodings
    padded to ``dims`` (their reductions attached, and dropped where the
    kernel takes the rung).  Keys that overflow the fixed shape are
    searched again alone (``search_opseq``).

    Returns ``(results, info)``: per-key results in order, and the
    dispatch info (lanes, pad lanes, overflow redos)."""
    from . import linearizable as lin
    from .encode import stack_batch

    sh = as_sharding(sharding)
    mesh = sh.mesh
    devs = [lin._resolve_device(d) for d in mesh.devices]
    D = len(devs)
    n = len(seqs)
    b = _round_up(n, D)
    per = b // D
    masked = any(e.masked for e in esps)
    masked_crash = any(e.mask_has_crash for e in esps)
    dedup = any(e.dedup for e in esps)
    use_k = lin._use_kernel(model, dims, devs[0], masked=masked,
                            dedup=dedup)
    tele_on = tele_acc is not None
    fn = get_sharded_batch_kernel(model, dims, batch=b, mesh=mesh,
                                  masked=masked, masked_crash=masked_crash,
                                  dedup=dedup, telemetry=tele_on)
    # pad keys repeat key 0's tables with no ops, and start finished
    full = stack_batch(esps, pad_to=b, device=devs[0])
    shard_args, carries = [], []
    for s, dev in enumerate(devs):
        shard_args.append(tuple(t[s * per:(s + 1) * per].to(dev)
                                for t in full))
        c = lin._init_batch_carry(per, dims, model, dev)
        live = max(0, min(per, n - s * per))
        c[1][live:] = 0
        c[2][live:] = lin.VALID
        carries.append(c)

    def call(cs, lvl_cap):
        t0 = time.perf_counter()
        res = fn(shard_args, budget, lvl_cap, False, cs)
        if tele_acc is not None:
            blk = torch.cat([r[6].to(devs[0]) for r in res]).cpu().numpy()
            t1 = time.perf_counter()
            # the pad lanes come off before the lane sum
            tele_acc.add_totals(blk[:n])
            _tele.emit_shard_levels(blk, n, D, t0, t1)
            res = [r[:6] for r in res]
        return res

    def is_active(cs):
        return any(bool(((c[2] == -1) & (c[1] > 0) & (c[3] < budget)).any())
                   for c in cs)

    carries = _drive_slices(call, carries, is_active)
    cols = [torch.cat([c[i].to(devs[0]) for c in carries]).cpu().numpy()[:n]
            for i in range(1, 6)]
    count, status, configs, depth, ovf = cols
    status = lin._finalize_batch_status(status, count, ovf)
    out, redo = [], 0
    engine = lin._engine_label(use_k, base="device-batch")
    for i in range(n):
        if int(status[i]) == lin.UNKNOWN and bool(ovf[i]):
            # overflowed the fixed shape: alone, up the single ladder
            redo += 1
            out.append(lin.search_opseq(seqs[i], model, budget=budget,
                                        device=devs[0], lint=False,
                                        audit=False, telemetry=telemetry))
        else:
            out.append(lin._device_batch_certificate(
                {"valid": lin._STATUS[int(status[i])],
                 "configs": int(configs[i]), "max_depth": int(depth[i]),
                 "engine": engine}))
    info = {"batch_lanes": b, "pad_lanes": b - n, "overflow_redo": redo}
    return out, info
