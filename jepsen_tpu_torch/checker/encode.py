"""Host encoding of one history for the device search.

Configuration encoding: determinate (ok) ops are kept sorted by
invocation.  In any reachable configuration, if ``p`` is the first
unlinearized determinate op, every linearized determinate op beyond it
was invoked before ``ret[p]``, and their number is bounded by the
host-computed ``window``; so the linearized determinate set is exactly
(prefix ``p``, bitmask over the next ``W`` ops).  Crashed (:info) ops,
which may linearize at any point after invocation or never, live in a
separate bitmask of width ``<= 64``.  A configuration is then the int32
row ``[p | window words | crash words | model state]``.

The reduction planes (:func:`attach_reductions`) carry the prepass's
must-order predecessors per row and the dead-value table; the masked
and dedup step (``step.py``) reads them, the unreduced search receives
them inert.

The carry ``(frontier, count, status, configs, max_depth, ovf)`` is the
whole search state and the exchange format with the JAX package:
:func:`from_reference` and :func:`to_numpy` move encodings and carries
across, word for word.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..decompose.canonical import NEVER_DEAD, dead_value_cutoffs
from ..history import INF_RET, NIL, OpSeq

#: int32 "+infinity" event rank on device
INF32 = 2**31 - 1

#: must-order predecessor slots per row shipped to the device; a row
#: with more keeps its latest ones (a subset of the predecessors is a
#: weaker prune, never a wrong one)
MASK_PREDS = 4

#: widest dead-value table the device dedup carries (candidate state
#: values only); wider value ranges skip the device rewrite
DEAD_TABLE_MAX = 1 << 16

#: refuse device search past these (host oracle instead)
MAX_WINDOW = 512
MAX_CRASH = 64

#: widest frontier rung
MAX_FRONTIER = 1 << 18


@dataclass
class EncodedSearch:
    """Device-ready arrays for one history (numpy; padded by
    :func:`pad_search`).  The ``*_mpred``/``*_cpred``/``dead_*`` fields
    are the reduction planes (:func:`attach_reductions`); ``masked`` and
    ``dedup`` say whether the search must read them, and
    :func:`pad_search` always materializes them (inert when off)."""

    det_f: np.ndarray  # int32 [n_det(_pad)]
    det_v1: np.ndarray
    det_v2: np.ndarray
    det_inv: np.ndarray  # INF32 padding
    det_ret: np.ndarray  # INF32 padding
    suffix_min_ret: np.ndarray  # int32 [n_det(_pad) + 1]
    crash_f: np.ndarray  # int32 [n_crash(_pad)]
    crash_v1: np.ndarray
    crash_v2: np.ndarray
    crash_inv: np.ndarray
    n_det: int
    n_crash: int
    window: int  # exact bound on the linearized-beyond-prefix span
    concurrency: int  # max simultaneously-enabled candidates
    #: det positions of up to MASK_PREDS must-predecessors per row (-1
    #: pads), and the crash-index predecessors as a bitmask
    det_mpred: np.ndarray | None = None    # int32 [n_det(_pad), P]
    det_cpred: np.ndarray | None = None    # uint64 [n_det]
    crash_mpred: np.ndarray | None = None  # int32 [n_crash(_pad), P]
    crash_cpred: np.ndarray | None = None  # uint64 [n_crash]
    #: the crash-pred bitmasks packed into int32 words (pad_search)
    det_cpredw: np.ndarray | None = None   # int32 [n_det_pad, CW]
    crash_cpredw: np.ndarray | None = None  # int32 [n_crash_pad, CW]
    #: dead-value table: the prefix position from which each value in
    #: [dead_lo, dead_lo + VT) is dead, and the token it rewrites to
    dead_from: np.ndarray | None = None    # int32 [VT]
    dead_lo: int = 0
    dead_tok: int = 0
    masked: bool = False
    mask_has_crash: bool = False
    dedup: bool = False


def split_rows(seq: OpSeq):
    """Row indices of determinate (ok) and crashed (info) ops."""
    ok = np.asarray(seq.ok, dtype=bool)
    return np.nonzero(ok)[0], np.nonzero(~ok)[0]


def window_width(det_inv: np.ndarray, det_ret: np.ndarray) -> int:
    """Exact window bound: max over b of #{j >= b : inv[j] < ret[b]}."""
    n = len(det_inv)
    if n == 0:
        return 1
    upper = np.searchsorted(det_inv, det_ret, side="left")
    return max(1, int((upper - np.arange(n)).max()))


def max_enabled(seq: OpSeq) -> int:
    """Bound on simultaneously-enabled candidates: the history's peak
    concurrency (enabled candidates pairwise overlap, and overlapping
    intervals share a point; crashed ops stay open forever)."""
    events = []
    for i in range(len(seq)):
        events.append((int(seq.inv[i]), 1))
        if int(seq.ret[i]) != INF_RET:
            events.append((int(seq.ret[i]), -1))
    events.sort()
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return max(1, peak)


def encode_search(seq: OpSeq) -> EncodedSearch:
    det_idx, crash_idx = split_rows(seq)
    inv64 = np.asarray(seq.inv, dtype=np.int64)
    det_inv = inv64[det_idx]
    det_ret = np.asarray(seq.ret, dtype=np.int64)[det_idx]

    def i32(a):
        return np.asarray(a, dtype=np.int32)

    det_ret32 = i32(np.minimum(det_ret, INF32))
    n_det = len(det_idx)
    # suffix minima of det returns; sfx[n_det] = +inf
    sfx = np.full(n_det + 1, INF32, dtype=np.int32)
    if n_det:
        sfx[:n_det] = np.minimum.accumulate(det_ret32[::-1])[::-1]
    return EncodedSearch(
        det_f=i32(seq.f[det_idx]), det_v1=i32(seq.v1[det_idx]),
        det_v2=i32(seq.v2[det_idx]),
        det_inv=i32(np.minimum(det_inv, INF32)), det_ret=det_ret32,
        suffix_min_ret=sfx,
        crash_f=i32(seq.f[crash_idx]), crash_v1=i32(seq.v1[crash_idx]),
        crash_v2=i32(seq.v2[crash_idx]),
        crash_inv=i32(np.minimum(inv64[crash_idx], INF32)),
        n_det=n_det, n_crash=len(crash_idx),
        window=window_width(det_inv, det_ret),
        concurrency=max_enabled(seq))


def attach_reductions(es: EncodedSearch, seq: OpSeq, model,
                      must_pred: dict | None, *,
                      dedup: bool = True) -> EncodedSearch:
    """Attach the reduction planes to ``es`` (in place; returned).

    ``must_pred`` is the prepass's row -> must-predecessor rows map,
    split here into det-position and crash-index tables.  ``dedup``
    also builds the dead-value table (``decompose/canonical.py``) when
    the model and the value range allow."""
    det_rows, crash_rows = split_rows(seq)
    if must_pred:
        det_pos_of = {int(r): p for p, r in enumerate(det_rows)}
        crash_of = {int(r): c for c, r in enumerate(crash_rows)}
        dmp = np.full((es.n_det, MASK_PREDS), -1, np.int32)
        # unsigned: crash index 63 sets bit 63
        dcp = np.zeros(es.n_det, np.uint64)
        cmp_ = np.full((es.n_crash, MASK_PREDS), -1, np.int32)
        ccp = np.zeros(es.n_crash, np.uint64)
        any_mask = False
        has_crash_pred = False
        for dst, srcs in must_pred.items():
            dp = sorted(det_pos_of[s] for s in srcs if s in det_pos_of)
            cp = 0
            for s in srcs:
                c = crash_of.get(s)
                if c is not None:
                    cp |= 1 << c
            if not dp and not cp:
                continue
            dp = dp[-MASK_PREDS:]  # keep the latest (they bind longest)
            if dst in det_pos_of:
                p = det_pos_of[dst]
                dmp[p, :len(dp)] = dp
                dcp[p] = cp
            else:
                c = crash_of[dst]
                cmp_[c, :len(dp)] = dp
                ccp[c] = cp
            any_mask = True
            has_crash_pred = has_crash_pred or bool(cp)
        if any_mask:
            es.det_mpred, es.det_cpred = dmp, dcp
            es.crash_mpred, es.crash_cpred = cmp_, ccp
            es.masked = True
            es.mask_has_crash = has_crash_pred
    if dedup and model.state_width == 1:
        dv = dead_value_cutoffs(seq, model)
        if dv is not None:
            lo, hi = dv.value_range()
            span = hi - lo + 1
            if span <= DEAD_TABLE_MAX:
                t = np.full(span, NEVER_DEAD, np.int32)
                for v, c in dv.cutoffs.items():
                    # compared-only values lie outside the candidate
                    # span: no state holds them
                    if lo <= v < lo + span:
                        t[v - lo] = min(c, NEVER_DEAD)
                es.dead_from = t
                es.dead_lo = lo
                es.dead_tok = dv.token
                es.dedup = True
    return es


def _pack_cpred(bits: np.ndarray | None, n_rows: int,
                cw: int) -> np.ndarray:
    """uint64 crash-pred bitmasks per row -> int32 words [n_rows, cw]."""
    out = np.zeros((n_rows, cw), np.int32)
    if bits is not None:
        b = bits.astype(np.uint64)
        for w in range(min(cw, 2)):
            out[:len(b), w] = ((b >> np.uint64(32 * w))
                               & np.uint64(0xFFFFFFFF)).astype(
                np.uint32).view(np.int32)
    return out


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _round_up(x: int, m: int) -> int:
    return ((max(1, x) + m - 1) // m) * m


def pad_search(es: EncodedSearch, n_det_pad: int, n_crash_pad: int,
               dead_pad: int | None = None) -> EncodedSearch:
    """Pad every table to static shapes.  The reduction planes are
    always materialized (all -1 predecessors, zero crash-pred words and
    an all-NEVER_DEAD table when absent); the dead table is padded to
    ``dead_pad`` entries (a batch passes its keys' common width), by
    default to this key's power of two, at least 8."""

    def pad(a, n, fill):
        out = np.full(n, fill, dtype=np.int32)
        out[:len(a)] = a
        return out

    cw = max(1, n_crash_pad // 32)
    dmp = np.full((n_det_pad, MASK_PREDS), -1, np.int32)
    if es.det_mpred is not None:
        dmp[:len(es.det_mpred)] = es.det_mpred
    cmp_ = np.full((n_crash_pad, MASK_PREDS), -1, np.int32)
    if es.crash_mpred is not None:
        cmp_[:len(es.crash_mpred)] = es.crash_mpred
    if dead_pad is None:
        dead_pad = (_next_pow2(len(es.dead_from))
                    if es.dead_from is not None else 8)
    dead = np.full(max(8, dead_pad), NEVER_DEAD, np.int32)
    if es.dead_from is not None:
        dead[:len(es.dead_from)] = es.dead_from
    return EncodedSearch(
        det_f=pad(es.det_f, n_det_pad, 0),
        det_v1=pad(es.det_v1, n_det_pad, NIL),
        det_v2=pad(es.det_v2, n_det_pad, NIL),
        det_inv=pad(es.det_inv, n_det_pad, INF32),
        det_ret=pad(es.det_ret, n_det_pad, INF32),
        suffix_min_ret=pad(es.suffix_min_ret, n_det_pad + 1, INF32),
        crash_f=pad(es.crash_f, n_crash_pad, 0),
        crash_v1=pad(es.crash_v1, n_crash_pad, NIL),
        crash_v2=pad(es.crash_v2, n_crash_pad, NIL),
        crash_inv=pad(es.crash_inv, n_crash_pad, INF32),
        n_det=es.n_det, n_crash=es.n_crash, window=es.window,
        concurrency=es.concurrency,
        det_mpred=dmp,
        det_cpredw=_pack_cpred(es.det_cpred, n_det_pad, cw),
        crash_mpred=cmp_,
        crash_cpredw=_pack_cpred(es.crash_cpred, n_crash_pad, cw),
        dead_from=dead, dead_lo=es.dead_lo, dead_tok=es.dead_tok,
        masked=es.masked, mask_has_crash=es.mask_has_crash,
        dedup=es.dedup)


@dataclass(frozen=True)
class SearchDims:
    """Static search dimensions."""

    n_det_pad: int
    n_crash_pad: int  # multiple of 32, <= 64
    window: int  # W, multiple of 32
    k: int  # successor lanes per config (>= max concurrency)
    state_width: int
    frontier: int  # F: max configs per BFS level

    @property
    def win_words(self) -> int:
        return self.window // 32

    @property
    def crash_words(self) -> int:
        return max(1, self.n_crash_pad // 32)

    @property
    def words(self) -> int:
        # p | win | crash | state
        return 1 + self.win_words + self.crash_words + self.state_width


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def _pack_bits(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """bool [..., 32*n_words] -> int32 words [..., n_words] (bit 31
    round-trips through the sign)."""
    b = bits.reshape(bits.shape[:-1] + (n_words, 32)).to(torch.int64)
    words = (b << _shifts(bits.device)).sum(dim=-1)
    return _u32_to_i32(words)


def _unpack_bits(words: torch.Tensor, n_words: int) -> torch.Tensor:
    """int32 words [..., n_words] -> bool [..., 32*n_words]."""
    w = _u32(words)[..., :, None]
    bits = (w >> _shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (n_words * 32,)).bool()


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned values, in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the int32 with the same
    bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _width_floor(device: torch.device) -> int:
    """Narrowest frontier rung: 64 on the card (one block's warps cover
    64 rows at the cost of one), 16 on the host, where per-level cost
    tracks the rows actually alive."""
    return 64 if device.type == "cuda" else 16


def _grid_width(f: int, device: torch.device) -> int:
    """Snap up to the power-of-two width grid, floored per device and
    clamped to MAX_FRONTIER."""
    w = _width_floor(device)
    while w < f and w < MAX_FRONTIER:
        w *= 2
    return w


def choose_dims(es: EncodedSearch, model, *, device,
                frontier: int | None = None) -> SearchDims:
    """Search dimensions, quantized to powers of two / multiples of 32.
    The default frontier starts narrow; the driver widens on overflow
    and narrows when the live frontier shrinks."""
    W = _round_up(es.window, 32)
    NC = _round_up(es.n_crash, 32) if es.n_crash else 32
    K = _next_pow2(min(es.concurrency, W + es.n_crash))
    if frontier is None:
        frontier = _grid_width(min(4096, (es.n_det + es.n_crash) // 8),
                               torch.device(device))
    return SearchDims(n_det_pad=max(64, _next_pow2(es.n_det)),
                      n_crash_pad=NC, window=W, k=max(1, K),
                      state_width=model.state_width, frontier=frontier)


def _init_config(dims: SearchDims, model) -> np.ndarray:
    """Root configuration: p=0, empty masks, the model's init state."""
    cfg = np.zeros(dims.words, np.int32)
    cfg[1 + dims.win_words + dims.crash_words:] = np.asarray(model.init,
                                                            np.int32)
    return cfg


def _init_carry(dims: SearchDims, model):
    """Fresh search carry as numpy (the JAX package's dtypes)."""
    frontier = np.zeros((dims.frontier, dims.words), np.int32)
    frontier[0] = _init_config(dims, model)
    return (frontier, np.int32(1), np.int32(-1), np.int32(0),
            np.int32(0), np.bool_(False))


def _widen_carry(carry, old_f: int, new_f: int):
    """Zero-pad a device carry's frontier from old_f to new_f rows."""
    fr = carry[0]
    out = torch.zeros((new_f, fr.shape[1]), dtype=fr.dtype,
                      device=fr.device)
    out[:old_f] = fr
    return (out,) + tuple(carry[1:])


def carry_to_device(carry, device) -> tuple:
    """A numpy carry (frontier, count, status, configs, max_depth, ovf)
    as device tensors: int32 frontier and scalars, bool ovf.  The
    frontier's bytes count as staged (``obs.telemetry.record_transfer``)."""
    from ..obs.telemetry import record_transfer

    dev = torch.device(device)
    frontier = np.asarray(carry[0], np.int32)
    record_transfer(frontier.nbytes)
    out = [torch.as_tensor(frontier, device=dev)]
    out += [torch.tensor(int(np.asarray(c)), dtype=torch.int32, device=dev)
            for c in carry[1:5]]
    out.append(torch.tensor(bool(np.asarray(carry[5])), device=dev))
    return tuple(out)


_TABLES = ("det_f", "det_v1", "det_v2", "det_inv", "det_ret",
           "suffix_min_ret", "crash_f", "crash_v1", "crash_v2",
           "crash_inv", "det_mpred", "det_cpredw", "crash_mpred",
           "crash_cpredw", "dead_from")


def search_args(esp: EncodedSearch, es: EncodedSearch | None = None, *,
                device) -> tuple:
    """The positional table/scalar arguments of the step functions: 15
    int32 tensors, then ``n_det, n_crash, dead_lo, dead_tok`` as Python
    ints.  ``es`` supplies the true counts when ``esp`` is padded.  The
    tables' bytes count as staged (``obs.telemetry.record_transfer``)."""
    from ..obs.telemetry import record_transfer, transfer_bytes

    src = es if es is not None else esp
    dev = torch.device(device)
    tables = [np.asarray(getattr(esp, k), np.int32) for k in _TABLES]
    record_transfer(transfer_bytes(tables))
    return tuple(torch.as_tensor(t, device=dev) for t in tables) + (
        int(src.n_det), int(src.n_crash), int(esp.dead_lo),
        int(esp.dead_tok))


#: the per-key scalars a stacked batch carries beside its tables
_BATCH_SCALARS = ("n_det", "n_crash", "dead_lo", "dead_tok")


def stack_batch(esps: list[EncodedSearch], *, pad_to: int | None = None,
                device) -> tuple:
    """Padded encodings stacked along a leading key axis, as the
    arguments of the batch slice functions: the 15 tables as int32
    ``[B, ...]`` tensors, then ``n_det, n_crash, dead_lo, dead_tok`` as
    int32 ``[B]``.  Keys past ``len(esps)`` (up to ``pad_to``) repeat
    key 0's tables with ``n_det = n_crash = 0``: inert pad keys.  The
    return suffix table's rows are padded with +inf to a multiple of 4
    entries, so that each key's row starts on a 16-byte boundary (the
    grid kernel's bulk copies need it); no step reads past entry
    ``n_det_pad``.  The tables' bytes count as staged
    (``obs.telemetry.record_transfer``)."""
    from ..obs.telemetry import record_transfer

    dev = torch.device(device)
    b = pad_to or len(esps)
    pad = b - len(esps)
    nbytes = 0

    def st(attr):
        nonlocal nbytes
        rows = [getattr(e, attr) for e in esps]
        a = np.stack(rows + [rows[0]] * pad).astype(np.int32, copy=False)
        if attr == "suffix_min_ret":
            n = a.shape[1]
            out = np.full((b, (n + 3) // 4 * 4), INF32, np.int32)
            out[:, :n] = a
            a = out
        nbytes += a.nbytes
        return torch.as_tensor(a, device=dev)

    def sc(attr):
        vals = [int(getattr(e, attr)) for e in esps] + [0] * pad
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    out = tuple(st(a) for a in _TABLES) + tuple(sc(a)
                                                for a in _BATCH_SCALARS)
    record_transfer(nbytes)
    return out


def from_reference(es_arrays: dict, carry=None, device="cuda"):
    """The JAX package's padded ``EncodedSearch`` fields (a dict of
    numpy arrays and ints, e.g. ``dataclasses.asdict``) and optionally
    its carry (numpy) -> ``(args, carry)`` as this port's tensors on
    ``device``: ``args`` as :func:`search_args` builds them."""
    names = {f.name for f in fields(EncodedSearch)}
    esp = EncodedSearch(**{k: v for k, v in es_arrays.items()
                           if k in names})
    args = search_args(esp, device=device)
    return args, (None if carry is None
                  else carry_to_device(carry, device))


def to_numpy(values) -> tuple:
    """Tensors (a carry or step arguments) -> numpy, in the JAX
    package's dtypes: int32 arrays and scalars, ``np.bool_`` flags;
    Python ints pass through."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            out.append(a if a.ndim else a[()])
        else:
            out.append(v)
    return tuple(out)
