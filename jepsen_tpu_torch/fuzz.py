"""``python -m jepsen_tpu_torch.fuzz`` — the differential fuzzer, with
shrinking.

  python -m jepsen_tpu_torch.fuzz --rounds 200 [--seed 0] [--n-ops 60]
      [--n-procs 4] [--model cas-register|register|mutex|
                             unordered-queue|fifo-queue] [--audit]
      [--device cuda|cpu]
  python -m jepsen_tpu_torch.fuzz --replay FILE [--model M]
  python -m jepsen_tpu_torch.fuzz --corpus [DIR] [--max-entries N]

Random histories (valid by construction, corrupted, crash-heavy) go
through three engines that must agree: the exact host search
(``checker/seq.py``), the device search (``search_opseq``: the greedy
witness and the prepass, then B1 on the card up to its widest frontier
and the torch step past it) and the host linear sweep
(``checker/linear.py``).  An engine that runs out of its cap answers
"unknown", which agrees with everything.  On a disagreement the history
shrinks, greedily, to a minimal repro written to ``--out`` as JSON ops,
which ``--replay`` runs again.  With ``--audit`` every engine's
certificate also replays through ``analyze/audit.py``, and a W-code
fails the run.  ``--corpus`` replays a banked campaign pool through
every route (``live/corpus.corpus_replay``).

The JAX package's ``tools/fuzz.py`` flags, lines and exit codes (0 no
divergence, 1 a divergence, a W-code or a corpus failure), plus
``--device`` (default ``cuda``: without a card the command exits 254
and says why; ``cpu`` runs the device leg's torch step on the host).
Only the errors that encoding and the lint raise make a round
"encode-error" and skip it: a ``KeyError`` of ``encode_ops`` and a
``HistoryLintError`` of the encoding or of an engine's lint.  Any other
error of an engine, a ``KeyError`` or a failed kernel launch among
them, propagates and fails the run.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

from .analyze.lint import HistoryLintError
from .history import Op, encode_ops
from .live.corpus import REPLAY_DEVICE_BUDGET as DEVICE_BUDGET
from .live.corpus import REPLAY_ORACLE_CAP as ORACLE_CAP
from .models import (cas_register, fifo_queue, mutex, register,
                     unordered_queue)

MODELS = {
    "cas-register": cas_register,
    "register": lambda: register(0),
    "mutex": mutex,
    # capacity bounds the multiset; #enqueues never exceeds n-ops, and
    # the fuzzer caps queue histories at 32 ops (see gen_history)
    "unordered-queue": lambda: unordered_queue(33),
    "fifo-queue": lambda: fifo_queue(33),
}

#: queue configs carry a 33-lane state; keep their histories small
QUEUE_MAX_OPS = 32

#: the per-engine work caps (``ORACLE_CAP``, ``DEVICE_BUDGET``) are the
#: corpus replay's: mutated histories can explode combinatorially, and
#: an engine that gives up answers "unknown", which is no divergence.
#: The linear sweep keeps its witness so its valid verdicts audit
WITNESS_CAP = 500_000


class EncodeError(ValueError):
    """A round the engines cannot take: an op the model has no code for
    (``encode_ops``'s ``KeyError``) or a history the lint refuses
    (``HistoryLintError``).  Its message is the cause's."""


def gen_history(rng: random.Random, model_name: str, n_ops: int,
                n_procs: int, crash_p: float) -> list[Op]:
    """One history of ``model_name`` from the simulators of
    ``synth.py``, drawing from ``rng`` in the JAX package's order."""
    from .synth import (sim_mutex_history, sim_queue_history,
                        sim_register_history)

    if model_name == "mutex":
        return sim_mutex_history(rng, n_ops, n_procs, crash_p=crash_p)
    if model_name in ("unordered-queue", "fifo-queue"):
        return sim_queue_history(rng, min(n_ops, QUEUE_MAX_OPS), n_procs,
                                 crash_p=crash_p,
                                 fifo=model_name == "fifo-queue")
    return sim_register_history(rng, n_procs, n_ops, crash_p=crash_p,
                                cas=(model_name == "cas-register"),
                                max_crashes=16)


def corrupt(rng: random.Random, h: list[Op]) -> list[Op]:
    """One corruption: for a queue history, half the time a swap of two
    dequeues or a dequeue from thin air; else ``synth.mutate``."""
    from .synth import corrupt_dequeue, mutate, swap_dequeues

    if any(op.f == "dequeue" for op in h) and rng.random() < 0.5:
        if rng.random() < 0.5:
            return swap_dequeues(rng, h)
        return corrupt_dequeue(rng, h)
    return mutate(rng, h)


def results(h: list[Op], model, *, device="cuda"):
    """``(seq, (oracle, device, linear))``: the three engines' whole
    results on one history, the device leg on ``device``.  An encode or
    lint error raises :class:`EncodeError`; any other error of an engine
    propagates as it is."""
    from .checker import linearizable as lin
    from .checker.linear import check_opseq_linear
    from .checker.seq import check_opseq

    try:
        s = encode_ops(h, model.f_codes)
    except (KeyError, HistoryLintError) as e:
        raise EncodeError(str(e)) from e
    try:
        a = check_opseq(s, model, max_configs=ORACLE_CAP)
        b = lin.search_opseq(s, model, budget=DEVICE_BUDGET, device=device)
        c = check_opseq_linear(s, model, max_configs=ORACLE_CAP,
                               witness_cap=WITNESS_CAP)
    except HistoryLintError as e:
        raise EncodeError(str(e)) from e
    return s, (a, b, c)


def verdicts(h: list[Op], model, *, device="cuda") -> tuple:
    """The three verdicts (oracle, device, linear); an encode or lint
    error gives ``("encode-error", message)`` for each."""
    try:
        _s, (a, b, c) = results(h, model, device=device)
    except EncodeError as e:
        err = ("encode-error", str(e))
        return err, err, err
    return a["valid"], b["valid"], c["valid"]


def audit_results(s, model, rs) -> list:
    """``[(engine, diagnostic)...]``: the W-codes of one round's three
    certificates (empty: every certificate replays clean)."""
    from .analyze.audit import audit

    bad = []
    for engine, r in zip(("oracle", "device", "linear"), rs):
        a = audit(s, model, r)
        if not a["ok"]:
            bad.extend((engine, d) for d in a["diagnostics"])
    return bad


def _diverge(vs) -> bool:
    vs = [v for v in vs if v != "unknown"]
    return len(set(vs)) > 1  # capped-out engines are not divergences


def diverges(h: list[Op], model, *, device="cuda") -> bool:
    return _diverge(verdicts(h, model, device=device))


def shrink(h: list[Op], model, *, max_passes: int = 8,
           device="cuda") -> list[Op]:
    """Greedy delta debugging: drop whole processes, then invoke +
    completion pairs and lone completions, while :func:`diverges`
    holds; at most ``max_passes`` passes."""
    cur = list(h)
    for _ in range(max_passes):
        changed = False
        for p in sorted({op.process for op in cur}):
            cand = [op for op in cur if op.process != p]
            if len(cand) < len(cur) and cand \
                    and diverges(cand, model, device=device):
                cur = cand
                changed = True
        i = 0
        while i < len(cur):
            op = cur[i]
            if op.type == "invoke":
                js = [j for j in range(i + 1, len(cur))
                      if cur[j].process == op.process]
                drop = {i} | ({js[0]} if js else set())
            else:
                drop = {i}
            cand = [op for j, op in enumerate(cur) if j not in drop]
            if cand and diverges(cand, model, device=device):
                cur = cand
                changed = True
            else:
                i += 1
        if not changed:
            break
    return cur


def _dump(ops: list[Op], path: str) -> None:
    with open(path, "w") as f:
        json.dump([op.to_dict() for op in ops], f, indent=1)


def replay(path: str, model_name: str, *, device="cuda") -> int:
    """Run a saved history through the three engines and print their
    verdicts; 1 when they diverge."""
    model = MODELS[model_name]()
    with open(path) as f:
        ops = [Op.from_dict(d) for d in json.load(f)]
    a, b, c = verdicts(ops, model, device=device)
    div = _diverge((a, b, c))
    print(f"oracle={a} device={b} linear={c} "
          f"({'DIVERGES' if div else 'agree'})")
    return 1 if div else 0


def fuzz(model_name: str, *, rounds: int = 100, seed: int = 0,
         n_ops: int = 60, n_procs: int = 4, audit: bool = False,
         out: str | None = "fuzz-repro.json", device="cuda",
         progress=None) -> dict:
    """The round loop: round ``i`` draws its history from
    ``random.Random(seed + i)`` (crash probability, the history, a
    corruption 70% of the time), checks it with the three engines and,
    with ``audit``, audits their certificates.  It stops at the first
    W-code (the history goes to ``out``) or divergence (the shrunk
    history goes to ``out``).  ``progress(rounds, seconds)``, where
    given, is called after every 25th clean round.

    Returns ``{"model", "rounds" (run), "divergence" (None, or {"round",
    "seed", "verdicts", "minimal_verdicts", "ops", "n_ops_before",
    "n_ops_after"}), "audit_failures" ([{"round", "seed", "engine",
    "diagnostic"}...]), "encode_errors", "engines" ({device-leg engine:
    rounds}), "frontier" (the device leg's widest), "frontier_seed" (the
    seed of the first round that reached it), "seconds"}``."""
    model = MODELS[model_name]()
    t0 = time.time()
    rec = {"model": model_name, "rounds": 0, "divergence": None,
           "audit_failures": [], "encode_errors": 0, "engines": {},
           "frontier": 0, "frontier_seed": None}

    def finish() -> dict:
        rec["seconds"] = round(time.time() - t0, 3)
        return rec

    for i in range(rounds):
        rng = random.Random(seed + i)
        crash_p = rng.choice([0.0, 0.0, 0.1, 0.25])
        h = gen_history(rng, model_name, n_ops, n_procs, crash_p)
        if rng.random() < 0.7:
            h = corrupt(rng, h)
        rec["rounds"] = i + 1
        try:
            s, rs = results(h, model, device=device)
        except EncodeError:
            rec["encode_errors"] += 1  # the lint fuzzer's beat
            continue
        engine = rs[1].get("engine")
        rec["engines"][engine] = rec["engines"].get(engine, 0) + 1
        if (rs[1].get("frontier") or 0) > rec["frontier"]:
            rec["frontier"], rec["frontier_seed"] = rs[1]["frontier"], seed + i
        if audit:
            bad = audit_results(s, model, rs)
            if bad:
                rec["audit_failures"] = [
                    {"round": i, "seed": seed + i, "engine": e,
                     "diagnostic": str(d)} for e, d in bad]
                if out:
                    _dump(h, out)
                return finish()
        if _diverge([r["valid"] for r in rs]):
            vs = tuple(r["valid"] for r in rs)
            small = shrink(h, model, device=device)
            vs2 = verdicts(small, model, device=device)
            rec["divergence"] = {
                "round": i, "seed": seed + i, "verdicts": list(vs),
                "minimal_verdicts": list(vs2),
                "ops": [op.to_dict() for op in small],
                "n_ops_before": len(h), "n_ops_after": len(small)}
            if out:
                _dump(small, out)
            return finish()
        if progress and (i + 1) % 25 == 0:
            progress(i + 1, time.time() - t0)
    return finish()


def corpus(pool_dir: str, *, max_entries: int | None = None,
           audit: bool = True, device="cuda") -> int:
    """Replay a banked pool through every route
    (``live/corpus.corpus_replay``), print the JAX package's summary
    line and each failure; 1 on any failure."""
    from .live.corpus import corpus_replay

    out = corpus_replay(pool_dir, audit=audit, max_entries=max_entries,
                        device=device)
    n = out["entries"]
    if not n:
        print(f"corpus: no entries under {pool_dir}")
        return 0
    for msg in out["failures"]:
        print(f"CORPUS {msg}", file=sys.stderr)
    fails = len(out["failures"])
    status = "CLEAN" if not fails else f"{fails} FAILURE(S)"
    hb, unknowns = out["hb_decided"], out["unknowns"]
    print(f"corpus: {n} entr{'y' if n == 1 else 'ies'} replayed through "
          f"all routes, {status}"
          + (f" ({hb} decided fast by the HB pre-pass, parity+audit "
             f"checked)" if hb else "")
          + (f" ({unknowns} route verdict(s) unknown under the budget)"
             if unknowns else "")
          + f" ({out['seconds']:.0f}s)")
    return 1 if fails else 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.fuzz",
        description="Differential fuzzer of the linearizability engines "
                    "(host oracle, device search, linear sweep), with "
                    "shrinking.")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-ops", type=int, default=60)
    ap.add_argument("--n-procs", type=int, default=4)
    ap.add_argument("--model", default="cas-register",
                    choices=sorted(MODELS))
    ap.add_argument("--replay", metavar="FILE")
    ap.add_argument("--corpus", nargs="?", const="store/corpus",
                    default=None, metavar="DIR",
                    help="Replay the banked live-campaign corpus "
                         "(live/corpus.py) through all engine routes "
                         "with verdict-parity + audit assertions; "
                         "DIR defaults to store/corpus")
    ap.add_argument("--max-entries", type=int, default=None,
                    help="Bound the --corpus replay to the first N "
                         "pool entries")
    ap.add_argument("--out", default="fuzz-repro.json")
    ap.add_argument("--audit", action="store_true",
                    help="Also replay every engine's certificate "
                         "through analyze/audit.py; any W-code fails "
                         "the run loudly (exit 1)")
    ap.add_argument("--device", default="cuda",
                    help="Device of the device leg and the corpus's "
                         "device routes (default cuda; exits 254 "
                         "without a card) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .checker.linearizable import _resolve_device

    try:
        device = _resolve_device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device}: {e}", file=sys.stderr)
        return 254
    if args.corpus is not None:
        return corpus(args.corpus, max_entries=args.max_entries,
                      device=device)
    if args.replay:
        return replay(args.replay, args.model, device=device)

    def progress(n, seconds):
        print(f"fuzz: {n}/{args.rounds} rounds clean ({seconds:.0f}s)",
              file=sys.stderr)

    rec = fuzz(args.model, rounds=args.rounds, seed=args.seed,
               n_ops=args.n_ops, n_procs=args.n_procs, audit=args.audit,
               out=args.out, device=device, progress=progress)
    if rec["audit_failures"]:
        f0 = rec["audit_failures"][0]
        print(f"AUDIT FAILURE at round {f0['round']} (seed {f0['seed']}):",
              file=sys.stderr)
        for f in rec["audit_failures"]:
            print(f"  [{f['engine']}] {f['diagnostic']}", file=sys.stderr)
        print(f"history -> {args.out}")
        return 1
    d = rec["divergence"]
    if d:
        a, b, c = d["verdicts"]
        print(f"DIVERGENCE at round {d['round']} (seed {d['seed']}): "
              f"oracle={a} device={b} linear={c}; shrinking...",
              file=sys.stderr)
        a2, b2, c2 = d["minimal_verdicts"]
        print(f"minimal repro: {d['n_ops_after']} ops (from "
              f"{d['n_ops_before']}) -> {args.out}; oracle={a2} device={b2} "
              f"linear={c2}")
        for op in d["ops"]:
            print(" ", op)
        return 1
    print(f"fuzz: {args.rounds} rounds, no divergence "
          f"({rec['seconds']:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
