"""``python -m jepsen_tpu_torch.analyze`` — lint/explain/audit a stored
history.  The counterpart of ``python -m jepsen_tpu.analyze``: the same
flags, help texts and exit codes, plus ``--device``.

Reads a ``history.jsonl`` (store.write_history's format: one op per
line), lints it; ``--explain`` prints the static search plan;
``--audit RESULT.json`` replays a stored result's certificate
(``linearization``/``final_ops``) against the history and model — the
standalone certificate checker::

    python -m jepsen_tpu_torch.analyze store/t/latest/history.jsonl \\
        --model cas-register --explain
    python -m jepsen_tpu_torch.analyze history.jsonl --json
    python -m jepsen_tpu_torch.analyze history.jsonl --model cas-register \\
        --audit result.json

``--device`` (default ``cuda``) is the device the plan is made for: it
sets the search's first frontier rung (64 rows on the card, 16 on the
host).  Without a card ``--device cuda`` exits 254 and says why; it
never plans for the host quietly::

    python -m jepsen_tpu_torch.analyze history.jsonl --model register \\
        --explain --device cpu

``--devlint`` takes no history: it runs one slice of every kernel
route under the op recorder of ``analyze/devlint.py`` on ``--device``
and holds it to the K-code device contract (K001-K007); it prints the
findings (``--json``: the result block) and exits 1 on errors, 0
otherwise::

    python -m jepsen_tpu_torch.analyze --devlint --json
    python -m jepsen_tpu_torch.analyze --devlint --device cpu

``--mc`` takes no history: it model-checks the live backend
state machines at bounded scope (analyze/modelcheck.py, MC1xx codes —
see docs/analyze.md §11).  The default sweeps every family x mode and
exits 0 exactly when the matrix matches expectations (clean modes
violation-free, seeded modes caught with replaying certificates); a
specific ``--mc-family``/``--mc-mode`` pair exits 1 iff violations
were found.  ``--replay`` re-executes an emitted schedule
certificate::

    python -m jepsen_tpu_torch.analyze --mc --json
    python -m jepsen_tpu_torch.analyze --mc --mc-scope shell   # MC2xx layer
    python -m jepsen_tpu_torch.analyze --mc --mc-family replicated \\
        --mc-mode volatile --mc-bank store
    python -m jepsen_tpu_torch.analyze --mc --replay cert.json
    python -m jepsen_tpu_torch.analyze --mc --explain   # scope plan only

``--mc-scope`` picks the checked layer: ``core`` (the lifted state
machines, MC1xx), ``shell`` (the daemons' request-dispatch shells
under a simulated transport — analyze/simnet.py, MC2xx), or ``all``.

``--mc``, ``--replay`` and ``--audit`` run on the host whatever
``--device`` says; ``--devlint`` runs its routes on it.

Exit codes follow the JAX package's cli.py contract: 0 clean, 1 lint
errors or audit W-codes found, 254 bad arguments.
"""

from __future__ import annotations

import argparse
import json
import sys

#: model factories reachable by name; parameterized ones take their
#: knob from --model-arg
MODELS = ("register", "cas-register", "mutex", "noop", "multi-register",
          "unordered-queue", "fifo-queue")


def _model(name: str, arg: int | None):
    from .. import models

    if name == "register":
        return models.register(arg if arg is not None else 0)
    if name == "cas-register":
        return models.cas_register()
    if name == "mutex":
        return models.mutex()
    if name == "noop":
        return models.noop()
    if name == "multi-register":
        return models.multi_register(arg if arg is not None else 8)
    if name == "unordered-queue":
        return models.unordered_queue(arg if arg is not None else 16)
    if name == "fifo-queue":
        return models.fifo_queue(arg if arg is not None else 16)
    raise ValueError(f"unknown model {name!r}; one of {MODELS}")


def _mc_pairs(opts) -> list[tuple]:
    from .modelcheck import ALL_FAMILIES, ALL_MODES, FAMILIES, \
        SHELL_FAMILIES

    scoped = {"core": FAMILIES, "shell": SHELL_FAMILIES,
              "all": ALL_FAMILIES}[opts.mc_scope]
    # a named family always runs, whatever the scope filter says
    fams = scoped if opts.mc_family == "all" else (opts.mc_family,)
    pairs = []
    for fam in fams:
        for mode in ALL_MODES[fam]:
            if opts.mc_mode in ("all", mode):
                pairs.append((fam, mode))
    return pairs


def _run_mc_cli(opts) -> int:
    from . import modelcheck as mc

    dpor = False if opts.no_dpor else None
    if opts.replay:
        try:
            cert = mc.load_certificate(opts.replay)
        except (OSError, ValueError) as e:
            print(f"cannot read certificate {opts.replay}: {e}",
                  file=sys.stderr)
            return 254
        try:
            rep = mc.replay_certificate(cert)
        except (KeyError, ValueError) as e:
            print(f"malformed certificate: {e}", file=sys.stderr)
            return 254
        if opts.as_json:
            print(json.dumps(rep, indent=2, default=str))
        else:
            print(f"replay: {'reproduced' if rep['reproduced'] else 'DID NOT reproduce'} "
                  f"{cert.get('code')} (got {rep['code']})")
        return 0 if rep["reproduced"] else 1
    pairs = _mc_pairs(opts)
    if not pairs:
        print(f"--mc-mode {opts.mc_mode!r} matches no mode of "
              f"--mc-family {opts.mc_family!r}", file=sys.stderr)
        return 254

    def scope_for(fam, mode):
        return mc.scope_from_args(
            fam, mode, crashes=opts.mc_crashes,
            partitions=opts.mc_partitions,
            max_events=opts.mc_max_events,
            max_states=opts.mc_max_states)

    if opts.explain:
        blocks = [mc.mc_plan_block(f, m, scope_for(f, m))
                  for f, m in pairs]
        if opts.as_json:
            print(json.dumps({"mc_plan": blocks}, indent=2,
                             default=str))
        else:
            for b in blocks:
                s = b["scope"]
                print(f"{b['family']}/{b['mode']}: nodes={s['nodes']} "
                      f"ops={s['ops']} crashes={s['crashes']} "
                      f"partitions={s['partitions']} "
                      f"max_events={s['max_events']}")
            print(f"codes: {', '.join(blocks[0]['codes'])}")
        return 0
    runs = []
    for fam, mode in pairs:
        runs.append(mc.run_mc(
            fam, mode, scope=scope_for(fam, mode), dpor=dpor,
            bank_base=opts.mc_bank if mode != "clean" else None))
    sweep = opts.mc_family == "all" and opts.mc_mode == "all"
    if sweep:
        # expected-outcome matrix: clean modes pass, seeded modes
        # caught with replaying certificates
        ok = all(
            r["ok"] if r["mode"] == "clean"
            else (not r["ok"]
                  and all(c.get("replayed") for c in r["violations"]))
            for r in runs)
    else:
        ok = all(r["ok"] for r in runs)
    if opts.as_json:
        print(json.dumps({"ok": ok, "runs": runs}, indent=2,
                         default=str))
    else:
        for r in runs:
            ex = r["explored"]
            codes = sorted({c["code"] for c in r["violations"]})
            verdict = "clean" if r["ok"] else \
                f"VIOLATIONS {', '.join(codes)}"
            print(f"{r['family']}/{r['mode']}: {verdict} — "
                  f"{ex['states']} states, {ex['schedules']} "
                  f"schedules, prune ratio {ex['prune_ratio']}, "
                  f"complete={ex['complete']}")
        print(f"mc: {'ok' if ok else 'FAILED'} "
              f"({len(runs)} run(s){' , sweep expectations' if sweep else ''})")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.analyze",
        description="Lint a stored history; --explain adds the static "
                    "search plan (dims, bucket, engine route, "
                    "decompositions).")
    p.add_argument("history", nargs="?", default=None,
                   help="history.jsonl path (one op/line); not needed "
                        "with --devlint")
    p.add_argument("--model", choices=MODELS, default=None,
                   help="Model for the model-facing checks + plan")
    p.add_argument("--model-arg", type=int, default=None,
                   help="Model parameter (initial value / width / "
                        "capacity)")
    p.add_argument("--explain", action="store_true",
                   help="Print the static search plan (needs --model)")
    p.add_argument("--audit", metavar="RESULT_JSON", default=None,
                   help="Audit a stored result's certificate against "
                        "this history (needs --model); exits 1 on any "
                        "W-code")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="Machine-readable output")
    p.add_argument("--devlint", action="store_true",
                   help="Lint every kernel route for the K-code "
                        "device contract")
    p.add_argument("--mc", action="store_true",
                   help="Model-check the live backend state machines "
                        "at bounded scope (no history needed)")
    p.add_argument("--mc-scope", default="core",
                   choices=("core", "shell", "all"),
                   help="Which layer to check: the lifted cores "
                        "(default), the daemon shells under the "
                        "simulated transport (analyze/simnet.py), or "
                        "both")
    p.add_argument("--mc-family", default="all",
                   choices=("all", "replicated", "rqueue", "lock",
                            "shell-kv", "shell-queue",
                            "shell-replicated", "shell-rqueue"),
                   help="Backend family for --mc (default: sweep the "
                        "--mc-scope families)")
    p.add_argument("--mc-mode", default="all",
                   choices=("all", "clean", "volatile", "split-brain",
                            "session-leak", "proxy-loop",
                            "stale-proxy"),
                   help="Backend mode for --mc (default: every mode "
                        "of the family)")
    p.add_argument("--mc-max-events", type=int, default=None,
                   help="Scope override: schedule depth bound")
    p.add_argument("--mc-crashes", type=int, default=None,
                   help="Scope override: crash budget")
    p.add_argument("--mc-partitions", type=int, default=None,
                   help="Scope override: partition budget")
    p.add_argument("--mc-max-states", type=int, default=None,
                   help="Scope override: state-expansion budget")
    p.add_argument("--mc-bank", metavar="DIR", default=None,
                   help="Bank violation histories into this corpus "
                        "base directory")
    p.add_argument("--no-dpor", action="store_true",
                   help="Disable sleep-set reduction for --mc "
                        "(soundness A/B; same violation set, slower)")
    p.add_argument("--replay", metavar="CERT_JSON", default=None,
                   help="Replay a --mc schedule certificate; exits 0 "
                        "iff it reproduces its recorded MC code")
    p.add_argument("--device", default="cuda",
                   help="Device the plan is made for: cuda (default; "
                        "exits 254 without a card) or cpu")
    try:
        opts = p.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code in (0, None) else 254

    if opts.mc:
        return _run_mc_cli(opts)
    if opts.history is None and not opts.devlint:
        print("history path required (or --devlint)", file=sys.stderr)
        return 254

    from ..checker.linearizable import _resolve_device

    try:
        device = _resolve_device(opts.device)
    except RuntimeError as e:
        print(f"--device {opts.device}: {e}", file=sys.stderr)
        return 254
    if opts.devlint:
        from .devlint import run_devlint

        rep = run_devlint(live=True, device=device)
        if opts.as_json:
            print(json.dumps(rep, indent=2, default=str))
        else:
            for d in rep["diagnostics"]:
                print(f"{d['severity'].upper()} {d['code']} "
                      f"{d['message']}")
            print(f"devlint: {rep['errors']} error(s), "
                  f"{rep['warnings']} warning(s) over "
                  f"{len(rep['routes'])} route(s): "
                  f"{', '.join(rep['routes'])}")
        return 1 if rep["errors"] else 0

    from .. import store
    from . import analyze
    from .plan import render_plan
    try:
        history = store.read_history(opts.history)
    except OSError as e:
        print(f"cannot read {opts.history}: {e}", file=sys.stderr)
        return 254
    model = _model(opts.model, opts.model_arg) if opts.model else None
    if opts.explain and model is None:
        print("--explain needs --model", file=sys.stderr)
        return 254
    if opts.audit and model is None:
        print("--audit needs --model", file=sys.stderr)
        return 254

    audit_rep = None
    if opts.audit:
        from .audit import audit as run_audit

        try:
            with open(opts.audit) as f:
                result = json.load(f)
        except (OSError, ValueError) as e:
            print(f"cannot read result {opts.audit}: {e}",
                  file=sys.stderr)
            return 254
        audit_rep = run_audit(history, model, result)

    rep = analyze(history, model, device=device)
    diags = rep["diagnostics"]
    if opts.as_json:
        out = {"errors": rep["errors"], "warnings": rep["warnings"],
               "diagnostics": [d.to_dict() for d in diags]}
        if opts.explain:
            out["plan"] = rep["plan"]
        if audit_rep is not None:
            out["audit"] = {
                "ok": audit_rep["ok"], "checked": audit_rep["checked"],
                "codes": audit_rep["codes"],
                "diagnostics": [d.to_dict()
                                for d in audit_rep["diagnostics"]]}
        print(json.dumps(out, indent=2, default=str))
    else:
        for d in diags:
            print(f"{d.severity.upper()} {d}")
        print(f"{rep['errors']} error(s), {rep['warnings']} warning(s) "
              f"over {len(history)} events")
        if opts.explain and rep["plan"] is not None:
            print(render_plan(rep["plan"]))
        elif opts.explain:
            print("plan skipped: history has lint errors")
        if audit_rep is not None:
            for d in audit_rep["diagnostics"]:
                print(f"AUDIT {d}")
            print(f"audit: {'ok' if audit_rep['ok'] else 'FAILED'} "
                  f"(checked {audit_rep['checked']}, "
                  f"{len(audit_rep['diagnostics'])} finding(s))")
    if audit_rep is not None and not audit_rep["ok"]:
        return 1
    return 1 if rep["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
