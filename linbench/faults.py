"""Faults planted in the port's timed path under a run: each has to make
``correct`` come out false.

    python3 linbench/faults.py --fault <name> --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``run.py`` does, with the fault in place, and prints the
run's result line; exits 0 when the run reads ``correct`` false.  The
CPU tests (``tests/test_linbench_faults.py``) plant each fault in a small
run; on the card this runs them at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def flip(orig):
    """An answer altered where it is produced: the verdict negated."""
    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        if out.get("valid") in (True, False):
            out["valid"] = not out["valid"]
        return out
    return wrapped


def half(orig):
    """Half of the batch left out."""
    def wrapped(seqs, *a, **kw):
        return orig(seqs, *a, **kw)[:len(seqs) // 2]
    return wrapped


def unchanged(orig):
    """A step that returns its state unchanged: the batch's device route
    ends every key where it began."""
    def wrapped(seqs, *a, **kw):
        return [{"valid": "unknown", "configs": 0, "max_depth": 0,
                 "engine": "device-batch"} for _ in seqs]
    return wrapped


def all_valid(orig):
    """The batch's device route answers "valid" for every key."""
    def wrapped(seqs, *a, **kw):
        out = orig(seqs, *a, **kw)
        for r in out:
            r["valid"] = True
        return out
    return wrapped


#: name -> (where in ``checker/linearizable.py``, the fault)
FAULTS = {
    "verdict_negated": ("Linearizable._check_direct", flip),
    "half_batch": ("search_batch", half),
    "ladder_unchanged": ("_search_batch_ladder", unchanged),
    "ladder_all_valid": ("_search_batch_ladder", all_valid),
}


def plant(name: str) -> None:
    """Put fault ``name`` in place, for the rest of the process."""
    from jepsen_tpu_torch.checker import linearizable as lin

    target, fault = FAULTS[name]
    owner, attr = (lin.Linearizable, target.split(".")[1]) \
        if "." in target else (lin, target)
    setattr(owner, attr, fault(getattr(owner, attr)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(run.ROOT))
    plant(args.fault)
    result = run.run(run.parse_args(
        ["--workload", args.workload, "--seed", str(args.seed),
         "--seconds", str(args.seconds), "--trace", "0"]))
    print(json.dumps({"fault": args.fault, "correct": result["correct"],
                      "failed": result["failed"],
                      "compared": result["compared"]}))
    return 0 if result["correct"] is False else 1


if __name__ == "__main__":
    sys.exit(main())
