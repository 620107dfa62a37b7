"""The control of the benchmark's comparison: the plain reference with
the real-time order dropped (sequential consistency, a guarantee weaker
than the configurations state), put in the program's place over a cell's
pool at the cell's own size, and compared with the reference as a run's
verdicts are.  It has to come out not correct.

    python3 linbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

Prints one JSON line per seed with the counts the comparison reads; the
control is refused (exit 1) unless every seed's run would be incorrect.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402
from reference import check as ref  # noqa: E402

#: the control's configuration budget: a search past it reads "unknown",
#: which the comparison counts as a failure of the control
MAX_CONFIGS = 200_000


def control_checks(pool: list[dict]) -> list[dict]:
    """The control's verdicts on every check of ``pool``, in the shape of
    a run's window records."""
    out = []
    for i, c in enumerate(pool):
        if c["keys"][0]["key"] is None:
            v = {None: ref.check(c["events"], real_time=False,
                                 max_configs=MAX_CONFIGS)["valid"]}
        else:
            v = {k: r["valid"] for k, r in ref.check_keys(
                c["events"], real_time=False,
                max_configs=MAX_CONFIGS).items()}
        out.append({"pool_index": i, "verdicts": v,
                    "valid": all(x is True for x in v.values())})
    return out


def control_run(cell: str, seed: int, sizes: dict | None = None) -> dict:
    """The comparison's counts with the control in the program's place,
    over the checks a run compares: the window's pool and the extra
    checks."""
    _, _, config, traffic = run.load_cell(cell)
    sizes = dict(sizes or {})
    for k in ("pool", "extra", "warmup"):
        traffic[k] = sizes.pop(k, traffic[k])
    t = {**config, **traffic["params"], **sizes}
    pool = run.window_pool(seed, t, traffic) + run.extra_pool(seed, t,
                                                              traffic)
    checks = control_checks(pool)
    got = run.compare(checks, pool)
    got["correct"] = all(got[k] <= v for k, v in run.LIMITS.items())
    return got


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    ok = True
    for seed in args.seed:
        got = control_run(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, **got}))
        ok = ok and not got["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
