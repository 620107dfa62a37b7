"""Schedule-satisfaction checker — the chronos constraint checker.

Reference: chronos/src/jepsen/chronos/checker.clj.  A *job* promises a
repeating schedule: ``{name, start, interval, count, epsilon,
duration}``.  A *run* is an observed execution ``{name, start, end?}``.
The checker decides, per job, whether the set of completed runs can
satisfy every *target* — the i-th target is the interval

    [start + i*interval,  start + i*interval + epsilon + forgiveness]

for every target that must have begun before the final read
(job->targets, checker.clj:30-47).  Each target needs a DISTINCT
completed run whose start time falls inside it.

The reference solves this assignment with the loco CSP solver
(checker.clj:126-170, ``$distinct`` over index vars).  Here the same
problem is solved exactly in O(n log n): targets are intervals over run
start-times, all target windows for one job are pairwise disjoint
by construction (interval > duration + epsilon + forgiveness,
chronos.clj:199-205 — asserted by disjoint_solution), so a greedy sweep
matching each target to the earliest unused run inside it is optimal
(classic interval point-matching; by exchange argument a failed greedy
match implies no perfect matching exists).

Times are unix-epoch seconds (floats); the suite layer converts.
"""

from __future__ import annotations

from ..history import is_invoke, is_ok
from .core import Checker

#: allow chronos to miss deadlines by a few seconds (checker.clj:26-28)
EPSILON_FORGIVENESS = 5


def job_targets(read_time: float, job: dict) -> list[tuple[float, float]]:
    """[(start, stop)] for targets that must have begun by read_time
    (checker.clj:30-47): a run may begin up to epsilon late and takes
    duration to finish, so the cutoff is read_time - epsilon - duration."""
    finish = read_time - job["epsilon"] - job["duration"]
    out = []
    t = job["start"]
    for _ in range(job["count"]):
        if t >= finish:
            break
        out.append((t, t + job["epsilon"] + EPSILON_FORGIVENESS))
        t += job["interval"]
    return out


def split_complete(runs: list[dict]) -> tuple[list, list]:
    """(completed, incomplete), each sorted by start
    (checker.clj:59-76)."""
    complete = sorted((r for r in runs if r.get("end") is not None),
                      key=lambda r: r["start"])
    incomplete = sorted((r for r in runs if r.get("end") is None),
                        key=lambda r: r["start"])
    return complete, incomplete


def match_targets(targets: list[tuple[float, float]],
                  runs: list[dict]) -> dict:
    """Greedy earliest-run-per-target matching.  Returns
    {"solution": [(target, run|None)], "extra": [unused runs]}."""
    solution = []
    used = [False] * len(runs)
    j = 0
    for (t0, t1) in targets:
        # skip runs before the window; they can never satisfy a later
        # (disjoint, sorted) target either
        while j < len(runs) and runs[j]["start"] < t0:
            j += 1
        if j < len(runs) and t0 <= runs[j]["start"] <= t1:
            solution.append(((t0, t1), runs[j]))
            used[j] = True
            j += 1
        else:
            solution.append(((t0, t1), None))
    extra = [r for i, r in enumerate(runs) if not used[i]]
    return {"solution": solution, "extra": extra}


def job_solution(read_time: float, job: dict, runs: list[dict]) -> dict:
    """checker.clj:116-185's per-job verdict."""
    targets = job_targets(read_time, job)
    complete, incomplete = split_complete(runs or [])
    # targets must be pairwise disjoint for greedy optimality; the
    # generator guarantees interval > duration+epsilon+forgiveness
    for (a, b) in zip(targets, targets[1:]):
        assert a[1] < b[0], f"overlapping targets {a} {b}"
    m = match_targets(targets, complete)
    valid = all(run is not None for _, run in m["solution"])
    return {
        "valid": valid,
        "job": job,
        "solution": m["solution"],
        "extra": m["extra"],
        "complete": complete,
        "incomplete": incomplete,
    }


def solution(read_time: float, jobs: list[dict],
             runs: list[dict]) -> dict:
    """checker.clj:187-209: partition jobs/runs by name, solve each."""
    runs_by = {}
    for r in runs or []:
        runs_by.setdefault(r["name"], []).append(r)
    solns = {j["name"]: job_solution(read_time, j,
                                     runs_by.get(j["name"], []))
             for j in jobs}
    return {
        "valid": all(s["valid"] for s in solns.values()),
        "jobs": solns,
        "extra": [r for s in solns.values() for r in s["extra"]],
        "incomplete": [r for s in solns.values() for r in s["incomplete"]],
        "read_time": read_time,
    }


class ScheduleChecker(Checker):
    """checker.clj:293-316: read-time = last read invocation's wall
    time; runs = last ok read's value; jobs = ok add-job values.  Also
    renders chronos.png target/run bars when the test map allows."""

    def __init__(self, plot: bool = True):
        self.plot = plot

    def check(self, test, history, opts=None):
        jobs = [op.value for op in history
                if is_ok(op) and op.f == "add-job"]
        runs = None
        read_time = None
        t0 = test.get("start_wall_time", 0)
        for op in history:
            if is_invoke(op) and op.f == "read" and op.time is not None:
                read_time = t0 + op.time / 1e9
            if is_ok(op) and op.f == "read":
                runs = op.value
        if runs is None:
            return {"valid": "unknown", "error": "no read completed"}
        if read_time is None:
            read_time = max((r["start"] for r in runs), default=t0)
        out = solution(read_time, jobs, runs)
        if self.plot:
            self._plot(test, out, opts)
        return out

    def _plot(self, test, soln, opts=None):
        """chronos.png — green/red target windows + run bars
        (checker.clj:224-292); never affects the verdict."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            from .. import store

            t0 = test.get("start_wall_time", 0)
            fig, ax = plt.subplots(figsize=(10, 4))
            for j, (name, s) in enumerate(sorted(soln["jobs"].items(),
                                                 key=lambda kv: str(kv[0]))):
                for (tgt, run) in s["solution"]:
                    ax.axvspan(tgt[0] - t0, tgt[1] - t0,
                               ymin=(j + 0.1) / max(1, len(soln["jobs"])),
                               ymax=(j + 0.9) / max(1, len(soln["jobs"])),
                               color="#00AB01" if run else "#AB0001",
                               alpha=0.3)
                for r in s["complete"] + s["incomplete"]:
                    end = r.get("end") or (r["start"] + 1)
                    ax.plot([r["start"] - t0, end - t0], [j + 0.5] * 2,
                            color="#00AB01" if r.get("end") else "#AB0001",
                            lw=4, solid_capstyle="butt")
            ax.set_xlabel("time (s)")
            ax.set_ylabel("job")
            p = store.path_mkdirs(test,
                                  *(opts or {}).get("subdirectory", []),
                                  "chronos.png")
            fig.savefig(p)
            plt.close(fig)
        except Exception:
            pass


def schedule_checker(plot: bool = True) -> Checker:
    return ScheduleChecker(plot)
