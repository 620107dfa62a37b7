"""Launch B1-T from several threads at once, at plans of different shared
memory, in one or more trees of this repo on one CUDA card.

    python3 tools/torch_launch_race.py ROOT [ROOT ...] [--launches N]
                                       [--rounds R]

This is what the independent checker does when it checks keys in
parallel threads (``util.bounded_pmap``), each key at its own dims.
Each round runs the trees in the given order and then in reverse, every
run in a process of its own that imports that tree's
``jepsen_tpu_torch`` and builds its kernel from that tree's sources.  A
run makes four register histories (``synth.register_history``, seeds 0
to 3) at frontiers 16, 128, 512 and 2048, and starts two threads for
each, every thread launching its history's first slice ``N`` times
through ``level_kernel.level_loop(..., telemetry=True)``.  A launch
that raises counts as failed.  No carry is read between launches, as
between a search's slices; once every thread has joined, each thread's
last carry is held to the same slice launched alone.  Each run prints
one line;
the last line is one JSON object with every run.  Needs one card;
imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

#: frontier of each history's search, one shared-memory plan each
FRONTIERS = (16, 128, 512, 2048)
#: threads per history
THREADS_PER_PLAN = 2


def child(root: str, launches: int) -> int:
    import random
    import threading
    import time

    import torch

    sys.path.insert(0, root)
    from jepsen_tpu_torch.checker import encode as enc
    from jepsen_tpu_torch.checker import level_kernel as lk
    from jepsen_tpu_torch.history import encode_ops
    from jepsen_tpu_torch.models import cas_register
    from jepsen_tpu_torch.synth import register_history

    cuda = torch.device("cuda")
    model = cas_register()
    setups = []
    for seed, frontier in enumerate(FRONTIERS):
        h = register_history(random.Random(seed), n_ops=200, n_procs=12,
                             overlap=10, crash_p=0.06, max_crashes=6,
                             n_values=3)
        seq = encode_ops(h, model.f_codes)
        es = enc.encode_search(seq)
        dims = enc.choose_dims(es, model, device=cuda, frontier=frontier)
        esp = enc.pad_search(es, dims.n_det_pad, dims.n_crash_pad)
        args = enc.search_args(esp, es, device=cuda)
        carry = enc.carry_to_device(enc._init_carry(dims, model), cuda)
        setups.append((dims, args, carry))

    def launch(i):
        dims, args, carry = setups[i]
        return lk.level_loop(model, dims, *args, 10**8, 8, False, *carry,
                             telemetry=True)

    def host(out):
        return [int(v) for v in out[1:6]], out[0][:int(out[1])].cpu()

    alone = [host(launch(i)) for i in range(len(setups))]
    last = [None] * (THREADS_PER_PLAN * len(setups))
    done = [0] * len(last)
    failed = []
    lock = threading.Lock()

    def work(t):
        # no host read between launches, as a search's slices, and each
        # carry freed by the next, so the allocator reuses its blocks:
        # each thread's last carry is read once every thread has joined
        for _ in range(launches):
            try:
                last[t] = launch(t % len(setups))
                done[t] += 1
            except Exception as e:  # noqa: BLE001 — counted
                with lock:
                    failed.append(repr(e))

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(len(last))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrong = 0
    for t, out in enumerate(last):
        if out is not None:
            got, want = host(out), alone[t % len(setups)]
            wrong += got[0] != want[0] or not torch.equal(got[1], want[1])
    smem = [lk.launch_plan(d, cuda, telemetry=True)["smem_bytes"]
            for d, _, _ in setups]
    print(json.dumps({"root": root, "smem_bytes": smem, "ok": sum(done),
                      "wrong_last": wrong, "failed": len(failed),
                      "errors": sorted(set(failed)), "wall_s": wall}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--launches", type=int, default=300,
                    help="launches per thread (default 300)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        return child(a.roots[0], a.launches)
    runs = []
    order = a.roots + a.roots[::-1]
    for _ in range(a.rounds):
        for root in order:
            root = str(Path(root).resolve())
            p = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child",
                 root, "--launches", str(a.launches)], cwd=root,
                capture_output=True, text=True)
            if p.returncode != 0:
                print(p.stderr[-3000:], file=sys.stderr)
                return p.returncode
            run = json.loads(p.stdout.strip().splitlines()[-1])
            print(f"{root}: {run['ok']} launched, {run['failed']} failed, "
                  f"{run['wrong_last']} threads' last carry wrong, of "
                  f"{run['ok'] + run['failed']} launches in "
                  f"{run['wall_s']:.3f} s; plans' shared memory "
                  f"{run['smem_bytes']}; {run['errors'][:2]}", flush=True)
            runs.append(run)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
