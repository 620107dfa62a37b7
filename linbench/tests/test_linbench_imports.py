"""What a run loads: no ``jax``, ``jaxlib``, ``flax`` or ``jepsen_tpu``,
top-level names compared whole (the port's own name begins with the JAX
package's); and the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

REHEARSAL = """
import json, sys
sys.path.insert(0, {here!r})
import run
run.DEVICE = "cpu"
args = run.parse_args(["--workload", "etcd-register.quorum",
                       "--seed", "3000000001", "--seconds", "0.01"])
r = run.run(args, {{"time_limit_s": 1, "pool": 1, "extra": 1,
                    "warmup": []}})
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": r["correct"], "tops": tops}}))
"""

YARDSTICK = """
import json, sys
sys.path.insert(0, {here!r})
import gen, roofline, stats, devtrace, control, faults, probes
from reference import check
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(src):
    out = subprocess.run([sys.executable, "-c", src.format(here=str(HERE))],
                         capture_output=True, text=True, timeout=600,
                         cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_rehearsal_loads_no_jax_and_not_the_jax_package():
    got = _run(REHEARSAL)
    assert got["correct"] is True
    assert "jepsen_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "jepsen_tpu"} & set(got["tops"])


def test_yardstick_loads_nothing_of_the_program():
    tops = set(_run(YARDSTICK))
    assert not {"jax", "jaxlib", "flax", "jepsen_tpu",
                "jepsen_tpu_torch", "torch"} & tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "jepsen_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", object())
    assert not [m for m in run.forbidden_modules()
                if m in ("jepsen_tpu_torch_x", "jaxfoo.bar")]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in run.forbidden_modules()
