"""The grid form's dispatch and wrapper (``level_kernel.level_loop_batch``):
which instantiation a launch takes is fixed by the key count alone, in
the C source, with one kernel launch per call and no path that catches a
failed launch; a CPU call runs the plain version and counts no launch;
and the per-key range checks run only when the count tensors change.
The kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py) and the plain version to the JAX package's
vmapped kernel (tests/test_torch_batch.py)."""

import ast
import inspect
import random
import re
import textwrap
from pathlib import Path

import pytest
import torch

from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch import synth as ts
from jepsen_tpu_torch.checker import encode as tenc
from jepsen_tpu_torch.checker import level_kernel as lk
from jepsen_tpu_torch.checker import linearizable as tlin
from jepsen_tpu_torch.history import encode_ops

_SRC = (Path(lk.__file__).resolve().parents[1] / "csrc"
        / "level_loop.cu").read_text()


def _batch(n_keys, lanes, frontier):
    """(model, dims, stacked args, stacked carry) of ``n_keys`` seeded
    cas-register keys in ``lanes`` lanes at ``frontier``."""
    m = tm.cas_register()
    seqs = [encode_ops(ts.register_history(
        random.Random(f"grid-form-{k}"), n_ops=24, n_procs=4, overlap=3,
        crash_p=0.05, max_crashes=2, n_values=3), m.f_codes)
        for k in range(n_keys)]
    es = [tlin.encode_search(s) for s in seqs]
    dims = tlin.batch_dims(es, m, frontier=frontier)
    ps = [tenc.pad_search(e, dims.n_det_pad, dims.n_crash_pad) for e in es]
    args = tenc.stack_batch(ps, pad_to=lanes, device="cpu")
    carry = tlin.pad_batch_carry(
        tlin._init_batch_carry(n_keys, dims, m, "cpu"), lanes - n_keys,
        dims, m, "cpu")
    return m, dims, args, carry


def test_instantiation_is_fixed_by_the_key_count():
    """The C launch picks the keyed instantiation for B > 1 and the
    unkeyed one for B = 1, by telemetry, and launches one kernel: a
    block per key."""
    pick = re.search(r"auto kernel = (.*?);", _SRC, re.S).group(1)
    assert " ".join(pick.split()) == (
        "tele ? (B > 1 ? level_loop_kernel<SW, true, true> : "
        "level_loop_kernel<SW, false, true>) : "
        "(B > 1 ? level_loop_kernel<SW, true, false> : "
        "level_loop_kernel<SW, false, false>)")
    assert len(re.findall(r"<<<", _SRC)) == 1
    assert re.search(r"kernel<<<B, pl\.threads,", _SRC)


@pytest.mark.parametrize("fn", [lk._launch, lk.level_loop,
                                lk.level_loop_batch])
def test_no_launch_path_catches_a_failed_launch(fn):
    """A failed launch raises from ``_raise_on``: no path on the way to
    the kernel holds a try statement that could swallow it and go on."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert "_raise_on(lib, rc" in inspect.getsource(lk._launch)


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("n_keys,lanes,frontier",
                         [(1, 1, 16), (2, 4, 32), (5, 8, 64)])
def test_cpu_call_is_the_plain_version_and_counts_nothing(
        n_keys, lanes, frontier, telemetry):
    """On CPU tensors the wrapper returns its plain version's answer bit
    for bit and adds to no launch count, by form or by rung."""
    m, dims, args, carry = _batch(n_keys, lanes, frontier)
    counts = (lk.LAUNCHES, lk.BATCH_LAUNCHES, dict(lk.LAUNCHES_BY_FORM),
              dict(lk.GRID_LAUNCHES))
    call = (*args, 10**8, 8, True, *carry)
    got = lk.level_loop_batch(m, dims, *call, telemetry=telemetry)
    want = lk.level_loop_batch_reference(m, dims, *call,
                                         telemetry=telemetry)
    assert len(got) == len(want) == (7 if telemetry else 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (lk.LAUNCHES, lk.BATCH_LAUNCHES, dict(lk.LAUNCHES_BY_FORM),
            dict(lk.GRID_LAUNCHES)) == counts


@pytest.mark.parametrize("index,value", [(15, -1), (15, "pad + 1"),
                                         (16, -1), (16, "pad + 1")])
def test_range_checks_follow_the_count_tensors(index, value):
    """A batch whose ``n_det`` (15) or ``n_crash`` (16) leaves its range
    is refused every time it is passed, though the good tensors before
    it were cached; the good tensors pass again after it."""
    m, dims, args, carry = _batch(3, 4, 16)
    pad = dims.n_det_pad if index == 15 else dims.n_crash_pad
    call = (10**8, 4, True, *carry)
    lk.level_loop_batch(m, dims, *args, *call)
    bad = list(args)
    bad[index] = args[index].clone()
    bad[index][1] = pad + 1 if value == "pad + 1" else value
    for _ in range(2):
        with pytest.raises(ValueError, match="out of range"):
            lk.level_loop_batch(m, dims, *bad, *call)
    lk.level_loop_batch(m, dims, *args, *call)


def test_range_check_masks_run_only_for_new_tensors():
    """``_check_inert`` computes an extra check's mask only when the
    watched tensors are not the ones it last found good."""
    _, dims, args, _ = _batch(2, 4, 16)
    seen, calls = [], []

    def bad(t):
        calls.append(t)
        return t < 0

    lk._check_inert(args, seen, extra=((args[15], bad),))
    lk._check_inert(args, seen, extra=((args[15], bad),))
    assert len(calls) == 1
    fresh = args[15].clone()
    lk._check_inert(args, seen, extra=((fresh, bad),))
    assert len(calls) == 2 and calls[-1] is fresh
