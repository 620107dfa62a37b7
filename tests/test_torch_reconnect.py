"""The port's ``reconnect.py`` against the JAX package's: for the same
parameters and seeds, ``Backoff`` gives the same jittered schedules
(``delays``, the stateful ``step``/``exhausted``/``reset`` loop,
``clone``), the same ``run`` retries and sleeps, and ``Wrapper`` the same
reopen behaviour.  Exact equality: both draw from ``random.Random``."""

import random

import pytest

from jepsen_tpu import reconnect as jr
from jepsen_tpu_torch import reconnect as tr

PARAMS = [
    dict(base=0.05, cap=2.0, factor=2.0, max_attempts=8, jitter=0.5),
    dict(base=0.01, cap=0.05, factor=3.0, max_attempts=3, jitter=0.0),
    dict(base=0.2, cap=1.0, factor=1.5, max_attempts=12, jitter=0.9),
    dict(base=0.1, cap=0.1, factor=2.0, max_attempts=1, jitter=0.25),
]


def _pair(seed, **kw):
    return (jr.Backoff(rng=random.Random(seed), **kw),
            tr.Backoff(rng=random.Random(seed), **kw))


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_backoff_schedules_equal(kw, seed):
    j, t = _pair(seed, **kw)
    assert t.delays() == j.delays()
    assert t.budget_s() == j.budget_s()
    assert [t.raw_delay(i) for i in range(16)] \
        == [j.raw_delay(i) for i in range(16)]
    # the stateful health-loop schedule, through an exhaustion and a
    # reset, and a clone taken mid-schedule
    steps = []
    for b in (j, t):
        out = []
        for _ in range(kw["max_attempts"] + 2):
            out.append((b.step(), b.exhausted()))
        c = b.clone()
        b.reset()
        out.append((b.step(), b.exhausted(), c.step(), c.attempt))
        steps.append(out)
    assert steps[1] == steps[0]


@pytest.mark.parametrize("fail_first", [0, 2, 5, 20])
def test_backoff_run_equal(fail_first):
    out = []
    for mod in (jr, tr):
        b = mod.Backoff(base=0.05, cap=0.4, max_attempts=6, jitter=0.5,
                        rng=random.Random(fail_first))
        calls = {"n": 0}
        slept = []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fail_first:
                raise OSError(f"down {calls['n']}")
            return calls["n"]

        try:
            res = b.run(flaky, sleep=slept.append)
        except OSError as e:
            res = f"raised {e}"
        out.append((res, calls["n"], slept))
    assert out[1] == out[0]


def test_wrapper_reopen_equal():
    out = []
    for mod in (jr, tr):
        attempts = {"n": 0}
        closed = []

        def opener():
            attempts["n"] += 1
            if attempts["n"] in (1, 2, 5):
                raise OSError("refused")
            return f"conn{attempts['n']}"

        slept = []
        b = mod.Backoff(base=0.05, cap=1.0, max_attempts=5, jitter=0.0)
        b_run = b.run
        b.run = lambda fn, _r=b_run, _s=slept, **kw: _r(
            fn, **{**kw, "sleep": _s.append})
        w = mod.wrapper(open=opener, close=closed.append, backoff=b,
                        log_errors=False)
        seen = [w.conn()]

        def use(c):
            raise ValueError(f"broken {c}")

        with pytest.raises(ValueError):
            w.with_conn(use)
        seen.append(w.conn())
        w.close()
        seen.append(w.conn())
        out.append((seen, closed, slept, attempts["n"]))
    assert out[1] == out[0]


def test_exhaustion_counter_counts_in_the_port_registry():
    from jepsen_tpu_torch.obs import metrics

    c = metrics.REGISTRY.counter(
        "jtpu_backoff_exhausted_total",
        "Reconnect backoff schedules that ran out of budget")
    before = c.value()
    b = tr.Backoff(base=0.0, cap=0.0, max_attempts=2, jitter=0.0)

    def dead():
        raise OSError("down")

    with pytest.raises(OSError):
        b.run(dead, sleep=lambda s: None)
    assert c.value() == before + 1
