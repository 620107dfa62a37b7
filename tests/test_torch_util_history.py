"""The port's ``util``, ``codec``, the rest of ``history`` (``index``,
``processes``, ``is_info`` and the ``strict=`` pairing) and
``synth.mutate`` against the JAX package's: the same inputs, made from
a seed, through both packages, with results equal exactly."""

import random
import threading

import pytest

from jepsen_tpu import codec as jcodec
from jepsen_tpu import history as jh
from jepsen_tpu import synth as jsynth
from jepsen_tpu import util as ju
from jepsen_tpu.analyze.lint import HistoryLintError as JLintError
from jepsen_tpu_torch import codec as tcodec
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch import util as tu
from jepsen_tpu_torch.analyze.lint import HistoryLintError as TLintError


def _dicts(h):
    return [op.to_dict() for op in h]


def _pair(seed, n_ops=40, crash_p=0.2):
    """The same seeded register history in both packages."""
    kw = dict(n_ops=n_ops, n_procs=4, overlap=3, crash_p=crash_p,
              max_crashes=4, n_values=5, cas=True)
    hj = jsynth.register_history(random.Random(seed), **kw)
    ht = tsynth.register_history(random.Random(seed), **kw)
    assert _dicts(hj) == _dicts(ht)
    return hj, ht


def _timed(h, seed):
    """``h`` with increasing times and a nemesis start/stop pair."""
    rng = random.Random(seed)
    t, out = 0, []
    for i, op in enumerate(h):
        t += rng.randrange(1, 5_000_000)
        out.append(type(op)(**{**op.__dict__, "time": t}))
        if i in (5, 15):
            out.append(type(op)(process="nemesis", type="info",
                                f="start" if i == 5 else "stop",
                                value=None, time=t + 1))
    return out


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8])
def test_majority(n):
    assert tu.majority(n) == ju.majority(n)


@pytest.mark.parametrize("seed", range(4))
def test_integer_interval_set_str(seed):
    rng = random.Random(seed)
    xs = [rng.randrange(40) for _ in range(rng.randrange(25))]
    assert tu.integer_interval_set_str(xs) == \
        ju.integer_interval_set_str(xs)


@pytest.mark.parametrize("seqs", [[], [[1, 2, 3], [1, 2, 4], [1, 2]],
                                  [["a"], ["b"]], [[5, 6]]])
def test_longest_common_prefix(seqs):
    assert tu.longest_common_prefix(seqs) == ju.longest_common_prefix(seqs)


@pytest.mark.parametrize("seed", range(3))
def test_history_latencies_and_nemesis_intervals(seed):
    hj, ht = _pair(300 + seed)
    hj, ht = _timed(hj, seed), _timed(ht, seed)
    lj = [(a.to_dict(), b.to_dict(), d) for a, b, d in
          ju.history_latencies(hj)]
    lt = [(a.to_dict(), b.to_dict(), d) for a, b, d in
          tu.history_latencies(ht)]
    assert lt == lj and lt
    ij = [(a.to_dict(), b and b.to_dict()) for a, b in
          ju.nemesis_intervals(hj)]
    it = [(a.to_dict(), b and b.to_dict()) for a, b in
          tu.nemesis_intervals(ht)]
    assert it == ij and len(it) == 1


def test_maps_timeout_retry_fcatch():
    xs = list(range(9))
    assert tu.real_pmap(lambda x: x * x, xs) == ju.real_pmap(
        lambda x: x * x, xs)
    assert tu.bounded_pmap(lambda x: -x, xs, 3) == ju.bounded_pmap(
        lambda x: -x, xs, 3)
    assert tu.bounded_pmap(abs, []) == []
    with pytest.raises(ValueError):
        tu.real_pmap(lambda x: int("z"), [1])
    assert tu.timeout(5, lambda: 7) == 7
    assert tu.timeout(0.01, lambda: tu.sleep_seconds(0.5), "late") == "late"
    with pytest.raises(tu.Timeout):
        tu.timeout(0.01, lambda: tu.sleep_seconds(0.5))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("again")
        return len(calls)

    assert tu.retry(0, flaky) == 3

    def never():
        calls.append(1)
        raise OSError("never")

    calls.clear()
    with pytest.raises(OSError):
        tu.retry(0, never, retries=2)
    assert len(calls) == 3
    err = tu.fcatch(lambda: 1 / 0)()
    assert isinstance(err, ZeroDivisionError)


def test_relative_time_thread_name_barrier():
    with tu.relative_time():
        a = tu.relative_time_nanos()
        b = tu.relative_time_nanos()
    assert 0 <= a <= b < 10**9
    with tu.WithThreadName("jepsen worker 3"):
        assert threading.current_thread().name == "jepsen worker 3"
    assert threading.current_thread().name != "jepsen worker 3"
    bar = tu.AbortableBarrier(2)
    t = threading.Thread(target=bar.wait)
    t.start()
    bar.wait()
    t.join(5)
    assert not t.is_alive()
    ev = threading.Event()
    bar2 = tu.AbortableBarrier(2, ev)
    ev.set()
    with pytest.raises(tu.WorkerAbort):
        bar2.wait()
    random.seed(4)
    s1 = tu.random_nonempty_subset(range(6))
    random.seed(4)
    assert s1 == ju.random_nonempty_subset(range(6)) and s1


@pytest.mark.parametrize("value", [None, 0, -3, "x", [1, 2], {"b": 1, "a":
                                  [None, 2.5]}, True])
def test_codec_round_trip(value):
    assert tcodec.encode(value) == jcodec.encode(value)
    assert tcodec.decode(tcodec.encode(value)) == jcodec.decode(
        jcodec.encode(value))
    assert tcodec.decode(tcodec.encode(value).decode()) == \
        jcodec.decode(jcodec.encode(value))


@pytest.mark.parametrize("seed", range(4))
def test_index_processes_is_info(seed):
    hj, ht = _pair(400 + seed)
    assert _dicts(th.index(ht)) == _dicts(jh.index(hj))
    assert all(op.index is None for op in ht)  # not mutated
    assert th.processes(ht) == jh.processes(hj)
    assert [th.is_info(op) for op in ht] == [jh.is_info(op) for op in hj]


@pytest.mark.parametrize("seed", range(4))
def test_strict_pairing_on_well_formed(seed):
    hj, ht = _pair(500 + seed)
    assert th.pair_index(ht, strict=True) == jh.pair_index(hj, strict=True)
    assert _dicts(th.complete(ht, strict=True)) == \
        _dicts(jh.complete(hj, strict=True))


def _malformed(kind, mk):
    if kind == "double-invoke":
        return [mk.invoke_op(0, "write", 1), mk.invoke_op(0, "write", 2),
                mk.ok_op(0, "write", 2)]
    if kind == "orphan":
        return [mk.ok_op(1, "read", 3)]
    return [mk.invoke_op(0, "read", None),
            mk.Op(process=0, type="maybe", f="read", value=1)]


@pytest.mark.parametrize("kind", ["double-invoke", "orphan", "type"])
def test_strict_pairing_raises_like_the_reference(kind):
    hj, ht = _malformed(kind, jh), _malformed(kind, th)
    # permissive by default, like knossos
    assert th.pair_index(ht) == jh.pair_index(hj)
    assert _dicts(th.complete(ht)) == _dicts(jh.complete(hj))
    for fn in ("pair_index", "complete"):
        with pytest.raises(JLintError) as ej:
            getattr(jh, fn)(hj, strict=True)
        with pytest.raises(TLintError) as et:
            getattr(th, fn)(ht, strict=True)
        assert [d.to_dict() for d in et.value.diagnostics] == \
            [d.to_dict() for d in ej.value.diagnostics]
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("seed", range(12))
def test_mutate(seed):
    hj, ht = _pair(600 + seed, n_ops=24, crash_p=0.0)
    mj = jsynth.mutate(random.Random(seed), hj)
    mt = tsynth.mutate(random.Random(seed), ht)
    assert _dicts(mt) == _dicts(mj)
    assert _dicts(ht) == _dicts(hj)  # the input is not mutated
