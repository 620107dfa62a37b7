"""The port's generator DSL and the ``independent`` generators against
the JAX package's: every combinator, drawn on one thread round-robin
over its processes after ``random.seed(s)``, gives the JAX package's op
stream exactly.  The time combinators keep the reference tests' bounds
(``tests/test_generator.py``), the stream linter raises H001 and H002 as
the JAX package's does, and the key generators give every thread group
the same keys in the same order."""

import random
import threading
import time

import pytest
import torch

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu.analyze import lint as jlint
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch.analyze import lint as tlint

PACKAGES = {"jax": (jgen, jind), "torch": (tgen, tind)}
SEEDS = (0, 1, 7)
TEST = {"concurrency": 4, "nodes": ["n1", "n2", "n3"]}
WORKERS = [0, 1, 2, 3]
ALL = WORKERS + ["nemesis"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(v):
    """An op value with the package's ``[k v]`` tuple made comparable."""
    if hasattr(v, "key") and hasattr(v, "value") and not isinstance(v, dict):
        return ("kv", _plain(v.key), _plain(v.value))
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def pull_all(G, g, test, processes, threads, max_ops=2_000):
    """Round-robin the processes on this thread until each is exhausted;
    the (process, op) stream."""
    out = []
    active = list(processes)
    with G.with_threads(threads):
        while active and len(out) < max_ops:
            progressed = False
            for p in list(active):
                op = G.op_and_validate(g, test, p)
                if op is None:
                    active.remove(p)
                else:
                    out.append((p, _plain(op)))
                    progressed = True
            if not progressed:
                break
    return out


def _read(G):
    return {"type": "invoke", "f": "read", "value": None}


def _write(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def _fgen(G):
    return lambda k: G.limit(3, G.mix([_read(G), _write, G.cas]))


#: name -> (builder(G, I) -> generator, processes, threads, test)
CASES = {
    "lift-dict": (lambda G, I: G.limit(3, _read(G)), [0], WORKERS, TEST),
    "lift-fn2": (lambda G, I: G.limit(
        4, lambda test, process: {"type": "invoke", "f": "w",
                                  "value": process}), [0, 5], WORKERS, TEST),
    "lift-fn0": (lambda G, I: G.limit(
        3, lambda: {"type": "invoke", "f": "z",
                    "value": random.randrange(9)}), [0], WORKERS, TEST),
    "void": (lambda G, I: G.void, [0], WORKERS, TEST),
    "f_map": (lambda G, I: G.f_map(
        {"start": "kill"}, G.seq([{"type": "info", "f": "start"},
                                  {"type": "info", "f": "stop"}])),
        ["nemesis"], ALL, TEST),
    "f_map-fn": (lambda G, I: G.f_map(
        str.upper, G.limit(3, G.cas)), [0, 1], WORKERS, TEST),
    "delay": (lambda G, I: G.delay(0.0, G.limit(3, G.cas)), [0, 1],
              WORKERS, TEST),
    "stagger": (lambda G, I: G.stagger(0.0002, G.limit(6, G.cas)),
                [0, 1, 2], WORKERS, TEST),
    "delay_til": (lambda G, I: G.delay_til(0.0005, G.limit(3, G.cas)),
                  [0, 1], WORKERS, TEST),
    "delay_til-lazy": (lambda G, I: G.delay_til(
        0.0005, G.limit(3, G.cas), precache=False), [0], WORKERS, TEST),
    "sleep": (lambda G, I: G.concat(G.sleep(0.001), G.limit(2, _read(G))),
              [0], WORKERS, TEST),
    "once": (lambda G, I: G.once(G.cas), [0, 1, 2], WORKERS, TEST),
    "derefer": (lambda G, I: G.derefer(lambda: G.limit(2, G.cas)),
                [0, 1], WORKERS, TEST),
    "log": (lambda G, I: G.concat(G.log("phase"), G.limit(2, _read(G))),
            [0, 1], WORKERS, TEST),
    "log_every": (lambda G, I: G.concat(G.log_every("tick"),
                                        G.limit(2, G.cas)),
                  [0], WORKERS, TEST),
    "each": (lambda G, I: G.each(lambda: G.seq(
        [{"type": "invoke", "f": "x", "value": i} for i in range(3)])),
        [0, 1, 2], WORKERS, TEST),
    "seq": (lambda G, I: G.seq([_read(G), G.limit(2, G.cas), None,
                                G.once(_write)]), [0, 1], WORKERS, TEST),
    "start_stop": (lambda G, I: G.limit(5, G.start_stop(0, 0)),
                   ["nemesis"], ALL, TEST),
    "mix": (lambda G, I: G.limit(30, G.mix([_read(G), _write, G.cas])),
            [0, 1, 2, 3], WORKERS, TEST),
    "mix-empty": (lambda G, I: G.mix([]), [0], WORKERS, TEST),
    "cas": (lambda G, I: G.limit(40, G.cas), [0, 1], WORKERS, TEST),
    "queue": (lambda G, I: G.limit(30, G.queue()), [0, 1, 2], WORKERS,
              TEST),
    "drain_queue": (lambda G, I: G.drain_queue(G.limit(20, G.queue())),
                    [0, 1], WORKERS, TEST),
    "time_limit": (lambda G, I: G.time_limit(30, G.limit(5, G.cas)),
                   [0, 1], WORKERS, TEST),
    "filter": (lambda G, I: G.limit(12, G.filter(
        lambda op: op["f"] != "read", G.cas)), [0, 1], WORKERS, TEST),
    "on": (lambda G, I: G.on(lambda t: t in (0, 2),
                             G.limit(9, G.cas)), WORKERS, WORKERS, TEST),
    "reserve": (lambda G, I: G.reserve(
        2, G.limit(6, _write), 1, G.limit(4, G.cas),
        G.limit(5, _read(G))), WORKERS, WORKERS, TEST),
    "concat": (lambda G, I: G.concat(G.limit(2, _read(G)),
                                     G.limit(3, G.cas)),
               [0, 1], WORKERS, TEST),
    "nemesis": (lambda G, I: G.nemesis(
        G.limit(2, {"type": "info", "f": "start"}),
        G.limit(7, G.cas)), ALL, ALL, TEST),
    "nemesis-only": (lambda G, I: G.nemesis(G.limit(
        3, {"type": "info", "f": "stop"})), ALL, ALL, TEST),
    "clients": (lambda G, I: G.clients(G.limit(6, G.cas)), ALL, ALL,
                TEST),
    "await_fn": (lambda G, I: G.await_fn(lambda: None,
                                         G.limit(4, G.cas)),
                 [0, 1], WORKERS, TEST),
    "synchronize": (lambda G, I: G.synchronize(G.limit(3, G.cas)), [0],
                    [0], TEST),
    "phases": (lambda G, I: G.phases(G.limit(2, _read(G)),
                                     G.limit(3, G.cas)), [0], [0], TEST),
    "then": (lambda G, I: G.then(G.limit(2, _read(G)),
                                 G.limit(2, G.cas)), [0], [0], TEST),
    "barrier": (lambda G, I: G.barrier(G.limit(3, G.cas)), [0], [0], TEST),
    "singlethreaded": (lambda G, I: G.singlethreaded(G.limit(5, G.cas)),
                       [0, 1], WORKERS, TEST),
    "sequential_generator": (lambda G, I: I.sequential_generator(
        range(4), _fgen(G)), [0, 1, 2], WORKERS, TEST),
    "concurrent_generator": (lambda G, I: I.concurrent_generator(
        2, range(7), _fgen(G)), WORKERS, WORKERS, TEST),
    "concurrent_generator-clients": (lambda G, I: G.nemesis(
        G.limit(2, {"type": "info", "f": "start"}),
        I.concurrent_generator(2, range(5), _fgen(G))), ALL, ALL, TEST),
}


def _draw(pkg, name, seed):
    G, I = PACKAGES[pkg]
    build, processes, threads, test = CASES[name]
    random.seed(seed)
    g = build(G, I)
    return pull_all(G, g, dict(test), processes, threads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_combinator_stream_equals_reference(name, seed):
    want = _draw("jax", name, seed)
    got = _draw("torch", name, seed)
    assert got == want


@pytest.mark.parametrize("process", [0, 3, 4, 6, 11, "nemesis"])
def test_process_thread_and_node(process):
    assert (tgen.process_to_thread(TEST, process)
            == jgen.process_to_thread(TEST, process))
    assert (tgen.process_to_node(TEST, process)
            == jgen.process_to_node(TEST, process))


def test_sort_processes_and_thread_binding():
    ps = ["nemesis", 3, 1, "a", 2]
    assert tgen.sort_processes(ps) == jgen.sort_processes(ps)
    with pytest.raises(RuntimeError):
        tgen.current_threads()
    with pytest.raises(AssertionError):
        tgen.with_threads([2, 1])
    with tgen.with_threads([0, 1, "nemesis"]):
        assert tgen.current_threads() == [0, 1, "nemesis"]


def test_next_tick_nanos():
    for anchor, dt, now in ((0, 10, 3), (5, 7, 100), (9, 1, 9)):
        assert (tgen.next_tick_nanos(anchor, dt, now)
                == jgen.next_tick_nanos(anchor, dt, now))


# ---------------------------------------------------------------------------
# the time combinators, to the reference tests' bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_time_limit_bounds(pkg):
    G, _ = PACKAGES[pkg]
    g = G.time_limit(0.2, {"type": "invoke", "f": "read"})
    assert g.op(TEST, 0) is not None
    time.sleep(0.25)
    assert g.op(TEST, 0) is None


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_delay_and_sleep_take_their_time(pkg):
    G, _ = PACKAGES[pkg]
    t0 = time.monotonic()
    ops = pull_all(G, G.delay(0.02, G.limit(2, G.cas)), TEST, [0], WORKERS)
    assert len(ops) == 2 and time.monotonic() - t0 >= 0.04
    t0 = time.monotonic()
    assert pull_all(G, G.sleep(0.03), TEST, [0], WORKERS) == []
    assert time.monotonic() - t0 >= 0.03
    g = G.stagger(0.001, G.limit(2, {"type": "invoke", "f": "r"}))
    assert len(pull_all(G, g, TEST, [0], WORKERS)) == 2


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_delay_til_aligns_to_ticks(pkg):
    G, _ = PACKAGES[pkg]
    g = G.delay_til(0.01, G.limit(3, G.cas))
    for _ in range(3):
        called = time.monotonic_ns()
        assert g.op(TEST, 0) is not None
        tick = G.next_tick_nanos(g.anchor, g.dt, called)
        # never more than the 10 us slack before the next tick
        assert time.monotonic_ns() + 10_000 >= tick


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_phases_barrier_ordering(pkg):
    """All threads finish phase a before any emits phase b."""
    G, _ = PACKAGES[pkg]
    test = {"concurrency": 3, "nodes": ["n1"]}
    g = G.phases(G.limit(3, {"type": "invoke", "f": "a"}),
                 G.limit(3, {"type": "invoke", "f": "b"}))
    order, lock = [], threading.Lock()

    def worker(p):
        with G.with_threads([0, 1, 2]):
            while True:
                op = G.gen_op(g, test, p)
                if op is None:
                    return
                with lock:
                    order.append(op["f"])

    ts = [threading.Thread(target=worker, args=(p,)) for p in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert order == ["a"] * 3 + ["b"] * 3


# ---------------------------------------------------------------------------
# the stream linter and the op validation
# ---------------------------------------------------------------------------


def _lint_error(pkg, emitted, process=0):
    G, _ = PACKAGES[pkg]
    L = {"jax": jlint, "torch": tlint}[pkg]
    test = {"concurrency": 2, "__stream_lint__": G.StreamLinter()}
    g = G.seq(emitted)
    try:
        for _ in emitted:
            G.op_and_validate(g, test, process)
    except L.HistoryLintError as e:
        assert type(e).__module__ == L.__name__
        return [(d.code, d.severity, d.process, d.f) for d in e.diagnostics]
    return None


@pytest.mark.parametrize("emitted,code", [
    ([{"type": "invoke", "f": "read"}, {"type": "invoke", "f": "write"}],
     "H001"),
    ([{"type": "ok", "f": "read"}], "H002"),
    ([{"type": "invoke", "f": "cas"}, {"type": "ok", "f": "cas"},
      {"type": "fail", "f": "cas"}], "H002"),
])
def test_stream_linter_codes(emitted, code):
    want = _lint_error("jax", emitted)
    got = _lint_error("torch", emitted)
    assert got == want and got[0][0] == code


def test_stream_linter_lets_completed_and_nemesis_ops_pass():
    for pkg in PACKAGES:
        G, _ = PACKAGES[pkg]
        linter = G.StreamLinter()
        test = {"concurrency": 2, "__stream_lint__": linter}
        assert G.op_and_validate({"type": "invoke", "f": "r"}, test, 0)
        linter.on_complete(0)
        assert G.op_and_validate({"type": "invoke", "f": "r"}, test, 0)
        assert G.op_and_validate({"type": "info", "f": "start"}, test,
                                 "nemesis")


def test_invalid_op_raises():
    for G in (jgen, tgen):
        with pytest.raises(G.InvalidOp):
            G.op_and_validate(lambda t, p: 42, TEST, 0)


# ---------------------------------------------------------------------------
# the independent generators
# ---------------------------------------------------------------------------


def _keys_by_process(stream):
    out = {}
    for p, op in stream:
        keys = out.setdefault(p, [])
        k = op["value"][1]
        if not keys or keys[-1] != k:
            keys.append(k)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_key_generators_give_each_group_the_same_keys(seed):
    for name in ("sequential_generator", "concurrent_generator"):
        want = _keys_by_process(_draw("jax", name, seed))
        got = _keys_by_process(_draw("torch", name, seed))
        assert got == want and got
    by_group = _keys_by_process(_draw("torch", "concurrent_generator", seed))
    assert by_group[0] == by_group[1] and by_group[2] == by_group[3]
    assert not set(by_group[0]) & set(by_group[2])


def test_concurrent_generator_layout_asserts():
    for G, I in PACKAGES.values():
        g = I.concurrent_generator(3, [1], lambda k: {"type": "invoke"})
        with G.with_threads([0, 1, 2, 3]):
            with pytest.raises(AssertionError, match="multiple of 3"):
                g.op({"concurrency": 4}, 0)
        g = I.concurrent_generator(2, [1], lambda k: {"type": "invoke"})
        with G.with_threads([0, 1, "nemesis"]):
            g.op({"concurrency": 2}, 0)
            with pytest.raises(AssertionError):
                g.op({"concurrency": 2}, "nemesis")
