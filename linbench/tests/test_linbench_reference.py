"""The plain reference on small hand-made histories."""

from reference import check as ref


def h(*evs):
    return list(evs)


def test_sequential_history_is_valid():
    assert ref.check(h((0, "invoke", "write", 1), (0, "ok", "write", 1),
                       (1, "invoke", "read", None), (1, "ok", "read", 1),
                       (0, "invoke", "cas", (1, 2)), (0, "ok", "cas", (1, 2)),
                       (1, "invoke", "read", None), (1, "ok", "read", 2)
                       ))["valid"] is True


def test_stale_read_is_invalid_but_sequentially_consistent():
    ev = h((0, "invoke", "write", 1), (0, "ok", "write", 1),
           (0, "invoke", "write", 2), (0, "ok", "write", 2),
           (1, "invoke", "read", None), (1, "ok", "read", 1))
    assert ref.check(ev)["valid"] is False
    assert ref.check(ev, real_time=False)["valid"] is True


def test_concurrent_write_may_come_first():
    ev = h((0, "invoke", "write", 1), (0, "ok", "write", 1),
           (0, "invoke", "write", 2), (1, "invoke", "read", None),
           (1, "ok", "read", 1), (0, "ok", "write", 2))
    assert ref.check(ev)["valid"] is True


def test_crashed_write_may_take_effect_late_or_never():
    late = h((0, "invoke", "write", 3), (0, "info", "write", 3),
             (1, "invoke", "write", 1), (1, "ok", "write", 1),
             (1, "invoke", "read", None), (1, "ok", "read", 3))
    assert ref.check(late)["valid"] is True
    never = h((0, "invoke", "write", 3), (0, "info", "write", 3),
              (1, "invoke", "read", None), (1, "ok", "read", None),
              (1, "invoke", "write", 1), (1, "ok", "write", 1),
              (1, "invoke", "read", None), (1, "ok", "read", 1))
    assert ref.check(never)["valid"] is True
    before = h((1, "invoke", "write", 1), (1, "ok", "write", 1),
               (1, "invoke", "read", None), (1, "ok", "read", 3),
               (0, "invoke", "write", 3), (0, "info", "write", 3))
    assert ref.check(before)["valid"] is False


def test_failed_ops_take_no_effect():
    ev = h((0, "invoke", "write", 1), (0, "ok", "write", 1),
           (1, "invoke", "cas", (1, 4)), (1, "fail", "cas", (1, 4)),
           (0, "invoke", "read", None), (0, "ok", "read", 4))
    assert ref.check(ev)["valid"] is False
    ev[3] = (1, "ok", "cas", (1, 4))
    assert ref.check(ev)["valid"] is True


def test_cas_needs_its_expected_value():
    ev = h((0, "invoke", "write", 1), (0, "ok", "write", 1),
           (1, "invoke", "cas", (2, 3)), (1, "ok", "cas", (2, 3)))
    assert ref.check(ev)["valid"] is False


def test_unset_register_and_nil_reads():
    assert ref.check(h((0, "invoke", "read", None),
                       (0, "ok", "read", 2)))["valid"] is False
    assert ref.check(h((0, "invoke", "write", 2), (0, "ok", "write", 2),
                       (0, "invoke", "read", None),
                       (0, "ok", "read", None)))["valid"] is True


def test_budget_reads_unknown():
    ev = []
    for p in range(6):
        ev.append((p, "invoke", "write", p))
    for p in range(6):
        ev.append((p, "ok", "write", p))
    ev += [(9, "invoke", "read", None), (9, "ok", "read", 7)]
    assert ref.check(ev, max_configs=5)["valid"] == "unknown"
    assert ref.check(ev)["valid"] is False


def test_keys_are_checked_apart():
    ev = [(0, "invoke", "write", 1, "a"), (0, "ok", "write", 1, "a"),
          ("nemesis", "info", "start", None),
          (1, "invoke", "read", None, "b"), (1, "ok", "read", 1, "b")]
    got = ref.check_keys(ev)
    assert got["a"]["valid"] is True and got["b"]["valid"] is False
