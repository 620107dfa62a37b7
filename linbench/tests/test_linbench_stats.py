"""The rate and tail arithmetic: all work over all time, the tail over
all checks."""

import importlib.util
from pathlib import Path

import stats

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_percentile_is_nearest_rank_over_all():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 0.95) == 95
    assert stats.percentile([3.0], 0.95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 50], 0.95) == 50


def test_covered_takes_the_union_inside_the_window():
    assert stats.covered([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert stats.covered([(-1, 1), (9, 12)], 0, 10) == 2
    assert stats.covered([], 0, 10) == 0


def test_rate_counts_all_decided_work_over_the_whole_window():
    checks = [{"ops": 1000, "seconds": 0.5}, {"ops": 1000, "seconds": 2.0},
              {"ops": 1000, "seconds": 0.5}]
    ctx = {"checks": checks, "decided": checks[:2], "window_s": 3.0}
    # the undecided check's ops are not counted, its time is
    assert reader("ops_verified_per_s")(ctx) == 2000 / 3.0


def test_tail_is_over_every_check():
    checks = [{"seconds": s} for s in [0.1] * 19 + [5.0]]
    assert reader("verdict_p95_s.entry")({"checks": checks}) == 0.1
    checks.append({"seconds": 6.0})
    assert reader("verdict_p95_s.entry")({"checks": checks}) == 5.0
    assert reader("verdict_p95_s.entry")({"checks": checks}) == 5.0


def test_shares_read_nothing_where_nothing_ran():
    ctx = {"probes": [], "spans": [], "t_w0": 0.0, "window_s": 1.0,
           "device": None, "counters": {"bucket_padded": 0,
                                        "bucket_useful": 0}}
    for name in ("confirm_share", "prepass_share", "device_idle_share",
                 "bucket_padding_efficiency", "b1_roofline"):
        assert reader(name)(ctx) is None, name


def test_roofline_counts_a_floor_from_the_history():
    import roofline

    ev = [(0, "invoke", "write", 1), (1, "invoke", "read", None),
          (0, "ok", "write", 1), (1, "ok", "read", 1),
          (2, "invoke", "write", 2), (2, "info", "write", 2)]
    # two completed ops pending at once, one crashed op: 3 lanes
    assert roofline.work(ev, True) == (2 * 3 * 8, 4 * (5 * 3 + 2 * 3))
    assert roofline.work(ev, False)[0] == 0
    assert roofline.least_seconds(67e12, 0) == 1.0
