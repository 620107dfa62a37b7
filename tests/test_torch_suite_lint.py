"""The port's suite and service lint (``jepsen_tpu_torch.analyze.suites``)
against the JAX package's (``jepsen_tpu.analyze.suites``).

Every case of ``tests/test_suite_lint.py`` and the T-code
fixtures of ``tests/test_devlint.py`` run through both packages on the
same fixture source or fixture package, and the two must agree on every
finding: code, severity, message and ``index``.  The N-codes are
restated for the port (its knobs are test-map keys, not environment
variables), so their fixtures hold each restated code to its reference
counterpart under the same breach, by code and severity.  Then the gates
over the port's own tree, and ``python -m
jepsen_tpu_torch.analyze.lint_suites`` beside ``tools/lint_suites.py``.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from jepsen_tpu.analyze import suites as jlint
from jepsen_tpu_torch.analyze import lint_suites as tcmd
from jepsen_tpu_torch.analyze import suites as tlint

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jepsen_tpu_torch"


def _dicts(diags):
    return [d.to_dict() for d in diags]


def _flat(by_file):
    return [(f, d.to_dict()) for f, ds in sorted(by_file.items())
            for d in ds]


def _errors(by_file):
    return [str(d) for ds in by_file.values() for d in ds
            if d.severity == "error"]


# ---------------------------------------------------------------------------
# S- and B-codes on fixture sources (tests/test_suite_lint.py :83-335)
# ---------------------------------------------------------------------------

_S002 = (
    "class AClient(Client):\n"
    "    def invoke(self, test, op):\n"
    "        try:\n"
    "            return replace(op, type='ok')\n"
    "        except Exception:\n"
    "            return replace(op, type='ok')\n")
_S005 = (
    "class FooNemesis(nemesis_mod.Nemesis):\n"
    "    def invoke(self, test, op):\n"
    "        return replace(op, type='ok')\n")
_B002 = (
    "class Shim:\n"
    "    def fetch(self, op):\n"
    "        try:\n"
    "            return do(op)\n"
    "        except Exception:\n"
    "            return replace(op, type='fail')\n")
_B002_CLIENT = (
    "class FooClient(Client):\n"
    "    def invoke(self, test, op):\n"
    "        try:\n"
    "            return replace(op, type='ok')\n"
    "        except Exception:\n"
    "            return replace(op, type='fail')\n")

#: case -> (lint function, fixture source, the codes it must find)
SOURCE_CASES = {
    "s001-none-and-fall-off": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        if op.f == 'read':\n"
        "            return None\n"), {"S001"}),
    "s001-op-unchanged": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        return op\n"), {"S001"}),
    "s001-op-reassigned": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        op = replace(op, type='ok')\n"
        "        return op\n"), set()),
    "s001-clean-shapes": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        try:\n"
        "            if op.f == 'read':\n"
        "                return replace(op, type='ok', value=1)\n"
        "            raise ValueError(op.f)\n"
        "        except OSError as e:\n"
        "            return replace(op, type='info', error=str(e))\n"),
        set()),
    "s002-broad-except-to-ok": ("lint_source", _S002, {"S002"}),
    "s003-unconditional-fail": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        try:\n"
        "            return replace(op, type='ok')\n"
        "        except Exception as e:\n"
        "            return replace(op, type='fail', error=str(e))\n"),
        {"S003"}),
    "s003-guarded-fail": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        try:\n"
        "            return replace(op, type='ok')\n"
        "        except Exception as e:\n"
        "            if 'conflict' in str(e):\n"
        "                return replace(op, type='fail')\n"
        "            raise\n"), set()),
    "s003-conditional-fail": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        try:\n"
        "            return replace(op, type='ok')\n"
        "        except Exception as e:\n"
        "            return replace(op, type='fail' if op.f == 'read'"
        " else 'info', error=str(e))\n"), set()),
    "s004-db-pairing": ("lint_source", (
        "class FooDB(db_mod.DB):\n"
        "    def setup(self, test, node):\n"
        "        pass\n"), {"S004"}),
    "s005-nemesis-ok": ("lint_source", _S005, {"S005"}),
    "s005-nemesis-info": ("lint_source", _S005.replace("'ok'", "'info'"),
                          set()),
    "suite-lint-suppression": ("lint_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        try:\n"
        "            return replace(op, type='ok')\n"
        "        except Exception as e:\n"
        "            return replace(op, type='fail')  # suite-lint: ok\n"),
        set()),
    "does-not-parse": ("lint_source", "class A(:\n", {"S001"}),
    "b001-missing-member": ("lint_live_source", (
        "class BrokenBackend(LiveBackend):\n"
        "    name = 'broken'\n"
        "    def workload(self, opts):\n"
        "        return {}\n"), {"B001"}),
    "b001-abstract-intermediate": ("lint_live_source", (
        "class ConsensusBackend(LiveBackend):\n"
        "    def health_check(self, test, node):\n"
        "        pass\n"
        "class FamBackend(ConsensusBackend):\n"
        "    name = 'fam'\n"
        "    def server_argv(self, test, node):\n"
        "        return []\n"
        "    def workload(self, opts):\n"
        "        return {}\n"), set()),
    "b001-annotated-and-async": ("lint_live_source", (
        "class FamBackend(LiveBackend):\n"
        "    name: str = 'fam'\n"
        "    def server_argv(self, test, node):\n"
        "        return []\n"
        "    async def workload(self, opts):\n"
        "        return {}\n"), set()),
    "b001-bare-annotation": ("lint_live_source", (
        "class ShyBackend(LiveBackend):\n"
        "    name: str\n"
        "    def server_argv(self, test, node):\n"
        "        return []\n"
        "    def workload(self, opts):\n"
        "        return {}\n"), {"B001"}),
    "b001-unnamed": ("lint_live_source", (
        "class ShyBackend(LiveBackend):\n"
        "    def server_argv(self, test, node):\n"
        "        return []\n"
        "    def workload(self, opts):\n"
        "        return {}\n"), {"B001"}),
    "b002-swallow-to-fail": ("lint_live_source", _B002, {"B002"}),
    "b002-guarded": ("lint_live_source", _B002.replace(
        "            return replace(op, type='fail')\n",
        "            if op.f == 'read':\n"
        "                return replace(op, type='fail')\n"
        "            raise\n"), set()),
    "b002-client-invoke-is-s003s": ("lint_live_source", _B002_CLIENT,
                                    set()),
    "s003-client-invoke": ("lint_source", _B002_CLIENT, {"S003"}),
    "b003-rename-without-fsync": ("lint_live_source", (
        "import os\n"
        "def save(path, data):\n"
        "    tmp = path + '.tmp'\n"
        "    with open(tmp, 'w') as f:\n"
        "        f.write(data)\n"
        "    os.replace(tmp, path)\n"), {"B003"}),
    "b003-fsync-first": ("lint_live_source", (
        "import os\n"
        "def save(path, data):\n"
        "    tmp = path + '.tmp'\n"
        "    with open(tmp, 'w') as f:\n"
        "        f.write(data)\n"
        "        f.flush()\n"
        "        os.fsync(f.fileno())\n"
        "    os.replace(tmp, path)\n"), set()),
    "b003-read-only": ("lint_live_source", (
        "import os\n"
        "def rotate(path):\n"
        "    with open(path, 'r') as f:\n"
        "        f.read()\n"
        "    os.rename(path, path + '.old')\n"), set()),
    # R-codes (tests/test_suite_lint.py :708-810)
    "r001-backoff-run": ("lint_retry_source", (
        "class AClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        self.backoff.run(lambda: self.conn.put(op.value))\n"
        "        return replace(op, type='ok')\n"), {"R001"}),
    "r001-backoff-run-with-info": ("lint_retry_source", (
        "class AClient(Client):\n"
        "    def invoke2(self, test, op):\n"
        "        try:\n"
        "            self.backoff.run(lambda: self.conn.put(op.value))\n"
        "            return replace(op, type='ok')\n"
        "        except Exception:\n"
        "            return replace(op, type='info')\n"), set()),
    "r001-with-conn-write": ("lint_retry_source", (
        "def invoke(self, test, op):\n"
        "    self.wrapper.with_conn(lambda c: c.write(op.value))\n"
        "    return replace(op, type='ok')\n"), {"R001"}),
    "r001-with-conn-read": ("lint_retry_source", (
        "def invoke(self, test, op):\n"
        "    self.wrapper.with_conn(lambda c: c.read(op.value))\n"
        "    return replace(op, type='ok')\n"), set()),
    "r001-r002-attempt-loop": ("lint_retry_source", (
        "def do(conn, op):\n"
        "    for attempt in range(3):\n"
        "        try:\n"
        "            conn.enqueue(op)\n"
        "            return 'ok'\n"
        "        except Exception:\n"
        "            continue\n"), {"R001", "R002"}),
    "r002-scan-is-not-retry": ("lint_retry_source", (
        "def sweep(files):\n"
        "    for f in files:\n"
        "        try:\n"
        "            load(f)\n"
        "        except Exception:\n"
        "            continue\n"), set()),
    "r002-kept-last-error": ("lint_retry_source", (
        "def do(conn, op):\n"
        "    last = None\n"
        "    for attempt in range(3):\n"
        "        try:\n"
        "            return conn.read(op)\n"
        "        except Exception as e:\n"
        "            last = e\n"
        "    return replace(op, type='fail', error=str(last))\n"), set()),
    "r002-reraise-after-loop": ("lint_retry_source", (
        "def do(conn, op):\n"
        "    for attempt in range(3):\n"
        "        try:\n"
        "            return conn.read(op)\n"
        "        except Exception:\n"
        "            continue\n"
        "    raise RuntimeError('budget')\n"), set()),
    "r-probe-loop": ("lint_retry_source", (
        "def wait(self):\n"
        "    while not self.bo.exhausted():\n"
        "        try:\n"
        "            self.health_check()\n"
        "            return\n"
        "        except Exception:\n"
        "            sleep(self.bo.step())\n"
        "    raise RuntimeError('dead')\n"), set()),
    "retrylint-suppression": ("lint_retry_source", (
        "def do(conn, op):\n"
        "    for attempt in range(3):\n"
        "        try:\n"
        "            conn.enqueue(op)  # server dedups; retrylint: ok\n"
        "            return 'ok'\n"
        "        except Exception:\n"
        "            continue\n"
        "    raise RuntimeError('budget')\n"), set()),
}


@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_source_lint_equals_reference(case):
    fn, src, want = SOURCE_CASES[case]
    got = getattr(tlint, fn)(src, "fix.py")
    assert _dicts(got) == _dicts(getattr(jlint, fn)(src, "fix.py"))
    assert {d.code for d in got} == want


def test_codes_equal_reference_but_the_restated_n_codes():
    assert set(tlint.SUITE_CODES) == set(jlint.SUITE_CODES)
    for code, desc in jlint.SUITE_CODES.items():
        if not code.startswith("N"):
            assert tlint.SUITE_CODES[code] == desc, code


# ---------------------------------------------------------------------------
# T-codes on fixture files (tests/test_devlint.py :347-470)
# ---------------------------------------------------------------------------

THREAD_CASES = {
    "t001-unlocked-rmw": ("""\
        import threading

        COUNT = 0

        def worker():
            global COUNT
            COUNT += 1

        def start():
            threading.Thread(target=worker).start()
    """, {"T001"}),
    "t001-locked": ("""\
        import threading

        COUNT = 0
        LOCK = threading.Lock()

        def worker():
            global COUNT
            with LOCK:
                COUNT += 1

        def start():
            threading.Thread(target=worker).start()
    """, set()),
    "t001-suppressed": ("""\
        import threading

        COUNT = 0

        def worker():
            global COUNT
            COUNT += 1  # threadlint: ok — fixture

        def start():
            threading.Thread(target=worker).start()
    """, set()),
    "t001-suppressed-above-def": ("""\
        import threading

        COUNT = 0

        # threadlint: ok — single-owner: only the worker writes COUNT
        def worker():
            global COUNT
            COUNT += 1

        def start():
            threading.Thread(target=worker).start()
    """, set()),
    "t001-check-then-act": ("""\
        import threading

        class Box:
            def worker(self):
                if self.slot is None:
                    self.slot = 1

            def start(self):
                threading.Thread(target=self.worker).start()
    """, {"T001"}),
    "t002-bare-acquire": ("""\
        import threading

        LOCK = threading.Lock()

        def worker():
            LOCK.acquire()
            step()
            LOCK.release()

        def start():
            threading.Thread(target=worker).start()
    """, {"T002"}),
    "t002-acquire-finally": ("""\
        import threading

        LOCK = threading.Lock()

        def worker():
            LOCK.acquire()
            try:
                step()
            finally:
                LOCK.release()

        def start():
            threading.Thread(target=worker).start()
    """, set()),
    "t003-flock-write": ("""\
        import threading

        def worker(fh):
            with _locked():
                fh.write("entry")

        def start():
            threading.Thread(target=worker).start()
    """, {"T003"}),
    "t003-flock-write-fsync": ("""\
        import os
        import threading

        def worker(fh):
            with _locked():
                fh.write("entry")
                os.fsync(fh.fileno())

        def start():
            threading.Thread(target=worker).start()
    """, set()),
    "t004-span-without-run": ("""\
        import threading

        def worker():
            with obs.span("prep", keys=3):
                step()

        def start():
            threading.Thread(target=worker).start()
    """, {"T004"}),
    "t004-span-with-run": ("""\
        import threading

        def worker(run_pin):
            with obs.span("prep", run=run_pin, keys=3):
                step()

        def start():
            threading.Thread(target=worker).start()
    """, set()),
    "caller-holds-lock": ("""\
        import threading

        class Svc:
            def _apply(self):
                self.n += 1

            def handle_line(self):
                with self._lock:
                    self._apply()

            def start(self):
                threading.Thread(target=self.handle_line).start()
    """, set()),
}


@pytest.mark.parametrize("case", sorted(THREAD_CASES))
def test_thread_lint_equals_reference(case, tmp_path):
    src, want = THREAD_CASES[case]
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(src))
    got = tlint.lint_thread_tier([p])
    assert _flat(got) == _flat(jlint.lint_thread_tier([p]))
    assert {d.code for ds in got.values() for d in ds} == want


# ---------------------------------------------------------------------------
# O-codes on fixture packages (tests/test_suite_lint.py :623-670)
# ---------------------------------------------------------------------------


def _metrics_pkg(tmp_path, *names):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text("from x import REGISTRY\n" + "".join(
        f"M{i} = REGISTRY.counter('{n}', 'h')\n"
        for i, n in enumerate(names)))
    return pkg


METRIC_CASES = {
    "o001-unregistered": (("jtpu_real_total",),
                          "PANEL = ['jtpu_real_total', "
                          "'jtpu_ghost_total']\n", {"O001"}),
    "o001-histogram-suffix": (("jtpu_lat_seconds",),
                              "Q = 'jtpu_lat_seconds_bucket'\n", set()),
    "o002-orphans": (("jtpu_used_total", "jtpu_orphan_a_total",
                      "jtpu_orphan_b_total"),
                     "P = 'jtpu_used_total'\n", {"O002"}),
    "metriclint-suppression": (("jtpu_real_total",),
                               "P = 'jtpu_real_total'\n"
                               "G = 'jtpu_ghost_total'  # metriclint: ok\n",
                               set()),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_lint_equals_reference(case, tmp_path):
    names, web_src, want = METRIC_CASES[case]
    pkg = _metrics_pkg(tmp_path, *names)
    web = tmp_path / "web.py"
    web.write_text(web_src)
    got = tlint.lint_metrics(pkg, consumers=[web])
    assert _flat(got) == _flat(jlint.lint_metrics(pkg, consumers=[web]))
    assert {d.code for ds in got.values() for d in ds} == want
    assert tlint.registered_metrics(pkg) == jlint.registered_metrics(pkg)


# ---------------------------------------------------------------------------
# N-codes, restated: each against its reference counterpart under the
# same breach (tests/test_suite_lint.py :531-616)
# ---------------------------------------------------------------------------


def _pkg(tmp_path, name, src):
    pkg = tmp_path / name
    pkg.mkdir()
    (pkg / "mod.py").write_text(src)
    return pkg


def _codes(by_file):
    return sorted((d.code, d.severity) for ds in by_file.values()
                  for d in ds)


#: case -> (port fixture and its texts, reference fixture and its texts,
#: what the port must find); the reference finds the same unless
#: ``ref_want`` says otherwise
KNOB_CASES = {
    # a switch no CLI flag writes: the port's idiom is a TEST_MAP_KEYS
    # tuple, the reference's a zero-arg *_enabled() reader
    "n001-toggle-without-flag": (
        ("class C:\n    TEST_MAP_KEYS = ('foo',)\n", "", "`foo`"),
        ("import os\ndef foo_enabled():\n"
         "    return os.environ.get('JEPSEN_TPU_FOO', '') != '0'\n",
         "", "JEPSEN_TPU_FOO"),
        [("N001", "error")], None),
    "n001-flag-clears-it": (
        ("class C:\n    TEST_MAP_KEYS = ('foo',)\n", "KEYS = ['foo']\n",
         "`foo`"),
        ("import os\ndef foo_enabled():\n"
         "    return os.environ.get('JEPSEN_TPU_FOO', '') != '0'\n",
         "JEPSEN_TPU_FOO", "JEPSEN_TPU_FOO"),
        [], None),
    # a knob that carries a value is not a switch: no flag required
    "n001-needs-a-switch": (
        ("def route(test):\n    return test.get('device')\n", "",
         "`device`"),
        ("import os\ndef depth():\n"
         "    return int(os.environ.get('JEPSEN_TPU_DEPTH', '4'))\n",
         "", "JEPSEN_TPU_DEPTH"),
        [], None),
    # an import-time read of a CLI-claimed knob; the port reads no
    # environment at all, so its N002 is every read
    "n002-import-time-read": (
        ("import os\nMODE = os.environ.get('JEPSEN_TPU_BAR', 'auto')\n",
         "JEPSEN_TPU_BAR", ""),
        ("import os\nMODE = os.environ.get('JEPSEN_TPU_BAR', 'auto')\n",
         "JEPSEN_TPU_BAR", "JEPSEN_TPU_BAR"),
        [("N002", "error")], None),
    "n002-any-environment-read": (
        ("import os\nfrom os import getenv\n"
         "def f():\n    return os.getenv('HOME'), getenv('X')\n", "", ""),
        ("import os\nMODE = os.environ.get('JEPSEN_TPU_BAR', 'auto')\n",
         "", "JEPSEN_TPU_BAR"),
        [("N002", "error"), ("N002", "error")], []),
    "n003-undocumented": (
        ("def f(test):\n    return test['stream_cache']\n", "", ""),
        ("import os\ndef f():\n    a = os.environ['JEPSEN_TPU_MYSTERY']\n"
         "    b = os.environ.get('JEPSEN_TPU_PROC_ID')\n    return a, b\n",
         "", ""),
        [("N003", "warning")], None),
    "n003-membership-is-a-read": (
        ("def f(opts):\n    return 'stream_cache' in opts\n", "", ""),
        ("import os\ndef f():\n"
         "    return 'JEPSEN_TPU_GHOST' in os.environ\n", "", ""),
        [("N003", "warning")], None),
    "knoblint-suppression": (
        ("class C:\n    TEST_MAP_KEYS = ('foo',)  # knoblint: ok\n", "",
         ""),
        ("import os\ndef foo_enabled():\n"
         "    return os.environ.get('JEPSEN_TPU_FOO') == '1'"
         "  # knoblint: ok\n", "", ""),
        [], None),
}


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_restated_knob_codes_against_reference(case, tmp_path):
    (tsrc, tcli, tdocs), (jsrc, jcli, jdocs), want, ref_want = \
        KNOB_CASES[case]
    got = tlint.lint_knobs(_pkg(tmp_path, "t", tsrc), cli_text=tcli,
                           docs_text=tdocs)
    ref = jlint.lint_knobs(_pkg(tmp_path, "j", jsrc), cli_text=jcli,
                           docs_text=jdocs)
    assert _codes(got) == want
    assert _codes(ref) == (want if ref_want is None else ref_want)


def test_n003_names_the_key_once(tmp_path):
    pkg = _pkg(tmp_path, "t", "def f(test):\n    a = test['stream_cache']\n"
               "    return a, test.get('stream_cache')\n")
    out = [d for ds in tlint.lint_knobs(pkg, cli_text="", docs_text="")
           .values() for d in ds]
    assert len(out) == 1 and "'stream_cache'" in out[0].message
    assert out[0].index == 2


# ---------------------------------------------------------------------------
# the gates over the port's own tree
# ---------------------------------------------------------------------------


def test_port_suites_and_live_have_no_protocol_errors():
    findings = tlint.lint_paths()
    assert _errors(findings) == []
    # the reference's lint finds the same over the same files
    dirs = [PKG / "suites", PKG / "live"]
    assert _flat(tlint.lint_paths(dirs)) == _flat(jlint.lint_paths(dirs))


def test_port_thread_tier_is_clean_under_both_lints():
    files = tlint.thread_tier_files()
    assert _errors(tlint.lint_thread_tier()) == []
    assert _errors(jlint.lint_thread_tier(files)) == []


def test_port_metrics_contract_holds():
    consumers = [REPO / c for c in tlint.METRIC_CONSUMERS]
    assert _errors(tlint.lint_metrics()) == []
    assert _errors(jlint.lint_metrics(PKG, consumers=consumers)) == []
    reg = tlint.registered_metrics()
    for name in ("jtpu_mc_states_total", "jtpu_mc_schedules_total",
                 "jtpu_mc_violations_total", "jtpu_mc_prune_ratio"):
        assert name in reg, name


def test_every_default_sweep_visits_port_files(monkeypatch):
    """No default path resolves outside ``jepsen_tpu_torch/`` or to
    nothing, so no gate above passes vacuously."""
    seen = []
    orig = tlint.lint_file
    monkeypatch.setattr(tlint, "lint_file",
                        lambda p: seen.append(Path(p)) or orig(p))
    tlint.lint_paths()
    assert {p.parent for p in seen} == {PKG / "suites", PKG / "live"}
    assert PKG / "suites" / "etcdemo.py" in seen
    files = tlint.thread_tier_files()
    for rel in tlint.THREAD_TIER:
        assert any(f == PKG / rel or PKG / rel in f.parents
                   for f in files), rel
    for c in tlint.METRIC_CONSUMERS:
        assert (REPO / c).is_file(), c
    assert tlint.METRIC_CONSUMERS[0] == "jepsen_tpu_torch/web.py"
    assert PKG / "stream" / "checker.py" in tlint._package_py_files(PKG)
    docs = tlint._readme_port_section(REPO / "README.md")
    for key in ("lint", "explain", "audit", "shrink", "hb", "dpor",
                "telemetry", "lin_decompose", "lin_algorithm", "stream",
                "stream_cache", "device"):
        assert f"`{key}`" in docs, key


def test_the_repaired_sites_carry_the_reference_arguments():
    """The eight ``threadlint: ok`` arguments the reference carries at
    the port's tier sites, each back in the port."""
    for rel, n in (("stream/checker.py", 7), ("decompose/cache.py", 1)):
        port = (PKG / rel).read_text().count("threadlint: ok")
        ref = (REPO / "jepsen_tpu" / rel).read_text().count(
            "threadlint: ok")
        assert port == ref == n, rel


# ---------------------------------------------------------------------------
# the defects the lint found in chronos and robustirc stay repaired, in
# the port's copies (tests/test_suite_lint.py :343-449)
# ---------------------------------------------------------------------------


def test_chronos_crashed_addjob_is_indeterminate(monkeypatch):
    """A crashed add-job POST may have been applied: it completes
    ``info``; a crashed read (effect-free) stays ``fail``."""
    import urllib.error

    from jepsen_tpu_torch.history import Op
    from jepsen_tpu_torch.suites import chronos

    def boom(*a, **kw):
        raise urllib.error.URLError("connection refused")

    monkeypatch.setattr(chronos.urllib.request, "urlopen", boom)
    client = chronos.ChronosClient(node="n1")
    job = {"name": "j1", "start": 10.0, "count": 5, "interval": 60,
           "epsilon": 15, "duration": 5}
    out = client.invoke({}, Op(process=0, type="invoke", f="add-job",
                               value=job))
    assert out.type == "info"

    def read_boom(_test):
        raise OSError("ssh down")

    monkeypatch.setattr(chronos, "read_runs", read_boom)
    out = client.invoke({}, Op(process=0, type="invoke", f="read",
                               value=None))
    assert out.type == "fail"


def test_robustirc_close_deletes_server_session():
    """close() quits the client's server-side session (the worker reopens
    clients after every crash) and survives a dead server."""
    from jepsen_tpu_torch.suites import robustirc

    calls = []

    class FakeSession:
        def quit(self, message="x"):
            calls.append("quit")

    c = robustirc.SetClient("n1")
    c.session = FakeSession()
    c.close({})
    assert calls == ["quit"]
    assert c.session is None

    class DeadSession:
        def quit(self, message="x"):
            raise OSError("server gone")

    c2 = robustirc.SetClient("n1")
    c2.session = DeadSession()
    c2.close({})  # must not raise
    assert c2.session is None


def test_robustirc_session_quit_issues_delete(monkeypatch):
    from jepsen_tpu_torch.suites import robustirc

    reqs = []

    class R:
        def __init__(self):
            self.fp = None

        def read(self):
            return b"{}"

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def close(self):
            pass

    def fake_urlopen(req, timeout=None, context=None):
        reqs.append((req.get_method(), req.full_url))
        return R()

    monkeypatch.setattr(robustirc.urllib.request, "urlopen",
                        fake_urlopen)
    monkeypatch.setattr(
        robustirc.IRCSession, "__init__",
        lambda self, node, timeout=10.0: (
            setattr(self, "node", str(node)),
            setattr(self, "timeout", timeout),
            setattr(self, "ctx", None),
            setattr(self, "session_id", "sess42"),
            setattr(self, "session_auth", "auth"),
        ) and None)
    s = robustirc.IRCSession("n1")
    s.quit()
    assert reqs and reqs[-1][0] == "DELETE"
    assert "/robustirc/v1/sess42" in reqs[-1][1]


@pytest.mark.parametrize("fname", ["chronos.py", "robustirc.py"])
def test_fixed_suites_stay_clean(fname):
    """The port's copy lints with no error, and every finding is the one
    the JAX package's lint gives on its own file."""
    port = tlint.lint_paths([PKG / "suites" / fname])
    ref = jlint.lint_paths([REPO / "jepsen_tpu" / "suites" / fname])
    assert _errors(port) == []
    assert [d.to_dict() for ds in port.values() for d in ds] == \
        [d.to_dict() for ds in ref.values() for d in ds]


def test_new_suites_warnings_are_the_references():
    """Over the suites this slice added, each warning of the port's
    sweep is the counterpart of one the JAX package's sweep gives on its
    own file (same code, line and message but the path)."""
    names = ("pgwire", "cockroach", "mongodb", "chronos", "rabbitmq",
             "robustirc", "galera", "percona", "postgres_rds", "crate",
             "elasticsearch", "dgraph", "mysql_cluster")

    def found(lint, root):
        out = []
        for name in names:
            for path, ds in lint.lint_paths(
                    [root / "suites" / f"{name}.py"]).items():
                out += [(name, d.code, d.severity, d.index,
                         d.message.replace(str(root), "<pkg>"))
                        for d in ds]
        return out

    port = found(tlint, PKG)
    assert port == found(jlint, REPO / "jepsen_tpu")
    assert {c for _n, c, sev, *_ in port if sev == "error"} == set()


# ---------------------------------------------------------------------------
# the command beside tools/lint_suites.py (tests/test_suite_lint.py :50-75,
# :459-520, :683-696, :822-832)
# ---------------------------------------------------------------------------


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "lint_suites_reference", REPO / "tools" / "lint_suites.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(capsys, argv):
    out = {}
    for name, main in (("torch", tcmd.main),
                       ("jax", _reference_tool().main)):
        rc = main(list(argv))
        out[name] = (rc, capsys.readouterr().out)
    return out


def _live(tmp_path, name, src):
    live = tmp_path / "live"
    live.mkdir(exist_ok=True)
    p = live / name
    p.write_text(src)
    return p


FIXTURE_CASES = {
    "s002-bad-suite": ("bad_suite.py", (
        "class FooClient(Client):\n"
        "    def invoke(self, test, op):\n"
        "        try:\n"
        "            return replace(op, type='ok')\n"
        "        except Exception:\n"
        "            return replace(op, type='ok')\n"), 1, "S002"),
    "b003-journal": ("live/bad_backend.py", (
        "import os\n"
        "def journal(path, line):\n"
        "    tmp = path + '.tmp'\n"
        "    with open(tmp, 'w') as f:\n"
        "        f.write(line)\n"
        "    os.replace(tmp, path)\n"), 1, "B003"),
    "clean-live": ("live/ok_backend.py", (
        "import os\n"
        "def journal(path, line):\n"
        "    tmp = path + '.tmp'\n"
        "    with open(tmp, 'w') as f:\n"
        "        f.write(line)\n"
        "        f.flush()\n"
        "        os.fsync(f.fileno())\n"
        "    os.replace(tmp, path)\n"), 0, None),
    "b002-probe": ("live/swallow_backend.py", (
        "from dataclasses import replace\n"
        "def probe(op):\n"
        "    try:\n"
        "        return do(op)\n"
        "    except Exception:\n"
        "        return replace(op, type='fail')\n"), 1, "B002"),
}


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("case", sorted(FIXTURE_CASES))
def test_command_equals_the_tool_on_fixtures(case, as_json, tmp_path,
                                             capsys):
    rel, src, rc, code = FIXTURE_CASES[case]
    p = tmp_path / rel
    p.parent.mkdir(exist_ok=True)
    p.write_text(src)
    out = _both(capsys, (["--json"] if as_json else []) + [str(p)])
    assert out["torch"] == out["jax"]
    got_rc, text = out["torch"]
    assert got_rc == rc
    if as_json:
        payload = json.loads(text)
        assert set(payload) == {"errors", "warnings", "files"}
        found = {d["code"] for ds in payload["files"].values() for d in ds}
        assert found == ({code} if code else set())
    elif code:
        assert code in text


@pytest.mark.parametrize("flag", ["--retry", "--threads", "--metrics"])
def test_command_tier_flags_exit_0_with_the_payload_keys(flag, capsys):
    """Each tier-wide pass over the port's tree alone: no error (the
    R-code gate is this case's ``--retry``)."""
    rc = tcmd.main([flag, "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert set(payload) == {"errors", "warnings", "files"}
    assert payload["errors"] == 0


def test_command_knobs_json_is_clean(capsys):
    """The restated N-code gate: no error and no warning over the port's
    package, ``cli.py`` and the README's port section."""
    assert tcmd.main(["--knobs", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload == {"errors": 0, "warnings": 0, "files": {}}


def test_command_codes_list_the_tools_codes(capsys):
    out = _both(capsys, ["--codes"])
    assert out["torch"][0] == out["jax"][0] == 0
    codes = [[ln.split()[0] for ln in text.splitlines()]
             for _rc, text in out.values()]
    assert codes[0] == codes[1] == sorted(jlint.SUITE_CODES)
    lines_t, lines_j = (set(text.splitlines()) for _rc, text in out.values())
    assert {ln for ln in lines_t if not ln.startswith("N")} == \
        {ln for ln in lines_j if not ln.startswith("N")}


def test_command_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.analyze.lint_suites",
         "--codes"], capture_output=True, text=True, cwd=str(REPO),
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert [ln.split()[0] for ln in out.stdout.splitlines()] == \
        sorted(tlint.SUITE_CODES)
