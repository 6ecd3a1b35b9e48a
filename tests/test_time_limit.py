"""The per-test time limit of ``conftest.py`` (``time_limit.py``).

Each case runs a child ``pytest -n 2 --dist loadfile`` session, the way the
whole suite runs, over planted tests in a temporary directory.  The child's
conftest binds the same ``time_limit.hooks`` as ``conftest.py``, with a table
of its own, and records after each test whether a timer is still armed.
"""

import json
import os
import signal
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
# The parent session's own pytest variables (xdist worker ids, addopts) stay out.
CHILD_ENV = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}

CHILD_CONFTEST = f"""
import json, os, signal, sys

sys.path.insert(0, {str(TESTS)!r})
from time_limit import hooks

pytest_runtest_setup, pytest_runtest_call, pytest_runtest_teardown = hooks(600.0, {{
    "test_planted.py::test_livelock": 1.0,
    "test_planted.py::test_livelock_under_except_exception": 1.0,
    "test_planted.py::test_in_time": 5.0,
}})


def pytest_runtest_logfinish(nodeid):
    with open(f"timers-{{os.getpid()}}.jsonl", "a") as f:
        f.write(json.dumps({{"nodeid": nodeid,
                            "timer": list(signal.getitimer(signal.ITIMER_REAL)),
                            "handler": str(signal.getsignal(signal.SIGALRM))}}) + "\\n")
"""

# In one file, so that --dist loadfile runs them in order on one worker.
PLANTED = """
import threading
import time


def livelock():
    cond = threading.Condition()
    with cond:
        while True:
            cond.wait(0.25)


def test_livelock():
    livelock()


def test_after_the_livelock():
    pass


def test_livelock_under_except_exception():
    try:
        livelock()
    except Exception:
        pass


def test_in_time():
    time.sleep(0.2)
"""


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    """The child session's test cases by name, its timer records and seconds."""
    root = tmp_path_factory.mktemp("time_limit")
    (root / "pytest.ini").write_text("[pytest]\n")
    (root / "conftest.py").write_text(CHILD_CONFTEST)
    (root / "test_planted.py").write_text(PLANTED)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist",
         "-n", "2", "--dist", "loadfile", "-p", "no:randomly", "--junitxml=junit.xml"],
        cwd=root, env=CHILD_ENV, capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - t0
    assert proc.returncode == 1, proc.stdout + proc.stderr
    cases = {c.get("name"): c for c in ET.parse(root / "junit.xml").iter("testcase")}
    timers = [json.loads(line) for p in root.glob("timers-*.jsonl")
              for line in p.read_text().splitlines()]
    return cases, timers, seconds


def test_livelock_fails_by_its_limit_and_the_next_test_runs(child):
    cases, _, seconds = child
    failure = cases["test_livelock"].find("failure")
    assert failure is not None
    assert "TimeLimitExceeded" in failure.get("message")
    assert "test_planted.py::test_livelock: call ran past its time limit of 1 s" \
        in failure.get("message")
    assert float(cases["test_livelock"].get("time")) < 5.0
    assert list(cases["test_after_the_livelock"]) == []     # passed
    assert seconds < 60.0


def test_except_exception_does_not_swallow_the_limit(child):
    cases, _, _ = child
    failure = cases["test_livelock_under_except_exception"].find("failure")
    assert failure is not None
    assert "TimeLimitExceeded" in failure.get("message")
    assert float(cases["test_livelock_under_except_exception"].get("time")) < 5.0


def test_in_time_passes_and_leaves_no_timer_armed(child):
    cases, timers, _ = child
    assert list(cases["test_in_time"]) == []                 # passed
    # Every test, the ones stopped by their limit too, leaves the timer
    # disarmed and the default SIGALRM handler back in place.
    assert {t["nodeid"] for t in timers} == {f"test_planted.py::{name}" for name in cases}
    for t in timers:
        assert t["timer"] == [0.0, 0.0], t
        assert t["handler"] == str(signal.SIG_DFL), t


def test_own_limits_name_collected_tests():
    """A renamed test would silently fall back to the default limit."""
    import conftest

    files = sorted({nodeid.split("::")[0] for nodeid in conftest.OWN_S})
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider",
         *files],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**CHILD_ENV, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")])})
    collected = set(proc.stdout.split())
    assert set(conftest.OWN_S) <= collected, proc.stdout + proc.stderr
