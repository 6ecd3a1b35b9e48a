"""A time limit for each phase of each test, so that a hang fails by name.

``hooks(default_s, own_s)`` returns the three pytest hooks that a conftest
binds to the names ``pytest_runtest_setup``, ``pytest_runtest_call`` and
``pytest_runtest_teardown``.  Each phase of a test (setup, call, teardown)
runs under a one-shot ``ITIMER_REAL`` timer of ``own_s.get(nodeid,
default_s)`` seconds, whose ``SIGALRM`` handler raises ``TimeLimitExceeded``
naming the test, the phase and the limit.  pytest then records the test as
failed and goes on to the next one.

The handler runs on the main thread, where pytest runs each test
(pytest-xdist's workers too: their exec model is ``main_thread_only``).  A
phase run on another thread, where no signal handler can be set, runs
without a limit.
"""

import signal
import threading

import pytest


class TimeLimitExceeded(BaseException):
    """A phase of a test ran past its time limit.

    A ``BaseException``, so that the ``except Exception`` of the code under
    test and a test's ``pytest.raises(OSError)`` cannot swallow it."""


def _limited(item, phase, limit_s):
    if threading.current_thread() is not threading.main_thread():
        return (yield)

    def on_alarm(signum, frame):
        raise TimeLimitExceeded(
            f"{item.nodeid}: {phase} ran past its time limit of {limit_s:g} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, limit_s)
    try:
        return (yield)
    finally:
        # Nested, so that an alarm landing before the disarm still restores
        # the handler (the one-shot timer has then fired and is spent).
        try:
            signal.setitimer(signal.ITIMER_REAL, 0)
        finally:
            signal.signal(signal.SIGALRM, previous)


def hooks(default_s, own_s):
    """The setup, call and teardown hooks limiting each test: ``own_s[nodeid]``
    seconds for the node ids in ``own_s``, ``default_s`` for every other."""
    def phase_hook(phase):
        @pytest.hookimpl(wrapper=True)
        def hook(item):
            return (yield from _limited(item, phase,
                                        own_s.get(item.nodeid, default_s)))
        return hook
    return phase_hook("setup"), phase_hook("call"), phase_hook("teardown")
