"""A time limit for every test, loaded by the repo's root ``conftest.py``.

A test's set-up (the module fixtures it is the first to use) and its call
share one deadline of ``DEFAULT_S`` seconds, or of the ``time_limit(seconds)``
marker's; its teardown has a limit of the same length of its own. The default
holds for the tests under ``tests/``; elsewhere only the marker sets a limit.
A ``SIGALRM`` from ``setitimer`` raises ``pytest.fail`` in the main thread
when the deadline passes, so the test fails with a message naming it and its
limit, and its ``finally`` blocks still run (the subprocesses it started are
killed). pytest-xdist's workers run tests on their main thread, where the
signal is delivered. A call into native code that never returns to the
interpreter is not interrupted before it does.

An alarm already armed when a phase starts (an in-process pytest run inside a
test) is restored, less the time spent, when the phase ends.
"""

import contextlib
import pathlib
import signal
import time

import pytest

DEFAULT_S = 300.0
TESTS = pathlib.Path(__file__).resolve().parent
DEADLINE = pytest.StashKey[float]()


def limit_of(item):
    marker = item.get_closest_marker("time_limit")
    if marker:
        return float(marker.args[0])
    return DEFAULT_S if TESTS in item.path.resolve().parents else None


@contextlib.contextmanager
def alarm(item, seconds):
    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit_of(item):g} s",
                    pytrace=False)

    outer_handler = signal.signal(signal.SIGALRM, expire)
    outer_left, _ = signal.setitimer(signal.ITIMER_REAL, max(seconds, 1e-3))
    start = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer_handler)
        if outer_left:
            signal.setitimer(signal.ITIMER_REAL,
                             max(outer_left - (time.monotonic() - start), 1e-3))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if limit_of(item) is None:
        return (yield)
    item.stash[DEADLINE] = time.monotonic() + limit_of(item)
    with alarm(item, limit_of(item)):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if limit_of(item) is None:
        return (yield)
    with alarm(item, item.stash[DEADLINE] - time.monotonic()):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    if limit_of(item) is None:
        return (yield)
    with alarm(item, limit_of(item)):
        return (yield)
