"""The per-test time limit of ``tests/time_limit.py``, run on small inner
suites in this process: a test past its limit fails with a message naming it
and the limit, a test inside its limit passes, and a module fixture that
overruns is charged to the test that first uses it."""

import pytest

INI = "[pytest]\nmarkers =\n    time_limit(seconds): the test's own time limit\n"


def run(pytester, source):
    pytester.makeini(INI)
    pytester.makepyfile(test_inner=source)
    return pytester.runpytest("-p", "tests.time_limit", "-p", "no:randomly")


@pytest.mark.parametrize("limit, passed", [(1, False), (10, True)])
def test_sleeping_test_against_its_limit(pytester, limit, passed):
    result = run(pytester, f"""
import time
import pytest

@pytest.mark.time_limit({limit})
def test_sleeps():
    time.sleep(3)
""")
    result.assert_outcomes(passed=int(passed), failed=int(not passed))
    if not passed:
        result.stdout.fnmatch_lines(["*test_inner.py::test_sleeps ran past its time limit of 1 s*"])


def test_module_fixture_overrun_is_charged_to_its_first_user(pytester):
    result = run(pytester, """
import time
import pytest

@pytest.fixture(scope="module")
def slow():
    time.sleep(3)

def test_first():
    pass

@pytest.mark.time_limit(1)
def test_second(slow):
    pass

def test_third(slow):
    pass
""")
    result.assert_outcomes(passed=1, errors=2)
    result.stdout.fnmatch_lines(["*test_inner.py::test_second ran past its time limit of 1 s*"])
