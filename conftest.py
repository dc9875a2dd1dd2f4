"""Settings of a pytest run in this repo, loaded before ``tests/conftest.py``.

Each pytest-xdist worker takes its share of the cores, every test under
``tests/`` has a time limit (``tests/time_limit.py``), the tests in ``MARKS``
get a longer one or are ``slow``, and the files are handed out to the workers
longest first.
"""

import os

import pytest
import torch

pytest_plugins = ["pytester", "tests.time_limit"]


def share(workers):
    return max(1, len(os.sched_getaffinity(0)) // workers)


# The workers share the cores: each caps torch's intra-op threads at its
# share, and numpy's OpenBLAS pool likewise (pytest_configure). More threads
# than cores slow every worker: the threads of one op wait for each other.
torch.set_num_threads(share(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

slow, limit = pytest.mark.slow, pytest.mark.time_limit

# By node id (a file, or one test in it). A limit is twice what the test took,
# with the module fixtures it was the first to use, under the tier-1 command
# (`-n 6 --dist loadfile -m 'not slow'`) on 8 CPUs, or under `-m slow` for the
# slow ones. `slow` marks the JAX package's whole-pipeline gates that take
# minutes on the CPU and test none of the port: the tier-1 run leaves them out.
MARKS = {
    "tests/test_torch_standalone.py": [limit(2560)],      # module fixture 1,279 s
    "tests/test_standalone_loop.py": [limit(2360)],       # first test 1,178 s
    "tests/test_torch_trim_vicinity.py": [limit(1460)],   # module fixture 728 s
    "tests/test_eight_agents.py": [limit(610)],           # first test 301 s
    "tests/test_trim_vicinity.py": [limit(560)],          # first tests 225 s, 280 s
    "tests/test_vocab_recall.py": [limit(430)],           # first test 213 s
    "tests/test_four_agents.py": [limit(390)],            # first test 193 s
    "tests/test_disturber.py": [limit(310)],              # test_drops_recovered_by_resend 153 s
    "tests/test_rendered_merge.py": [slow, limit(4010)],  # 2,004 s under `-m slow`
    "tests/test_rendered_loop.py": [slow, limit(2210)],   # 1,106 s
    "tests/test_rendered_ate.py": [slow, limit(960)],     # 480 s
    "tests/test_multiprocess.py::test_sequence_streaming_client": [slow, limit(1175)],  # 587 s
}


def marks_of(nodeid):
    return [mark for key, marks in MARKS.items()
            if nodeid == key or nodeid.startswith(key + "::") for mark in marks]


def pytest_configure(config):
    # pytest-xdist otherwise hands out the files largest first by test count.
    config.option.loadscopereorder = False
    # OpenBLAS sizes its pool when numpy loads, which in a worker is before
    # this file, so the controller hands the cap to the workers it starts.
    workers = getattr(config.option, "numprocesses", None)
    if workers:
        os.environ.setdefault("OPENBLAS_NUM_THREADS", str(share(workers)))


@pytest.hookimpl(wrapper=True)
def pytest_collection_modifyitems(items):
    for item in items:
        for mark in marks_of(item.nodeid):
            item.add_marker(mark)
    yield  # `-m` deselects by these marks
    # The files whose tests have the longest limits start first; the other
    # files, and each file's tests, keep their order.
    longest = {}
    for item in items:
        mark = item.get_closest_marker("time_limit")
        longest[item.path] = max(longest.get(item.path, 0), mark.args[0] if mark else 0)
    items.sort(key=lambda item: -longest[item.path])
