"""The test run's clock: the order in which xdist hands out the test files,
and a time limit on every test phase.

pytest loads this file for every run started in the repository (it sits
beside pyproject.toml). The tests' own set-up (CPU JAX, the vectors) is
tests/conftest.py.
"""
import collections
import contextlib
import faulthandler
import json
import os
import signal
import sys

import pytest

# Each phase of a test (setup, call, teardown) runs under this limit,
# about twice the slowest phase of the suite (the inter_qcif case of
# tests/test_entropy_device.py: 491-598 s in whole runs of the tier-1
# command on an 8-core machine). A phase past it fails with the stacks
# of all threads, and its worker goes on with the next test.
TEST_LIMIT_S = 1200

# The alarm's handler runs only when the main thread comes back to Python:
# one held in native code (an XLA compile, a lock without a timeout) gets
# its stacks from faulthandler's own thread this long after the limit.
_STACKS_GRACE_S = 30

DURATIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "durations.json")


@contextlib.contextmanager
def _time_limit(item, phase):
    """Fail `item` at TEST_LIMIT_S, with every thread's stack on stderr,
    instead of letting a hang take the run."""
    limit = TEST_LIMIT_S

    def expire(signum, frame):
        faulthandler.cancel_dump_traceback_later()
        faulthandler.dump_traceback(file=sys.__stderr__, all_threads=True)
        pytest.fail(f"{item.nodeid} ran past its limit of {limit} s in "
                    f"{phase}")

    faulthandler.dump_traceback_later(limit + _STACKS_GRACE_S,
                                      file=sys.__stderr__, exit=False)
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(item, "teardown"):
        return (yield)


def order_by_cost(items, costs):
    """Sort `items` in place, whole files at a time, costliest file first.

    `costs` maps a test file's name to its seconds. The files it lacks
    follow the costed ones in the order xdist's loadfile would give them
    (most test ids first, then collection order). The tests of a file keep
    their order. Only the order changes: a stale table can only slow a
    run, never skip or change a test."""
    def file_of(item):
        return os.path.basename(item.nodeid.split("::")[0])

    n_ids = collections.Counter(file_of(item) for item in items)

    def rank(item):
        f = file_of(item)
        return (0, -costs[f]) if f in costs else (1, -n_ids[f])

    items.sort(key=rank)


def pytest_configure(config):
    # xdist's loadfile queues the files by their number of test ids; keep
    # the collection's order instead, which order_by_cost sets below.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    """In an xdist worker, collect the files by tests/durations.json,
    costliest first, so that `--dist loadfile` starts the longest files
    first and the run does not end on a few long files.

    The table holds each file's seconds summed over its tests, from the
    `--junitxml` report (report.xml below) of a whole run with ROADMAP.md's
    tier-1 command:

        python - <<'PY'
        import collections, json, xml.etree.ElementTree as ET
        cost = collections.Counter()
        for case in ET.parse("report.xml").iter("testcase"):
            name = case.get("classname").split(".")[1] + ".py"
            cost[name] += float(case.get("time"))
        json.dump({f: round(s, 1) for f, s in cost.most_common()},
                  open("tests/durations.json", "w"), indent=1)
        PY

    Refresh it when a file's cost moves by a minute or a file of more
    than about a minute is added."""
    if not hasattr(config, "workerinput"):
        return
    with open(DURATIONS) as f:
        order_by_cost(items, json.load(f))
