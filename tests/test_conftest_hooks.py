"""The run's clock in the repository's root conftest.py.

* order_by_cost: on a fake collection and cost table, the files come out
  costliest first, and the files the table lacks follow in the order
  xdist's loadfile would give them (most test ids first);
* xdist's loadfile queue, with the reordering the root conftest turns off,
  hands the files out in the collection's order;
* the time limit: a test that sleeps past a 1 s limit fails with the limit
  in its message and every thread's stack, and the next test of its file
  still runs and passes.
"""
import importlib.util
import os
import time
from types import SimpleNamespace

pytest_plugins = ["pytester"]

ROOT_CONFTEST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conftest.py")


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT_CONFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _collection(ids):
    return [f"tests/{f}::t{i}" for f, n in ids.items() for i in range(n)]


def _files(nodeids):
    files = []
    for nodeid in nodeids:
        f = nodeid.split("::")[0].split("/")[1]
        if f not in files:
            files.append(f)
    return files


def test_collection_orders_files_costliest_first():
    ids = {"test_a.py": 1, "test_b.py": 3, "test_c.py": 2, "test_d.py": 4,
           "test_e.py": 1}
    costs = {"test_a.py": 50.0, "test_b.py": 500.0, "test_e.py": 5.0,
             "test_gone.py": 900.0}
    items = [SimpleNamespace(nodeid=n) for n in _collection(ids)]
    _root_conftest().order_by_cost(items, costs)
    nodeids = [item.nodeid for item in items]
    assert sorted(nodeids) == sorted(_collection(ids))
    # costed by cost; then xdist's order: d (4 ids) before c (2 ids)
    assert _files(nodeids) == [
        "test_b.py", "test_a.py", "test_e.py", "test_d.py", "test_c.py"]
    # a file's tests keep their order
    assert [n for n in nodeids if "test_b.py" in n] == \
        [f"tests/test_b.py::t{i}" for i in range(3)]


class _FakeNode:
    gateway = SimpleNamespace(id="gw0")
    shutting_down = False

    def __init__(self):
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_loadfile_queue_follows_collection_order():
    from xdist.scheduler import LoadFileScheduling

    collection = _collection({"test_x.py": 1, "test_y.py": 4,
                              "test_z.py": 2})
    config = SimpleNamespace(option=SimpleNamespace(loadscopereorder=True),
                             getvalue=lambda name: {"tx": ["1*popen"]}[name])
    _root_conftest().pytest_configure(config)
    sched = LoadFileScheduling(config)
    node = _FakeNode()
    sched.add_node(node)
    sched.add_node_collection(node, collection)
    sched.schedule()
    done = 0
    while done < len(node.sent):
        sched.mark_test_complete(node, node.sent[done])
        done += 1
    assert node.shutting_down
    assert [collection[i] for i in node.sent] == collection


def test_time_limit_fails_hung_test_and_run_goes_on(pytester):
    pytester.makeconftest(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "root_conftest", {ROOT_CONFTEST!r})
        root = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(root)
        root.TEST_LIMIT_S = 1
        pytest_runtest_setup = root.pytest_runtest_setup
        pytest_runtest_call = root.pytest_runtest_call
        pytest_runtest_teardown = root.pytest_runtest_teardown
        """)
    pytester.makepyfile(test_hang="""
        import threading
        import time


        def test_hangs():
            threading.Thread(target=time.sleep, args=(120,), daemon=True,
                             name="side").start()
            time.sleep(120)


        def test_next():
            assert True
        """)
    t0 = time.monotonic()
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider",
                                           "-p", "no:randomly")
    assert time.monotonic() - t0 < 60
    result.assert_outcomes(failed=1, passed=1)
    out = result.stdout.str()
    assert "test_hang.py::test_hangs ran past its limit of 1 s in call" \
        in out
    # faulthandler: the main thread and the sleeping side thread
    assert out.count("most recent call first") >= 2
    assert "test_hang.py\", line 8 in test_hangs" in out
