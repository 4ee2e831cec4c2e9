"""The repository's root conftest.py orders the suite's work under
`--dist loadfile`: its file names must name test files, and xdist's
scheduler must hand their work out first, so that neither a rename nor
a change in xdist switches the order off in silence."""

import ast
import importlib.util
import pathlib
import types

import pytest

TESTS = pathlib.Path(__file__).resolve().parent


def _root_conftest():
    path = TESTS.parent / "conftest.py"
    spec = importlib.util.spec_from_file_location("root_conftest", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_long_files_exist():
    sched = _root_conftest()
    assert sched.LONG_FILES
    assert set(sched.SPLIT_FILES) <= set(sched.LONG_FILES)
    for name in sched.LONG_FILES:
        path = TESTS / name
        assert path.is_file(), name
        tree = ast.parse(path.read_text())
        assert any(isinstance(node, ast.FunctionDef)
                   and node.name.startswith("test_")
                   for node in tree.body), name


class _Node:
    shutting_down = False

    def __init__(self):
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.extend(indices)

    def shutdown(self):
        self.shutting_down = True


def test_long_files_are_scheduled_first():
    pytest.importorskip("xdist")
    sched_mod = _root_conftest()
    # the count heuristic alone would queue this 5-test file first
    collection = [f"tests/test_many.py::test_{i}" for i in range(5)]
    for name in reversed(sched_mod.LONG_FILES):
        collection += [f"tests/{name}::test_a", f"tests/{name}::test_b"]
    config = types.SimpleNamespace(
        option=types.SimpleNamespace(loadscopereorder=True),
        getvalue={"tx": ["1*popen"], "dist": "loadfile"}.get,
    )
    sched = sched_mod.pytest_xdist_make_scheduler(config, None)
    node = _Node()
    sched.add_node(node)
    sched.add_node_collection(node, collection)
    sched.schedule()
    done = 0
    while done < len(node.sent):
        sched.mark_test_complete(node, node.sent[done])
        done += 1
    order = [collection[i] for i in node.sent]
    assert sorted(order) == sorted(collection)
    expected = [f"tests/{name}::test_{t}"
                for name in sched_mod.LONG_FILES for t in "ab"]
    assert order[:len(expected)] == expected
    units = sched.assigned_work[node]
    for name in sched_mod.LONG_FILES:
        tests = [f"tests/{name}::test_a", f"tests/{name}::test_b"]
        if name in sched_mod.SPLIT_FILES:
            assert all(list(units[t]) == [t] for t in tests), name
        else:
            assert list(units[f"tests/{name}"]) == tests, name
