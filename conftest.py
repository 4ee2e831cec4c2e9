"""Order of the test suite's work under pytest-xdist's `--dist loadfile`.

xdist queues test files by their test count, most first, and gives every
test of a file to one worker. The suite's run length is then set by its
longest files, started late or run in a row. Serial seconds per file:
CHANGES.md; the layout and the rule for new files: ROADMAP.md,
"Test budget".
"""

import os
from collections import OrderedDict

import pytest

# Test files started first, in this order: those over ~300 s serial on one
# worker, whole files longest first, then the split file's tests.
LONG_FILES = (
    "test_golden.py",
    "test_lazy.py",
    "test_stream.py",
    "test_camera_grad.py",
    "test_parallel.py",
)
# Files whose tests are handed out one at a time, each to the next free
# worker: their tests share no module fixture worth keeping in one process.
SPLIT_FILES = ("test_parallel.py",)


def _file(nodeid):
    return os.path.basename(nodeid.split("::")[0])


def long_files_first(config, log=None):
    """xdist's `LoadFileScheduling` with `SPLIT_FILES` cut into one unit a
    test and `LONG_FILES`' units queued first; the rest of the queue keeps
    xdist's order."""
    from xdist.scheduler import LoadFileScheduling

    class LongFilesFirst(LoadFileScheduling):
        queued = False

        def _split_scope(self, nodeid):
            if _file(nodeid) in SPLIT_FILES:
                return nodeid
            return super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            # the first assignment comes right after xdist built the queue
            if not self.queued:
                self.queued = True
                rank = {name: i for i, name in enumerate(LONG_FILES)}
                self.workqueue = OrderedDict(sorted(
                    self.workqueue.items(),
                    key=lambda unit: rank.get(_file(unit[0]), len(rank)),
                ))
            super()._assign_work_unit(node)

    return LongFilesFirst(config, log)


# optionalhook: the hook's spec is xdist's, so `-p no:xdist` would otherwise
# stop with "unknown hook"
@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    return long_files_first(config, log)
