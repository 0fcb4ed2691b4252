"""Arm tests/_time_guard.py's per-test time limit around every test phase.

Each phase (setup, where module fixtures run, call and teardown) fails with
a message naming the limit once it runs past ``TEST_LIMIT_S``, so one hung
test costs its worker that long at most, not the whole run.
"""

import contextlib
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent / "tests"))
from _time_guard import time_limit  # noqa: E402

#: Each phase of a test fails at this many seconds
TEST_LIMIT_S = 300
#: Files left unguarded: the JAX package's sharded tests render through an
#: eager shard_map over the 8-device virtual mesh, up to ~900 s a test on an
#: 8-core CPU, and they are kept as they are
UNGUARDED = frozenset({"tests/test_parallel.py"})


def _guarded(phase, item):
    if item.nodeid.split("::")[0] in UNGUARDED:
        return contextlib.nullcontext()
    return time_limit(TEST_LIMIT_S, what=f"{item.nodeid} ({phase})")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _guarded("setup", item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _guarded("call", item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _guarded("teardown", item):
        return (yield)
