"""Arm tests/_time_guard.py's per-test time limit around every test phase,
and mark the eager sharded renders of tests/test_parallel.py slow.

Each phase (setup, where module fixtures run, call and teardown) fails with
a message naming the limit once it runs past ``TEST_LIMIT_S``, so one hung
test costs its worker that long at most, not the whole run.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent / "tests"))
from _time_guard import time_limit  # noqa: E402

#: Each phase of a test fails at this many seconds
TEST_LIMIT_S = 300
#: The file whose eager sharded renders are marked slow
SLOW_FILE = Path(__file__).parent / "tests" / "test_parallel.py"
#: Its tests that render through an eager shard_map over the 8-device
#: virtual CPU mesh with interpreted kernels; seconds each on an 8-core CPU.
#: Their twins under jax.jit, tests/test_parallel_jit.py, run in tier-1
SLOW_TESTS = frozenset({
    "test_gaussians_sharded_matches_single",                 # 131-158 s
    "test_gaussians_sharded_flagship_config_matches_single",  # 849-895 s
    "test_gaussians_sharded_ring_exchange_matches_all_gather",  # 316 s
    "test_gaussians_depth_sliced_matches_single",            # 288 s
    "test_gaussians_sharded_midfan_exact_certified_matches_single",  # > 330 s
    "test_gaussians_sharded_tail_decim_matches_single",      # > 330 s
})


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: before -m deselects by mark
    for item in items:
        if item.path == SLOW_FILE and item.originalname in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


def _guarded(phase, item):
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
