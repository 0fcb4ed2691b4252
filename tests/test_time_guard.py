"""tests/_time_guard.py: the alarm stops a sleeping or busy test, and a block
that ends in time leaves the signal state as it found it. These run inside
the root conftest's own guard, so they also show that guards nest."""

import signal
import time

import pytest

from _time_guard import TimeLimitExceeded, time_limit


def test_sleep_is_stopped():
    t0 = time.monotonic()
    with pytest.raises(TimeLimitExceeded, match="its 1 s time limit"):
        with time_limit(1):
            time.sleep(5)
    assert time.monotonic() - t0 < 2


def test_busy_loop_is_stopped():
    t0 = time.monotonic()
    with pytest.raises(TimeLimitExceeded, match="its 1 s time limit"):
        with time_limit(1):
            while time.monotonic() - t0 < 5:
                pass
    assert time.monotonic() - t0 < 2


def test_block_in_time_restores_signal_state():
    with time_limit(60):                        # an outer alarm
        handler = signal.getsignal(signal.SIGALRM)
        left = signal.getitimer(signal.ITIMER_REAL)[0]
        with time_limit(1):
            time.sleep(0.1)
        assert signal.getsignal(signal.SIGALRM) is handler
        assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= left
    # with no outer alarm, none is left behind
    saved = signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        with time_limit(1):
            time.sleep(0.1)
        assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    finally:
        if saved[0]:
            signal.setitimer(signal.ITIMER_REAL, saved[0])
