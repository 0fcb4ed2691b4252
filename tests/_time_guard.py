"""A per-test time limit without pytest-timeout.

:func:`time_limit` arms a ``SIGALRM`` alarm that raises
:class:`TimeLimitExceeded` in the main thread, which fails the test with a
message naming the limit. Python runs signal handlers only between bytecodes,
so a test stuck in C with the GIL released is not stopped: the run's own
outer time limit bounds that case.

Guards nest: on exit the previous ``SIGALRM`` handler and an outer alarm's
remaining time are restored (an outer deadline that fell inside the block
then fires at once).
"""

import contextlib
import signal
import time


class TimeLimitExceeded(BaseException):
    """Raised in the main thread when a guarded block outlives its limit.

    A ``BaseException``, so that ``except Exception`` in the code under test
    does not swallow it."""


@contextlib.contextmanager
def time_limit(seconds, what="test"):
    """Fail the block with :class:`TimeLimitExceeded` after ``seconds``.

    Call from the main thread: the alarm needs it.
    """
    start = time.monotonic()
    outer_handler = signal.getsignal(signal.SIGALRM)
    outer_left = signal.getitimer(signal.ITIMER_REAL)[0]

    def on_alarm(signum, frame):
        raise TimeLimitExceeded(
            f"{what} ran past its {seconds:g} s time limit")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, signal.SIG_DFL
                      if outer_handler is None else outer_handler)
        if outer_left:
            # an outer deadline that passed meanwhile fires at once
            left = outer_left - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))
