"""Time limits of their own for the port tests that start a cluster, a
world of ranks or a subprocess, so that a hang fails that one test (with
the main thread's stack in its error) instead of holding up the whole
test run until its deadline. pytest-timeout is not installed; this is
SIGALRM in the main thread, where pytest runs tests and fixtures.

``tests/conftest.py`` already arms a 180 s alarm around every test body
and its function-scoped fixtures. Two gaps remain, and this fills them:
- a module-scoped fixture's set-up (a cluster started for a whole file)
  runs outside that alarm: wrap it in ``with time_limit(seconds, what):``;
- a module whose tests take seconds can hold them to a tighter limit:
  ``from torch_time_limit import per_test_time_limit`` (an autouse
  fixture) with ``TIME_LIMIT_S`` set in the module.
"""

import contextlib
import signal
import threading
import time
import traceback

import pytest

DEFAULT_S = 300.0


class TimeLimitExceeded(Exception):
    pass


@contextlib.contextmanager
def time_limit(seconds: float, what: str = "the test"):
    """Raise ``TimeLimitExceeded`` in the main thread if the body runs past
    ``seconds``. An enclosing limit (``tests/conftest.py``'s per-test alarm
    of every test) keeps its deadline: one that ends first is left alone,
    one that ends later is re-armed afterwards."""
    outer_left, _ = signal.getitimer(signal.ITIMER_REAL)
    if (threading.current_thread() is not threading.main_thread()
            or 0 < outer_left <= seconds):
        yield            # an enclosing limit that ends first stays in force
        return
    outer_handler = signal.getsignal(signal.SIGALRM)
    outer_deadline = time.monotonic() + outer_left if outer_left else None

    def on_alarm(signum, frame):
        stack = "".join(traceback.format_stack(frame))
        raise TimeLimitExceeded(
            f"{what} ran past its time limit of {seconds} s; the main "
            f"thread was at:\n{stack}")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, outer_handler)
        if outer_deadline is not None:
            signal.setitimer(signal.ITIMER_REAL,
                             max(outer_deadline - time.monotonic(), 1e-3))


@pytest.fixture(autouse=True)
def per_test_time_limit(request):
    seconds = getattr(request.module, "TIME_LIMIT_S", DEFAULT_S)
    with time_limit(seconds, request.node.nodeid):
        yield
