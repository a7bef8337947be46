"""The per-test time limit the port's cluster and world tests use
(``tests/torch_time_limit.py``): a body past its limit raises in the main
thread, soon after the limit; a nested limit leaves the enclosing one's
deadline in force (here ``tests/conftest.py``'s per-test alarm, when it
is armed); a body within its limit is untouched."""

import signal
import time

import pytest

from torch_time_limit import TimeLimitExceeded, time_limit

import torch_threads  # noqa: F401,E402  (one torch thread a test process)


def _outer_left():
    return signal.getitimer(signal.ITIMER_REAL)[0]


def _assert_outer_restored(before, t0):
    after = _outer_left()
    if before == 0:
        assert after == 0
    else:
        assert 0 < after <= before
        assert after >= before - (time.monotonic() - t0) - 1.0


def test_a_hang_raises_at_its_limit():
    before, t0 = _outer_left(), time.monotonic()
    with pytest.raises(TimeLimitExceeded, match="a sleeper ran past"):
        with time_limit(0.3, "a sleeper"):
            time.sleep(30)
    assert time.monotonic() - t0 < 5
    _assert_outer_restored(before, t0)


def test_a_body_within_its_limit_is_untouched():
    before, t0 = _outer_left(), time.monotonic()
    with time_limit(5, "a quick body"):
        time.sleep(0.05)
    _assert_outer_restored(before, t0)


def test_an_outer_limit_that_ends_first_stays_in_force():
    with pytest.raises(TimeLimitExceeded, match="outer"):
        with time_limit(0.3, "outer"):
            with time_limit(10, "inner"):
                time.sleep(30)


def test_nested_limits_keep_the_outer_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeLimitExceeded, match="outer"):
        with time_limit(0.6, "outer"):
            with time_limit(0.2, "inner"):
                time.sleep(0.05)
            left = _outer_left()
            assert 0 < left <= 0.6
            time.sleep(30)
    assert time.monotonic() - t0 < 5
