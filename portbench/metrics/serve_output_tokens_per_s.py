"""Every output token streamed to a client inside the window, over the
window's wall time; tokens of requests still in flight count (host clock)."""

from portbench import work


def read(run):
    return work.served(run)["tokens"] / run.window_s
