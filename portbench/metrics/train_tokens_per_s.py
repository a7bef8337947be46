"""Tokens of every step the window ran over the window's wall time, the
window closed by a synchronise (host clock)."""


def read(run):
    x = run.extra
    return x["steps"] * x["batch"] * x["seq"] / run.window_s
