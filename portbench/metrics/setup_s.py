"""Set-up: process start to the window's opening (host clock)."""


def read(run):
    return run.setup_s
