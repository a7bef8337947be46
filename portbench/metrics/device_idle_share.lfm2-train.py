"""Share of the LFM2 cell's traced window in which no operation ran on the
device (the union of the operations' intervals is the busy time)."""


def read(run):
    w = run.trace_window
    if w is None or not w.ops:
        return None
    return 100.0 * w.idle_share()
