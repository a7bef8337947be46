"""The window's length over the decode forwards the engine ran in it
(``stats()['decode_forwards']``): one forward advances every active slot
by one token."""


def read(run):
    n = run.extra["stats1"]["decode_forwards"] - run.extra["stats0"][
        "decode_forwards"]
    if n <= 0:
        return None
    return 1e3 * run.window_s / n
