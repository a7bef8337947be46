"""95th percentile of submit to first token over the requests submitted in
the window, on the client's clock."""

import statistics


def read(run):
    t0, t1 = run.extra["t0"], run.extra["t1"]
    ttft = [1e3 * (q.times[0] - q.submitted) for q in run.extra["requests"]
            if t0 <= q.submitted < t1 and q.times]
    if len(ttft) < 2:
        return None
    return statistics.quantiles(ttft, n=100, method="inclusive")[94]
