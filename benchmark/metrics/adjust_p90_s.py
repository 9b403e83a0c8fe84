"""adjust_p90_s: the 90th percentile of the seconds of every adjustment
in the window (`statistics.quantiles`, n = 10), start upload to the
answer on the host."""

import statistics


def read(run):
    t = [r["seconds"] for r in run.completed()]
    return statistics.quantiles(t, n=10)[8] if len(t) >= 2 else None
