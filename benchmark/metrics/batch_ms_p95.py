"""The 95th percentile over every batch call of the window, from issue
to the output being ready (host clock, until a synchronize returns)."""

import statistics


def read(run):
    if len(run.batch_ms) < 20:
        return None
    return statistics.quantiles(run.batch_ms, n=20)[18]
