"""Share of the window the runner spent in calls of its page source
(the benchmark's span around each call), in %."""


def read(run):
    if run.window_s <= 0 or "source" not in run.spans.by_name:
        return None
    return 100.0 * run.span_seconds("source") / run.window_s
