"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of their intervals), in %."""

from benchmark import devicetrace as trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(run.trace, run.window_s)
                    / run.window_s)
