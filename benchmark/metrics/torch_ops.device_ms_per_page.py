"""Device time of PyTorch's own kernels (those an ATen operator
launched: the block statistics, swt's plain-torch passes, the bitmap
conversions) in the traced window, ms a page completed."""

from benchmark import devicetrace as trace


def read(run):
    if run.trace is None or not run.pages:
        return None
    s = trace.kernel_seconds(run.trace, run.window_s, from_program=False)
    return 1e3 * s / run.pages if s > 0 else None
