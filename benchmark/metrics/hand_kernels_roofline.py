"""The program's hand kernels against their least time, in %: the sum
over its kernel entries of calls (its launch counters, wherever the
program keeps them) times the least time of one call at the cell's
shapes (`bounds.WORK`), over the device time of every kernel of its own
library in the traced window (told from PyTorch's by origin, not by
name). Where an entry ran that has no work model, the work would be
counted short: nothing is read, and the reason is logged."""

from benchmark import devicetrace as trace
from benchmark.bounds import entry_seconds
from benchmark.harness import log


def read(run):
    if run.trace is None:
        return None
    spent = trace.kernel_seconds(run.trace, run.window_s, from_program=True)
    if spent <= 0:
        return None
    b, h, w = run.shape
    ran = {e: n for e, n in run.counters.items() if n}
    unknown = sorted(e for e in ran if entry_seconds(e, b, h, w) is None)
    if unknown:
        log(f"hand_kernels_roofline not read: no work model for the "
            f"kernel entries {unknown}")
        return None
    least = sum(n * entry_seconds(e, b, h, w) for e, n in ran.items())
    return 100.0 * least / spent if least > 0 else None
