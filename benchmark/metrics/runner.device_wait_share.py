"""Share of the window the runner's host waited for the card (the
program's spans `runner.wait_loaded`, on the copies to the card, and
`runner.wait_done`, on a chunk's compute and copies back), in %."""

from benchmark.program_spans import host_seconds


def read(run):
    s = host_seconds(run, ("runner.wait_loaded", "runner.wait_done"))
    if s is None or run.window_s <= 0:
        return None
    return 100.0 * s / run.window_s
