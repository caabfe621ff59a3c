"""Stream time of the unpaper filters' block statistics (the program's
span `unpaper.block_stats`, outermost only: window sums and coverage,
timed by CUDA events on their stream), ms a page."""

from benchmark.program_spans import per_page, stream_seconds


def read(run):
    return per_page(run, stream_seconds(run, ("unpaper.block_stats",)))
