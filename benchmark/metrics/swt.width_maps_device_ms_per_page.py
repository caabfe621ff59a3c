"""Stream time of SWT's width maps (the program's span `swt.width_maps`,
timed by CUDA events on its stream), ms a page."""

from benchmark.program_spans import per_page, stream_seconds


def read(run):
    return per_page(run, stream_seconds(run, ("swt.width_maps",)))
