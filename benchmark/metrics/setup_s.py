"""Seconds from the run's start to the window's opening: loading, the
first build of the kernels, the inputs made from the seed, warm calls."""


def read(run):
    return run.setup_s
