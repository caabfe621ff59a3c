"""Pages completed over all of the window's time (host clock)."""


def read(run):
    return run.pages / run.window_s if run.window_s > 0 else None
