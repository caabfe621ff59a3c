"""Host time of the compiled pipeline's calls (the benchmark's span from
the call until it returns, before any synchronize; the floods' host
reads included), ms a page."""


def read(run):
    if not run.pages or "pipeline" not in run.spans.by_name:
        return None
    return 1e3 * run.span_seconds("pipeline") / run.pages
