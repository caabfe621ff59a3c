"""Host time the runner spent staging chunks (the program's spans
`runner.stage_in`: padding, the pinned copy, issuing the copies to the
card; `runner.stage_out`: the pinned output, issuing the copies back),
ms a page."""

from benchmark.program_spans import host_seconds, per_page


def read(run):
    return per_page(run, host_seconds(
        run, ("runner.stage_in", "runner.stage_out")))
