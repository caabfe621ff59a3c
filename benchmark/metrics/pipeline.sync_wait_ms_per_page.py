"""Host time the pipeline spent in its host reads (the program's
`sync.*` spans: each read, and the wait for the card's queued work it
makes), ms a page. 0 where the program's pipeline spans are in the
window and no read is."""

from benchmark.program_spans import host_seconds, per_page, spans


def read(run):
    if not spans(run, ("pipeline",)):
        return None
    return per_page(run, host_seconds(run, ("sync.",)) or 0.0)
