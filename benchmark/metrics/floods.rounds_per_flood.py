"""Rounds an 8-connected flood took (the program's `flood.rounds` counts
over its `flood` spans in the window: the packed flood's rounds, the
sweep flood's launches)."""

from benchmark.program_spans import counts_in, spans


def read(run):
    floods = spans(run, ("flood",))
    if not floods:
        return None
    return counts_in(run, "flood.rounds", floods) / len(floods)
