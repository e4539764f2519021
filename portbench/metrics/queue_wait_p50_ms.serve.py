"""Median ms a request waited in ``SlotServer.queue``, from ``submit`` to the
start of its prefill: the program's ``engine.queue`` spans, over the
requests admitted in the traced window (a median: the window admits ~20)."""
import statistics

from portbench import program_spans


def read(run):
    recs = program_spans.of("engine.queue")
    if not recs:
        return None
    return statistics.median(program_spans.wall_ms(r) for r in recs)
