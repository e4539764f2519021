"""Mean wall ms of the program's ``engine.decode`` span per engine step: the
host's enqueue of ``transformer.decode_step`` and the argmax, up to the
return of the last launch."""
from portbench import program_spans


def read(run):
    recs = program_spans.of("engine.decode")
    if not recs:
        return None
    return sum(map(program_spans.wall_ms, recs)) / len(recs)
