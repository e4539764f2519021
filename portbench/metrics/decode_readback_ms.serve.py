"""Mean wall ms of the program's ``engine.readback`` span per engine step:
the sampled tokens copied to the host, which waits for the device to
finish the step."""
from portbench import program_spans


def read(run):
    recs = program_spans.of("engine.readback")
    if not recs:
        return None
    return sum(map(program_spans.wall_ms, recs)) / len(recs)
