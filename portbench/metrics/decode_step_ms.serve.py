"""Mean wall ms of an engine step that admitted no prefill, on the
host's clock, over the window's steps that the profiler did not record:
``models/transformer.decode_step`` end to end, with the host's enqueue,
the tokens read back and the engine's bookkeeping."""


def read(run):
    walls = [s["wall_s"] for s in run.host.get("engine_steps", ())
             if s["prefills"] == 0 and s["decoded"] > 0 and not s["traced"]]
    return 1e3 * sum(walls) / len(walls) if walls else None
