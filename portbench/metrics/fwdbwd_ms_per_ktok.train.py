"""Device ms of the forward and backward (``train/step.loss_and_grads``),
per 1000 tokens."""


def read(run):
    recs = run.of("fwdbwd")
    tokens = sum(r["tokens"] for r in recs)
    busy = sum(run.device_s(r) for r in recs)
    if not tokens or busy <= 0:
        return None
    return busy * 1e6 / tokens
