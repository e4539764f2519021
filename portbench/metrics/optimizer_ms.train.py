"""Device ms of the AdamW update (``optim/optimizers.adamw_update``), per
step."""


def read(run):
    recs = run.of("optimizer")
    busy = sum(run.device_s(r) for r in recs)
    if not recs or busy <= 0:
        return None
    return busy * 1e3 / len(recs)
