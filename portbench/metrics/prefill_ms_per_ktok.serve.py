"""Device ms of every prefill (``models/transformer.prefill``) in the
traced window, per 1000 prompt tokens."""


def read(run):
    recs = run.of("prefill")
    tokens = sum(r["tokens"] for r in recs)
    busy = sum(run.device_s(r) for r in recs)
    if not tokens or busy <= 0:
        return None
    return busy * 1e6 / tokens
