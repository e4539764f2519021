"""The program's own spans (``repro_torch.spans``), for the readers of
per-layer metrics.  The program records them only while a profiler
records, so in a ``--trace 1`` run they are the traced window's.  A
program without them (an older commit) gives None, and the reader then
reports nothing."""


def of(name: str):
    """The program's records named ``name``, or None where it has no spans."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return [r for r in spans.records() if r["name"] == name]


def wall_ms(rec: dict) -> float:
    """A record's wall time on the host's clock."""
    return (rec["t1_ns"] - rec["t0_ns"]) * 1e-6


def device_ms_per_ktok(name: str):
    """Device ms of every ``name`` record per 1000 of their tokens; None off
    the card, where the records carry no device time."""
    recs = of(name)
    if not recs or any(r["device_ms"] is None for r in recs):
        return None
    tokens = sum(r["attrs"]["tokens"] for r in recs)
    return sum(r["device_ms"] for r in recs) * 1e3 / tokens if tokens else None
