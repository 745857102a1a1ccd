"""Helpers the per-layer readers share."""


def per(rec: dict, span: str, count: str, scale: float):
    """A span's seconds per counted unit, times ``scale``; None when the run
    counted none."""
    n = rec["counters"].get(count, 0)
    if span not in rec["spans"] or not n:
        return None
    return rec["spans"][span] / n * scale


def idle_pct(rec: dict):
    """The traced window's share with no device operation running; None
    when the trace holds no device operation."""
    tr = rec.get("trace") or {}
    if not tr.get("busy_s"):
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
