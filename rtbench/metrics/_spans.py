"""What the readers of the program's own spans share.

The program records its spans (``tpu_rt_torch.spans``) while
``torch.profiler`` runs, so after a ``--trace 1`` run its snapshot holds
the traced window's spans alone: the set-up, the timed window and the
wrapper's lone calls after the traced window run with the profiler off.
A run without a traced window, a program without the recorder, or a window
that filled the recorder (its counter ``spans.dropped``: spans lost) gives
nothing to read.
"""


def records(rec: dict):
    """The program's span records ``(name, parent, start_ns, end_ns)`` of the
    traced window, or None."""
    if not rec.get("trace"):
        return None
    try:
        from tpu_rt_torch import spans
    except ImportError:
        return None
    snap = spans.snapshot()
    if snap["counters"].get("spans.dropped"):
        return None
    return snap["spans"]


def under(recs: list, i: int, name: str) -> bool:
    """Whether a span called ``name`` encloses record ``i``."""
    p = recs[i][1]
    while p >= 0:
        if recs[p][0] == name:
            return True
        p = recs[p][1]
    return False


def closed(recs: list, keep) -> list:
    """Seconds of each finished record ``i`` for which ``keep(i, name)``."""
    return [(r[3] - r[2]) * 1e-9 for i, r in enumerate(recs)
            if r[3] is not None and keep(i, r[0])]


def per_frame_ms(rec: dict, keep):
    """Milliseconds of the kept spans over the window's ``frame`` spans;
    None where it holds no frame."""
    recs = records(rec)
    if not recs:
        return None
    frames = len(closed(recs, lambda i, n: n == "frame"))
    if not frames:
        return None
    return sum(closed(recs, keep)) / frames * 1e3
