"""Milliseconds per frame of the renderer's ``phase_s["sort"]``, over the
window's frames; none when the frames spent no time there."""

from rtbench.metrics._util import per


def read(rec: dict):
    v = per(rec, "frame.sort_s", "frames", 1e3)
    return v if v else None
