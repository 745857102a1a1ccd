"""The device's idle share of the traced window, in %: the window's wall
time less the union of its device operations (profiler timeline)."""

from rtbench.metrics._util import idle_pct


def read(rec: dict):
    return idle_pct(rec)
