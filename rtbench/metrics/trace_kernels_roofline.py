"""The trace kernels' share of their least time, in %.

Least time: the bytes any implementation must move, each ray read once
(origin, direction, tmin, tmax: 32 B) and each hit written once (triangle
and t: 8 B), over the card's HBM rate (``rtbench/peaks.py``).  Kernel time:
the traced window's device time of the traversal kernels by name
(``quad_*`` / ``flat_*`` kernels).  No operation term yet: the port's node
and triangle tests depend on the tree it built."""

import re

from rtbench import peaks

KERNEL = re.compile(r"\b(quad|flat)_\w*kernel")
BYTES_PER_RAY = 32 + 8


def read(rec: dict):
    tr = rec.get("trace") or {}
    spent = sum(s for name, s in tr.get("device_ops", {}).items() if KERNEL.search(name))
    rays = rec["counters"].get("trace_rays", 0)
    if spent <= 0 or not rays:
        return None
    return rays * BYTES_PER_RAY / peaks.HBM_BYTES_PER_S / spent * 100.0
