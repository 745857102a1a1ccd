"""Seconds of the set-up span ``setup.kernels_s`` (``rtbench/port.py``
``Port``: the routing tracer, its quad collapse and device tables, up to the
end of its first launch, which builds or loads the kernel library)."""


def read(rec: dict):
    return rec["spans"].get("setup.kernels_s")
