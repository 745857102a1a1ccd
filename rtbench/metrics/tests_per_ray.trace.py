"""Node and triangle tests per ray over the cell's batches, each traced
once after the traced window (``drivers/diffuse.py``'s stats pass): the
port's sums of the kernels' per-ray counters (``tpu_rt_torch.trace``
``count_stats``), ``(trace.node_tests + trace.tri_tests) /
trace.stats_rays``.  A port without those counters gives nothing."""


def read(rec: dict):
    c = rec["counters"]
    if not c.get("trace.stats_rays"):
        return None
    return (c["trace.node_tests"] + c["trace.tri_tests"]) / c["trace.stats_rays"]
