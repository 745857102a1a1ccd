"""The entries a ray's traversal stack held at once, on average over the
cell's batches, each traced once after the traced window (the stats pass of
``drivers/primary_stats.py``): the port's sum of each ray's stack
high-water (``tpu_rt_torch.trace`` ``count_stats``), ``trace.stack_entries
/ trace.stats_rays``.  The kernels' stack holds 64 entries.  A port without
that counter gives nothing."""


def read(rec: dict):
    c = rec["counters"]
    if not c.get("trace.stats_rays") or "trace.stack_entries" not in c:
        return None
    return c["trace.stack_entries"] / c["trace.stats_rays"]
