"""Driver ``primary_stats``: the trace driver's primary rays
(``drivers/trace.py``: the loop, the count of W x H a call, the judge),
with ``drivers/diffuse.py``'s stats pass after the traced window.

The stats pass routes each batch once ``with_stats=True``, closest hit,
recording off, so that it adds no span to the window.  What the port's
counters gained in it goes into the record: ``trace.stats_rays``,
``trace.node_tests``, ``trace.tri_tests``, ``trace.warp_tests`` (read by
``tests_per_ray.trace`` and ``simt_efficiency.trace``) and
``trace.stack_entries``, the sum of each ray's stack high-water (read by
``stack_per_ray.trace``).  A port without a counter adds none, and its
reader reads nothing.

The record also gets the routed tree's size, which no metric reads:
``tables.depth`` (its levels), ``tables.nodes`` (node records) and
``tables.woop_rows``.

Importing this driver registers the hairball scene (``rtbench/data/
hairball.py``), so that the set-up finds its generator and framing.
"""

from __future__ import annotations

from rtbench.data import hairball  # noqa: F401  (registers the scene)
from rtbench.drivers import diffuse, trace

STATS = diffuse.STATS + ("trace.stack_entries",)


class Driver(trace.Driver):
    def traced(self, seconds: float, rec: dict) -> None:
        from tpu_rt_torch import spans

        super().traced(seconds, rec)
        before = spans.snapshot()["counters"]
        for r in self.rays:
            self.route(self.tables, r, any_hit=self.any_hit, with_stats=True)
        after = spans.snapshot()["counters"]
        rec["counters"].update({k: after[k] - before.get(k, 0) for k in STATS if k in after})
        t = self.tables
        rec["counters"].update({"tables.depth": int(t.depth), "tables.nodes": t.nodes.shape[0],
                                "tables.woop_rows": t.woop.shape[0]})
