"""Driver ``diffuse``: the reference App's measurement loop (App.cc:188-204)
on diffuse batches, closest hit.

Set-up traces each pose's primary rays closest hit, then makes its diffuse
batches of up to ``max_batch`` rays with the port's ``RayGen.ao`` and the
camera's far as ``max_dist``, as ``Renderer::nextBatch``'s diffuse branch
does (Renderer.cc:274-279).  The window and the judged sample are the trace
driver's (``drivers/trace.py``, whose ``CHECK_RAYS`` and ``HOST_CALLS`` it
reads), the calls closest hit, counting each batch's live rays.

After the traced window, the stats pass: each batch routed once
``with_stats=True``, recording off, so that it adds no span to the window.
The port sums the kernels' per-ray counters into its recorder's counters
(``trace.stats_rays``, ``trace.node_tests``, ``trace.tri_tests``,
``trace.warp_tests``); what the pass added goes into the record for
``tests_per_ray.trace`` and ``simt_efficiency.trace``.  A port without
those counters adds none, and the two read nothing.
"""

from __future__ import annotations

import numpy as np

from rtbench.drivers import trace
from rtbench.port import Port

STATS = ("trace.stats_rays", "trace.node_tests", "trace.tri_tests", "trace.warp_tests")


class Driver(trace.Driver):
    def prepare(self):
        import torch

        from tpu_rt_torch.raygen import RayGen

        mix = self.mix
        if self.shared is None:
            self.shared = Port(self.mesh, self.config, self.device, self.spans)
        port = self.port = self.shared
        self.any_hit = False
        self.batches = []
        for p, cam in enumerate(self.port_cams):
            gen = RayGen(mix["max_batch"])
            rays, _, _ = gen.primary(cam, mix["width"], mix["height"], device=port.device)
            hits = port.route(port.tables, rays, any_hit=False)
            first = True
            while (out := gen.ao(rays, hits, port.tri_normal, mix["samples"], float(cam.far),
                                 first, seed=self.ao_seed)) is not None:
                first = False
                batch, _, _, (lo, _) = out
                live = int((batch.tmax >= 0).sum())
                self.batches.append({"pose": p, "lo": lo, "rays": batch, "count": live})
        port.sync()
        for b in self.batches:
            n = b["rays"].num
            b["check"] = np.sort(self.rng.choice(n, size=min(trace.CHECK_RAYS, n),
                                                 replace=False))
        self.route, self.tables = port.route, port.tables
        self.counts = [b["count"] for b in self.batches]
        self.rays = [b["rays"] for b in self.batches]
        for r in self.rays:
            self.route(self.tables, r, any_hit=False)
        port.sync()
        self.events = [torch.cuda.Event() if port.device.type == "cuda" else None
                       for _ in range(trace.IN_FLIGHT)]

    def traced(self, seconds: float, rec: dict) -> None:
        from tpu_rt_torch import spans

        super().traced(seconds, rec)
        before = spans.snapshot()["counters"]
        for r in self.rays:
            self.route(self.tables, r, any_hit=False, with_stats=True)
        after = spans.snapshot()["counters"]
        rec["counters"].update({k: after[k] - before.get(k, 0) for k in STATS if k in after})

    def outputs(self) -> dict:
        """The trace driver's items, each slot the primary ray its diffuse
        ray came from, with its sample."""
        items, answers = super().outputs()
        s = self.mix["samples"]
        idx = items["slot"]
        lo = np.array([b["lo"] for b in self.batches])[items["batch"]]
        items["slot"], items["sample"] = lo + idx // s, idx % s
        return items, answers

    def judge(self, ref, items, answers) -> dict:
        from rtbench.reference import diffuse

        return diffuse.judge_diffuse(ref, self.cams, self.mix, items, answers, self.ao_seed)

    def control(self, ref, items):
        from rtbench.reference import diffuse

        return diffuse.control_answers(ref, self.cams, self.mix, items, self.ao_seed)
