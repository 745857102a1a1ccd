"""Driver ``diffuse_frames``: the ``frames`` driver's whole frames
(``drivers/frames.py``: the renderer's set-up, the closed loop over the
poses in whole cycles, ``frame_ms`` and ``frame_ms_p95``, the phases, the
judged pixels) on diffuse rays, judged by the diffuse frame reference
(``reference/diffuse_frames.py``) with each pose's far.

The traced window also counts the rays its frames traced into
``trace_rays``: W x H a frame for the primary pre-trace, plus the frame's
secondary rays (``Renderer.rays_traced``), for
``trace_kernels_roofline.frame``.  After it, with recording off, the stats
pass: each pose rendered once more, and its batches routed once more
``with_stats`` (``Renderer.frame_stats``).  What the port's counters gained
in it goes into the record (``trace.stats_rays``, ``trace.node_tests``,
``trace.tri_tests``, ``trace.warp_tests``, ``trace.stack_entries``), for
``tests_per_ray.frame`` and ``simt_efficiency.frame``.  A port whose
renderer has no ``frame_stats`` adds none, and those two read nothing.
"""

from __future__ import annotations

import time

from rtbench import profile
from rtbench.drivers import diffuse, frames

STATS = diffuse.STATS + ("trace.stack_entries",)


class Driver(frames.Driver):
    def traced(self, seconds: float, rec: dict) -> None:
        from tpu_rt_torch import spans

        r = self.renderer
        np_ = len(self.cams)
        primary = self.mix["width"] * self.mix["height"]
        n = rays = 0
        with profile.Profile(self.device) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() < t0 + seconds:
                self._frame(n % np_)
                rays += primary + r.rays_traced
                n += 1
        rec["trace"] = prof.summary
        rec["counters"].update(traced_frames=n, trace_rays=rays)
        stats = getattr(r, "frame_stats", None)
        if stats is None:
            return
        before = spans.snapshot()["counters"]
        for cam in self.port_cams:
            r.render_frame(cam)
            stats()
        after = spans.snapshot()["counters"]
        rec["counters"].update({k: after[k] - before.get(k, 0) for k in STATS if k in after})

    def judge(self, ref, items, answers) -> dict:
        from rtbench.reference import diffuse_frames

        return diffuse_frames.judge_diffuse_frames(ref, self.cams, self.mix, items, answers,
                                                   self.ao_seed, self.mesh.tri_diffuse())

    def control(self, ref, items):
        from rtbench.reference import diffuse_frames

        return diffuse_frames.control_pixels(ref, self.cams, self.mix, items, self.ao_seed,
                                             self.mesh.tri_diffuse())
