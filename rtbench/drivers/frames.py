"""Driver ``frames``: whole frames as the CLI and the viewer render them.

A frame is ``Renderer.render_frame(camera)`` then ``update_result()``
(raygen, the primary trace, the secondary batches with their sort, the
traces, the reconstruction and the image's copy to the host), in a closed
loop over the mix's camera poses.  ``frame_ms`` is the window's wall time
over the frames completed; ``frame_ms_p95`` the 95th percentile of each
frame's own wall time.  The program's ``phase_s`` spans give the layers'
times per frame.

Set-up gives the renderer the scene and renders one frame under the span
``setup.renderer_s``: the renderer's own SBVH load (or build), quad
collapse, device tables, routing tracer and kernel library, and the first
frame's launches.  The rest of the poses' frames warm up after it.

For the judge, each pose keeps the image of its last frame in the window,
and ``CHECK_PIXELS`` of its pixels drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from rtbench import paths, profile
from rtbench.drivers import common
from rtbench.port import port_mesh

PHASES = ("raygen", "sort", "trace", "reconstruct")
CHECK_PIXELS = 1024  # judged pixels of each pose


class Driver(common.Driver):
    def prepare(self):
        from tpu_rt_torch.renderer import Renderer, RendererParams
        from tpu_rt_torch.scene import Scene

        mix = self.mix
        t0 = time.perf_counter()
        if self.shared is None:
            self.shared = Scene(port_mesh(self.mesh))
        params = RendererParams(
            ray_type=mix["ray_type"], ao_radius=self.radius, num_samples=mix["samples"],
            sort_secondary=mix["sort_secondary"], max_batch=mix["max_batch"],
            seed=self.ao_seed, cache_dir=paths.BVH_DIR, tracer=self.config["tracer"],
            device=str(self.device))
        self.renderer = Renderer(mix["width"], mix["height"], params)
        self.renderer.set_scene(self.shared)
        for p, cam in enumerate(self.port_cams):
            self.renderer.render_frame(cam)
            self.renderer.update_result()
            if p == 0:
                self.spans["setup.renderer_s"] = time.perf_counter() - t0
        n = mix["width"] * mix["height"]
        self.check = [np.sort(self.rng.choice(n, size=min(CHECK_PIXELS, n), replace=False))
                      for _ in self.cams]
        self.kept = [None] * len(self.cams)

    def _frame(self, p: int):
        r = self.renderer
        t0 = time.perf_counter()
        r.render_frame(self.port_cams[p])
        image = r.update_result()
        return time.perf_counter() - t0, dict(r.phase_s), image

    def window(self, seconds: float) -> dict:
        times = []
        phases = dict.fromkeys(PHASES, 0.0)
        np_ = len(self.cams)
        t0 = time.perf_counter()
        end = t0 + seconds
        # Whole cycles over the poses, so that each pose weighs alike.
        while time.perf_counter() < end or len(times) % np_:
            p = len(times) % np_
            dt, ph, image = self._frame(p)
            times.append(dt)
            for k in PHASES:
                phases[k] += ph[k]
            self.kept[p] = image
        wall = time.perf_counter() - t0
        n = len(times)
        self.attempted = n
        for k in PHASES:
            self.spans[f"frame.{k}_s"] = phases[k]
        self.counters["frames"] = n
        return {"frame_ms": wall / n * 1e3,
                "frame_ms_p95": float(np.percentile(np.asarray(times) * 1e3, 95))}

    def traced(self, seconds: float, rec: dict) -> None:
        np_ = len(self.cams)
        with profile.Profile(self.device) as prof:
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() < t0 + seconds:
                self._frame(n % np_)
                n += 1
        rec["trace"] = prof.summary
        rec["counters"]["traced_frames"] = n

    def outputs(self):
        items = {"pose": [], "pixel": []}
        pixels = []
        for p, idx in enumerate(self.check):
            items["pose"].append(np.full(len(idx), p))
            items["pixel"].append(idx)
            img = self.kept[p].reshape(-1, 4)
            pixels.append(img[idx].astype(np.float64))
        return ({k: np.concatenate(v) for k, v in items.items()}, np.concatenate(pixels))

    def free(self):
        self.renderer.free()
        self.renderer = self.shared = None

    def judge(self, ref, items, answers) -> dict:
        from rtbench.reference import judge

        return judge.judge_frames(ref, self.cams, self.mix, items, answers, self.ao_seed,
                                  self.radius)

    def control(self, ref, items):
        from rtbench.reference import control

        return control.frame_pixels(ref, self.cams, self.mix, items, self.ao_seed, self.radius)

    def units(self, items) -> np.ndarray:
        return items["pose"]
