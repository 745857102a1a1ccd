"""Frame orchestrator — counterpart of ``tpu_rt.renderer.Renderer`` (the
reference's src/rt/cuda/Renderer.cc) for primary rays: owns the scene, the
BVH (with cache), the ray generator and the tracer, and runs the
begin_frame / next_batch / trace_batch / update_result cycle on one torch
device.

Trace time is kernel-only: on a CUDA device it is read from CUDA events
recorded around the trace call; on the CPU (tests) from the host clock
around the plain version.  AO and diffuse frames are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu_rt_torch.bvh import BuildParams, Platform, load_or_build_bvh
from tpu_rt_torch.core.math import to_abgr
from tpu_rt_torch.core.types import Hits, Rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.scene import Camera, Scene
from tpu_rt_torch.shade import reconstruct_image
from tpu_rt_torch.trace import make_routing_tracer

RAY_TYPES = ("primary",)


@dataclass
class RendererParams:
    """Reference Renderer::Params (Renderer.hh:54-76), primary-ray subset."""

    ray_type: str = "primary"
    cache_dir: str | None = "bvhcache"
    # "auto": the 4-wide BVH kernel on a CUDA device, its plain PyTorch
    # version on the CPU (tpu_rt_torch.trace.make_routing_tracer).
    tracer: str = "auto"
    device: str = "cpu"


@dataclass
class BatchRecord:
    rays: Rays
    hits: Hits | None
    slot_to_id: torch.Tensor
    id_to_slot: torch.Tensor


class Renderer:
    def __init__(self, width: int = 640, height: int = 480, params: RendererParams | None = None):
        self.width = width
        self.height = height
        self.params = params or RendererParams()
        if self.params.ray_type not in RAY_TYPES:
            raise NotImplementedError(
                f"ray_type {self.params.ray_type!r} is not ported to tpu_rt_torch yet "
                "(ROADMAP.md); only 'primary'")
        self.device = torch.device(self.params.device)
        self.platform = Platform.gpu()
        self.build_params = BuildParams()
        self.raygen = RayGen()
        self.scene: Scene | None = None
        self.flat = None
        self.bvh_stats = None
        self.trace_time_s = 0.0
        self.rays_traced = 0

    # -- setup ---------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        self.set_scene(Scene(mesh))

    def set_scene(self, scene: Scene) -> None:
        self.scene = scene
        self.flat = None

    def _ensure_bvh(self) -> None:
        if self.flat is None:
            if self.scene is None:
                raise RuntimeError("set_mesh/set_scene first")
            self.flat, self.bvh_stats = load_or_build_bvh(
                self.scene, self.platform, self.build_params, cache_dir=self.params.cache_dir)
            self._tri_shaded_dev = torch.as_tensor(self.scene.tri_shaded, device=self.device)
            self._tri_material_dev = torch.as_tensor(self.scene.tri_material, device=self.device)
            self.routing, self.active_tracer, self.tracer_tables = make_routing_tracer(
                self.flat, prefer=self.params.tracer, device=self.device,
                cache_dir=self.params.cache_dir)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- frame cycle ---------------------------------------------------------

    def begin_frame(self, camera: Camera) -> None:
        """BVH setup + primary raygen, reference Renderer::beginFrame
        (Renderer.cc:112-152)."""
        self._ensure_bvh()
        self.camera = camera
        self.phase_s = {"raygen": 0.0, "sort": 0.0, "trace": 0.0, "reconstruct": 0.0}
        t0 = time.perf_counter()
        rays, s2i, i2s = self.raygen.primary(camera, self.width, self.height, device=self.device)
        self._sync()
        self.phase_s["raygen"] += time.perf_counter() - t0
        self.primary = BatchRecord(rays=rays, hits=None, slot_to_id=s2i, id_to_slot=i2s)
        self.trace_time_s = 0.0
        self.rays_traced = 0
        self._new_batch = True
        self._batch: BatchRecord | None = None

    def _timed_trace(self, rays: Rays) -> Hits:
        """Trace with kernel-only timing, the Mray/s metric discipline
        (App.cc:188-204: trace time only)."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hits = self.routing(self.tracer_tables, rays)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            hits = self.routing(self.tracer_tables, rays)
            dt = time.perf_counter() - t0
        self.phase_s["trace"] += dt
        self.trace_time_s += dt
        self.rays_traced += rays.num
        return hits

    def get_total_num_rays(self) -> int:
        """Ray budget of the frame (Renderer.cc:221-238): the primary count."""
        return self.width * self.height

    def next_batch(self) -> bool:
        """Generate the next trace batch (Renderer::nextBatch,
        Renderer.cc:242-291): primary rays are one batch."""
        if not self._new_batch:
            return False
        self._new_batch = False
        self._batch = self.primary
        return True

    def trace_batch(self) -> float:
        """Trace the current batch; returns elapsed seconds (kernel only)."""
        if self._batch is None:
            raise RuntimeError("next_batch() first")
        t0 = self.trace_time_s
        self._batch.hits = self._timed_trace(self._batch.rays)
        return self.trace_time_s - t0

    def render_frame(self, camera: Camera) -> dict:
        """Full frame: begin_frame + batch loop.  Returns timing/ray stats;
        the Mray/s numerator is W x H (App.cc:188-204), the denominator the
        kernel-only trace time.  ``timer`` says which clock timed the trace:
        "cuda_event" on a CUDA device, "host" on the CPU."""
        self.begin_frame(camera)
        total_rays = self.get_total_num_rays()
        while self.next_batch():
            self.trace_batch()
        mrays_per_s = (total_rays / (self.trace_time_s * 1e6)
                       if self.trace_time_s > 0 else float("inf"))
        return {
            "total_rays": total_rays,
            "rays_traced": self.rays_traced,
            "trace_time_s": self.trace_time_s,
            "mrays_per_s": mrays_per_s,
            "phase_s": dict(self.phase_s),
            "tracer": self.active_tracer,
            "device": str(self.device),
            "timer": "cuda_event" if self.device.type == "cuda" else "host",
        }

    # -- reconstruction ------------------------------------------------------

    def update_result(self) -> np.ndarray:
        """Reconstruct the frame RGBA image [h, w, 4] f32 on the host
        (Renderer::updateResult, Renderer.cc:421-445)."""
        t0 = time.perf_counter()
        hits = self.primary.hits
        image = reconstruct_image(
            self.primary.slot_to_id, hits.tri, self.primary.id_to_slot, hits.tri,
            self._tri_shaded_dev, self._tri_material_dev, "primary", 1,
            self.width * self.height)
        out = image.cpu().numpy().reshape(self.height, self.width, 4)
        self.phase_s["reconstruct"] += time.perf_counter() - t0
        return out

    def update_result_u32(self) -> np.ndarray:
        """ABGR8 image [h, w] u32, the reference's display format."""
        return to_abgr(self.update_result())
