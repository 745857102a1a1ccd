"""Frame orchestrator — counterpart of ``tpu_rt.renderer.Renderer`` (the
reference's src/rt/cuda/Renderer.cc): owns the scene, the BVH (with cache),
the ray generator and the tracer, and runs the begin_frame / next_batch /
trace_batch / update_result cycle on one torch device, for primary, AO and
diffuse rays.

Trace time is kernel-only: on a CUDA device it is read from CUDA events
recorded around each trace call and summed over the batches; on the CPU
(tests) from the host clock around the plain version.  As in ``tpu_rt``,
the seed is explicit and batch results are kept on the device until one
reconstruction over the frame.  ``RendererParams.tracer`` picks the route
(``tpu_rt_torch.trace.make_routing_tracer``): the 4-wide or the binary
traversal kernel, or the wavefront tracer (``"xla"``).  Secondary batches
can be Morton-sorted (``sort_secondary``, the 30-bit coarse key) or sorted
dead-last with only the live prefix traced (``compact_degenerate``), on the
device (``tpu_rt_torch.rays.buffer``); the sort's time goes to
``phase_s["sort"]``, never to the trace time.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu_rt_torch.bvh import BuildParams, Platform, load_or_build_bvh
from tpu_rt_torch.core.math import to_abgr
from tpu_rt_torch.core.types import Hits, Rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.rays.buffer import (
    inverse_permutation,
    morton_sort_device_coarse,
    permute_rays,
    sort_dead_last_device,
    trace_live_prefix,
)
from tpu_rt_torch.scene import Camera, Scene
from tpu_rt_torch.shade import count_hits, reconstruct_image
from tpu_rt_torch.trace import TRACERS, check_cursors, make_routing_tracer, release_persisting_l2

RAY_TYPES = ("primary", "ao", "diffuse")


@dataclass
class RendererParams:
    """Reference Renderer::Params (Renderer.hh:54-76)."""

    ray_type: str = "primary"
    ao_radius: float = 5.0
    num_samples: int = 8
    # Off by default, as in tpu_rt (the reference's committed benchmark
    # forces sortSecondary off, App.cc:157): Morton-sort each secondary
    # batch by the coarse 30-bit origin key before it is traced.
    sort_secondary: bool = False
    # Sort degenerate (primary-miss, tmax < 0) rays to the end of each
    # secondary batch and trace only the live prefix (rays/buffer.py
    # sort_dead_last_device / trace_live_prefix); implies the sort.
    compact_degenerate: bool = False
    # Output rays per secondary batch (Renderer.cc:46).
    max_batch: int = 1 << 21
    seed: int = 0
    cache_dir: str | None = "bvhcache"
    # One of TRACERS: "auto" / "packet4" the 4-wide BVH kernel, "packet"
    # the binary one, "pallas" 4-wide then binary -- each the CUDA kernel on
    # a CUDA device, its plain PyTorch version on the CPU -- or "xla" the
    # wavefront tracer (tpu_rt_torch.trace.make_routing_tracer).
    tracer: str = "auto"
    # "cuda" launches the kernels; "cpu" runs their plain versions (no
    # fallback from one to the other).
    device: str = "cuda"
    # The triangle phase (tpu_rt's TPU_RT_MXU and TPU_RT_C): the binary
    # kernel's tensor-core leaf test (tracer "packet" only), and the leaves
    # a ray holds before it drains them (1..4; make_routing_tracer).
    mxu: bool = False
    cursors: int = 1
    # Directory for a torch.profiler trace of each render_frame, exported as
    # a Chrome trace (None = off).
    profile_dir: str | None = None


@dataclass
class BatchRecord:
    rays: Rays
    hits: Hits | None
    slot_to_id: torch.Tensor
    id_to_slot: torch.Tensor
    input_range: tuple[int, int]


class Renderer:
    def __init__(self, width: int = 640, height: int = 480, params: RendererParams | None = None):
        self.width = width
        self.height = height
        self.params = params or RendererParams()
        p = self.params
        if p.ray_type not in RAY_TYPES:
            raise ValueError(f"ray_type {p.ray_type!r} not in {RAY_TYPES}")
        if p.tracer not in TRACERS:
            raise ValueError(f"tracer {p.tracer!r} not in {TRACERS}")
        check_cursors(p.cursors)
        if p.mxu and p.tracer != "packet":
            raise ValueError(f"mxu=True needs tracer='packet', not {p.tracer!r}")
        self.device = torch.device(p.device)
        self.platform = Platform.gpu()
        self.build_params = BuildParams()
        self.raygen = RayGen(p.max_batch)
        self.scene: Scene | None = None
        self.tracer_tables = None
        self._drop_bvh()
        self.trace_time_s = 0.0
        self.rays_traced = 0
        self.rays_skipped = 0
        self.batch_trace_s: list[float] = []
        self.setup_s = 0.0

    # -- setup ---------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        self.set_scene(Scene(mesh))

    def set_scene(self, scene: Scene) -> None:
        self.scene = scene
        self._drop_bvh()

    def set_build_params(self, params: BuildParams) -> None:
        """Build the scene's SBVH with ``params`` from the next frame on
        (``tpu_rt``'s ``Renderer.set_build_params``): the tree, its stats,
        the routing tracer and the device tables are dropped, and the next
        ``begin_frame`` loads or builds them again under a cache key that
        hashes ``params``."""
        self.build_params = params
        self._drop_bvh()

    def free(self) -> None:
        """Let go of the device memory the renderer holds: the tables (a
        ``mixed`` L2 window given back) and the last frame's rays and hits.
        A later frame loads them again."""
        self._drop_bvh()
        self.primary = self._batch = None
        self._batches = []

    def _drop_bvh(self) -> None:
        """Forget the scene's tree and everything made from it.  Tables in
        the ``mixed`` residency give back the persisting L2 first."""
        if getattr(self.tracer_tables, "residency", None) == "mixed":
            release_persisting_l2()
        self.flat = None
        self.bvh_stats = None
        self.routing = self.tracer_tables = None
        self._tri_normal_dev = self._tri_shaded_dev = self._tri_material_dev = None

    def _ensure_bvh(self) -> None:
        if self.flat is None:
            if self.scene is None:
                raise RuntimeError("set_mesh/set_scene first")
            t0 = time.perf_counter()
            self.flat, self.bvh_stats = load_or_build_bvh(
                self.scene, self.platform, self.build_params, cache_dir=self.params.cache_dir)
            # Scene tables go to the device once per scene, not per batch.
            self._tri_normal_dev = torch.as_tensor(self.scene.tri_normal, device=self.device)
            self._tri_shaded_dev = torch.as_tensor(self.scene.tri_shaded, device=self.device)
            self._tri_material_dev = torch.as_tensor(self.scene.tri_material, device=self.device)
            self.routing, self.active_tracer, self.tracer_tables = make_routing_tracer(
                self.flat, prefer=self.params.tracer, device=self.device,
                cache_dir=self.params.cache_dir, mxu=self.params.mxu,
                cursors=self.params.cursors)
            self._sync()
            # Host seconds of BVH build (or cache load), collapse and upload.
            self.setup_s = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- frame cycle ---------------------------------------------------------

    def begin_frame(self, camera: Camera) -> None:
        """BVH setup + primary raygen (+ the primary trace for secondary ray
        types), reference Renderer::beginFrame (Renderer.cc:112-152)."""
        self._ensure_bvh()
        self.camera = camera
        self.phase_s = {"raygen": 0.0, "sort": 0.0, "trace": 0.0, "reconstruct": 0.0}
        t0 = time.perf_counter()
        rays, s2i, i2s = self.raygen.primary(camera, self.width, self.height, device=self.device)
        self._sync()
        self.phase_s["raygen"] += time.perf_counter() - t0
        self.primary = BatchRecord(rays=rays, hits=None, slot_to_id=s2i, id_to_slot=i2s,
                                   input_range=(0, rays.num))
        self.trace_time_s = 0.0
        self.rays_traced = 0
        self.rays_skipped = 0
        self.batch_trace_s = []
        if self.params.ray_type != "primary":
            # Not part of the metric (Renderer.cc: the primary pre-trace of
            # secondary types is not timed).
            self.primary.hits = self._timed_trace(rays, any_hit=False, count=False)
        self._new_batch = True
        self._batch: BatchRecord | None = None
        self._batch_live: int | None = None
        self._batches: list[BatchRecord] = []

    def _timed_trace(self, rays: Rays, any_hit: bool, count: bool = True) -> Hits:
        """Trace with kernel-only timing, the Mray/s metric discipline
        (App.cc:188-204: trace time only, and only for the measured
        batches)."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            hits = self.routing(self.tracer_tables, rays, any_hit=any_hit)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            hits = self.routing(self.tracer_tables, rays, any_hit=any_hit)
            dt = time.perf_counter() - t0
        self.phase_s["trace"] += dt
        if count:
            self.trace_time_s += dt
            self.rays_traced += rays.num
            self.batch_trace_s.append(dt)
        return hits

    def get_total_num_rays(self) -> int:
        """Ray budget of the frame (Renderer.cc:221-238): the primary count,
        or primary hits x num_samples for secondary types."""
        if self.params.ray_type == "primary":
            return self.width * self.height
        return int(count_hits(self.primary.hits.tri)) * self.params.num_samples

    def next_batch(self) -> bool:
        """Generate the next trace batch (Renderer::nextBatch,
        Renderer.cc:242-291)."""
        p = self.params
        if p.ray_type == "primary":
            if not self._new_batch:
                return False
            self._new_batch = False
            self._batch = self.primary
            self._batches.append(self.primary)
            return True

        max_dist = p.ao_radius if p.ray_type == "ao" else float(self.camera.far)
        t0 = time.perf_counter()
        out = self.raygen.ao(self.primary.rays, self.primary.hits, self._tri_normal_dev,
                             p.num_samples, max_dist, self._new_batch, seed=p.seed)
        self._sync()
        self.phase_s["raygen"] += time.perf_counter() - t0
        self._new_batch = False
        if out is None:
            self._batch = None
            return False
        rays, s2i, i2s, rng = out
        self._batch_live = None
        if p.sort_secondary or p.compact_degenerate:
            # Keys, sort and permutation on the device; the ID<->slot maps
            # are permuted there too.  compact_degenerate takes the
            # dead-last 192-bit sort; sort_secondary alone the coarse key.
            t0 = time.perf_counter()
            if p.compact_degenerate:
                order = sort_dead_last_device(rays)
                self._batch_live = int((rays.tmax >= 0).sum())
            else:
                order = morton_sort_device_coarse(rays.origin, rays.dirn)
            rays = permute_rays(rays, order)
            s2i = s2i[order]
            i2s = inverse_permutation(order)[i2s.long()]
            self._sync()
            self.phase_s["sort"] += time.perf_counter() - t0
        self._batch = BatchRecord(rays=rays, hits=None, slot_to_id=s2i, id_to_slot=i2s,
                                  input_range=rng)
        self._batches.append(self._batch)
        return True

    def trace_batch(self) -> float:
        """Trace the current batch; returns elapsed seconds (kernel only).
        AO rays take the any-hit form, diffuse rays need the closest hit."""
        if self._batch is None:
            raise RuntimeError("next_batch() first")
        t0 = self.trace_time_s
        any_hit = self.params.ray_type == "ao"
        rays = self._batch.rays
        if self._batch_live is None:
            self._batch.hits = self._timed_trace(rays, any_hit=any_hit)
        else:
            # Only the live prefix is traced (and timed, and counted); the
            # dead suffix is counted as skipped.
            traced = self.rays_traced
            self._batch.hits = trace_live_prefix(
                lambda r: self._timed_trace(r, any_hit=any_hit), rays, self._batch_live)
            self.rays_skipped += rays.num - (self.rays_traced - traced)
        return self.trace_time_s - t0

    def render_frame(self, camera: Camera) -> dict:
        """Full frame: begin_frame + batch loop.  Returns timing/ray stats.

        The Mray/s numerator is get_total_num_rays() — W x H, or primary
        HITS x num_samples for secondary types — not the number of rays
        traced, which for AO/diffuse includes the tmax = -1 rays of primary
        misses (App.cc:188-204 with Renderer.cc:221-238).  The denominator
        is the kernel-only trace time summed over the batches.  ``timer``
        says which clock timed the trace: "cuda_event" on a CUDA device,
        "host" on the CPU.  ``rays_skipped`` counts the dead rays of
        ``compact_degenerate`` batches that were not traced.

        With ``RendererParams.profile_dir`` the frame runs under
        ``torch.profiler`` (CPU, and CUDA on a CUDA device), and the trace
        is written there as a Chrome trace, ``profile_trace`` its path."""
        profile_dir = self.params.profile_dir
        prof = contextlib.nullcontext()
        if profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
        with prof:
            self.begin_frame(camera)
            total_rays = self.get_total_num_rays()
            while self.next_batch():
                self.trace_batch()
            self._sync()
        trace_path = None
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            trace_path = os.path.join(profile_dir,
                                      f"render_frame_{time.time_ns()}.pt.trace.json")
            prof.export_chrome_trace(trace_path)
        mrays_per_s = (total_rays / (self.trace_time_s * 1e6)
                       if self.trace_time_s > 0 else float("inf"))
        return {
            "total_rays": total_rays,
            "rays_traced": self.rays_traced,
            "rays_skipped": self.rays_skipped,
            "batches": len(self._batches),
            "batch_trace_s": list(self.batch_trace_s),
            "trace_time_s": self.trace_time_s,
            "mrays_per_s": mrays_per_s,
            "phase_s": dict(self.phase_s),
            "tracer": self.active_tracer,
            "device": str(self.device),
            "timer": "cuda_event" if self.device.type == "cuda" else "host",
            "profile_trace": trace_path,
        }

    # -- reconstruction ------------------------------------------------------

    def frame_sample_tri(self) -> torch.Tensor:
        """Per-(primary slot, sample) hit ids of a secondary frame, assembled
        over its batches on the device: entry k * S + j is sample j of
        primary slot k (Renderer.cc:421-445; tpu_rt does this in numpy)."""
        s = self.params.num_samples
        out = torch.full((self.width * self.height * s,), -1, dtype=torch.int32,
                         device=self.device)
        for b in self._batches:
            lo, hi = b.input_range
            n = (hi - lo) * s
            # Input slot k of a batch is primary slot lo + k.
            out[lo * s:lo * s + n] = b.hits.tri[b.id_to_slot[:n].long()]
        return out

    def update_result(self) -> np.ndarray:
        """Reconstruct the frame RGBA image [h, w, 4] f32 on the host
        (Renderer::updateResult, Renderer.cc:421-445)."""
        t0 = time.perf_counter()
        p = self.params
        num_pixels = self.width * self.height
        if p.ray_type == "primary":
            hits = self.primary.hits
            image = reconstruct_image(
                self.primary.slot_to_id, hits.tri, self.primary.id_to_slot, hits.tri,
                self._tri_shaded_dev, self._tri_material_dev, "primary", 1, num_pixels)
        else:
            s = p.num_samples
            image = reconstruct_image(
                self.primary.slot_to_id, self.primary.hits.tri,
                torch.arange(num_pixels * s, dtype=torch.int32, device=self.device),
                self.frame_sample_tri(), self._tri_shaded_dev, self._tri_material_dev,
                p.ray_type, s, num_pixels)
        out = image.cpu().numpy().reshape(self.height, self.width, 4)
        self.phase_s["reconstruct"] += time.perf_counter() - t0
        return out

    def update_result_u32(self) -> np.ndarray:
        """ABGR8 image [h, w] u32, the reference's display format."""
        return to_abgr(self.update_result())
