"""Host-side ray generation orchestration with batching.

Counterpart of ``tpu_rt.raygen.raygen.RayGen`` (reference
src/rt/ray/RayGen.cc): owns the max-batch budget and the cursor-based
batching of secondary generations (RayGen.cc:124-142) so AO at
numSamples x W x H fits device memory.  Secondary batches are generated on
the device of the input rays.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.core.types import Hits, Rays
from tpu_rt_torch.raygen.generators import gen_ao_rays, gen_primary_rays, gen_shadow_rays
from tpu_rt_torch.scene.pixel_table import PixelTable


class RayGen:
    def __init__(self, max_rays_per_batch: int = 1 << 21):
        # Renderer constructs the reference RayGen with 1<<21 (Renderer.cc:46).
        self.max_rays_per_batch = int(max_rays_per_batch)
        self.pixel_table = PixelTable()
        self._cursor = 0

    # -- primary -------------------------------------------------------------

    def primary(self, camera, width: int, height: int, device="cuda"):
        """Morton-ordered primary rays for the camera (RayGen.cc:50-73) on
        ``device``.  Returns (Rays, slot_to_id, id_to_slot)."""
        self.pixel_table.set_size(width, height)
        i2p = self.pixel_table.index_to_pixel_device(device)
        origin = torch.as_tensor(np.asarray(camera.position, np.float32), device=device)
        m = torch.as_tensor(camera.nscreen_to_world(width, height), device=device)
        return gen_primary_rays(i2p, origin, m, width, height, float(np.float32(camera.far)))

    # -- secondary batching --------------------------------------------------

    def _batching(self, num_input: int, num_samples: int, new_batch: bool):
        """Cursor over input rays, <= max_batch output rays per call
        (RayGen.cc:124-142).  Returns (lo, hi) or None when exhausted."""
        if new_batch:
            self._cursor = 0
        if self._cursor >= num_input:
            return None
        lo = self._cursor
        span = max(1, self.max_rays_per_batch // max(1, num_samples))
        hi = min(num_input, lo + span)
        self._cursor = hi
        return lo, hi

    def ao(
        self,
        in_rays: Rays,
        in_hits: Hits,
        tri_normal: torch.Tensor,
        num_samples: int,
        max_dist: float,
        new_batch: bool,
        seed: int = 0,
    ):
        """Generate the next AO batch, or None when the input is exhausted.
        ``tri_normal`` is the scene's [T,3] normals, best already on the
        rays' device (the Renderer uploads them once per scene).  Returns
        (Rays, slot_to_id, id_to_slot, (lo, hi))."""
        rng = self._batching(in_rays.num, num_samples, new_batch)
        if rng is None:
            return None
        lo, hi = rng
        rays, s2i, i2s = gen_ao_rays(
            in_rays.origin[lo:hi], in_rays.dirn[lo:hi], in_hits.t[lo:hi], in_hits.tri[lo:hi],
            torch.as_tensor(tri_normal, device=in_rays.origin.device), num_samples,
            max_dist, seed, task_offset=lo)
        return rays, s2i, i2s, (lo, hi)

    def shadow(
        self,
        in_rays: Rays,
        in_hits: Hits,
        num_samples: int,
        light_position,
        light_radius: float,
        new_batch: bool,
        seed: int = 0,
    ):
        """Generate the next shadow batch toward a spherical light, or None
        when the input is exhausted.  Returns (Rays, slot_to_id,
        id_to_slot, (lo, hi))."""
        rng = self._batching(in_rays.num, num_samples, new_batch)
        if rng is None:
            return None
        lo, hi = rng
        rays, s2i, i2s = gen_shadow_rays(
            in_rays.origin[lo:hi], in_rays.dirn[lo:hi], in_hits.t[lo:hi], in_hits.tri[lo:hi],
            num_samples, light_position, light_radius, seed, task_offset=lo)
        return rays, s2i, i2s, (lo, hi)
