"""Host-side ray generation orchestration.

Counterpart of ``tpu_rt.raygen.raygen.RayGen`` (reference
src/rt/ray/RayGen.cc) for primary rays.  The secondary-ray batching
(``ao``/``shadow``) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.raygen.generators import gen_primary_rays
from tpu_rt_torch.scene.pixel_table import PixelTable


class RayGen:
    def __init__(self):
        self.pixel_table = PixelTable()

    def primary(self, camera, width: int, height: int, device="cpu"):
        """Morton-ordered primary rays for the camera (RayGen.cc:50-73) on
        ``device``.  Returns (Rays, slot_to_id, id_to_slot)."""
        self.pixel_table.set_size(width, height)
        i2p = self.pixel_table.index_to_pixel_device(device)
        origin = torch.as_tensor(np.asarray(camera.position, np.float32), device=device)
        m = torch.as_tensor(camera.nscreen_to_world(width, height), device=device)
        return gen_primary_rays(i2p, origin, m, width, height, float(np.float32(camera.far)))
