"""Image reconstruction from trace results (torch).

Counterpart of ``tpu_rt.shade.reconstruct`` (reference reconstructKernel +
countHitsKernel, src/rt/cuda/RendererKernels.cu:60-162) for primary rays:
a hit pixel takes its triangle's precomputed headlight-shaded color, a miss
the background (0.2, 0.4, 0.8, 1.0).  The AO and diffuse rules are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

BG_COLOR = np.array([0.2, 0.4, 0.8, 1.0], np.float32)


def reconstruct_image(
    primary_slot_to_id: torch.Tensor,  # [P] i32
    primary_tri: torch.Tensor,         # [P] i32 primary hit ids
    batch_id_to_slot: torch.Tensor,    # [P] i32
    batch_tri: torch.Tensor,           # [P] i32 batch hit ids
    tri_shaded: torch.Tensor,          # [T,4] f32 precomputed shaded colors
    tri_material: torch.Tensor,        # [T,4] f32 material colors
    ray_type: str,                     # "primary" only, for now
    num_rays_per_primary: int,
    num_pixels: int,
) -> torch.Tensor:
    """Returns [num_pixels, 4] f32 RGBA image (pixel index = primary ray id)
    on the device of the inputs."""
    if ray_type != "primary" or num_rays_per_primary != 1:
        raise NotImplementedError(
            f"reconstruct_image: ray_type={ray_type!r} is not ported yet "
            "(ROADMAP.md); only 'primary' with one ray per pixel")
    dev = batch_tri.device
    primary_id = primary_slot_to_id.to(device=dev, dtype=torch.long)
    if tri_shaded.shape[0] == 0:
        # Empty scene: every ray misses; pad the color table so the gather
        # below stays well-formed (the miss mask routes around the values).
        tri_shaded = torch.zeros((1, 4), dtype=torch.float32, device=dev)

    # One batch ray per primary, addressed by primary *id*
    # (RendererKernels.cu:73: batchSlots = batchIDToSlot + primaryID).
    slots = batch_id_to_slot.to(dev).long()[primary_id]
    tri = batch_tri[slots].long()
    miss = tri == -1
    hit_color = tri_shaded.to(dev)[tri.clamp(0, tri_shaded.shape[0] - 1)]
    bg = torch.as_tensor(BG_COLOR, device=dev)
    color = torch.where(miss[:, None], bg[None, :], hit_color)
    image = torch.zeros((num_pixels, 4), dtype=torch.float32, device=dev)
    image[primary_id] = color
    return image


def count_hits(tri: torch.Tensor) -> torch.Tensor:
    """Number of rays that hit anything (countHitsKernel,
    RendererKernels.cu:112-162) — sizes the secondary-ray denominator."""
    return (tri >= 0).sum(dtype=torch.int32)
