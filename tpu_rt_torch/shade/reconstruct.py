"""Image reconstruction from trace results (torch).

Counterpart of ``tpu_rt.shade.reconstruct`` (reference reconstructKernel +
countHitsKernel, src/rt/cuda/RendererKernels.cu:60-162), including the
reference's quirks, kept deliberately (SURVEY.md section 7 "quirks"):

- background color (0.2, 0.4, 0.8, 1.0),
- AO: miss = white, blocked = (0,0,0,1) — black despite the comment in the
  reference claiming white — and primary-miss pixels get the background,
- Diffuse: per-sample shaded color averaged, then modulated by the *primary*
  hit's material color (the background where the primary ray missed).
"""

from __future__ import annotations

import numpy as np
import torch

BG_COLOR = np.array([0.2, 0.4, 0.8, 1.0], np.float32)


def reconstruct_image(
    primary_slot_to_id: torch.Tensor,  # [P] i32
    primary_tri: torch.Tensor,         # [P] i32 primary hit ids
    batch_id_to_slot: torch.Tensor,    # [P*S] i32 (or [P] for primary)
    batch_tri: torch.Tensor,           # [B] i32 batch hit ids
    tri_shaded: torch.Tensor,          # [T,4] f32 precomputed shaded colors
    tri_material: torch.Tensor,        # [T,4] f32 material colors
    ray_type: str,                     # "primary" | "ao" | "diffuse"
    num_rays_per_primary: int,
    num_pixels: int,
) -> torch.Tensor:
    """Returns [num_pixels, 4] f32 RGBA image (pixel index = primary ray id)
    on the device of ``batch_tri``."""
    if ray_type not in ("primary", "ao", "diffuse"):
        raise ValueError(f"reconstruct_image: unknown ray_type {ray_type!r}")
    dev = batch_tri.device
    f32 = torch.float32
    p = primary_tri.shape[0]
    s = num_rays_per_primary
    primary_id = primary_slot_to_id.to(device=dev, dtype=torch.long)
    if tri_shaded.shape[0] == 0:
        # Empty scene: every ray misses; pad the color tables so the gathers
        # below stay well-formed (the miss mask routes around the values).
        tri_shaded = torch.zeros((1, 4), dtype=f32, device=dev)
        tri_material = torch.zeros((1, 4), dtype=f32, device=dev)
    tri_shaded = tri_shaded.to(dev)
    tri_material = tri_material.to(dev)
    id_to_slot = batch_id_to_slot.to(dev).long()

    if ray_type == "primary":
        # One batch ray per primary, addressed by primary *id*
        # (RendererKernels.cu:73: batchSlots = batchIDToSlot + primaryID).
        slots = id_to_slot[primary_id][:, None]  # [P,1]
    else:
        base = (torch.arange(p, dtype=torch.long, device=dev)[:, None] * s
                + torch.arange(s, dtype=torch.long, device=dev)[None, :])
        slots = id_to_slot[base]  # [P,S]

    tri = batch_tri[slots].long()  # [P,S]
    miss = tri == -1
    bg = torch.as_tensor(BG_COLOR, device=dev)
    if ray_type == "primary":
        miss_color = bg
    else:
        miss_color = torch.ones(4, dtype=f32, device=dev)
    if ray_type == "ao":
        hit_color = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=f32, device=dev).expand(*tri.shape, 4)
    else:
        hit_color = tri_shaded[tri.clamp(0, tri_shaded.shape[0] - 1)]
    color = torch.where(miss[..., None], miss_color, hit_color)
    color = color.mean(dim=1)  # [P,4]

    primary_miss = (primary_tri.to(dev) == -1)[:, None]
    if ray_type == "ao":
        color = torch.where(primary_miss, bg, color)
    elif ray_type == "diffuse":
        ptri = primary_tri.to(dev).long().clamp(0, tri_material.shape[0] - 1)
        color = color * torch.where(primary_miss, bg, tri_material[ptri])

    image = torch.zeros((num_pixels, 4), dtype=f32, device=dev)
    image[primary_id] = color
    return image


def count_hits(tri: torch.Tensor) -> torch.Tensor:
    """Number of rays that hit anything (countHitsKernel,
    RendererKernels.cu:112-162) — sizes the secondary-ray denominator."""
    return (tri >= 0).sum(dtype=torch.int32)
