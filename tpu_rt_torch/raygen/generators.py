"""Device ray generators (torch) — primary rays.

Counterpart of ``tpu_rt.raygen.generators.gen_primary_rays``, the
vectorized re-design of the reference's rayGenPrimaryKernel
(src/rt/ray/RayGenKernels.cu:79-113).  One call is a handful of elementwise
torch ops over the whole batch on the device of its inputs.  AO, diffuse
and shadow generators are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from tpu_rt_torch.core.types import Rays


def gen_primary_rays(
    index_to_pixel: torch.Tensor,    # [W*H] i32
    origin: torch.Tensor,            # [3] f32
    nscreen_to_world: torch.Tensor,  # [4,4] f32
    width: int,
    height: int,
    max_dist: float,
):
    """Primary rays in Morton-swizzled pixel order.  Returns
    (Rays, slot_to_id, id_to_slot), all on the device of ``index_to_pixel``."""
    dev = index_to_pixel.device
    n = width * height
    f32 = torch.float32
    task = torch.arange(n, dtype=torch.int32, device=dev)
    pixel = index_to_pixel.to(torch.int32)

    px = (pixel % width).to(f32)
    py = (pixel // width).to(f32)
    sx = 2.0 * (px + 0.5) / width - 1.0
    sy = 2.0 * (py + 0.5) / height - 1.0

    # Transform (sx, sy, 0, 1) by the 4x4 with explicit f32 per-element
    # math, never a matmul (which could run in TF32 on the card): the
    # perspective inverse has heavy cancellation in w.
    m = nscreen_to_world.to(device=dev, dtype=f32)
    world = m[None, :, 0] * sx[:, None] + m[None, :, 1] * sy[:, None] + m[None, :, 3]  # [n,4]
    world_pos = world[:, :3] / world[:, 3:4]
    d = world_pos - origin.to(device=dev, dtype=f32)[None, :]
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)

    rays = Rays(
        origin=origin.to(device=dev, dtype=f32).expand(n, 3).contiguous(),
        dirn=d.contiguous(),
        tmin=torch.zeros((n,), dtype=f32, device=dev),
        tmax=torch.full((n,), float(max_dist), dtype=f32, device=dev),
    )
    slot_to_id = pixel
    id_to_slot = torch.zeros((n,), dtype=torch.int32, device=dev).scatter_(0, pixel.long(), task)
    return rays, slot_to_id, id_to_slot
