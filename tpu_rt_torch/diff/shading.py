"""Differentiable shading: pixel colors as smooth functions of geometry and
materials.

Counterpart of ``tpu_rt.diff.shading``.  The reference precomputes
quantized headlight-shaded colors per triangle (Scene.cc:37,80); the
differentiable path recomputes the same shading model from raw vertices and
float materials so pixels carry gradients:

    normal  = normalize(cross(v1-v0, v2-v0))        (Scene.cc:75)
    lambert = dot(normal, normalize(1,2,3))*0.5+0.5 (Scene.cc:37,80)
    color   = material_rgb * lambert                 per hit triangle
    miss    = background (0.2, 0.4, 0.8)
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.core.types import FlatBVH, Hits, Rays
from tpu_rt_torch.diff.tracer import trace_diff
from tpu_rt_torch.shade.reconstruct import BG_COLOR

LIGHT = np.array([1.0, 2.0, 3.0], np.float32)
LIGHT = LIGHT / np.linalg.norm(LIGHT)


def shade_hits_diff(hits_tri, vtx_pos, tri_vtx_index, tri_material):
    """Per-ray RGB from hit ids, differentiable w.r.t. vtx_pos and
    tri_material.  Misses get the background color.

    A dense per-TRIANGLE Lambert color table followed by one per-ray table
    gather, as in ``tpu_rt``: the geometry work is [T]-sized dense math and
    the per-ray part a single [N] gather of 12 B rows, so the backward pass
    is one scatter-add into the [T,3] table followed by dense per-triangle
    products.  The dot with the light is an elementwise product and a sum
    (no matmul: cuBLAS has no deterministic mode without a workspace
    setting, and ``train_step`` runs its backward deterministically)."""
    hit = hits_tri >= 0
    tri_c = hits_tri.long().clamp(0, max(0, tri_vtx_index.shape[0] - 1))
    tvi = tri_vtx_index.long()
    v0 = vtx_pos[tvi[:, 0]]
    v1 = vtx_pos[tvi[:, 1]]
    v2 = vtx_pos[tvi[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-30)
    light = torch.as_tensor(LIGHT, device=n.device)
    lambert = (n * light).sum(dim=-1) * 0.5 + 0.5
    table = tri_material[:, :3] * lambert[:, None]      # [T,3]
    color = table[tri_c]                                # one [N] gather
    bg = torch.as_tensor(BG_COLOR[:3], device=color.device)
    return torch.where(hit[:, None], color, bg[None, :])


def render_image_diff(flat: FlatBVH, rays: Rays, vtx_pos, tri_vtx_index, tri_material,
                      raw: Hits | None = None):
    """Differentiable primary-ray render: [N,3] RGB per ray.

    Gradients flow to vtx_pos both through shading normals and through the
    hit-distance path (trace_diff), and to tri_material through shading.
    ``raw``: the routing hits, as in ``trace_diff`` (None: the wavefront
    over ``flat``)."""
    hits = trace_diff(False, flat, rays, vtx_pos, tri_vtx_index, raw)
    return shade_hits_diff(hits.tri, vtx_pos, tri_vtx_index, tri_material)
