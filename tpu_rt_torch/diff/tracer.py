"""Differentiable tracing: gradients through hit distance / barycentrics.

Counterpart of ``tpu_rt.diff.tracer``, in torch autograd:

- BVH traversal (which triangle a ray hits) is discrete *routing*: it runs
  under ``torch.no_grad()`` on detached rays — the wavefront tracer, or any
  tracer's hits passed as ``raw`` (the CUDA traversal kernels on the card).
- Given the routing, (t, u, v) are recomputed differentiably from the hit
  triangle's *raw vertices* via Moller-Trumbore, so they are a smooth
  function of (rays, vtx_pos) with exact autograd gradients; no custom
  backward, no differentiating through the Woop tables.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.core.types import FlatBVH, Hits, Rays
from tpu_rt_torch.trace.wavefront import trace_wavefront


def moller_trumbore_tuv(o, d, v0, v1, v2):
    """Differentiable (t, u, v) of rays against given triangles ([N,3] each).
    Same intersection equations as the CPU oracle (reference
    Intersect::RayTriangle, src/rt/Util.cc:50-94)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * pvec).sum(dim=-1)
    inv_det = 1.0 / det
    tvec = o - v0
    u = (tvec * pvec).sum(dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = (d * qvec).sum(dim=-1) * inv_det
    t = (e2 * qvec).sum(dim=-1) * inv_det
    return t, u, v


def trace_diff(any_hit: bool, flat: FlatBVH, rays: Rays, vtx_pos: torch.Tensor,
               tri_vtx_index: torch.Tensor, raw: Hits | None = None) -> Hits:
    """Differentiable trace.  ``flat`` (from ``device_bvh``) must be built
    from the same (vtx_pos, tri_vtx_index): it carries the routing, through
    ``trace_wavefront``; the raw arrays carry the derivative.  Returns Hits
    whose t/u/v are differentiable w.r.t. rays and vtx_pos (misses keep t =
    tmax with zero gradient).

    raw: optional precomputed routing Hits (e.g. from a CUDA traversal
    kernel) — routing is discrete, so any correct tracer's output can carry
    it; when given, ``flat`` is unused.

    As in ``tpu_rt``, a miss is recomputed against triangle 0 and masked
    out; where that recompute divides by a zero determinant, the masked
    branch's backward gives NaN (0 x inf), as ``tpu_rt``'s does."""
    if raw is None:
        with torch.no_grad():
            raw = trace_wavefront(flat, Rays(*(x.detach() for x in rays)), any_hit=any_hit)
    raw = Hits(*(x.detach() for x in raw))

    hit = raw.tri >= 0
    tri_c = raw.tri.long().clamp(0, max(0, tri_vtx_index.shape[0] - 1))
    idx = tri_vtx_index[tri_c].long()
    v0 = vtx_pos[idx[:, 0]]
    v1 = vtx_pos[idx[:, 1]]
    v2 = vtx_pos[idx[:, 2]]
    t, u, v = moller_trumbore_tuv(rays.origin, rays.dirn, v0, v1, v2)

    zero = torch.zeros_like(t)
    return Hits(
        tri=raw.tri,
        t=torch.where(hit, t, raw.t),
        u=torch.where(hit, u, zero),
        v=torch.where(hit, v, zero),
    )
