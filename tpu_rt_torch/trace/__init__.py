"""Routing tracers: resolve a tracer for a scene and a device.

Counterpart of ``tpu_rt.trace.make_routing_tracer``.  Only the 4-wide
(packet4) path is ported, in its closest-hit and any-hit forms: the CUDA
kernel on a CUDA device, its plain PyTorch version on the CPU
(``tpu_rt_torch.trace.quad_kernel``).
"""

from __future__ import annotations

import torch

from tpu_rt_torch.trace.quad_kernel import QuadTables, trace_quad, upload_quad

__all__ = ["make_routing_tracer", "trace_quad", "upload_quad", "QuadTables"]


def make_routing_tracer(flat, prefer: str = "auto", device="cpu",
                        cache_dir: str | None = None):
    """Returns (fn, kind, tables) where fn(tables, rays, any_hit=False) ->
    Hits (closest hit, or with ``any_hit`` the first accepted hit), and
    tables are the device tables of the scene.

    prefer:
      "auto" / "packet4" — the 4-wide BVH (collapse4 with leaf_max =
                  MAX_LEAF4 = 16) traced by the CUDA kernel on a CUDA
                  device and by the plain PyTorch version on the CPU;
      "xla" / "packet"   — the wavefront tracer and the binary kernel are
                  not ported yet: NotImplementedError (ROADMAP.md).
    cache_dir: consult/populate the quad-collapse cache (bvh.cache).
    """
    if prefer in ("xla", "packet"):
        raise NotImplementedError(
            f"tracer {prefer!r} is not ported to tpu_rt_torch yet; see ROADMAP.md")
    if prefer not in ("auto", "packet4"):
        raise ValueError(f"unknown tracer {prefer!r}")
    from tpu_rt_torch.bvh.cache import load_or_collapse_quad
    from tpu_rt_torch.bvh.collapse import MAX_LEAF4

    device = torch.device(device)
    quad = load_or_collapse_quad(flat, leaf_max=MAX_LEAF4, cache_dir=cache_dir)
    tables = upload_quad(quad, device)
    kind = "quad-cuda" if device.type == "cuda" else "quad-plain"
    return trace_quad, kind, tables
