"""Routing tracers: resolve a tracer for a scene and a device.

Counterpart of ``tpu_rt.trace``: the host oracles (``cpu_reference``), the
portable wavefront tracer (``wavefront``, the ``"xla"`` route), and the two
traversal kernels -- the 4-wide one (``quad_kernel``, the ``"packet4"``
route) and the binary one (``flat_kernel``, the ``"packet"`` route) -- each
a CUDA kernel on a CUDA device and its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import functools
import warnings

import torch

from tpu_rt_torch.trace.common import StackDepthError
from tpu_rt_torch.trace.cpu_reference import (
    RayStats,
    assign_treelets,
    intersect_brute,
    trace_flat_scalar,
)
from tpu_rt_torch.trace.flat_kernel import FlatTables, trace_flat, upload_flat
from tpu_rt_torch.trace.quad_kernel import QuadTables, trace_quad, upload_quad
from tpu_rt_torch.trace.wavefront import device_bvh, trace_wavefront

__all__ = [
    "RayStats",
    "assign_treelets",
    "intersect_brute",
    "trace_flat_scalar",
    "trace_wavefront",
    "device_bvh",
    "make_routing_tracer",
    "trace_quad",
    "upload_quad",
    "QuadTables",
    "trace_flat",
    "upload_flat",
    "FlatTables",
    "StackDepthError",
    "TRACERS",
]

TRACERS = ("auto", "packet4", "pallas", "packet", "xla")


def make_routing_tracer(flat, prefer: str = "auto", device="cpu", want_uv: bool = False,
                        cache_dir: str | None = None):
    """Returns (fn, kind, tables): fn(tables, rays, any_hit=False,
    with_stats=False) -> Hits (closest hit, or with ``any_hit`` the first
    accepted hit), or ``(Hits, {"node_tests", "tri_tests"})`` with
    ``with_stats``; ``kind`` names the route; ``tables`` are the scene's
    device tables.

    want_uv: a config of the tracer, as in ``tpu_rt``: without it the
    kernels return u = v = 0 (the frame path reads only tri and t); the
    wavefront always fills u, v.

    prefer:
      "packet4" — the 4-wide BVH (collapse4, leaf_max = MAX_LEAF4 = 16),
                  kind "quad-cuda" (the CUDA kernel) or "quad-plain" (its
                  plain PyTorch version, on the CPU); raises if the quad
                  tree is too deep for the kernel's stack;
      "packet"  — the binary FlatBVH, kind "flat-cuda" / "flat-plain";
      "pallas"  — packet4, then packet;
      "auto"    — packet4; only a quad tree too deep for the quad stack
                  falls to packet, with a RuntimeWarning (``tpu_rt`` falls
                  further to the wavefront; the port never does: a tree
                  neither kernel's stack holds raises);
      "xla"     — the wavefront tracer on ``device``, kind "wavefront".
    cache_dir: consult/populate the quad-collapse cache (bvh.cache).
    """
    if prefer not in TRACERS:
        raise ValueError(f"unknown tracer {prefer!r}; one of {TRACERS}")
    device = torch.device(device)
    route = "cuda" if device.type == "cuda" else "plain"
    if prefer == "xla":
        return trace_wavefront, "wavefront", device_bvh(flat, device)
    if prefer != "packet":
        from tpu_rt_torch.bvh.cache import load_or_collapse_quad
        from tpu_rt_torch.bvh.collapse import MAX_LEAF4

        quad = load_or_collapse_quad(flat, leaf_max=MAX_LEAF4, cache_dir=cache_dir)
        try:
            tables = upload_quad(quad, device)
        except StackDepthError as e:
            if prefer == "packet4":
                raise
            warnings.warn(f"tpu_rt_torch: {e}; {prefer!r} falls to the binary kernel "
                          f"(flat-{route})", RuntimeWarning, stacklevel=2)
        else:
            return functools.partial(trace_quad, want_uv=want_uv), f"quad-{route}", tables
    return (functools.partial(trace_flat, want_uv=want_uv), f"flat-{route}",
            upload_flat(flat, device))
