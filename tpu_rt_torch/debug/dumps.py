"""Bitwise golden-dump utilities for kernel/hardware verification.

Counterpart of ``tpu_rt.debug.dumps``: the same files, byte for byte, from
the port's types (``Rays`` / ``Hits`` of tensors on any device, a host or
device ``FlatBVH``).  The reference dumps rays, BVH nodes and Woop
triangles as IEEE-754 hex words, one per line (its fetch_* kernels,
src/rt/cuda/CudaTracer.cc:519-637, triangle_{x,y,z,w}.txt), binary ray
snapshots (RayBuffer::dumpRayBuffer -> AORay%02d.dump) and text results
(dumpRayResult -> RayResult%02d.dump, "id t" lines, RayBuffer.cc:89-223).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_rt_torch.core.math import float_to_bits
from tpu_rt_torch.core.types import FlatBVH, Hits, Rays, make_rays


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dump_hex_words(path: str, values) -> None:
    """One 8-digit uppercase-hex IEEE word per line (the reference's
    printf("%08X\\n", floatToBits(v)) format)."""
    bits = float_to_bits(np.asarray(_np(values), np.float32).reshape(-1))
    with open(path, "w") as f:
        for w in bits:
            f.write(f"{int(w):08X}\n")


def load_hex_words(path: str) -> np.ndarray:
    """Inverse of dump_hex_words -> f32 array."""
    with open(path) as f:
        bits = np.array([int(line, 16) for line in f if line.strip()], np.uint32)
    return bits.view(np.float32)


def dump_bvh_nodes(flat: FlatBVH, directory: str = ".", prefix: str = "node") -> list[str]:
    """Per-lane node dumps: node_{n0xy,n1xy,nz,links}_{x,y,z,w}.txt in the
    reference's fetch_node layout — one file per float4 lane of the node row
    (the reference's n0xy/n1xy/nz/tmp split, fetch_node.cu)."""
    nodes = np.asarray(_np(flat.nodes), np.float32)
    groups = {
        "n0xy": nodes[:, 0:4],   # c0.lo.x, c0.hi.x, c0.lo.y, c0.hi.y
        "n1xy": nodes[:, 4:8],
        "nz": nodes[:, 8:12],
        "links": nodes[:, 12:16],
    }
    written = []
    os.makedirs(directory, exist_ok=True)
    for name, block in groups.items():
        for lane, suffix in enumerate("xyzw"):
            path = os.path.join(directory, f"{prefix}_{name}_{suffix}.txt")
            dump_hex_words(path, block[:, lane])
            written.append(path)
    return written


def dump_woop_triangles(flat: FlatBVH, directory: str = ".") -> list[str]:
    """triangle_{x,y,z,w}.txt — every Woop row's float4 lanes in fetch order
    (v00, v11, v22 per triangle), matching the reference's default-on dump
    (CudaTracer.cc:519-637)."""
    woop = np.asarray(_np(flat.tri_woop), np.float32).reshape(-1, 3, 4)
    os.makedirs(directory, exist_ok=True)
    written = []
    for lane, suffix in enumerate("xyzw"):
        path = os.path.join(directory, f"triangle_{suffix}.txt")
        dump_hex_words(path, woop[:, :, lane])
        written.append(path)
    return written


def dump_rays(rays: Rays, path: str) -> None:
    """Binary ray snapshot: float32 records (ox,oy,oz,tmin,dx,dy,dz,tmax) —
    the reference's 32-byte Ray struct stream (dumpRayBuffer,
    RayBuffer.cc:89-150)."""
    o = np.asarray(_np(rays.origin), np.float32)
    d = np.asarray(_np(rays.dirn), np.float32)
    tmin = np.asarray(_np(rays.tmin), np.float32)[:, None]
    tmax = np.asarray(_np(rays.tmax), np.float32)[:, None]
    rec = np.concatenate([o, tmin, d, tmax], axis=1).astype("<f4")
    rec.tofile(path)


def load_rays(path: str, device="cuda") -> Rays:
    rec = np.fromfile(path, dtype="<f4").reshape(-1, 8)
    o, tmin, d, tmax = (np.ascontiguousarray(rec[:, c]) for c in (slice(0, 3), 3, slice(4, 7), 7))
    return make_rays(o, d, tmin, tmax, device=device)


def dump_ray_results(hits: Hits, path: str) -> None:
    """Text results "id t" per line (dumpRayResult, RayBuffer.cc:180-223)."""
    tri = _np(hits.tri)
    t = np.asarray(_np(hits.t), np.float32)
    with open(path, "w") as f:
        for i in range(tri.shape[0]):
            f.write(f"{int(tri[i])} {float(t[i]):g}\n")
