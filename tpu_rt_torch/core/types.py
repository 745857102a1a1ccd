"""Core data types: SoA rays and hits as torch tensors, the flattened BVH on
the host.

Counterpart of ``tpu_rt.core.types``.  ``Rays`` and ``Hits`` hold torch
tensors on whatever device the caller chose; ``FlatBVH`` and ``AABB`` stay
host numpy, exactly as the builder emits them, and are uploaded to a device
by the tracer that consumes them (``tpu_rt_torch.trace.quad_kernel``).

- ``Rays``   : origins/directions as [N,3] f32, tmin/tmax as [N] f32.
- ``Hits``   : hit triangle id ([N] i32, -1 = miss) and hit distance t.
- ``FlatBVH``: the Compact2-equivalent binary layout (reference
  src/rt/cuda/CudaBVH.cc:270-357), one 16-float row per inner node; see
  ``tpu_rt.core.types.FlatBVH`` for the column map, which is identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Sentinel node "address" marking an empty traversal stack / retired lane
# (INT32_MAX keeps the "is leaf" test a sign test).
SENTINEL = np.int32(0x7FFFFFFF)


class Rays(NamedTuple):
    """A batch of rays, SoA.  All tensors share the leading dim N."""

    origin: torch.Tensor  # [N, 3] f32
    dirn: torch.Tensor    # [N, 3] f32
    tmin: torch.Tensor    # [N]    f32
    tmax: torch.Tensor    # [N]    f32  (< 0 marks a degenerate/disabled ray)

    @property
    def num(self) -> int:
        return int(self.origin.shape[0])


class Hits(NamedTuple):
    """Trace results.  ``tri`` is the *original* scene triangle id (-1 miss).
    ``u``/``v`` are the barycentrics at the hit, zero where a tracer does
    not compute them (the frame path consumes only ``tri`` and ``t``)."""

    tri: torch.Tensor  # [N] i32
    t: torch.Tensor    # [N] f32
    u: torch.Tensor    # [N] f32
    v: torch.Tensor    # [N] f32


class FlatBVH(NamedTuple):
    """Flattened two-wide BVH (host numpy), column layout as in
    ``tpu_rt.core.types.FlatBVH``.

    nodes: [num_nodes, 16] f32 (cols 12..15 bitcast i32 links / counts);
    tri_woop: [num_refs, 12] f32; tri_index: [num_refs] i32;
    leaf_counts: [num_refs + 1] i32.
    """

    nodes: np.ndarray
    tri_woop: np.ndarray
    tri_index: np.ndarray
    leaf_counts: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def num_refs(self) -> int:
        return int(self.tri_woop.shape[0])


class AABB:
    """Host-side axis-aligned bounding box (numpy).  Mirrors the semantics of
    the reference's FW::AABB (src/rt/Util.hh:37-60): starts inverted so that
    ``valid()`` is false until grown."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo=None, hi=None):
        self.lo = np.full(3, np.inf, np.float32) if lo is None else np.asarray(lo, np.float32).copy()
        self.hi = np.full(3, -np.inf, np.float32) if hi is None else np.asarray(hi, np.float32).copy()

    def grow_point(self, p) -> "AABB":
        np.minimum(self.lo, p, out=self.lo)
        np.maximum(self.hi, p, out=self.hi)
        return self

    def grow(self, other: "AABB") -> "AABB":
        np.minimum(self.lo, other.lo, out=self.lo)
        np.maximum(self.hi, other.hi, out=self.hi)
        return self

    def intersect(self, other: "AABB") -> "AABB":
        np.maximum(self.lo, other.lo, out=self.lo)
        np.minimum(self.hi, other.hi, out=self.hi)
        return self

    def valid(self) -> bool:
        return bool(np.all(self.lo <= self.hi))

    def area(self) -> float:
        """Total surface area; 0 for an invalid box (reference Util.hh:52-56)."""
        if not self.valid():
            return 0.0
        d = self.hi - self.lo
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))

    def midpoint(self):
        return (self.lo + self.hi) * 0.5

    def copy(self) -> "AABB":
        return AABB(self.lo, self.hi)

    def __repr__(self):
        return f"AABB(lo={self.lo.tolist()}, hi={self.hi.tolist()})"


def make_rays(origin, dirn, tmin, tmax, device="cuda") -> Rays:
    """Build a Rays batch from array-likes on ``device``, casting to the
    canonical dtypes."""

    def f32(x, shape):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).reshape(shape)

    return Rays(origin=f32(origin, (-1, 3)), dirn=f32(dirn, (-1, 3)),
                tmin=f32(tmin, (-1,)), tmax=f32(tmax, (-1,)))


def concat_rays(a: Rays, b: Rays) -> Rays:
    """The rays of ``a``, then those of ``b`` (both on one device)."""
    return Rays(*(torch.cat([x, y]) for x, y in zip(a, b)))


def pad_rays(rays: Rays, multiple: int) -> tuple[Rays, int]:
    """Pad the batch up to a multiple of ``multiple``.

    Padding rays get tmax = -1, the reference's "degenerate ray" convention
    (src/rt/ray/RayGenKernels.cu:221) so tracers skip them.  Returns the
    padded batch and the original size.
    """
    n = rays.origin.shape[0]
    pad = -(-n // multiple) * multiple - n
    if pad == 0:
        return rays, n
    dev = rays.origin.device
    f32 = torch.float32
    padded = Rays(
        origin=torch.cat([rays.origin, torch.zeros((pad, 3), dtype=f32, device=dev)]),
        dirn=torch.cat([rays.dirn, torch.tensor([[1.0, 0.0, 0.0]], dtype=f32, device=dev).expand(pad, 3)]),
        tmin=torch.cat([rays.tmin, torch.zeros((pad,), dtype=f32, device=dev)]),
        tmax=torch.cat([rays.tmax, torch.full((pad,), -1.0, dtype=f32, device=dev)]),
    )
    return padded, n
