"""Vectorized wavefront BVH traversal in PyTorch ops -- the portable tracer
(the ``"xla"`` route), on any torch device.

Counterpart of ``tpu_rt/trace/xla_tracer.py``, step for step: each step
advances every ray by one unit of work -- a ray inside a leaf tests ONE
Woop triangle, any other ray does one node step (slab tests of both
children, near-first, push far) -- over the whole batch, with a [N, 64]
stack per ray.  It is plain torch, not a kernel.  Its arithmetic is
``tpu_rt``'s, not the oracle's: ``t = Oz / Dz`` is a true division where
``trace_flat_scalar`` multiplies by ``1 / Dz``, so it agrees with the
oracle and the binary kernel to ``tpu_rt``'s tolerances
(``tests/test_trace.py``), and its counters equal ``tpu_rt``'s wavefront's
exactly (``RayStats``'s on nearly every ray: a last-bit change of the hit
distance mid-walk can flip a later slab test).

One difference from ``tpu_rt``: ``tpu_rt`` clips the stack pointer at
``STACK_DEPTH`` silently; here ``device_bvh`` measures the tree's depth
and refuses a tree whose stack would not fit.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.core.types import SENTINEL, FlatBVH, Hits, Rays
from tpu_rt_torch.trace.common import (STACK_SIZE, check_stack, count_stats, safe_inv,
                                       tree_depth)

STACK_DEPTH = STACK_SIZE  # tpu_rt's name; the reference's STACK_SIZE (kepler_dynamic_fetch.cu:47)


def device_bvh(flat: FlatBVH, device="cuda") -> FlatBVH:
    """Upload a host FlatBVH to ``device`` as a FlatBVH of tensors (nodes
    f32 [N,16], tri_woop f32 [R,12], tri_index and leaf_counts i32).  A tree
    deeper than ``STACK_DEPTH`` levels raises ``StackDepthError``."""
    nodes = np.ascontiguousarray(flat.nodes, np.float32)
    depth = tree_depth(np.ascontiguousarray(nodes[:, 12:14]).view(np.int32))
    check_stack(depth, depth, "binary BVH (wavefront)")
    return FlatBVH(
        nodes=torch.tensor(nodes, device=device),
        tri_woop=torch.tensor(np.asarray(flat.tri_woop, np.float32), device=device),
        tri_index=torch.tensor(np.asarray(flat.tri_index, np.int32), device=device),
        leaf_counts=torch.tensor(np.asarray(flat.leaf_counts, np.int32), device=device),
    )


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def trace_wavefront(flat: FlatBVH, rays: Rays, any_hit: bool = False, with_stats: bool = False):
    """Trace a ray batch against the device BVH from ``device_bvh``.
    Returns Hits (original scene triangle ids, -1 for a miss; u, v always
    filled) and, with ``with_stats``, a dict of per-ray ``node_tests``,
    ``tri_tests`` and ``stack`` (the most entries its stack held at once)
    counters, whose sums it adds to the recorder's (``common.count_stats``)."""
    nodes = flat.nodes
    links = nodes.view(torch.int32)[:, 12:16]
    woop = flat.tri_woop
    tri_index = flat.tri_index
    leaf_counts = flat.leaf_counts

    dev = rays.origin.device
    n = rays.origin.shape[0]
    num_refs = woop.shape[0]
    origin, dirn, tmin = rays.origin, rays.dirn, rays.tmin
    i32 = torch.int32
    sent = int(SENTINEL)

    if num_refs == 0 or nodes.shape[0] == 0:
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        hits = Hits(tri=torch.full((n,), -1, dtype=i32, device=dev), t=rays.tmax.clone(),
                    u=zeros, v=zeros.clone())
        if with_stats:
            zi = torch.zeros((n,), dtype=i32, device=dev)
            return hits, {"node_tests": zi, "tri_tests": zi.clone(), "stack": zi.clone()}
        return hits

    idir = safe_inv(dirn)
    ood = origin * idir

    node = torch.where(rays.tmax < 0.0, sent, 0).to(i32)
    leaf_ptr = torch.full((n,), -1, dtype=i32, device=dev)  # >= 0: next Woop row to test
    leaf_end = torch.zeros((n,), dtype=i32, device=dev)
    stack = torch.full((n, STACK_DEPTH), sent, dtype=i32, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    hit_row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    hit_t = rays.tmax.clone()
    hit_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    hit_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    node_tests = torch.zeros((n,), dtype=i32, device=dev)
    tri_tests = torch.zeros((n,), dtype=i32, device=dev)
    stack_hw = torch.zeros((n,), dtype=i32, device=dev)
    rows = torch.arange(n, device=dev)

    def pop(node_val, sp, want):
        sp_next = torch.where(want, sp - 1, sp)
        popped = stack[rows, sp_next.clamp(0, STACK_DEPTH - 1)]
        popped = torch.where(sp_next < 0, sent, popped)
        return torch.where(want, popped, node_val), sp_next

    while bool(((node != sent) | (leaf_ptr >= 0)).any()):
        # ---------------- leaf phase: one Woop triangle per ray -------------
        in_leaf = leaf_ptr >= 0
        trow = torch.where(in_leaf, leaf_ptr, 0).long()
        w = woop[trow]
        Oz = w[:, 3] - _dot3(origin, w[:, 0:3])
        Dz = _dot3(dirn, w[:, 0:3])
        t = Oz / Dz
        u = (w[:, 7] + _dot3(origin, w[:, 4:7])) + t * _dot3(dirn, w[:, 4:7])
        v = (w[:, 11] + _dot3(origin, w[:, 8:11])) + t * _dot3(dirn, w[:, 8:11])
        accept = in_leaf & (t > tmin) & (t < hit_t) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        hit_t = torch.where(accept, t, hit_t)
        hit_row = torch.where(accept, trow, hit_row)
        hit_u = torch.where(accept, u, hit_u)
        hit_v = torch.where(accept, v, hit_v)
        tri_tests += in_leaf.to(i32)

        leaf_ptr = torch.where(in_leaf, leaf_ptr + 1, leaf_ptr)
        leaf_ptr = torch.where(in_leaf & (leaf_ptr >= leaf_end), -1, leaf_ptr)
        if any_hit:
            # The first accepted hit retires the ray (kernel :376-381).
            node = torch.where(accept, sent, node)
            leaf_ptr = torch.where(accept, -1, leaf_ptr)

        # ---------------- node phase: one traversal step --------------------
        # A ray can arrive here with a leaf link in its node register (popped
        # off the stack last step); it passes the slab logic untouched and is
        # moved to the leaf registers below.
        in_node = ~in_leaf & (node != sent)
        is_inner = in_node & (node >= 0)
        nrow = torch.where(is_inner, node, 0).long()
        nd = nodes[nrow]
        lk = links[nrow]
        node_tests += is_inner.to(i32)

        def slab(lo_cols, hi_cols):
            lo_t = nd[:, lo_cols] * idir - ood
            hi_t = nd[:, hi_cols] * idir - ood
            near = torch.maximum(torch.minimum(lo_t, hi_t).amax(1), tmin)
            far = torch.minimum(torch.maximum(lo_t, hi_t).amin(1), hit_t)
            return near, far

        c0min, c0max = slab([0, 2, 8], [1, 3, 9])
        c1min, c1max = slab([4, 6, 10], [5, 7, 11])
        hit0 = c0max >= c0min
        hit1 = c1max >= c1min
        c0, c1 = lk[:, 0], lk[:, 1]
        both = hit0 & hit1
        swap = both & (c1min < c0min)
        near_child = torch.where(swap, c1, torch.where(hit0, c0, c1))
        far_child = torch.where(swap, c0, c1)

        # Push the far child where both children hit (device_bvh guarantees
        # the stack holds it).
        push = is_inner & both
        pr = torch.nonzero(push).squeeze(1)
        stack[pr, sp[pr]] = far_child[pr]
        sp = sp + push.long()
        stack_hw = torch.maximum(stack_hw, sp.to(i32))

        # Pop where neither hit.
        miss = is_inner & ~hit0 & ~hit1
        new_node = torch.where(is_inner, torch.where(miss, 0, near_child), node)
        new_node, sp = pop(new_node, sp, miss)

        # Leaf child reached: move it to the leaf registers and pop the next
        # traversal node.
        is_leaf_child = in_node & (new_node < 0)
        first = torch.where(is_leaf_child, ~new_node, 0).clamp(0, num_refs)
        count = leaf_counts[first.long()]
        leaf_ptr = torch.where(is_leaf_child, first, leaf_ptr)
        leaf_end = torch.where(is_leaf_child, first + count, leaf_end)
        # Empty leaves retire at once.
        leaf_ptr = torch.where(is_leaf_child & (count == 0), -1, leaf_ptr)
        new_node2, sp = pop(new_node, sp, is_leaf_child)
        node = torch.where(in_node, new_node2, node)

    tri = torch.where(hit_row >= 0, tri_index[hit_row.clamp(0, max(0, num_refs - 1))], -1)
    hits = Hits(tri=tri.to(i32), t=hit_t, u=hit_u, v=hit_v)
    if with_stats:
        return count_stats((hits, {"node_tests": node_tests, "tri_tests": tri_tests,
                                   "stack": stack_hw}))
    return hits
