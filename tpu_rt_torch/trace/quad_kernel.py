"""Traversal of the 4-wide BVH, closest hit and any hit, each with or
without the barycentrics and the per-ray counters: the CUDA kernel, its
plain PyTorch version, and the device tables both read.

Counterpart of the 4-wide (`w4`) form of the Pallas kernel
``tpu_rt/trace/packet2.py`` ``_kernel2`` (through ``trace_packet4``), in
its closest-hit, ``any_hit``, ``want_uv`` and ``count_iters`` forms.  Both
versions here compute what the host oracle ``trace_quad_scalar``
(``tpu_rt_torch/bvh/collapse.py``) computes, in the same order, so their
(tri, t, u, v) equal the oracle's bit for bit -- for any hit too, down to
which occluder is reported: a ray stops at its first accepted hit in the
oracle's visit order.  The counters are per ray: ``node_tests`` quad nodes
visited, ``tri_tests`` triangles tested (the oracle has none, so the kernel
is held to the plain version's).

- ``trace_quad`` dispatches on the device of the rays: a CPU tensor takes
  the plain version, a CUDA tensor launches the kernel
  (``tpu_rt_torch/csrc/quad_trace.cu``) or raises.
- ``trace_quad_plain`` is a wavefront loop over the batch in PyTorch ops:
  each step processes the current node of every live ray.
- ``upload_quad`` turns any object with numpy ``nodes``/``tri_woop``/
  ``tri_index`` (``tpu_rt``'s QuadBVH or the port's) into device tables
  with the same bits, in a residency (``tables.RESIDENCIES``; the
  counterpart of ``trace_packet4``'s ``hbm=``).  The residency changes only
  the kernel's load hints, never the function.

The kernel is built with nvcc for sm_90a at first launch into the port's
git-ignored build directory and loaded with ctypes; ``KERNEL.launches``
counts its launches, ``KERNEL.launches_by_form`` those of each form
(``common.FORMS``).  ``cursors`` > 1 (``trace_packet4``'s ``c=``) holds
leaves and drains them later, in ``quad_trace_c.cu`` (``KERNEL_C``, forms
``closest_c`` ...): t stays the oracle's bit for bit, tri but at exact-t
ties.  ``trace_packet4``'s ``tile``, ``k`` and ``u`` launch the slot forms
(``quad_trace_k<K>.cu``, ``KERNEL_K[K]``; ``common.check_schedule``): the
same results and counters as the default forms, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch.bvh.collapse import COUNT_SHIFT, FIRST_MASK, SENT
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.trace.common import (
    MAX_CURSORS,
    STACK_SIZE,
    CudaTraceKernel,
    HeldLeaves,
    SLOTS,
    TraceState,
    check_cursors,
    check_schedule,
    check_stack,
    drain_plain,
    safe_inv,
    tree_depth,
    visit_masks,
    woop_rows,
)
from tpu_rt_torch.trace.tables import (
    QUAD_NODE_BYTES,
    TABLE_BUDGET,
    WOOP_ROW_BYTES,
    quad_residency,
    check_residency,
)


class QuadTables(NamedTuple):
    """Device tables of one QuadBVH."""

    nodes: torch.Tensor      # [Q, 32] f32, cols 24..28 int32 bits
    woop: torch.Tensor       # [max(R, 1), 16] f32, col 12 the triangle id bits
    depth: int               # levels of the quad tree (0 when empty)
    residency: str = "vmem"  # one of tables.RESIDENCIES


def upload_quad(quad, device, residency=None, budget_bytes: int | None = None) -> QuadTables:
    """Device tables for a QuadBVH: the node records byte for byte, and the
    Woop rows padded to 16 floats with the original triangle id in slot 12.
    A node pushes at most 3 children, so a tree of depth D needs a stack of
    3 * D; a deeper tree raises ``StackDepthError``.

    ``residency=None`` applies ``trace_packet4``'s rule
    (``tables.quad_residency``) to these tables' bytes (128 per node, 64
    per Woop row; ``tpu_rt`` counts its 128-lane-padded tables) within
    ``budget_bytes``, by default ``tables.TABLE_BUDGET`` (none: vmem)."""
    nodes = np.ascontiguousarray(quad.nodes, np.float32)
    if nodes.ndim != 2 or nodes.shape[1] != 32:
        raise ValueError(f"quad nodes must be [Q, 32], got {nodes.shape}")
    depth = tree_depth(np.ascontiguousarray(nodes[:, 24:28]).view(np.int32))
    check_stack(depth, 3 * depth, "quad BVH")
    if nodes.shape[0] >= 2**31:
        raise ValueError("quad_trace indexes nodes with int32")
    woop = woop_rows(quad.tri_woop, quad.tri_index)
    if residency is None:
        budget = TABLE_BUDGET if budget_bytes is None else budget_bytes
        residency = quad_residency(nodes.shape[0] * QUAD_NODE_BYTES,
                                   woop.shape[0] * WOOP_ROW_BYTES, budget)
    # torch.tensor copies the bytes: NaN boxes and link bits stay as built.
    return QuadTables(nodes=torch.tensor(nodes, device=device),
                      woop=torch.tensor(woop, device=device), depth=depth,
                      residency=check_residency(residency))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def trace_quad_plain(tables: QuadTables, rays: Rays, any_hit: bool = False,
                     want_uv: bool = False, with_stats: bool = False,
                     visited: dict | None = None, cursors: int = 1,
                     tile: int | None = None, k: int | None = None, u: int | None = None):
    """Closest hit per ray, or with ``any_hit`` the first accepted hit in
    visit order, as ``trace_quad_scalar``, in PyTorch ops on the device of
    ``rays``.  Every float op is the oracle's, in its order: explicit
    three-term sums, NaN-propagating min/max, 1/d then multiply.  An any-hit
    ray that holds a hit drains no later leaf and leaves the live set.
    Returns what ``trace_quad`` returns.  With ``visited`` (a dict) it also
    records the rows the trace reads, as the kernel reads them:
    ``visited["nodes"]`` and ``["woop"]``, bool masks over the tables' rows
    (``common.visit_masks``).

    ``cursors`` > 1: each hit leaf child, in visit order, is held
    (``common.HeldLeaves``), and a ray drains the leaves it holds, oldest
    first, when it holds ``cursors`` of them or its stack is empty.
    ``tile``, ``k``, ``u``: the slot forms' settings, checked
    (``common.check_schedule``); the function does not depend on them."""
    cursors = check_cursors(cursors)
    check_schedule(tile, k, u, cursors=cursors)
    dev = rays.origin.device
    n = rays.origin.shape[0]
    nodes = tables.nodes.to(dev)
    nodes_i = nodes.view(torch.int32)
    woop = tables.woop.to(dev)
    woop_i = woop.view(torch.int32)
    st = TraceState.start(rays)
    seen = visit_masks(visited, dev, nodes=nodes.shape[0], woop=woop.shape[0])
    if nodes.shape[0] == 0 or n == 0:
        return st.result(want_uv, with_stats)

    d, tmin = rays.dirn, rays.tmin
    idir = safe_inv(d)
    ood = rays.origin * idir
    pos = torch.arange(4, device=dev)

    def drain_links(link, r):
        """Drain leaf ``link`` = ~(first | count << 24) of live row ``r``."""
        c = ~link
        drain_plain(woop, woop_i, c & FIRST_MASK, (c >> COUNT_SHIFT) & 0xFF, ids[r], rays, st,
                    any_hit, None if seen is None else seen["woop"])

    # Live rays (ids), their current node, stack and stack pointer, and the
    # leaves they hold.
    ids = torch.nonzero(~(rays.tmax < 0)).squeeze(1)
    node = torch.zeros_like(ids)
    stack = torch.zeros((ids.shape[0], STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.zeros_like(ids)
    held = HeldLeaves(ids.shape[0], cursors, dev) if cursors > 1 else None
    while ids.numel():
        a = ids.shape[0]
        rows = torch.arange(a, device=dev)
        st.node_tests[ids] += 1
        if seen is not None:
            seen["nodes"][node] = True
        # Slab tests of the four children in stored order.
        box = nodes[node, :24].reshape(a, 4, 6)
        lk = nodes_i[node, 24:28].long()
        hint = nodes_i[node, 28].long()
        ia = idir[ids][:, None, :]
        oa = ood[ids][:, None, :]
        lo = box[:, :, 0::2] * ia - oa
        hi = box[:, :, 1::2] * ia - oa
        mn = torch.minimum(lo, hi)
        mx = torch.maximum(lo, hi)
        near3 = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
        far3 = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
        t0 = tmin[ids][:, None]
        ht = st.t[ids][:, None]
        near = torch.where(t0 > near3, t0, near3)
        far = torch.where(ht < far3, ht, far3)
        hit = (far >= near) & (lk != int(SENT))

        # Visit order: stored if d[hint] >= 0 for this ray, else reversed.
        fwd = d[ids].gather(1, hint[:, None]) >= 0
        perm = torch.where(fwd, pos[None, :], 3 - pos[None, :])
        hit_v = hit.gather(1, perm)
        lk_v = lk.gather(1, perm)

        # Drain the hit leaves in visit order, each triangle in turn (or
        # hold them, and drain what is held once ``cursors`` are held).
        for p in range(4):
            leaf = hit_v[:, p] & (lk_v[:, p] < 0)
            if any_hit:
                leaf &= st.tri[ids] < 0
            sel = torch.nonzero(leaf).squeeze(1)
            if sel.numel():
                if held is None:
                    drain_links(lk_v[sel, p], sel)
                else:
                    held.drain(held.add(sel, lk_v[sel, p]), drain_links)

        # Inner children: go to the first in visit order, push the others
        # last-first so the second pops next.
        inner = hit_v & (lk_v >= 0)
        m = inner.sum(1)
        order = torch.sort((~inner).to(torch.int8), dim=1, stable=True).indices
        inn = lk_v.gather(1, order)
        for i in range(3):
            q = m - 1 - i
            w = torch.nonzero(q >= 1).squeeze(1)
            stack[w, sp[w] + i] = inn[w, q[w]]
        go = m > 0
        pop = ~go & (sp > 0)
        if held is not None:
            # An empty stack: drain what is held before the ray ends.
            held.drain(torch.nonzero(~go & ~pop).squeeze(1), drain_links)
        node = torch.where(go, inn[:, 0], node)
        node = torch.where(pop, stack[rows, (sp - 1).clamp(min=0)], node)
        sp = torch.where(go, sp + (m - 1), torch.where(pop, sp - 1, sp))
        live = go | pop
        if any_hit:
            live &= st.tri[ids] < 0
        ids, node, stack, sp = ids[live], node[live], stack[live], sp[live]
        if held is not None:
            held.keep(live)
    return st.result(want_uv, with_stats)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

class QuadTraceKernel(CudaTraceKernel):
    """Wrapper of ``quad_trace.cu`` or ``quad_trace_c.cu`` (postponed
    leaves; see ``CudaTraceKernel``)."""

    def __init__(self, name: str = "quad_trace", suffix: str = "",
                 cursors: tuple[int, int] = (1, 1),
                 designs: tuple = ("persistent", "first", "shared_stack"),
                 slots: int | None = None):
        super().__init__(name, [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], suffix, cursors,
                         designs, slots)

    def launch_args(self, tables: QuadTables) -> tuple[list, list, dict]:
        """``launch``'s table checks, table arguments and table options."""
        f32 = torch.float32
        checks = [("nodes", tables.nodes, f32, (tables.nodes.shape[0], 32)),
                  ("woop", tables.woop, f32, (tables.woop.shape[0], 16))]
        args = [tables.nodes.data_ptr(), tables.nodes.shape[0], tables.woop.data_ptr()]
        return checks, args, {"residency": tables.residency, "stack_need": 3 * tables.depth}

    def __call__(self, tables: QuadTables, rays: Rays, any_hit: bool = False,
                 want_uv: bool = False, with_stats: bool = False, cursors: int = 1,
                 units: int | None = None, tile: int | None = None):
        checks, args, opts = self.launch_args(tables)
        return self.launch(checks, args, rays, any_hit, want_uv, with_stats, cursors=cursors,
                           units=units, tile=tile, **opts)


KERNEL = QuadTraceKernel()
KERNEL_C = QuadTraceKernel("quad_trace_c", "_c", (2, MAX_CURSORS), ("persistent",))
# The slot forms, one library per K.
KERNEL_K = {k: QuadTraceKernel(f"quad_trace_k{k}", "", (1, 1), ("persistent",), k)
            for k in SLOTS}
KERNELS = (KERNEL, KERNEL_C, *KERNEL_K.values())


def trace_quad(tables: QuadTables, rays: Rays, any_hit: bool = False,
               want_uv: bool = False, with_stats: bool = False, cursors: int = 1,
               tile: int | None = None, k: int | None = None, u: int | None = None):
    """Closest hit per ray over the QuadBVH tables, or with ``any_hit`` the
    first accepted hit in visit order; u, v with ``want_uv`` (else 0) and
    ``(hits, {"node_tests", "tri_tests"})`` with ``with_stats``.  CPU rays
    take the plain version; CUDA rays launch the kernel (there is no
    fallback).  Counterpart of ``tpu_rt`` ``trace_packet4``, whose ``c=``
    is ``cursors``: leaves a ray holds before it drains them,
    1..MAX_CURSORS (``quad_trace_c.cu`` for more than 1), and whose
    ``tile``, ``k`` and ``u`` launch the slot forms
    (``common.check_schedule``: any of them given, ``quad_trace_k<k>.cu``;
    not with ``cursors`` > 1)."""
    cursors = check_cursors(cursors)
    schedule = check_schedule(tile, k, u, cursors=cursors)
    dev = rays.origin.device
    if dev.type == "cpu":
        return trace_quad_plain(tables, rays, any_hit, want_uv, with_stats, cursors=cursors,
                                tile=tile, k=k, u=u)
    if dev.type == "cuda":
        if schedule is not None:
            return KERNEL_K[schedule[0]](tables, rays, any_hit, want_uv, with_stats, cursors,
                                         units=u, tile=tile)
        kernel = KERNEL_C if cursors > 1 else KERNEL
        return kernel(tables, rays, any_hit, want_uv, with_stats, cursors)
    raise ValueError(f"trace_quad: unsupported device {dev}")
