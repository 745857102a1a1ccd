"""Traversal of the binary BVH (FlatBVH), closest hit and any hit, each with
or without the barycentrics and the per-ray counters: the CUDA kernel, its
plain PyTorch version, and the device tables both read.

Counterpart of the binary f32 node-unit form of the Pallas kernel
``tpu_rt/trace/packet2.py`` ``_kernel2`` (through ``trace_packet2`` and
``make_routing_tracer(prefer="packet")``).  Both versions here compute what
the host oracle ``trace_flat_scalar`` (``tpu_rt_torch/trace/
cpu_reference.py``) computes, in the same order, so their (tri, t, u, v)
equal the oracle's bit for bit, and their ``node_tests`` / ``tri_tests``
equal its ``RayStats.per_ray_node_tests`` / ``per_ray_tri_tests``.  For any
hit a ray stops at its first accepted hit in the oracle's visit order, so
the occluder is the oracle's too.  (The Pallas kernel orders a packet's
children by a split-axis vote, so against ``trace_packet2`` only hit vs
miss of an any-hit ray is comparable.)

- ``trace_flat`` dispatches on the device of the rays: a CPU tensor takes
  the plain version, a CUDA tensor launches the kernel
  (``tpu_rt_torch/csrc/flat_trace.cu``) or raises.
- ``trace_flat_plain`` is a wavefront loop over the batch in PyTorch ops:
  each step moves every live ray by one node or one whole leaf.
- ``upload_flat`` turns ``tpu_rt``'s or the port's FlatBVH (numpy) into
  device tables with the same bits, or with bf16 node records
  (``tables.pack_bf16_nodes``), in a residency (``tables.RESIDENCIES``):
  the counterpart of ``trace_packet2``'s ``bf16_nodes=`` and ``hbm=``.

With bf16 node records the boxes are rounded outward, so the hits keep the
f32 tree's ``t`` (and ``tri`` up to exact-``t`` ties) while the visit order
and counters are the bf16 tree's; the kernel's bf16 forms equal the plain
version's bit for bit, the oracle's only in ``t``.

The triangle phase has two more forms, ``trace_packet2``'s ``c=`` and
``mxu=``: ``cursors`` > 1 holds leaves and drains them later
(``flat_trace_c.cu``; t still the oracle's bit for bit, tri but at exact-t
ties, more node tests), and ``mxu=True`` tests each leaf whole with the
tensor cores (``flat_trace_mxu.cu``; f32-class t, ties to the largest
triangle id).  Each is held to its plain version here, which takes the
same ``mxu`` and ``cursors``.

``trace_packet2``'s ``tile``, ``k`` and ``u`` launch the slot forms
(``flat_trace_k<K>.cu``, ``KERNEL_K[K]``): K rays a thread, U Woop rows
read at once, a block's pool of ``tile`` rays.  Each ray is traced by the
same ops, so their results and counters are the default forms' bit for
bit; the plain version takes and checks the same arguments and computes
what it computes without them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.trace.common import (
    MAX_CURSORS,
    MXU_LEAF,
    STACK_SIZE,
    CudaTraceKernel,
    HeldLeaves,
    SLOTS,
    TraceState,
    check_cursors,
    check_schedule,
    check_stack,
    drain_mxu_plain,
    drain_plain,
    safe_inv,
    tree_depth,
    visit_masks,
    woop_rows,
)
from tpu_rt_torch.trace.tables import (
    TABLE_BUDGET,
    choose_node_format,
    pack_bf16_nodes,
    check_residency,
    tables2_residency,
)


class FlatTables(NamedTuple):
    """Device tables of one FlatBVH."""

    nodes: torch.Tensor        # [N, 16] f32, cols 12..15 int32 bits; bf16: [N, 8] i32
    woop: torch.Tensor         # [max(R, 1), 16] f32, col 12 the triangle id bits
    leaf_counts: torch.Tensor  # [R + 1] i32, the last entry the empty leaf
    depth: int                 # inner-node levels (0 when empty)
    residency: str = "vmem"    # one of tables.RESIDENCIES
    bf16_nodes: bool = False   # nodes as bf16 records (tables.pack_bf16_nodes)
    max_leaf: int = 0          # triangles of the widest leaf (mxu=True takes <= MXU_LEAF)


def upload_flat(flat, device, residency=None, bf16_nodes: bool | None = None,
                budget_bytes: int | None = None) -> FlatTables:
    """Device tables for a FlatBVH: the node rows (or their bf16 records)
    and leaf counts byte for byte, and the Woop rows padded to 16 floats
    with the original triangle id in slot 12 (so no ``tri_index`` gather is
    needed).  The binary stack holds at most one entry per level, so a tree
    deeper than ``STACK_SIZE`` raises ``StackDepthError``.

    As ``trace_packet2``: ``bf16_nodes=None`` takes the node format (and,
    unless given, the residency) from ``choose_node_format``; a given
    format with ``residency=None`` takes ``tables2_residency``.  The policy's
    budget is ``budget_bytes``, by default ``tables.TABLE_BUDGET`` (none:
    vmem f32) on every device."""
    nodes = np.ascontiguousarray(flat.nodes, np.float32)
    if nodes.ndim != 2 or nodes.shape[1] != 16:
        raise ValueError(f"flat nodes must be [N, 16], got {nodes.shape}")
    depth = tree_depth(np.ascontiguousarray(nodes[:, 12:14]).view(np.int32))
    check_stack(depth, depth, "binary BVH")
    counts = np.ascontiguousarray(flat.leaf_counts, np.int32)
    if nodes.shape[0] >= 2**31 or counts.shape[0] >= 2**31:
        raise ValueError("flat_trace indexes nodes and leaves with int32")
    if counts.shape[0] == 0:
        counts = np.zeros(1, np.int32)
    if bf16_nodes is None or residency is None:
        budget = TABLE_BUDGET if budget_bytes is None else budget_bytes
        if bf16_nodes is None:
            auto, bf16_nodes = choose_node_format(flat, budget)
            residency = auto if residency is None else residency
        elif residency is None:
            residency = tables2_residency(flat, bf16_nodes, budget)
    residency = check_residency(residency)
    if bf16_nodes:
        nodes = pack_bf16_nodes(nodes)
    woop = woop_rows(flat.tri_woop, flat.tri_index)
    return FlatTables(nodes=torch.tensor(nodes, device=device),
                      woop=torch.tensor(woop, device=device),
                      leaf_counts=torch.tensor(counts, device=device), depth=depth,
                      residency=residency, bf16_nodes=bool(bf16_nodes),
                      max_leaf=int(counts.max()))


def decode_bf16_nodes(nodes: torch.Tensor) -> torch.Tensor:
    """bf16 node records [N, 8] i32 as f32 node rows [N, 16]: each bound
    widened exactly (low half ``w << 16``, high half ``w & 0xFFFF0000``),
    the links in cols 12, 13 as int32 bits, cols 14, 15 zero."""
    words = nodes[:, :6]
    lo = (words << 16).view(torch.float32)
    hi = (words & -65536).view(torch.float32)
    bounds = torch.stack((lo, hi), dim=2).reshape(-1, 12)
    links = nodes[:, 6:8].contiguous().view(torch.float32)
    return torch.cat((bounds, links, torch.zeros_like(links)), dim=1)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

# Columns of child 0's and child 1's (lo.x, lo.y, lo.z) and (hi.x, hi.y, hi.z).
_LO = ((0, 2, 8), (4, 6, 10))
_HI = ((1, 3, 9), (5, 7, 11))


def check_mxu(tables: FlatTables) -> None:
    """The tensor-core leaf test takes leaves of at most MXU_LEAF triangles
    (tpu_rt's ``pack_tables2`` refuses wider ones)."""
    if tables.max_leaf > MXU_LEAF:
        raise ValueError(f"mxu=True takes leaves of at most {MXU_LEAF} triangles; this tree "
                         f"has a leaf of {tables.max_leaf}")


def trace_flat_plain(tables: FlatTables, rays: Rays, any_hit: bool = False,
                     want_uv: bool = False, with_stats: bool = False,
                     visited: dict | None = None, mxu: bool = False, cursors: int = 1,
                     tile: int | None = None, k: int | None = None, u: int | None = None):
    """Closest hit per ray, or with ``any_hit`` the first accepted hit in
    visit order, as ``trace_flat_scalar``, in PyTorch ops on the device of
    ``rays``.  Every float op is the oracle's, in its order, on the f32
    rows or on the bf16 records widened as the kernel widens them (the
    residency does not change the function).  In each step a
    ray at an inner node tests both children and goes to the nearer hit one
    (pushing the other) or pops; a ray at a leaf link drains the leaf and
    pops.  Returns what ``trace_flat`` returns.  With ``visited`` (a dict)
    it also records the rows the trace reads, as the kernel reads them:
    ``visited["nodes"]``, ``["woop"]`` and ``["leaf_counts"]``, bool masks
    over the tables' rows (``common.visit_masks``).

    ``cursors`` > 1: a ray at a leaf link holds it and pops instead
    (``common.HeldLeaves``); it drains the leaves it holds, oldest first,
    when it holds ``cursors`` of them or its stack is empty.  ``mxu``: each
    leaf is tested whole by ``common.drain_mxu_plain``, the tensor-core
    leaf test's function.  ``tile``, ``k``, ``u``: the slot forms' settings,
    checked (``common.check_schedule``); the function does not depend on
    them."""
    cursors = check_cursors(cursors)
    check_schedule(tile, k, u, mxu, cursors)
    if mxu:
        check_mxu(tables)
    dev = rays.origin.device
    n = rays.origin.shape[0]
    nodes = tables.nodes.to(dev)
    if tables.bf16_nodes:
        nodes = decode_bf16_nodes(nodes)
    links = nodes.view(torch.int32)[:, 12:14]
    woop = tables.woop.to(dev)
    woop_i = woop.view(torch.int32)
    counts = tables.leaf_counts.to(dev)
    st = TraceState.start(rays)
    seen = visit_masks(visited, dev, nodes=nodes.shape[0], woop=woop.shape[0],
                       leaf_counts=counts.shape[0])
    if nodes.shape[0] == 0 or n == 0:
        return st.result(want_uv, with_stats)

    idir = safe_inv(rays.dirn)
    ood = rays.origin * idir
    lo_cols = torch.tensor(_LO, device=dev)
    hi_cols = torch.tensor(_HI, device=dev)

    drain = drain_mxu_plain if mxu else drain_plain

    def drain_links(link, r):
        """Drain leaf ``link`` of live row ``r`` (one per row)."""
        first = ~link
        leaf = first.clamp(max=counts.shape[0] - 1)
        if seen is not None:
            seen["leaf_counts"][leaf] = True
        drain(woop, woop_i, first, counts[leaf], ids[r], rays, st, any_hit,
              None if seen is None else seen["woop"])

    # Live rays (ids), their current link (>= 0 inner, < 0 leaf), stack and
    # stack pointer, and the leaves they hold.
    ids = torch.nonzero(~(rays.tmax < 0)).squeeze(1)
    node = torch.zeros_like(ids)
    stack = torch.zeros((ids.shape[0], STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.zeros_like(ids)
    held = HeldLeaves(ids.shape[0], cursors, dev) if cursors > 1 else None
    while ids.numel():
        rows = torch.arange(ids.shape[0], device=dev)
        pop = torch.zeros_like(ids, dtype=torch.bool)
        at_leaf = torch.nonzero(node < 0).squeeze(1)

        # Inner nodes: slab tests of both children.
        sel = torch.nonzero(node >= 0).squeeze(1)
        if sel.numel():
            r = ids[sel]
            nd = node[sel]
            st.node_tests[r] += 1
            if seen is not None:
                seen["nodes"][nd] = True
            box = nodes[nd]
            ia = idir[r][:, None, :]
            oa = ood[r][:, None, :]
            lo = box[:, lo_cols] * ia - oa                  # [s, 2, 3]
            hi = box[:, hi_cols] * ia - oa
            mn = torch.minimum(lo, hi)
            mx = torch.maximum(lo, hi)
            near3 = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
            far3 = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
            t0 = rays.tmin[r][:, None]
            ht = st.t[r][:, None]
            near = torch.where(t0 > near3, t0, near3)
            far = torch.where(ht < far3, ht, far3)
            h0, h1 = (far >= near).unbind(1)
            c0, c1 = links[nd].long().unbind(1)
            # Both hit: the nearer entry next (c1min < c0min swaps), the
            # other pushed; one hit: that one; none: pop.
            both = h0 & h1
            swap = both & (near[:, 1] < near[:, 0])
            b = sel[both]
            stack[b, sp[b]] = torch.where(swap, c0, c1)[both]
            sp[b] += 1
            node[sel] = torch.where(swap | ~h0, c1, c0)
            pop[sel] = ~h0 & ~h1

        # Rays that started the step at a leaf link: drain it (or hold it,
        # and drain what they hold once they hold ``cursors``), then pop.
        sel = at_leaf
        if sel.numel():
            if held is None:
                drain_links(node[sel], sel)
            else:
                held.drain(held.add(sel, node[sel]), drain_links)
            pop[sel] = True

        can = pop & (sp > 0)
        if held is not None:
            # An empty stack: drain what is held before the ray ends.
            held.drain(torch.nonzero(pop & ~can).squeeze(1), drain_links)
        node = torch.where(can, stack[rows, (sp - 1).clamp(min=0)], node)
        sp = torch.where(can, sp - 1, sp)
        live = ~pop | can
        if any_hit:
            live &= st.tri[ids] < 0
        ids, node, stack, sp = ids[live], node[live], stack[live], sp[live]
        if held is not None:
            held.keep(live)
    return st.result(want_uv, with_stats)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

class FlatTraceKernel(CudaTraceKernel):
    """Wrapper of a binary kernel library (see ``CudaTraceKernel``):
    ``flat_trace.cu`` or ``flat_trace_c.cu`` (postponed leaves)."""

    def __init__(self, name: str = "flat_trace", suffix: str = "",
                 cursors: tuple[int, int] = (1, 1),
                 designs: tuple = ("persistent", "first", "shared_stack"),
                 slots: int | None = None):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(name, [vp, ci, ci, vp, vp, ci], suffix, cursors, designs, slots)

    def launch_args(self, tables: FlatTables) -> tuple[list, list, dict]:
        """``launch``'s table checks, table arguments and table options."""
        f32 = torch.float32
        nc = tables.leaf_counts.shape[0]
        node_spec = (torch.int32, 8) if tables.bf16_nodes else (f32, 16)
        checks = [("nodes", tables.nodes, node_spec[0], (tables.nodes.shape[0], node_spec[1])),
                  ("woop", tables.woop, f32, (tables.woop.shape[0], 16)),
                  ("leaf_counts", tables.leaf_counts, torch.int32, (nc,))]
        args = [tables.nodes.data_ptr(), tables.nodes.shape[0], int(tables.bf16_nodes),
                tables.woop.data_ptr(), tables.leaf_counts.data_ptr(), nc]
        return checks, args, {"residency": tables.residency, "bf16_nodes": tables.bf16_nodes,
                              "stack_need": tables.depth}

    def __call__(self, tables: FlatTables, rays: Rays, any_hit: bool = False,
                 want_uv: bool = False, with_stats: bool = False, cursors: int = 1,
                 units: int | None = None, tile: int | None = None):
        checks, args, opts = self.launch_args(tables)
        return self.launch(checks, args, rays, any_hit, want_uv, with_stats, cursors=cursors,
                           units=units, tile=tile, **opts)


class FlatMxuKernel(FlatTraceKernel):
    """Wrapper of ``flat_trace_mxu.cu``, the tensor-core leaf test with
    1..MAX_CURSORS leaves held per ray (and, for its vmem f32 frame forms,
    the first version, ``design="first"``); refuses leaves wider than
    MXU_LEAF."""

    def __init__(self):
        super().__init__("flat_trace_mxu", "_mxu", (1, MAX_CURSORS),
                         ("persistent", "first"))

    def __call__(self, tables: FlatTables, rays: Rays, any_hit: bool = False,
                 want_uv: bool = False, with_stats: bool = False, cursors: int = 1):
        check_mxu(tables)
        return super().__call__(tables, rays, any_hit, want_uv, with_stats, cursors)


# Dynamic shared memory per block of the tensor-core form's designs
# (mxu_leaf.cuh): a warp's ray table (MxuRays, 1,408 bytes) or, in the first
# version, its product table (MxuWarp, 7,104 bytes), for each of 4 warps.
MXU_SMEM = {"persistent": 4 * 1408, "first": 4 * 7104}

KERNEL = FlatTraceKernel()
KERNEL_C = FlatTraceKernel("flat_trace_c", "_c", (2, MAX_CURSORS), ("persistent",))
KERNEL_MXU = FlatMxuKernel()
# The slot forms, one library per K.
KERNEL_K = {k: FlatTraceKernel(f"flat_trace_k{k}", "", (1, 1), ("persistent",), k)
            for k in SLOTS}
KERNELS = (KERNEL, KERNEL_C, KERNEL_MXU, *KERNEL_K.values())


def kernel_for(mxu: bool, cursors: int) -> FlatTraceKernel:
    """The library of a form: the tensor-core leaf test, postponed leaves
    (cursors > 1) or the first versions' forms."""
    return KERNEL_MXU if mxu else KERNEL_C if cursors > 1 else KERNEL


def trace_flat(tables: FlatTables, rays: Rays, any_hit: bool = False,
               want_uv: bool = False, with_stats: bool = False, mxu: bool = False,
               cursors: int = 1, tile: int | None = None, k: int | None = None,
               u: int | None = None):
    """Closest hit per ray over the FlatBVH tables, or with ``any_hit`` the
    first accepted hit in visit order; u, v with ``want_uv`` (else 0) and
    ``(hits, {"node_tests", "tri_tests"})`` with ``with_stats``.  CPU rays
    take the plain version; CUDA rays launch the kernel (there is no
    fallback).  Counterpart of ``tpu_rt`` ``trace_packet2``, whose ``c=``
    and ``mxu=`` are ``cursors`` (leaves a ray holds before it drains them,
    1..MAX_CURSORS) and ``mxu`` (the tensor-core leaf test; leaves of at
    most MXU_LEAF triangles, else ValueError), and whose ``tile``, ``k``
    and ``u`` launch the slot forms (``common.check_schedule``: any of them
    given, ``flat_trace_k<k>.cu``; not with ``mxu`` or ``cursors`` > 1)."""
    cursors = check_cursors(cursors)
    schedule = check_schedule(tile, k, u, mxu, cursors)
    if mxu:
        check_mxu(tables)
    dev = rays.origin.device
    if dev.type == "cpu":
        return trace_flat_plain(tables, rays, any_hit, want_uv, with_stats, mxu=mxu,
                                cursors=cursors, tile=tile, k=k, u=u)
    if dev.type == "cuda":
        if schedule is not None:
            return KERNEL_K[schedule[0]](tables, rays, any_hit, want_uv, with_stats, cursors,
                                         units=u, tile=tile)
        return kernel_for(mxu, cursors)(tables, rays, any_hit, want_uv, with_stats, cursors)
    raise ValueError(f"trace_flat: unsupported device {dev}")
