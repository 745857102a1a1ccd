"""Rays sharded over the ranks of a ``torch.distributed`` group, geometry
replicated.

Counterpart of ``tpu_rt.dist.sharding``, on processes instead of a device
mesh:

- A rank is a process with one device.  ``RayMesh`` holds the group, the
  world size, this rank and its device; without a process group it is a
  world of 1, so every function here also runs in a single process.
- Rays are batch-data-parallel: rank ``r`` holds the contiguous block of
  the global batch that ``P("rays")`` gives device ``r`` in ``tpu_rt``, and
  traces it with its own tracer (the wavefront, or a CUDA traversal kernel
  from ``make_routing_tracer``).  The forward trace calls NO collective.
- The BVH tables are replicated: every rank holds the same host arrays and
  uploads them to its own device, which needs no collective either.
- Backward: the loss and the vertex and material gradients are summed over
  the ranks, three ``all_reduce`` calls, the only communication in a step.

Results are rank-local: ``trace_sharded`` and ``render_diff_sharded`` return
this rank's block; ``grad_step_sharded``'s three results are the same on
every rank.  ``collective_audit`` counts the collectives the process
calls, as ``torch.profiler`` records them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_rt_torch.core.types import FlatBVH, Hits, Rays
from tpu_rt_torch.diff.shading import render_image_diff, shade_hits_diff
from tpu_rt_torch.diff.tracer import trace_diff
from tpu_rt_torch.diff.train import _deterministic
from tpu_rt_torch.trace.wavefront import device_bvh, trace_wavefront


class RayMesh(NamedTuple):
    """The ray axis: ``size`` ranks of ``group`` (None: a world of 1 in this
    process), this process's ``rank`` and the device it traces on."""

    group: object
    size: int
    rank: int
    device: torch.device


def make_ray_mesh(device="cuda", group=None) -> RayMesh:
    """The ray axis over the ranks of ``group`` (default: the default group
    when one is initialized, else a world of 1), tracing on ``device``
    ("cuda": the current CUDA device, which ``init_multihost`` sets to
    ``cuda:LOCAL_RANK`` for NCCL)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    elif device.type == "cpu":
        device = torch.device("cpu")  # where CPU tensors report they are
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return RayMesh(None, 1, 0, device)
    return RayMesh(group, dist.get_world_size(group), dist.get_rank(group), device)


def shard_rows(x, mesh: RayMesh) -> torch.Tensor:
    """This rank's contiguous block of the rows of a global array, on the
    rank's device.  The row count must divide by the mesh size."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"row count {n} not divisible by {mesh.size} ranks; pad_rays first")
    block = n // mesh.size
    return x[mesh.rank * block:(mesh.rank + 1) * block].to(mesh.device).contiguous()


def shard_rays(rays: Rays, mesh: RayMesh) -> Rays:
    """This rank's block of a global ray batch (pads are the caller's job:
    N must divide by the mesh size -- use ``tpu_rt_torch.core.types.pad_rays``)."""
    return Rays(*(shard_rows(x, mesh) for x in rays))


def replicate_bvh(flat: FlatBVH, mesh: RayMesh) -> FlatBVH:
    """The scene's FlatBVH on this rank's device (a host FlatBVH is
    uploaded by ``device_bvh``).  Every rank holds the same host arrays, so
    this needs no collective."""
    if isinstance(flat.nodes, np.ndarray):
        return device_bvh(flat, mesh.device)
    return FlatBVH(*(x.to(mesh.device) for x in flat))


def _check_device(mesh: RayMesh, rays: Rays) -> None:
    # A rank traces on its own device only: never on another, never the CPU
    # in place of its card.
    if rays.origin.device != mesh.device:
        raise ValueError(f"rays on {rays.origin.device}, the mesh traces on {mesh.device}; "
                         "shard_rays places them")


def _check_pair(routing, tables) -> None:
    if routing is not None and tables is None:
        raise ValueError("routing given without tables: pass the (fn, tables) pair from "
                         "make_routing_tracer together")


def _route(routing, tables, rays: Rays) -> Hits | None:
    """The stop-gradient routing hits: ``routing``'s, or None, which lets
    ``trace_diff`` route with the wavefront over ``flat``."""
    _check_pair(routing, tables)
    return None if routing is None else routing(tables, rays, False)


def trace_sharded(flat: FlatBVH, rays: Rays, mesh: RayMesh, any_hit: bool = False,
                  routing=None, tables=None) -> Hits:
    """Trace this rank's block of rays (from ``shard_rays``); returns its
    Hits.  No collective: each rank runs its own traversal.

    routing/tables: the (fn, tables) pair from ``make_routing_tracer`` on
    the mesh's device -- on the card the CUDA traversal kernels.  Default:
    the wavefront over ``flat`` (from ``replicate_bvh``)."""
    _check_device(mesh, rays)
    _check_pair(routing, tables)
    if routing is None:
        routing, tables = trace_wavefront, flat
    return routing(tables, rays, any_hit)


def render_diff_sharded(mesh: RayMesh, flat, rays: Rays, vtx_pos, tri_vtx_index,
                        tri_material, routing=None, tables=None) -> torch.Tensor:
    """Differentiable render of this rank's rays: [n, 3] RGB, geometry
    replicated.  routing/tables (``make_routing_tracer``) route the
    stop-gradient trace; default the wavefront over ``flat``."""
    _check_device(mesh, rays)
    hits = trace_diff(False, flat, rays, vtx_pos, tri_vtx_index, _route(routing, tables, rays))
    return shade_hits_diff(hits.tri, vtx_pos, tri_vtx_index, tri_material)


def _all_reduce(x: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def grad_step_sharded(mesh: RayMesh, flat, rays: Rays, vtx_pos, tri_vtx_index, tri_material,
                      target, routing=None, tables=None) -> tuple:
    """One 'training step': this rank's forward render, the L2 image loss
    against its block of ``target`` ([n, 3], ``shard_rows``), backward with
    the loss, vertex and material gradients summed over the ranks (three
    ``all_reduce`` calls) and scaled to the mean over the global batch.

    The backward runs deterministically, as ``diff/train.py``'s
    ``train_step``.  routing/tables route the stop-gradient trace as in
    ``render_diff_sharded``; gradients flow through the recompute only.

    Returns (loss, grad_vtx_pos, grad_tri_material), the same on every
    rank."""
    n_local = rays.origin.shape[0]
    if tuple(target.shape) != (n_local, 3):
        raise ValueError(f"target {tuple(target.shape)}: want this rank's block ({n_local}, 3)")
    _check_device(mesh, rays)
    vp = vtx_pos.detach().clone().requires_grad_(True)
    mat = tri_material.detach().clone().requires_grad_(True)
    rgb = render_image_diff(flat, rays, vp, tri_vtx_index, mat, _route(routing, tables, rays))
    loss = torch.sum((rgb - target) ** 2)
    with _deterministic():
        loss.backward()
    # The only collectives of the step.  The global ray count comes from
    # the group's size, not from a collective.
    out = [_all_reduce(x, mesh) for x in (loss.detach(), vp.grad, mat.grad)]
    scale = 1.0 / (n_local * mesh.size * 3)
    return tuple(x * scale for x in out)


# c10d's collective ops (the profiler's "c10d::<op>" events) under
# tpu_rt's StableHLO names; an op not listed counts under its own name.
COLLECTIVE_OPS = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather", "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter", "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "broadcast_": "collective_broadcast",
    "send": "collective_permute", "recv_": "collective_permute",
    "recv_any_source_": "collective_permute",
}


def _count_collectives(event_names) -> dict:
    """Occurrences of each collective among profiler event names: every
    ``c10d::`` op, under ``COLLECTIVE_OPS``' name."""
    out = {}
    for name in event_names:
        if name.startswith("c10d::"):
            op = COLLECTIVE_OPS.get(name[6:], name[6:])
            out[op] = out.get(op, 0) + 1
    return out


def _profiled_collectives(fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return _count_collectives(e.name for e in prof.events())


def collective_audit(mesh: RayMesh, flat, rays: Rays, vtx_pos, tri_vtx_index, tri_material,
                     target, routing=None, tables=None) -> dict:
    """Mechanical proof of the zero-forward-collective design: one
    ``trace_sharded`` and one ``grad_step_sharded`` on this rank's rays,
    each under ``torch.profiler``, counting every collective the process
    calls (c10d's ops, whoever makes them).

    Expected: forward {} and grad step {"all_reduce": 3} (loss, vertex and
    material gradients).  Without a process group nothing is reduced, and
    the grad step counts {} too."""
    def forward():
        hits = trace_sharded(flat, rays, mesh, routing=routing, tables=tables)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return hits

    return {
        "n_devices": mesh.size,
        "forward": _profiled_collectives(forward),
        "grad_step": _profiled_collectives(lambda: grad_step_sharded(
            mesh, flat, rays, vtx_pos, tri_vtx_index, tri_material, target,
            routing=routing, tables=tables)),
    }
