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

from tpu_rt_torch.trace.common import (
    MAX_CURSORS,
    MAX_UNITS,
    MXU_LEAF,
    SLOTS,
    StackDepthError,
    check_cursors,
    check_schedule,
    release_persisting_l2,
)
from tpu_rt_torch.trace.cpu_reference import (
    RayStats,
    assign_treelets,
    intersect_brute,
    trace_flat_scalar,
)
from tpu_rt_torch.trace.flat_kernel import FlatTables, check_mxu, trace_flat, upload_flat
from tpu_rt_torch.trace.quad_kernel import QuadTables, trace_quad, upload_quad
from tpu_rt_torch.trace.tables import (
    RESIDENCIES,
    TABLE_BUDGET,
    VMEM_TABLE_BUDGET,
    choose_node_format,
    quad_policy,
    tables2_residency,
)
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
    "RESIDENCIES",
    "TABLE_BUDGET",
    "VMEM_TABLE_BUDGET",
    "choose_node_format",
    "quad_policy",
    "tables2_residency",
    "release_persisting_l2",
    "route_kind",
    "kernel_order",
    "MAX_CURSORS",
    "MXU_LEAF",
    "check_cursors",
    "SLOTS",
    "MAX_UNITS",
    "check_schedule",
]

TRACERS = ("auto", "packet4", "pallas", "packet", "xla")


def route_kind(tables, route: str, mxu: bool = False, cursors: int = 1,
               tile: int | None = None, k: int | None = None, u: int | None = None) -> str:
    """``kind`` of a kernel route: "quad-" or "flat-", then "cuda" or
    "plain", then ``tpu_rt``'s suffixes for a residency other than vmem
    ("-mixed", "-hbm") and for bf16 nodes ("-bf16"), then "-mxu" for the
    tensor-core leaf test, "-c<cursors>" for more than one leaf held per
    ray (e.g. "flat-cuda-mxu-c2"), and "-k<k>", "-u<u>", "-t<tile>" for the
    slot forms' settings given (e.g. "quad-cuda-k2-t512")."""
    kind = ("flat" if isinstance(tables, FlatTables) else "quad") + f"-{route}"
    if tables.residency != "vmem":
        kind += f"-{tables.residency}"
    kind += "-bf16" if getattr(tables, "bf16_nodes", False) else ""
    kind += ("-mxu" if mxu else "") + (f"-c{cursors}" if cursors > 1 else "")
    return kind + "".join(f"-{tag}{x}" for tag, x in (("k", k), ("u", u), ("t", tile))
                          if x is not None)


def kernel_order(prefer: str, route: str) -> tuple[str, ...]:
    """The kernels a kernel route tries in turn ("packet4" the 4-wide,
    "packet" the binary), for ``make_routing_tracer``'s ``prefer`` on the
    ``route`` "cuda" or "plain".  Each is taken unless its tables' stack
    check refuses the tree (``StackDepthError``); the next then takes it,
    and the last one's refusal raises.  "auto" on the card tries the binary
    kernel first: it beat the 4-wide kernel on every tree timed on the H100,
    the deepest and largest included.  "pallas", and "auto" on the CPU,
    keep ``tpu_rt``'s order, 4-wide first: the plain route is held against
    ``tpu_rt``."""
    if prefer == "auto" and route == "cuda":
        return ("packet", "packet4")
    if prefer in ("auto", "pallas"):
        return ("packet4", "packet")
    return (prefer,)


def make_routing_tracer(flat, prefer: str = "auto", device="cuda", want_uv: bool = False,
                        cache_dir: str | None = None, budget_bytes: int | None = None,
                        residency: str | None = None, bf16_nodes: bool | None = None,
                        mxu: bool = False, cursors: int = 1, tile: int | None = None,
                        k: int | None = None, u: int | None = None):
    """Returns (fn, kind, tables): fn(tables, rays, any_hit=False,
    with_stats=False) -> Hits (closest hit, or with ``any_hit`` the first
    accepted hit), or ``(Hits, {"node_tests", "tri_tests", "stack"})`` with
    ``with_stats``; ``kind`` names the route; ``tables`` are the scene's
    device tables.

    device: "cuda" (the default) launches the kernels; "cpu" runs their
    plain PyTorch versions.  There is no fallback from one to the other.

    want_uv: a config of the tracer, as in ``tpu_rt``: without it the
    kernels return u = v = 0 (the frame path reads only tri and t); the
    wavefront always fills u, v.

    prefer:
      "packet4" — the 4-wide BVH (collapse4 with ``quad_policy``'s leaf
                  width: 16, or 32 when the binary f32 node table exceeds
                  the budget), kind "quad-cuda" (the CUDA kernel) or
                  "quad-plain" (its plain PyTorch version, on the CPU),
                  with "-mixed" / "-hbm" for those residencies; raises if
                  the quad tree is too deep for the kernel's stack;
      "packet"  — the binary FlatBVH in ``choose_node_format``'s residency
                  and node format, kind "flat-cuda" / "flat-plain" with
                  "-mixed" / "-hbm" and "-bf16" (e.g.
                  "flat-cuda-mixed-bf16");
      "pallas"  — packet4, then packet;
      "auto"    — on the card, packet; only a binary tree too deep for
                  the binary stack falls to packet4, with a RuntimeWarning
                  (the binary kernel beat the 4-wide one on every tree
                  timed on the H100, so the 4-wide collapse runs only
                  then); on the CPU, ``tpu_rt``'s order: packet4, and only
                  a quad tree too deep for the quad stack falls to packet.
                  ``tpu_rt`` falls further to the wavefront; the port never
                  does: a tree neither kernel's stack holds raises
                  (``kernel_order``);
      "xla"     — the wavefront tracer on ``device``, kind "wavefront".
    cache_dir: consult/populate the quad-collapse cache (bvh.cache) and the
    leaf-width tune file (``tables._tune_path``).
    budget_bytes: the placement policy's budget; default ``TABLE_BUDGET``
    on every device (none: vmem f32 tables, 16-wide leaves);
    ``VMEM_TABLE_BUDGET`` gives ``tpu_rt``'s decisions.  A caller whose
    tables come out ``mixed`` calls ``release_persisting_l2()`` after its
    frame.
    residency, bf16_nodes: force the tables' residency (either kernel) and
    the binary kernel's node format, as ``trace_packet2``'s and
    ``trace_packet4``'s ``hbm=`` and ``bf16_nodes=``; None applies the
    policy.
    mxu, cursors: the triangle phase, the counterparts of ``tpu_rt``'s
    ``TPU_RT_MXU`` and ``TPU_RT_C`` (the port reads no environment
    variable).  ``cursors`` (1..MAX_CURSORS): leaves a ray holds before it
    drains them, on either kernel.  ``mxu=True``: the binary kernel's
    tensor-core leaf test, on leaves of at most MXU_LEAF triangles; only
    ``"packet"`` takes it (``tpu_rt``'s packet4 ignores ``TPU_RT_MXU``, and
    an argument is not ignored: ``"packet4"``, ``"auto"`` and ``"pallas"``
    raise ValueError).  The wavefront (``"xla"``) takes neither.
    tile, k, u: ``tpu_rt``'s packet tile, interleave and triangle units,
    passed to whichever kernel the route takes: any of them given launches
    its slot forms (``common.check_schedule``: K rays a thread, U Woop rows
    read at once, a block's pool of ``tile`` rays; the same hits).  Not
    with ``mxu`` or ``cursors`` > 1, and not on the wavefront: ValueError.
    """
    if prefer not in TRACERS:
        raise ValueError(f"unknown tracer {prefer!r}; one of {TRACERS}")
    cursors = check_cursors(cursors)
    if mxu and prefer != "packet":
        raise ValueError(f"mxu=True needs the binary kernel (prefer='packet'), not {prefer!r}")
    schedule = check_schedule(tile, k, u, mxu, cursors)
    device = torch.device(device)
    route = "cuda" if device.type == "cuda" else "plain"
    if prefer == "xla":
        if cursors != 1:
            raise ValueError("the wavefront tracer ('xla') has no leaf cursors")
        if schedule is not None:
            raise ValueError("the wavefront tracer ('xla') has no tile, k or u")
        return trace_wavefront, "wavefront", device_bvh(flat, device)
    slots = {"tile": tile, "k": k, "u": u}

    def quad_route():
        from tpu_rt_torch.bvh.cache import load_or_collapse_quad

        budget = TABLE_BUDGET if budget_bytes is None else budget_bytes
        quad = load_or_collapse_quad(flat, leaf_max=quad_policy(flat, cache_dir, budget),
                                     cache_dir=cache_dir)
        tables = upload_quad(quad, device, residency=residency, budget_bytes=budget)
        return (functools.partial(trace_quad, want_uv=want_uv, cursors=cursors, **slots),
                route_kind(tables, route, cursors=cursors, **slots), tables)

    def flat_route():
        tables = upload_flat(flat, device, residency=residency, bf16_nodes=bf16_nodes,
                             budget_bytes=budget_bytes)
        if mxu:
            check_mxu(tables)
        return (functools.partial(trace_flat, want_uv=want_uv, mxu=mxu, cursors=cursors, **slots),
                route_kind(tables, route, mxu, cursors, **slots), tables)

    routes = {"packet4": (quad_route, "4-wide", "quad"), "packet": (flat_route, "binary", "flat")}
    order = kernel_order(prefer, route)
    for kernel, fallback in zip(order, order[1:] + (None,)):
        try:
            return routes[kernel][0]()
        except StackDepthError as e:
            if fallback is None:
                raise
            _, name, stem = routes[fallback]
            warnings.warn(f"tpu_rt_torch: {e}; {prefer!r} falls to the {name} kernel "
                          f"({stem}-{route})", RuntimeWarning, stacklevel=2)
