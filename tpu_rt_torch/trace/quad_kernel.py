"""Traversal of the 4-wide BVH, closest hit and any hit: the CUDA kernel,
its plain PyTorch version, and the device tables both read.

Counterpart of the 4-wide (`w4`) form of the Pallas kernel
``tpu_rt/trace/packet2.py`` ``_kernel2`` (through ``trace_packet4``), in
its closest-hit and ``any_hit=True`` forms.  Both versions here compute
what the host oracle ``trace_quad_scalar`` (``tpu_rt_torch/bvh/collapse.py``)
computes, in the same order, so their (tri, t) equal the oracle's bit for
bit -- for any hit too, down to which occluder is reported: a ray stops at
its first accepted hit in the oracle's visit order.

- ``trace_quad`` dispatches on the device of the rays: a CPU tensor takes
  the plain version, a CUDA tensor launches the kernel
  (``tpu_rt_torch/csrc/quad_trace.cu``) or raises.
- ``trace_quad_plain`` is a wavefront loop over the batch in PyTorch ops:
  each step processes the current node of every live ray.
- ``upload_quad`` turns any object with numpy ``nodes``/``tri_woop``/
  ``tri_index`` (``tpu_rt``'s QuadBVH or the port's) into device tables
  with the same bits.

The kernel is built with nvcc for sm_90a at first launch into the port's
git-ignored build directory and loaded with ctypes; ``KERNEL.launches``
counts its launches, ``KERNEL.launches_by_form`` those of each form.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch._build import build_shared
from tpu_rt_torch.bvh.collapse import COUNT_SHIFT, FIRST_MASK, OOEPS, SENT
from tpu_rt_torch.core.types import Hits, Rays

# Per-ray traversal stack depth, a compile-time constant of the kernel.  A
# node pushes at most 3 children, so a tree of depth D needs at most 3 * D
# entries; upload_quad refuses deeper trees instead of clamping silently.
STACK_SIZE = 64

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "quad_trace.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DSTACK_SIZE={STACK_SIZE}"]


class QuadTables(NamedTuple):
    """Device tables of one QuadBVH."""

    nodes: torch.Tensor  # [Q, 32] f32, cols 24..28 int32 bits
    woop: torch.Tensor   # [max(R, 1), 16] f32, col 12 the triangle id bits
    depth: int           # levels of the quad tree (0 when empty)


def quad_depth(nodes: np.ndarray) -> int:
    """Number of levels of the quad tree rooted at node 0."""
    q = nodes.shape[0]
    if q == 0:
        return 0
    links = np.ascontiguousarray(nodes[:, 24:28]).view(np.int32)
    depth = 0
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        depth += 1
        if depth > q:
            raise ValueError("quad BVH links form a cycle")
        ch = links[frontier].reshape(-1)
        frontier = ch[(ch >= 0) & (ch != SENT)].astype(np.int64)
    return depth


def upload_quad(quad, device) -> QuadTables:
    """Device tables for a QuadBVH: the node records byte for byte, and the
    Woop rows padded to 16 floats with the original triangle id in slot 12
    (as ``tpu_rt`` ``pack_tables4`` does, without its 128-lane transpose)."""
    nodes = np.ascontiguousarray(quad.nodes, np.float32)
    if nodes.ndim != 2 or nodes.shape[1] != 32:
        raise ValueError(f"quad nodes must be [Q, 32], got {nodes.shape}")
    depth = quad_depth(nodes)
    if 3 * depth > STACK_SIZE:
        raise ValueError(f"quad BVH depth {depth} needs a stack of {3 * depth} "
                         f"> STACK_SIZE={STACK_SIZE}")
    tri_woop = np.asarray(quad.tri_woop, np.float32)
    tri_index = np.ascontiguousarray(quad.tri_index, np.int32)
    r = tri_woop.shape[0]
    woop = np.zeros((max(r, 1), 16), np.float32)
    woop[:r, :12] = tri_woop
    woop[:r, 12] = tri_index.view(np.float32)
    # torch.tensor copies the bytes: NaN boxes and link bits stay as built.
    return QuadTables(nodes=torch.tensor(nodes, device=device),
                      woop=torch.tensor(woop, device=device), depth=depth)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    ooeps = torch.full_like(d, float(OOEPS))
    return torch.ones_like(d) / torch.where(d.abs() > float(OOEPS), d, torch.copysign(ooeps, d))


def trace_quad_plain(tables: QuadTables, rays: Rays, any_hit: bool = False) -> Hits:
    """Closest hit per ray, or with ``any_hit`` the first accepted hit in
    visit order, as ``trace_quad_scalar``, in PyTorch ops on the device of
    ``rays``.  Every float op is the oracle's, in its order: explicit
    three-term sums, NaN-propagating min/max, 1/d then multiply.  An any-hit
    ray that holds a hit drains no later leaf and leaves the live set."""
    dev = rays.origin.device
    n = rays.origin.shape[0]
    nodes = tables.nodes.to(dev)
    nodes_i = nodes.view(torch.int32)
    woop = tables.woop.to(dev)
    woop_i = woop.view(torch.int32)
    o, d = rays.origin, rays.dirn
    tmin = rays.tmin
    hit_t = rays.tmax.clone()
    hit_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    if nodes.shape[0] == 0 or n == 0:
        return Hits(tri=hit_tri, t=hit_t, u=zeros, v=zeros.clone())

    idir = _safe_inv(d)
    ood = o * idir
    pos = torch.arange(4, device=dev)

    # Live rays (ids), their current node, stack and stack pointer.
    ids = torch.nonzero(~(rays.tmax < 0)).squeeze(1)
    node = torch.zeros_like(ids)
    stack = torch.zeros((ids.shape[0], STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.zeros_like(ids)
    while ids.numel():
        a = ids.shape[0]
        rows = torch.arange(a, device=dev)
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
        ht = hit_t[ids][:, None]
        near = torch.where(t0 > near3, t0, near3)
        far = torch.where(ht < far3, ht, far3)
        hit = (far >= near) & (lk != int(SENT))

        # Visit order: stored if d[hint] >= 0 for this ray, else reversed.
        fwd = d[ids].gather(1, hint[:, None]) >= 0
        perm = torch.where(fwd, pos[None, :], 3 - pos[None, :])
        hit_v = hit.gather(1, perm)
        lk_v = lk.gather(1, perm)

        # Drain the hit leaves in visit order, each triangle in turn.
        for p in range(4):
            leaf = hit_v[:, p] & (lk_v[:, p] < 0)
            if any_hit:
                leaf &= hit_tri[ids] < 0
            sel = torch.nonzero(leaf).squeeze(1)
            if sel.numel():
                _drain(woop, woop_i, ~lk_v[sel, p], ids[sel], o, d, tmin, hit_t, hit_tri,
                       any_hit)

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
        node = torch.where(go, inn[:, 0], node)
        node = torch.where(pop, stack[rows, (sp - 1).clamp(min=0)], node)
        sp = torch.where(go, sp + (m - 1), torch.where(pop, sp - 1, sp))
        live = go | pop
        if any_hit:
            live &= hit_tri[ids] < 0
        ids, node, stack, sp = ids[live], node[live], stack[live], sp[live]
    return Hits(tri=hit_tri, t=hit_t, u=zeros, v=zeros.clone())


def _drain(woop, woop_i, c, ray_ids, o, d, tmin, hit_t, hit_tri, any_hit) -> None:
    """Test the leaves ``c`` (= ~link) of rays ``ray_ids``, triangle k of
    every leaf in step k, updating hit_t/hit_tri in place.  With ``any_hit``
    a ray takes no triangle after its first accepted one."""
    first = (c & FIRST_MASK).long()
    count = ((c >> COUNT_SHIFT) & 0xFF).long()
    ox, oy, oz = o[ray_ids].unbind(1)
    dx, dy, dz = d[ray_ids].unbind(1)
    t_min = tmin[ray_ids]
    best_t = hit_t[ray_ids]
    best_tri = hit_tri[ray_ids]
    for k in range(int(count.max())):
        valid = k < count
        row = torch.where(valid, first + k, 0)
        w = woop[row]
        Oz = w[:, 3] - ox * w[:, 0] - oy * w[:, 1] - oz * w[:, 2]
        Dz = dx * w[:, 0] + dy * w[:, 1] + dz * w[:, 2]
        t = Oz * (torch.ones_like(Dz) / Dz)
        Ox = w[:, 7] + ox * w[:, 4] + oy * w[:, 5] + oz * w[:, 6]
        Dx = dx * w[:, 4] + dy * w[:, 5] + dz * w[:, 6]
        u = Ox + t * Dx
        Oy = w[:, 11] + ox * w[:, 8] + oy * w[:, 9] + oz * w[:, 10]
        Dy = dx * w[:, 8] + dy * w[:, 9] + dz * w[:, 10]
        v = Oy + t * Dy
        take = (valid & (t > t_min) & (t < best_t) & (u >= 0)
                & (v >= 0) & (u + v <= 1.0))
        if any_hit:
            take &= best_tri < 0
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, woop_i[row, 12], best_tri)
    hit_t[ray_ids] = best_t
    hit_tri[ray_ids] = best_tri


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return path


class QuadTraceKernel:
    """Wrapper of ``quad_trace.cu``: builds and loads it at first use,
    checks its arguments, launches it on the current stream, and counts
    launches of both forms in ``launches`` and of each in
    ``launches_by_form`` ("closest", "any")."""

    def __init__(self):
        self.launches = 0
        self.launches_by_form = {"closest": 0, "any": 0}
        self.build_log = ""
        self.build_s = 0.0
        self._lib = None

    def load(self):
        if self._lib is None:
            t0 = time.perf_counter()
            path, self.build_log = build_shared("quad_trace", [CSRC], [_nvcc()] + NVCC_FLAGS)
            lib = ctypes.CDLL(path)
            self.build_s = time.perf_counter() - t0
            vp = ctypes.c_void_p
            lib.quad_trace_launch.restype = ctypes.c_int
            lib.quad_trace_launch.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp,
                                              vp, vp, ctypes.c_int, ctypes.c_int, vp]
            self._lib = lib
        return self._lib

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_form = dict.fromkeys(self.launches_by_form, 0)

    def __call__(self, tables: QuadTables, rays: Rays, any_hit: bool = False) -> Hits:
        dev = rays.origin.device
        if dev.type != "cuda":
            raise ValueError(f"QuadTraceKernel needs CUDA tensors, got {dev}")
        n = rays.origin.shape[0]
        checks = [("nodes", tables.nodes, (tables.nodes.shape[0], 32)),
                  ("woop", tables.woop, (tables.woop.shape[0], 16)),
                  ("origin", rays.origin, (n, 3)), ("dirn", rays.dirn, (n, 3)),
                  ("tmin", rays.tmin, (n,)), ("tmax", rays.tmax, (n,))]
        for name, x, shape in checks:
            if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
                raise ValueError(f"{name}: need float32 {shape} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: must be contiguous")
        if tables.nodes.data_ptr() % 16 or tables.woop.data_ptr() % 16:
            raise ValueError("nodes/woop: the kernel reads float4, need 16-byte alignment")
        if n >= 2**31 or tables.nodes.shape[0] >= 2**31:
            raise ValueError("quad_trace indexes rays and nodes with int32")
        lib = self.load()
        tri = torch.empty((n,), dtype=torch.int32, device=dev)
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.quad_trace_launch(
                tables.nodes.data_ptr(), tables.nodes.shape[0], tables.woop.data_ptr(),
                rays.origin.data_ptr(), rays.dirn.data_ptr(),
                rays.tmin.data_ptr(), rays.tmax.data_ptr(),
                tri.data_ptr(), t.data_ptr(), n, int(bool(any_hit)), stream)
        if err != 0:
            raise RuntimeError(f"quad_trace launch failed: cudaError {err}")
        self.launches += 1
        self.launches_by_form["any" if any_hit else "closest"] += 1
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        return Hits(tri=tri, t=t, u=zeros, v=zeros.clone())


KERNEL = QuadTraceKernel()


def trace_quad(tables: QuadTables, rays: Rays, any_hit: bool = False) -> Hits:
    """Closest hit per ray over the QuadBVH tables, or with ``any_hit`` the
    first accepted hit in visit order.  CPU rays take the plain version;
    CUDA rays launch the kernel (there is no fallback)."""
    dev = rays.origin.device
    if dev.type == "cpu":
        return trace_quad_plain(tables, rays, any_hit=any_hit)
    if dev.type == "cuda":
        return KERNEL(tables, rays, any_hit=any_hit)
    raise ValueError(f"trace_quad: unsupported device {dev}")
