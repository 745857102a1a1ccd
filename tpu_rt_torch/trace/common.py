"""What the two traversal kernels share: the stack-depth check of their
tables, the plain PyTorch version's per-ray state and Woop drain, and the
ctypes wrapper that builds, checks, launches and counts a kernel.

Each kernel has eight forms for each table layout, the instantiations of
``template <bool kAnyHit, bool kWantUv, bool kStats, ...>`` in
``tpu_rt_torch/csrc/`` (see ``trace_common.cuh``): closest or any hit,
with or without the barycentrics u, v, with or without the per-ray counters
``node_tests`` and ``tri_tests``.  A tracer returns ``Hits`` (u = v = 0
unless ``want_uv``), or ``(Hits, {"node_tests", "tri_tests"})`` with
``with_stats``, the form of ``trace_wavefront``.  The layouts are the
tables' residency (``tables.RESIDENCIES``: the cache policy of their loads)
and, for the binary kernel, its node format (f32 or bf16).

The ``mixed`` residency holds the node table in a persisting L2
access-policy window attached to each launch.  Its set-aside (the device's
``cudaLimitPersistingL2CacheSize``) is set by the first mixed launch and
shrinks the L2 for every other kernel until ``release_persisting_l2``
resets the persisting lines and sets it back to 0: a caller that forces
the mixed tables calls it after its frame.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch._build import build_shared
from tpu_rt_torch.bvh.collapse import OOEPS, SENT
from tpu_rt_torch.core.types import Hits, Rays
from tpu_rt_torch.trace.tables import _residency_flags

# Per-ray traversal stack depth, a compile-time constant of both kernels
# (the reference's STACK_SIZE, kepler_dynamic_fetch.cu:47).  The tables'
# uploads refuse a tree whose stack would not fit instead of clamping.
STACK_SIZE = 64

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DSTACK_SIZE={STACK_SIZE}"]


class StackDepthError(ValueError):
    """A tree too deep for a tracer's per-ray stack."""


def tree_depth(links: np.ndarray) -> int:
    """Number of inner-node levels of the tree rooted at row 0, given its
    int32 child links [rows, k] (>= 0 an inner row; leaves < 0 and SENT
    ignored)."""
    rows = links.shape[0]
    if rows == 0:
        return 0
    depth = 0
    frontier = np.zeros(1, np.int64)
    while frontier.size:
        depth += 1
        if depth > rows:
            raise ValueError("BVH links form a cycle")
        ch = links[frontier].reshape(-1)
        frontier = ch[(ch >= 0) & (ch != SENT)].astype(np.int64)
    return depth


def check_stack(depth: int, need: int, what: str) -> None:
    """Refuse a tree of ``depth`` levels whose stack needs ``need`` entries."""
    if need > STACK_SIZE:
        raise StackDepthError(f"{what} depth {depth} needs a stack of {need} "
                              f"> STACK_SIZE={STACK_SIZE}")


def woop_rows(tri_woop: np.ndarray, tri_index: np.ndarray) -> np.ndarray:
    """Woop rows padded to 16 floats with the original triangle id in slot
    12 (as ``tpu_rt`` ``pack_tables4`` does, without its 128-lane
    transpose); one zero row when there are none."""
    tri_woop = np.asarray(tri_woop, np.float32)
    r = tri_woop.shape[0]
    woop = np.zeros((max(r, 1), 16), np.float32)
    woop[:r, :12] = tri_woop
    woop[:r, 12] = np.ascontiguousarray(tri_index, np.int32).view(np.float32)
    return woop


# ---------------------------------------------------------------------------
# Plain PyTorch version: per-ray state and the Woop drain
# ---------------------------------------------------------------------------

def safe_inv(d: torch.Tensor) -> torch.Tensor:
    ooeps = torch.full_like(d, float(OOEPS))
    return torch.ones_like(d) / torch.where(d.abs() > float(OOEPS), d, torch.copysign(ooeps, d))


class TraceState(NamedTuple):
    """Per-ray results of a plain trace, updated in place."""

    t: torch.Tensor           # [N] f32, tmax until a hit
    tri: torch.Tensor         # [N] i32, -1 until a hit
    u: torch.Tensor           # [N] f32
    v: torch.Tensor           # [N] f32
    node_tests: torch.Tensor  # [N] i32
    tri_tests: torch.Tensor   # [N] i32

    @classmethod
    def start(cls, rays: Rays) -> "TraceState":
        n, dev = rays.origin.shape[0], rays.origin.device
        zf = torch.zeros((n,), dtype=torch.float32, device=dev)
        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        return cls(t=rays.tmax.clone(), tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
                   u=zf, v=zf.clone(), node_tests=zi, tri_tests=zi.clone())

    def result(self, want_uv: bool, with_stats: bool):
        """Hits (u = v = 0 unless ``want_uv``), with the counters if asked."""
        if want_uv:
            hits = Hits(tri=self.tri, t=self.t, u=self.u, v=self.v)
        else:
            hits = Hits(tri=self.tri, t=self.t, u=torch.zeros_like(self.u),
                        v=torch.zeros_like(self.v))
        if with_stats:
            return hits, {"node_tests": self.node_tests, "tri_tests": self.tri_tests}
        return hits


def visit_masks(visited: dict | None, dev, **rows: int) -> dict | None:
    """The rows of each table that a plain trace reads: fills ``visited``
    (if given) with an all-False [n] bool mask on ``dev`` per table named in
    ``rows`` (name=n), which the trace sets where it reads a row.  Returns
    ``visited``."""
    if visited is not None:
        visited.update({k: torch.zeros((n,), dtype=torch.bool, device=dev)
                        for k, n in rows.items()})
    return visited


def drain_plain(woop, woop_i, first, count, ray_ids, rays: Rays, st: TraceState,
                any_hit: bool, seen: torch.Tensor | None = None) -> None:
    """Test the Woop rows first .. first + count - 1 of rays ``ray_ids``
    (each ray at most once per call), row k of every leaf in step k, as the
    kernels' ``drain`` does: a hit must be strictly nearer, and with
    ``any_hit`` a ray tests no triangle after its first accepted one.
    Updates ``st`` in place, and marks the rows tested in ``seen`` ([R]
    bool) if given."""
    first, count = first.long(), count.long()
    ox, oy, oz = rays.origin[ray_ids].unbind(1)
    dx, dy, dz = rays.dirn[ray_ids].unbind(1)
    t_min = rays.tmin[ray_ids]
    best_t, best_tri = st.t[ray_ids], st.tri[ray_ids]
    best_u, best_v = st.u[ray_ids], st.v[ray_ids]
    tested = torch.zeros_like(best_tri)
    for k in range(int(count.max()) if count.numel() else 0):
        valid = k < count
        if any_hit:
            valid &= best_tri < 0
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
        tested += valid.to(torch.int32)
        if seen is not None:
            seen[row[valid]] = True
        best_t = torch.where(take, t, best_t)
        best_tri = torch.where(take, woop_i[row, 12], best_tri)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)
    st.t[ray_ids] = best_t
    st.tri[ray_ids] = best_tri
    st.u[ray_ids] = best_u
    st.v[ray_ids] = best_v
    st.tri_tests[ray_ids] += tested


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return path


def form_name(any_hit: bool, want_uv: bool, with_stats: bool) -> str:
    """"closest" or "any", then "_uv" and "_stats" for the forms that keep them."""
    return ("any" if any_hit else "closest") + ("_uv" if want_uv else "") + (
        "_stats" if with_stats else "")


FORMS = tuple(form_name(a, u, s) for a in (False, True) for u in (False, True)
              for s in (False, True))


def layout_name(residency: str, bf16_nodes: bool = False) -> str:
    """"" for the vmem f32 tables, else "@" + residency (+ "-bf16")."""
    if residency == "vmem" and not bf16_nodes:
        return ""
    return f"@{residency}" + ("-bf16" if bf16_nodes else "")


# Kernels whose mixed launches set a persisting-L2 set-aside since the last
# release_persisting_l2().
_L2_HELD: set = set()


def release_persisting_l2() -> None:
    """After a frame: reset the persisting L2 lines and the set-aside that
    mixed launches took, so that other kernels get the whole L2 back.  A
    no-op when no mixed launch ran since the last call."""
    while _L2_HELD:
        kernel = _L2_HELD.pop()
        err = kernel._lib.trace_l2_release()
        if err != 0:
            raise RuntimeError(f"{kernel.name}: resetting the persisting L2 failed: "
                               f"cudaError {err}")


class CudaTraceKernel:
    """Wrapper of one traversal kernel source: builds and loads it at first
    use, checks its arguments, launches it on the current stream, and
    counts launches of all forms in ``launches`` and of each in
    ``launches_by_form`` (keys ``FORMS``, then each form with its
    ``layout_name``, such as ``closest@mixed-bf16``).

    The C entry point takes the table arguments, then origin, dirn, tmin,
    tmax, out_tri, out_t, out_u, out_v, out_node_tests, out_tri_tests,
    n_rays, any_hit, want_uv, stats, nodes_stream, tris_stream,
    window_bytes, set_aside, stream."""

    def __init__(self, name: str, table_argtypes: list):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.table_argtypes = table_argtypes
        self.launches = 0
        self.launches_by_form = dict.fromkeys(FORMS, 0)
        self.build_log = ""
        self.build_s = 0.0
        self._fn = None
        self._lib = None
        self._l2 = {}
        self._warned_clip = False

    def load(self):
        if self._fn is None:
            t0 = time.perf_counter()
            path, self.build_log = build_shared(
                self.name, [self.source], [nvcc()] + NVCC_FLAGS,
                deps=[os.path.join(CSRC, "trace_common.cuh")])
            lib = ctypes.CDLL(path)
            fn = getattr(lib, f"{self.name}_launch")
            self.build_s = time.perf_counter() - t0
            vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            fn.restype = ci
            fn.argtypes = self.table_argtypes + [vp] * 10 + [ci] * 6 + [sz, sz, vp]
            lib.trace_l2_info.restype = ci
            lib.trace_l2_info.argtypes = [ci, ctypes.POINTER(ctypes.c_longlong)]
            lib.trace_l2_release.restype = ci
            lib.trace_l2_release.argtypes = []
            self._lib = lib
            self._fn = fn
        return self._fn

    def l2_info(self, device) -> dict:
        """The card's L2 size, its largest persisting set-aside and largest
        access-policy window, in bytes (cudaDevAttrL2CacheSize,
        cudaDevAttrMaxPersistingL2CacheSize,
        cudaDevAttrMaxAccessPolicyWindowSize), read once per device."""
        device = torch.device(device)
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in self._l2:
            self.load()
            out = (ctypes.c_longlong * 3)()
            err = self._lib.trace_l2_info(index, out)
            if err != 0:
                raise RuntimeError(f"{self.name}: reading the L2 attributes failed: "
                                   f"cudaError {err}")
            self._l2[index] = {"l2_bytes": out[0], "max_persisting_l2": out[1],
                               "max_window": out[2]}
        return self._l2[index]

    def l2_window(self, table_bytes: int, device) -> tuple[int, int]:
        """(window bytes, set-aside bytes) of a mixed launch over a node
        table of ``table_bytes``: the window clipped to the card's largest,
        the set-aside the smaller of the window and the card's largest
        set-aside (hitRatio = set-aside / window)."""
        info = self.l2_info(device)
        window = min(table_bytes, info["max_window"])
        if window < table_bytes and not self._warned_clip:
            self._warned_clip = True
            warnings.warn(f"{self.name}: node table of {table_bytes} B exceeds the largest "
                          f"access-policy window; clipped to {window} B", RuntimeWarning,
                          stacklevel=3)
        return window, min(window, info["max_persisting_l2"])

    def reset_counts(self) -> None:
        self.launches = 0
        self.launches_by_form = dict.fromkeys(FORMS, 0)

    def launch(self, tables: list, table_args: list, rays: Rays, any_hit: bool,
               want_uv: bool, with_stats: bool, residency: str = "vmem",
               bf16_nodes: bool = False):
        """Check ``tables`` ([(name, tensor, dtype, shape)]; the first is
        the node table, and float32 and int32 tables are read as 16-byte
        rows) and ``rays``, launch the form on tables of ``residency``, and
        return what the plain version returns."""
        dev = rays.origin.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got {dev}")
        n = rays.origin.shape[0]
        f32, i32 = torch.float32, torch.int32
        checks = tables + [("origin", rays.origin, f32, (n, 3)), ("dirn", rays.dirn, f32, (n, 3)),
                           ("tmin", rays.tmin, f32, (n,)), ("tmax", rays.tmax, f32, (n,))]
        for i, (name, x, dtype, shape) in enumerate(checks):
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"{name}: need {dtype} {shape} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: must be contiguous")
            if i < len(tables) and x.dim() == 2 and x.data_ptr() % 16:
                raise ValueError(f"{name}: the kernel reads 16-byte rows, need 16-byte "
                                 "alignment")
        if n >= 2**31:
            raise ValueError(f"{self.name} indexes rays with int32")
        nodes_stream, tris_stream = _residency_flags(residency)
        fn = self.load()
        window = set_aside = 0
        if tris_stream and not nodes_stream and tables[0][1].numel():
            window, set_aside = self.l2_window(tables[0][1].numel() * 4, dev)
        tri = torch.empty((n,), dtype=i32, device=dev)
        t = torch.empty((n,), dtype=f32, device=dev)
        uv = [torch.empty((n,), dtype=f32, device=dev) for _ in range(2)] if want_uv else None
        stats = {k: torch.empty((n,), dtype=i32, device=dev)
                 for k in ("node_tests", "tri_tests")} if with_stats else None
        outs = [tri.data_ptr(), t.data_ptr()]
        outs += [x.data_ptr() for x in uv] if want_uv else [None, None]
        outs += [x.data_ptr() for x in stats.values()] if with_stats else [None, None]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*table_args, rays.origin.data_ptr(), rays.dirn.data_ptr(),
                     rays.tmin.data_ptr(), rays.tmax.data_ptr(), *outs, n, int(bool(any_hit)),
                     int(bool(want_uv)), int(bool(with_stats)), int(nodes_stream),
                     int(tris_stream), window, set_aside, stream)
        if set_aside:
            _L2_HELD.add(self)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        key = form_name(any_hit, want_uv, with_stats) + layout_name(residency, bf16_nodes)
        self.launches_by_form[key] = self.launches_by_form.get(key, 0) + 1
        if not want_uv:
            # The frame forms write no u, v: zeros, enqueued after the
            # kernel so that their fills run behind it, not before it.
            uv = [torch.zeros((n,), dtype=f32, device=dev) for _ in range(2)]
        hits = Hits(tri, t, *uv)
        return (hits, stats) if with_stats else hits
