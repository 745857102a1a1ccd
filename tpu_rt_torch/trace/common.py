"""What the two traversal kernels share: the stack-depth check of their
tables, the plain PyTorch version's per-ray state, its Woop drains (the
scalar one and the tensor-core leaf test's) and postponed leaves, and the
ctypes wrapper that builds, checks, launches and counts a kernel.

Each kernel has eight forms for each table layout, the instantiations of
``template <bool kAnyHit, bool kWantUv, bool kStats, ...>`` in
``tpu_rt_torch/csrc/`` (see ``trace_common.cuh``): closest or any hit,
with or without the barycentrics u, v, with or without the per-ray counters
``node_tests``, ``tri_tests`` and ``stack`` (the most entries the ray's
traversal stack held at once).  A tracer returns ``Hits`` (u = v = 0
unless ``want_uv``), or ``(Hits, {"node_tests", "tri_tests", "stack"})``
with ``with_stats``, the form of ``trace_wavefront``; a route called
``with_stats`` adds their sums to the recorder's counters (``count_stats``).
The layouts are the tables' residency (``tables.RESIDENCIES``: the cache
policy of their loads) and, for the binary kernel, its node format (f32 or
bf16).

Each kernel source is one library with its own launch counts: the forms
that drain a leaf when it is reached (``quad_trace``, ``flat_trace``), the
postponed-leaf forms (``quad_trace_c``, ``flat_trace_c``: ``cursors`` =
2..``MAX_CURSORS`` leaves held per ray, tpu_rt's C > 1 leaf cursors; form
names end in ``_c``), the binary kernel's tensor-core leaf test
(``flat_trace_mxu``: tpu_rt's ``mxu=True``, with 1..``MAX_CURSORS``
cursors; ``_mxu``) and the slot forms, one library per K
(``quad_trace_k<K>``, ``flat_trace_k<K>``: tpu_rt's ``k``, ``u`` and
``tile``, see ``check_schedule``; ``_k<K>``, then ``_u<U>`` and
``_t<tile>`` where given).  Every library has one design: persistent warps
that fetch their rays from a pool, each lane's traversal stack in local
memory below a top held in a register (``trace_common.cuh``).

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
import warnings
from typing import NamedTuple

import numpy as np
import torch

from tpu_rt_torch import spans
from tpu_rt_torch._build import build_shared
from tpu_rt_torch.bvh.collapse import OOEPS, SENT
from tpu_rt_torch.core.types import Hits, Rays
from tpu_rt_torch.trace.tables import _residency_flags

# Rays of a warp, the lanes that run one traversal loop in lock step.
WARP = 32
# Per-ray traversal stack depth, a compile-time constant of both kernels
# (the reference's STACK_SIZE, kepler_dynamic_fetch.cu:47).  The tables'
# uploads refuse a tree whose stack would not fit instead of clamping.
STACK_SIZE = 64
# Leaves a ray may hold before it drains them (trace_common.cuh kMaxCursors).
MAX_CURSORS = 4
# Triangles of one leaf the tensor-core leaf test takes (mxu_leaf.cuh
# kMxuLeaf; tpu_rt's U = MAX_LEAF for mxu=True).
MXU_LEAF = 8

# The slot forms' settings, tpu_rt's k, u and tile (trace_common.cuh): the
# rays a thread holds (one library per K), the most Woop rows a slot reads at
# once (kMaxUnits: the widest quad leaf), and a block's claim of rays, a
# multiple of BLOCK.
SLOTS = (1, 2, 4, 8)
MAX_UNITS = 32

# Threads per block of every traversal kernel (trace_common.cuh kBlock).
BLOCK = 128

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


def persistent_grid(n_rays: int, sms: int, blocks_per_sm: int, block: int = BLOCK) -> int:
    """Blocks of a persistent launch: the card's SMs x the blocks of the
    form that fit on one, clipped to the blocks ``n_rays`` need (the
    kernels' ``persistent_grid``)."""
    if sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"need an SM count and blocks per SM >= 1, got {sms}, {blocks_per_sm}")
    return min(sms * blocks_per_sm, -(-max(int(n_rays), 0) // block))


def check_cursors(cursors) -> int:
    """The number of leaves a ray may hold: an int, 1..MAX_CURSORS."""
    if isinstance(cursors, bool) or not isinstance(cursors, (int, np.integer)):
        raise TypeError(f"cursors must be an int, got {cursors!r}")
    if not 1 <= cursors <= MAX_CURSORS:
        raise ValueError(f"cursors must be in 1..{MAX_CURSORS}, got {cursors}")
    return int(cursors)


def check_schedule(tile=None, k=None, u=None, mxu: bool = False, cursors: int = 1):
    """tpu_rt's ``tile``, ``k`` and ``u`` of ``trace_packet2`` /
    ``trace_packet4``: None when all three are None (the default forms),
    else ``(k, u, tile)`` for a slot form, a given None taken as K = 1, U =
    1 and no block pool (the default forms' schedule).  ``k`` is one of
    SLOTS, ``u`` an int in 1..MAX_UNITS, ``tile`` a positive multiple of
    BLOCK (tpu_rt asserts ``tile % 128 == 0``).  Anything else, and any of
    them with ``mxu=True`` or ``cursors`` > 1 (which tpu_rt takes and the
    slot forms do not), raises ValueError naming the setting."""
    given = {name: x for name, x in (("k", k), ("u", u), ("tile", tile)) if x is not None}
    if not given:
        return None
    named = ", ".join(f"{name}={x!r}" for name, x in given.items())
    for name, x in given.items():
        if isinstance(x, bool) or not isinstance(x, (int, np.integer)):
            raise ValueError(f"{name} must be an int, got {x!r}")
    if k is not None and k not in SLOTS:
        raise ValueError(f"k must be one of {SLOTS}, got {k}")
    if u is not None and not 1 <= u <= MAX_UNITS:
        raise ValueError(f"u must be in 1..{MAX_UNITS}, got {u}")
    if tile is not None and (tile < BLOCK or tile % BLOCK):
        raise ValueError(f"tile must be a positive multiple of {BLOCK}, got {tile}")
    if mxu:
        raise ValueError(f"{named}: the slot forms have no tensor-core leaf test (mxu=True)")
    if cursors != 1:
        raise ValueError(f"{named}: the slot forms hold no leaves (cursors={cursors})")
    return (int(k or 1), int(u or 1), int(tile or 0))


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
    stack: torch.Tensor       # [N] i32, the stack's high-water

    @classmethod
    def start(cls, rays: Rays) -> "TraceState":
        n, dev = rays.origin.shape[0], rays.origin.device
        zf = torch.zeros((n,), dtype=torch.float32, device=dev)
        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        return cls(t=rays.tmax.clone(), tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
                   u=zf, v=zf.clone(), node_tests=zi, tri_tests=zi.clone(), stack=zi.clone())

    def result(self, want_uv: bool, with_stats: bool):
        """Hits (u = v = 0 unless ``want_uv``), with the counters if asked."""
        if want_uv:
            hits = Hits(tri=self.tri, t=self.t, u=self.u, v=self.v)
        else:
            hits = Hits(tri=self.tri, t=self.t, u=torch.zeros_like(self.u),
                        v=torch.zeros_like(self.v))
        if with_stats:
            return hits, {"node_tests": self.node_tests, "tri_tests": self.tri_tests,
                          "stack": self.stack}
        return hits


def warp_work(stats: dict) -> torch.Tensor:
    """Each 32-ray warp's largest per-ray node_tests + tri_tests (int64,
    one per warp; the last warp padded with zeros): the steps a lock-step
    warp's loop runs."""
    work = stats["node_tests"].long() + stats["tri_tests"].long()
    groups = -(-work.numel() // WARP)
    work = torch.nn.functional.pad(work, (0, groups * WARP - work.numel()))
    return work.view(groups, WARP).amax(1)


def count_stats(out):
    """Add a ``with_stats`` trace's per-ray counters, summed on the device
    and read to the host once, to the recorder's counters
    (``tpu_rt_torch.spans.count``): ``trace.stats_rays`` (the rays traced),
    ``trace.node_tests``, ``trace.tri_tests``, ``trace.warp_tests`` (the
    sum of ``warp_work``) and ``trace.stack_entries`` (the sum of each
    ray's stack high-water).  Returns ``out``, the ``(hits, stats)``
    pair."""
    stats = out[1]
    sums = torch.stack([stats["node_tests"].long().sum(), stats["tri_tests"].long().sum(),
                        warp_work(stats).sum(), stats["stack"].long().sum()]).tolist()
    spans.count("trace.stats_rays", stats["node_tests"].numel())
    for name, n in zip(("trace.node_tests", "trace.tri_tests", "trace.warp_tests",
                        "trace.stack_entries"), sums):
        spans.count(name, n)
    return out


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


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row dot products of f32 values taken in float64 (each product
    exact), rounded once to f32."""
    return (a.double() * b.double()).sum(1).float()


def mxu_products(w: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The six Woop dot products of the tensor-core leaf test
    (``csrc/mxu_leaf.cuh``) for Woop rows ``w`` [A, 16] and rays ``o``,
    ``d`` [A, 3]: (Oz, Dz, Ox, Dx, Oy, Dy), each in float64 and rounded
    once to f32, the rows' L(4) against the rays' [o, 1] or [d, 0]."""
    one = torch.ones_like(o[:, :1])
    ro = torch.cat((o, one), 1)
    wz, wx, wy = w[:, 0:4], w[:, 4:8], w[:, 8:12]
    lz = torch.cat((-wz[:, :3], wz[:, 3:]), 1)
    return (_dot64(lz, ro), _dot64(wz[:, :3], d), _dot64(wx, ro), _dot64(wx[:, :3], d),
            _dot64(wy, ro), _dot64(wy[:, :3], d))


class LeafBest:
    """The running winner of a tensor-core leaf test: the smallest t of the
    candidates that count, ties to the largest triangle id, u and v of that
    same candidate (``mxu_leaf.cuh`` ``leaf_best``; packet2.py:831-862)."""

    def __init__(self, n: int, dev):
        self.t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        self.tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.u = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.v = torch.zeros((n,), dtype=torch.float32, device=dev)

    def offer(self, prods, tid, valid, t_min, t_max) -> None:
        """One candidate per ray, from its six products (``mxu_products``),
        triangle ids ``tid`` and ``valid`` mask: t = Oz / Dz (a true
        division), u = Ox + t Dx, v = Oy + t Dy; it counts when
        tmin < t < tmax and u, v >= 0, u + v <= 1."""
        ozt, dzt, oxt, dxt, oyt, dyt = prods
        t = ozt / dzt
        u = oxt + t * dxt
        v = oyt + t * dyt
        ok = (valid & (t > t_min) & (t < t_max) & (u >= 0) & (v >= 0) & (u + v <= 1.0))
        better = ok & ((t < self.t) | ((t == self.t) & (tid > self.tri)))
        self.t = torch.where(better, t, self.t)
        self.tri = torch.where(better, tid, self.tri)
        self.u = torch.where(better, u, self.u)
        self.v = torch.where(better, v, self.v)


def drain_mxu_plain(woop, woop_i, first, count, ray_ids, rays: Rays, st: TraceState,
                    any_hit: bool, seen: torch.Tensor | None = None) -> None:
    """The tensor-core leaf test of ``csrc/flat_trace_mxu.cu`` on the leaves
    first .. first + count - 1 (count <= MXU_LEAF) of rays ``ray_ids`` (each
    ray at most once per call): every candidate's dot products in float64,
    rounded once (``mxu_products``), the leaf's winner (``LeafBest``)
    merged with a strict t < hit distance; with ``any_hit`` only rays that
    hold no hit test the leaf, and only they take a hit.  Counts ``count``
    triangle tests per ray that tests the leaf.  Updates ``st`` in place,
    and marks the rows read in ``seen`` if given."""
    first, count = first.long(), count.long()
    o, d = rays.origin[ray_ids], rays.dirn[ray_ids]
    t_min, t_max = rays.tmin[ray_ids], rays.tmax[ray_ids]
    active = st.tri[ray_ids] < 0 if any_hit else torch.ones_like(count, dtype=torch.bool)
    best = LeafBest(ray_ids.shape[0], o.device)
    for k in range(int(count.max()) if count.numel() else 0):
        valid = active & (k < count)
        row = torch.where(valid, first + k, 0)
        if seen is not None:
            seen[row[valid]] = True
        best.offer(mxu_products(woop[row], o, d), woop_i[row, 12], valid, t_min, t_max)
    take = active & (best.t < st.t[ray_ids])
    st.t[ray_ids] = torch.where(take, best.t, st.t[ray_ids])
    st.tri[ray_ids] = torch.where(take, best.tri, st.tri[ray_ids])
    st.u[ray_ids] = torch.where(take, best.u, st.u[ray_ids])
    st.v[ray_ids] = torch.where(take, best.v, st.v[ray_ids])
    st.tri_tests[ray_ids] += torch.where(active, count, 0).to(torch.int32)


class HeldLeaves:
    """Plain version of the kernels' postponed leaves (``trace_common.cuh``
    ``Postponed``): up to ``cursors`` leaf links per live ray, oldest first.
    Rows are positions in the plain loop's arrays of live rays."""

    def __init__(self, n: int, cursors: int, dev):
        self.cursors = cursors
        self.link = torch.zeros((n, cursors), dtype=torch.int64, device=dev)
        self.n = torch.zeros((n,), dtype=torch.int64, device=dev)

    def add(self, rows: torch.Tensor, links: torch.Tensor) -> torch.Tensor:
        """Hold one more leaf for each of ``rows`` (distinct); returns the
        rows that now hold ``cursors`` leaves."""
        self.link[rows, self.n[rows]] = links.long()
        self.n[rows] += 1
        return rows[self.n[rows] == self.cursors]

    def drain(self, rows: torch.Tensor, drain_links) -> None:
        """Drain the leaves ``rows`` hold, oldest first, with
        ``drain_links(links, rows)`` (one leaf per row per call); then they
        hold none."""
        if rows.numel() == 0:
            return
        n = self.n[rows]
        for k in range(int(n.max())):
            r = rows[n > k]
            drain_links(self.link[r, k], r)
        self.n[rows] = 0

    def keep(self, live: torch.Tensor) -> None:
        """Follow the loop's compaction to the rays still live."""
        self.link, self.n = self.link[live], self.n[live]


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


def form_name(any_hit: bool, want_uv: bool, with_stats: bool, k: int | None = None,
              u: int | None = None, tile: int | None = None) -> str:
    """"closest" or "any", then "_uv" and "_stats" for the forms that keep
    them, then a slot form's "_k<k>", "_u<u>" and "_t<tile>" for the
    settings given."""
    return ("any" if any_hit else "closest") + ("_uv" if want_uv else "") + (
        "_stats" if with_stats else "") + "".join(
        f"_{tag}{x}" for tag, x in (("k", k), ("u", u), ("t", tile)) if x is not None)


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


def headers() -> list[str]:
    """The headers the kernel sources include (they enter the build hash)."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))


class CudaTraceKernel:
    """Wrapper of one traversal kernel library (``csrc/<name>.cu``): builds
    and loads it at first use, checks its arguments, launches it on the
    current stream, and counts launches of all forms in ``launches`` and of
    each in ``launches_by_form`` (keys ``forms``: ``FORMS`` with the
    library's ``suffix``, then each with its ``layout_name``, such as
    ``closest_c@mixed-bf16``).  ``cursors`` is the range of leaves a ray
    may hold that the library takes.

    The C entry point takes the table arguments, then origin, dirn, tmin,
    tmax, out_tri, out_t, out_u, out_v, out_node_tests, out_tri_tests,
    out_stack, n_rays, cursors, any_hit, want_uv, stats, nodes_stream,
    tris_stream, window_bytes, set_aside, counter, shape, stream (``argtypes``; the
    QUAD_LAUNCH_ARGS / FLAT_LAUNCH_ARGS macros of ``csrc/``).
    ``last_shape`` holds the last launch's grid, blocks per SM, dynamic
    shared memory and SM count.

    A slot library (``slots`` = K, one of SLOTS) takes U (``units``) and S
    (``tile``, 0 for none) before the table arguments, and counts its
    launches under ``form_name(..., k=K, u=, tile=)`` + layout."""

    def __init__(self, name: str, table_argtypes: list, suffix: str = "",
                 cursors: tuple[int, int] = (1, 1), slots: int | None = None):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.table_argtypes = table_argtypes
        self.suffix = suffix
        self.cursors = cursors
        self.slots = slots
        self.forms = tuple(form_name(a, u, s, k=slots) + suffix for a in (False, True)
                           for u in (False, True) for s in (False, True))
        self.launches = 0
        self.launches_by_form = dict.fromkeys(self.forms, 0)
        self.last_shape = None
        self.build_log = ""
        self.build_s = 0.0
        self.path = None
        self._fn = None
        self._lib = None
        self._l2 = {}
        self._warned_clip = False

    @property
    def argtypes(self) -> list:
        """The ctypes types of the C entry point's arguments, in order."""
        vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        schedule = [ci, ci] if self.slots else []
        return (schedule + self.table_argtypes + [vp] * 11 + [ci] * 7
                + [sz, sz, vp, vp, vp])

    def load(self):
        if self._fn is None:
            with spans.span("setup.kernel_load", timed=True) as load:
                self.path, self.build_log = build_shared(self.name, [self.source],
                                                         [nvcc()] + NVCC_FLAGS, deps=headers())
                lib = ctypes.CDLL(self.path)
                fn = getattr(lib, f"{self.name}_launch")
            self.build_s = load.seconds
            ci = ctypes.c_int
            fn.restype = ci
            fn.argtypes = self.argtypes
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
        self.launches_by_form = dict.fromkeys(self.forms, 0)

    def launch(self, tables: list, table_args: list, rays: Rays, any_hit: bool,
               want_uv: bool, with_stats: bool, residency: str = "vmem",
               bf16_nodes: bool = False, cursors: int = 1, units: int | None = None,
               tile: int | None = None):
        """Check ``cursors`` (in the library's range) and ``units`` /
        ``tile`` (U and S, ``check_schedule``: to a slot library only)
        before any tensor, then ``tables`` ([(name, tensor, dtype, shape)];
        the first is the node table, and float32 and int32 tables are read
        as 16-byte rows) and ``rays``; launch the form on tables of
        ``residency``, and return what the plain version returns."""
        lo, hi = self.cursors
        if not lo <= cursors <= hi:
            raise ValueError(f"{self.name} takes cursors {lo}..{hi}, got {cursors}")
        if self.slots is None and (units is not None or tile is not None):
            raise ValueError(f"{self.name} takes no u or tile (a slot library does)")
        if self.slots is not None:
            check_schedule(tile, self.slots, units)
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
                 for k in ("node_tests", "tri_tests", "stack")} if with_stats else None
        outs = [tri.data_ptr(), t.data_ptr()]
        outs += [x.data_ptr() for x in uv] if want_uv else [None, None]
        outs += [x.data_ptr() for x in stats.values()] if with_stats else [None] * 3
        # The ray pool of the persistent kernels: 4 bytes, zeroed by the launch.
        counter = torch.empty((1,), dtype=i32, device=dev)
        shape = (ctypes.c_int * 4)()
        schedule = [int(units or 1), int(tile or 0)] if self.slots else []
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*schedule, *table_args, rays.origin.data_ptr(), rays.dirn.data_ptr(),
                     rays.tmin.data_ptr(), rays.tmax.data_ptr(), *outs, n, int(cursors),
                     int(bool(any_hit)), int(bool(want_uv)), int(bool(with_stats)),
                     int(nodes_stream), int(tris_stream), window, set_aside,
                     counter.data_ptr(), ctypes.addressof(shape), stream)
        if set_aside:
            _L2_HELD.add(self)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        if n:
            self.last_shape = dict(zip(("grid", "blocks_per_sm", "smem_bytes", "sms"), shape))
        self.launches += 1
        key = (form_name(any_hit, want_uv, with_stats, k=self.slots, u=units, tile=tile)
               + self.suffix + layout_name(residency, bf16_nodes))
        self.launches_by_form[key] = self.launches_by_form.get(key, 0) + 1
        if not want_uv:
            # The frame forms write no u, v: zeros, enqueued after the
            # kernel so that their fills run behind it, not before it.
            uv = [torch.zeros((n,), dtype=f32, device=dev) for _ in range(2)]
        hits = Hits(tri, t, *uv)
        return (hits, stats) if with_stats else hits
