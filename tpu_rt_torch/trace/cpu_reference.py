"""CPU oracle tracers (host numpy) — the semantic ground truth.

A copy of ``tpu_rt/trace/cpu_reference.py`` with its imports rewritten; the
tests hold it bit-equal to ``tpu_rt``'s.  It is the oracle of the binary
kernel (``tpu_rt_torch/trace/flat_kernel.py``), whose per-ray counters
equal ``RayStats.per_ray_node_tests`` / ``per_ray_tri_tests``.

Two independent implementations, mirroring the reference's verification
strategy (SURVEY.md section 4; reference BVH::trace, src/rt/bvh/BVH.cc:67-163
and Intersect::RayTriangle, src/rt/Util.cc:50-94):

- ``intersect_brute``: vectorized Moller-Trumbore against *every* triangle —
  independent of any BVH, the final arbiter of hit correctness.
- ``trace_flat_scalar``: per-ray scalar traversal of the FlatBVH with the
  exact float32 arithmetic of the device kernel (ooeps idir clamp, Woop test
  with the GPU sign convention of kepler_dynamic_fetch.cu:334-370, near-first
  ordering, postponed-leaf-free simple stack) plus RayStats counters —
  the golden reference the vectorized tracers must match hit-for-hit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpu_rt_torch.core.types import FlatBVH

OOEPS = np.float32(np.exp2(-80.0))


@dataclass
class RayStats:
    """Per-batch algorithmic counters (reference BVH.hh:39-50).

    ``num_treelets`` counts treelet TRANSITIONS during traversal (the
    reference's numTreelets, BVH.cc:89-99: ++ whenever the walk enters a
    node whose treelet id differs from the previous node's, reset per
    ray).  The reference never assigns m_treelet (all -1, so it counts
    1/ray); pass a ``treelets`` array from :func:`assign_treelets` to
    :func:`trace_flat_scalar` for a real partition.  Transitions are
    counted on INNER-node visits (flat leaves live inside their parent's
    record here, unlike the reference's LeafNode objects, so leaf visits
    carry no treelet of their own).
    """

    num_rays: int = 0
    num_node_tests: int = 0
    num_triangle_tests: int = 0
    num_treelets: int = 0
    per_ray_node_tests: np.ndarray | None = None
    per_ray_tri_tests: np.ndarray | None = None
    per_ray_treelets: np.ndarray | None = None


def assign_treelets(flat: FlatBVH, max_nodes: int = 64) -> np.ndarray:
    """Partition the inner-node tree into treelets of <= max_nodes nodes.

    Greedy top-down: the root opens treelet 0; a child joins its parent's
    treelet while that treelet has budget, otherwise it opens a new one.
    Returns an int32 array [num_nodes] of treelet ids.  This is the
    flat-BVH analog of the reference's per-node m_treelet slot
    (BVHNode.hh:66, "for queuing tests") which the reference leaves
    unassigned; treelets/ray from the oracle then measures traversal
    locality — how often a ray's walk crosses a VMEM-tile-sized region
    of the node table (the roofline question for mixed/hbm residency).
    """
    nodes = np.asarray(flat.nodes, np.float32)
    links = np.ascontiguousarray(nodes[:, 12:16]).view(np.int32)
    n = nodes.shape[0]
    tl = np.full(n, -1, np.int32)
    if n == 0:
        return tl
    counts = [1]  # the root occupies its own treelet's first slot
    tl[0] = 0
    stack = [0]
    while stack:
        node = stack.pop()
        t = tl[node]
        for c in (int(links[node, 0]), int(links[node, 1])):
            if c < 0:  # leaf link: leaves inherit the parent treelet
                continue
            if counts[t] < max_nodes:
                tl[c] = t
                counts[t] += 1
            else:
                tl[c] = len(counts)
                counts.append(1)
            stack.append(c)
    return tl


def intersect_brute(
    tris: np.ndarray,
    origin: np.ndarray,
    dirn: np.ndarray,
    tmin: np.ndarray,
    tmax: np.ndarray,
    chunk: int = 4_194_304,
):
    """Closest-hit Moller-Trumbore of every ray against every triangle.

    tris: [T,3,3] f32 vertex positions.  Returns (hit_id [R] i32, t, u, v).
    Rays with tmax < 0 are degenerate and always miss (reference
    RayGenKernels.cu:221 convention).  Hits require tmin < t < tmax with the
    ray's *current* closest, matching the kernel's strict inequalities.
    Ties on t resolve to the lowest triangle index.
    """
    tris = np.asarray(tris, np.float32)
    origin = np.asarray(origin, np.float32).reshape(-1, 3)
    dirn = np.asarray(dirn, np.float32).reshape(-1, 3)
    tmin = np.asarray(tmin, np.float32).reshape(-1)
    tmax = np.asarray(tmax, np.float32).reshape(-1)
    n_rays = origin.shape[0]
    n_tris = tris.shape[0]

    hit_id = np.full(n_rays, -1, np.int32)
    hit_t = tmax.copy()
    hit_u = np.zeros(n_rays, np.float32)
    hit_v = np.zeros(n_rays, np.float32)

    if n_tris == 0 or n_rays == 0:
        return hit_id, hit_t, hit_u, hit_v

    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]

    rows = max(1, chunk // max(n_tris, 1))
    for start in range(0, n_rays, rows):
        sl = slice(start, min(start + rows, n_rays))
        o = origin[sl][:, None, :]  # [r,1,3]
        d = dirn[sl][:, None, :]

        pvec = np.cross(d, e2[None, :, :])               # [r,T,3]
        det = np.einsum("tk,rtk->rt", e1, pvec)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_det = 1.0 / det
            tvec = o - v0[None, :, :]
            u = np.einsum("rtk,rtk->rt", tvec, pvec) * inv_det
            qvec = np.cross(tvec, e1[None, :, :])
            v = np.einsum("rtk,rtk->rt", d, qvec) * inv_det
            t = np.einsum("tk,rtk->rt", e2, qvec) * inv_det

        ok = (
            (np.abs(det) > 0)
            & (u >= 0)
            & (v >= 0)
            & (u + v <= 1)
            & (t > tmin[sl][:, None])
            & (t < hit_t[sl][:, None])
            & (tmax[sl][:, None] >= 0)
        )
        t_masked = np.where(ok, t, np.inf)
        best = np.argmin(t_masked, axis=1)
        r = np.arange(t_masked.shape[0])
        found = np.isfinite(t_masked[r, best])
        gi = np.flatnonzero(found) + start
        hit_id[gi] = best[found]
        hit_t[gi] = t[r[found], best[found]]
        hit_u[gi] = u[r[found], best[found]]
        hit_v[gi] = v[r[found], best[found]]
    return hit_id, hit_t, hit_u, hit_v


def _flat_views(flat: FlatBVH):
    nodes = np.asarray(flat.nodes, np.float32)
    links = np.ascontiguousarray(nodes[:, 12:16]).view(np.int32)
    woop = np.asarray(flat.tri_woop, np.float32)
    tri_index = np.asarray(flat.tri_index, np.int32)
    leaf_counts = np.asarray(flat.leaf_counts, np.int32)
    return nodes, links, woop, tri_index, leaf_counts


def trace_flat_scalar(
    flat: FlatBVH,
    origin: np.ndarray,
    dirn: np.ndarray,
    tmin: np.ndarray,
    tmax: np.ndarray,
    any_hit: bool = False,
    stats: RayStats | None = None,
    treelets: np.ndarray | None = None,
):
    """Scalar per-ray FlatBVH traversal, float32-exact vs the device kernel.

    Returns (hit_tri [R] i32 original ids, t, u, v).  ``any_hit=True``
    terminates a ray at its first accepted intersection (AO semantics,
    reference kernel anyHit branch kepler_dynamic_fetch.cu:376-381).
    ``treelets`` (from :func:`assign_treelets`) enables the reference's
    numTreelets transition counter (BVH.cc:89-99) in ``stats``; without
    it every node shares treelet -1, so the count is 1/ray as in the
    reference's unassigned default.
    """
    nodes, links, woop, tri_index, leaf_counts = _flat_views(flat)
    origin = np.asarray(origin, np.float32).reshape(-1, 3)
    dirn = np.asarray(dirn, np.float32).reshape(-1, 3)
    tmin = np.asarray(tmin, np.float32).reshape(-1)
    tmax = np.asarray(tmax, np.float32).reshape(-1)
    n_rays = origin.shape[0]

    hit_row = np.full(n_rays, -1, np.int64)
    hit_t = tmax.copy()
    hit_u = np.zeros(n_rays, np.float32)
    hit_v = np.zeros(n_rays, np.float32)
    node_tests = np.zeros(n_rays, np.int64)
    tri_tests = np.zeros(n_rays, np.int64)
    treelet_trans = np.zeros(n_rays, np.int64)

    f32 = np.float32
    for r in range(n_rays):
        if tmax[r] < 0 or nodes.shape[0] == 0:
            continue
        o = origin[r]
        d = dirn[r]
        idir = np.empty(3, f32)
        for k in range(3):
            dk = d[k]
            idir[k] = f32(1.0) / (dk if abs(dk) > OOEPS else np.copysign(OOEPS, dk))
        ood = (o * idir).astype(f32)

        t_min = tmin[r]
        stack = [np.int32(0x7FFFFFFF)]  # sentinel
        node = np.int32(0)
        cur_tl = -2  # reference: currentTreelet = -2 per ray (BVH.cc:76)
        while node != 0x7FFFFFFF:
            if node >= 0:
                node_tests[r] += 1
                tl = -1 if treelets is None else int(treelets[node])
                if tl != cur_tl:
                    treelet_trans[r] += 1
                    cur_tl = tl
                row = nodes[node]
                c0lo = (row[[0, 2, 8]] * idir - ood).astype(f32)
                c0hi = (row[[1, 3, 9]] * idir - ood).astype(f32)
                c1lo = (row[[4, 6, 10]] * idir - ood).astype(f32)
                c1hi = (row[[5, 7, 11]] * idir - ood).astype(f32)
                c0min = max(np.minimum(c0lo, c0hi).max(), t_min)
                c0max = min(np.maximum(c0lo, c0hi).min(), hit_t[r])
                c1min = max(np.minimum(c1lo, c1hi).max(), t_min)
                c1max = min(np.maximum(c1lo, c1hi).min(), hit_t[r])
                hit0 = c0max >= c0min
                hit1 = c1max >= c1min
                c0, c1 = links[node, 0], links[node, 1]
                if not hit0 and not hit1:
                    node = stack.pop()
                elif hit0 and hit1:
                    if c1min < c0min:
                        c0, c1 = c1, c0
                    stack.append(c1)
                    node = c0
                else:
                    node = c0 if hit0 else c1
            else:
                first = ~node
                count = leaf_counts[min(first, leaf_counts.shape[0] - 1)]
                done = False
                for j in range(first, first + count):
                    tri_tests[r] += 1
                    w = woop[j]
                    Oz = f32(w[3] - o[0] * w[0] - o[1] * w[1] - o[2] * w[2])
                    Dz = f32(d[0] * w[0] + d[1] * w[1] + d[2] * w[2])
                    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                        inv_dz = f32(1.0) / Dz
                        t = f32(Oz * inv_dz)
                    if t > t_min and t < hit_t[r]:
                        Ox = f32(w[7] + o[0] * w[4] + o[1] * w[5] + o[2] * w[6])
                        Dx = f32(d[0] * w[4] + d[1] * w[5] + d[2] * w[6])
                        u = f32(Ox + t * Dx)
                        if u >= 0.0:
                            Oy = f32(w[11] + o[0] * w[8] + o[1] * w[9] + o[2] * w[10])
                            Dy = f32(d[0] * w[8] + d[1] * w[9] + d[2] * w[10])
                            v = f32(Oy + t * Dy)
                            if v >= 0.0 and u + v <= 1.0:
                                hit_t[r] = t
                                hit_row[r] = j
                                hit_u[r] = u
                                hit_v[r] = v
                                if any_hit:
                                    done = True
                                    break
                if done:
                    break
                node = stack.pop()

    if stats is not None:
        stats.num_rays += n_rays
        stats.num_node_tests += int(node_tests.sum())
        stats.num_triangle_tests += int(tri_tests.sum())
        stats.num_treelets += int(treelet_trans.sum())
        stats.per_ray_node_tests = node_tests
        stats.per_ray_tri_tests = tri_tests
        stats.per_ray_treelets = treelet_trans

    hit_tri = np.where(hit_row >= 0, tri_index[np.clip(hit_row, 0, max(0, tri_index.shape[0] - 1))], -1).astype(np.int32)
    return hit_tri, hit_t, hit_u, hit_v
