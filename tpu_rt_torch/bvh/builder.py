"""Split-BVH (SBVH) construction on the host — vectorized numpy.

Algorithm parity with the reference SplitBVHBuilder
(src/rt/bvh/SplitBVHBuilder.cc:55-485), per node:

1. cull degenerate references (zero extent / negative box),
2. *object split*: for each axis, order references by centroid (triIdx
   tiebreak), sweep SAH left/right with squared-count tiebreak,
3. *spatial split* (only while child overlap area >= rootArea * splitAlpha
   and level < MaxSpatialDepth): chop each reference into 128 uniform bins
   per axis with enter/exit counts, sweep bin SAH,
4. pick min(leaf, object, spatial); spatial split classifies straddling
   references by unsplit-left / unsplit-right / duplicate SAH arbitration.

Deviations from the reference (deliberate, documented):
- Reference-order inside a node's straddler set comes from a stable
  partition rather than the reference's swap dance; the arbitration loop
  itself is sequential and order-faithful within that set.
- Bin bounds are computed by direct slab clipping. This is mathematically
  identical to the reference's iterative chop (its left/right clip AABBs are
  exactly the clipped-polygon AABBs and the nested intersections are
  monotone), but evaluated vectorized over (reference, bin) pairs.

The builder is also exposed through a C++ native module (tpu_rt_torch.native) for
big scenes; this numpy version is the semantic definition and the fallback.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from tpu_rt_torch.core.math import float_to_bits, hash_bits, hash_buffer

F32_MAX = np.float32(np.finfo(np.float32).max)


@dataclass
class Platform:
    """SAH cost model (reference src/rt/bvh/Platform.hh:39-79).  The GPU
    platform the renderer uses is Platform('GPU') with leaf prefs (1, 8)
    (Renderer.cc:53-54)."""

    name: str = "Default"
    sah_node_cost: float = 1.0
    sah_triangle_cost: float = 1.0
    node_batch_size: int = 1
    tri_batch_size: int = 1
    min_leaf_size: int = 1
    max_leaf_size: int = 0x7FFFFFF

    @classmethod
    def gpu(cls) -> "Platform":
        return cls(name="GPU", min_leaf_size=1, max_leaf_size=8)

    def triangle_cost(self, n) -> np.ndarray:
        n = np.asarray(n)
        batched = -(-n // self.tri_batch_size) * self.tri_batch_size
        return (batched * self.sah_triangle_cost).astype(np.float32)

    def node_cost(self, n) -> np.ndarray:
        n = np.asarray(n)
        batched = -(-n // self.node_batch_size) * self.node_batch_size
        return (batched * self.sah_node_cost).astype(np.float32)

    def hash(self) -> int:
        # Deterministic name hash (the reference hashes its String with
        # Jenkins too, Platform.hh:69): python's builtin str hash is
        # PYTHONHASHSEED-salted per process, which silently changed the
        # BVH cache key every run and rebuilt hairball-class scenes
        # (~6.5 min) on every suite invocation until round 4.
        return hash_bits(
            hash_buffer(np.frombuffer(self.name.encode(), np.uint8)),
            int(float_to_bits(np.float32(self.sah_node_cost))),
            int(float_to_bits(np.float32(self.sah_triangle_cost))),
            self.tri_batch_size,
            self.node_batch_size,
            self.min_leaf_size,
            self.max_leaf_size,
        )


@dataclass
class BuildParams:
    """Reference BVH::BuildParams (BVH.hh:69-86) + the builder's compile-time
    constants promoted to config (SplitBVHBuilder.hh:41-46)."""

    split_alpha: float = 1.0e-5
    max_depth: int = 64
    max_spatial_depth: int = 48
    num_spatial_bins: int = 128
    enable_prints: bool = False

    def hash(self) -> int:
        return hash_bits(
            int(float_to_bits(np.float32(self.split_alpha))),
            self.max_depth,
            self.max_spatial_depth,
            self.num_spatial_bins,
        )


@dataclass
class BuildStats:
    """Reference BVH::Stats (BVH.hh:55-67) + duplicate ratio."""

    sah_cost: float = 0.0
    branching_factor: int = 2
    num_inner_nodes: int = 0
    num_leaf_nodes: int = 0
    num_child_nodes: int = 0
    num_tris: int = 0
    num_duplicates: int = 0

    @property
    def duplicate_pct(self) -> float:
        base = max(1, self.num_tris - self.num_duplicates)
        return 100.0 * self.num_duplicates / base


class BVHNode:
    """Host-side pointer tree node.  Inner: children = (left, right);
    leaf: [lo, hi) range into tri_indices."""

    __slots__ = ("lo_b", "hi_b", "left", "right", "lo", "hi")

    def __init__(self, lo_b, hi_b, left=None, right=None, lo=-1, hi=-1):
        self.lo_b = lo_b  # bounds min [3] f32
        self.hi_b = hi_b  # bounds max [3] f32
        self.left = left
        self.right = right
        self.lo = lo
        self.hi = hi

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    def area(self) -> float:
        d = self.hi_b - self.lo_b
        if np.any(d < 0):
            return 0.0
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))

    def num_tris(self) -> int:
        return self.hi - self.lo if self.is_leaf else 0


@dataclass
class BVH:
    """Build result: pointer tree + the leaf triangle-index stream."""

    root: BVHNode
    tri_indices: np.ndarray  # [R] i32, leaves reference [lo,hi) slices
    stats: BuildStats = field(default_factory=BuildStats)


def _area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Vectorized AABB surface area; 0 for invalid boxes.  lo/hi [...,3]."""
    d = hi - lo
    valid = np.all(d >= 0, axis=-1)
    a = 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])
    return np.where(valid, a, 0.0).astype(np.float32)


class _SBVHBuilder:
    def __init__(self, tri_vtx: np.ndarray, vtx_pos: np.ndarray, platform: Platform, params: BuildParams):
        self.tri_vtx = np.asarray(tri_vtx, np.int32).reshape(-1, 3)
        self.vtx = np.asarray(vtx_pos, np.float32).reshape(-1, 3)
        self.platform = platform
        self.params = params
        self.num_bins = params.num_spatial_bins

        # Reference stack, SoA.  The top `num_ref` rows of these arrays are
        # the refs of the node currently being built (mirrors the
        # reference's m_refStack discipline, SplitBVHBuilder.cc:121-186).
        n = self.tri_vtx.shape[0]
        tri = self.vtx[self.tri_vtx]  # [n,3,3]
        self.r_tri = np.arange(n, dtype=np.int32)
        self.r_lo = tri.min(axis=1).astype(np.float32)
        self.r_hi = tri.max(axis=1).astype(np.float32)

        self.root_lo = self.r_lo.min(axis=0) if n else np.zeros(3, np.float32)
        self.root_hi = self.r_hi.max(axis=0) if n else np.zeros(3, np.float32)
        self.min_overlap = _area(self.root_lo, self.root_hi) * np.float32(params.split_alpha)

        self.tri_out: list[np.ndarray] = []  # leaf triangle-index chunks
        self.tri_out_size = 0
        self.num_duplicates = 0

    # -- ref stack helpers ---------------------------------------------------

    def _top(self, n: int) -> slice:
        return slice(self.r_tri.shape[0] - n, self.r_tri.shape[0])

    def _pop(self, n: int) -> None:
        keep = self.r_tri.shape[0] - n
        self.r_tri = self.r_tri[:keep]
        self.r_lo = self.r_lo[:keep]
        self.r_hi = self.r_hi[:keep]

    def _push(self, tri, lo, hi) -> None:
        self.r_tri = np.concatenate([self.r_tri, tri])
        self.r_lo = np.concatenate([self.r_lo, lo])
        self.r_hi = np.concatenate([self.r_hi, hi])

    # -- main recursion ------------------------------------------------------

    def run(self) -> BVH:
        num_ref = self.r_tri.shape[0]
        if num_ref == 0:
            root = BVHNode(np.zeros(3, np.float32), np.zeros(3, np.float32), lo=0, hi=0)
            return BVH(root=root, tri_indices=np.zeros(0, np.int32))
        root = self._build_node(num_ref, self.root_lo, self.root_hi, 0)
        tri_indices = (
            np.concatenate(self.tri_out) if self.tri_out else np.zeros(0, np.int32)
        ).astype(np.int32)
        bvh = BVH(root=root, tri_indices=tri_indices)
        bvh.stats.num_duplicates = self.num_duplicates
        return bvh

    def _create_leaf(self, num_ref: int) -> BVHNode:
        # Reference emits refs popped from the stack in reverse
        # (SplitBVHBuilder.cc:190-199); order inside a leaf is irrelevant to
        # traversal but kept reversed for familiarity.
        sl = self._top(num_ref)
        tris = self.r_tri[sl][::-1].copy()
        lo = self.tri_out_size
        self.tri_out.append(tris)
        self.tri_out_size += num_ref
        node_lo = self.r_lo[sl].min(axis=0) if num_ref else np.zeros(3, np.float32)
        node_hi = self.r_hi[sl].max(axis=0) if num_ref else np.zeros(3, np.float32)
        self._pop(num_ref)
        return BVHNode(node_lo, node_hi, lo=lo, hi=self.tri_out_size)

    def _build_node(self, num_ref: int, lo_b: np.ndarray, hi_b: np.ndarray, level: int) -> BVHNode:
        p = self.platform

        # Remove degenerates (SplitBVHBuilder.cc:134-143): negative extent or
        # all extent concentrated on one axis (lines/points).
        sl = self._top(num_ref)
        size = self.r_hi[sl] - self.r_lo[sl]
        bad = (size.min(axis=1) < 0.0) | (size.sum(axis=1) == size.max(axis=1))
        if bad.any():
            good = ~bad
            tri, lo, hi = self.r_tri[sl][good], self.r_lo[sl][good], self.r_hi[sl][good]
            self._pop(num_ref)
            self._push(tri, lo, hi)
            num_ref = tri.shape[0]

        if num_ref <= p.min_leaf_size or level >= self.params.max_depth:
            return self._create_leaf(num_ref)

        area = _area(lo_b, hi_b)
        leaf_sah = area * p.triangle_cost(num_ref)
        node_sah = area * p.node_cost(2)

        obj = self._find_object_split(num_ref, node_sah)

        spatial = None
        if level < self.params.max_spatial_depth and obj is not None:
            ov_lo = np.maximum(obj["left_lo"], obj["right_lo"])
            ov_hi = np.minimum(obj["left_hi"], obj["right_hi"])
            if _area(ov_lo, ov_hi) >= self.min_overlap:
                spatial = self._find_spatial_split(num_ref, node_sah)

        obj_sah = obj["sah"] if obj is not None else F32_MAX
        spa_sah = spatial["sah"] if spatial is not None else F32_MAX
        min_sah = min(float(leaf_sah), float(obj_sah), float(spa_sah))
        if min_sah == float(leaf_sah) and num_ref <= p.max_leaf_size:
            return self._create_leaf(num_ref)

        split_result = None
        if spatial is not None and min_sah == float(spa_sah):
            split_result = self._perform_spatial_split(num_ref, spatial)
        if split_result is None or split_result[0] == 0 or split_result[2] == 0:
            if split_result is not None:
                # Undo nothing: spatial split rebuilt the stack top in place;
                # a degenerate side falls back to the object split over the
                # (possibly re-materialized) refs, like the reference
                # (SplitBVHBuilder.cc:178-181).
                num_ref = split_result[0] + split_result[2]
            split_result = self._perform_object_split(num_ref, obj)

        n_left, (l_lo, l_hi), n_right, (r_lo, r_hi) = split_result
        self.num_duplicates += n_left + n_right - num_ref

        # Right child's refs are on top of the stack: build right first
        # (reference SplitBVHBuilder.cc:182-185).
        right = self._build_node(n_right, r_lo, r_hi, level + 1)
        left = self._build_node(n_left, l_lo, l_hi, level + 1)
        return BVHNode(lo_b.copy(), hi_b.copy(), left=left, right=right)

    # -- object split --------------------------------------------------------

    def _find_object_split(self, num_ref: int, node_sah: np.ndarray):
        """Sweep SAH over centroid-sorted refs, all 3 dims
        (SplitBVHBuilder.cc:203-244)."""
        if num_ref < 2:
            return None
        sl = self._top(num_ref)
        lo, hi, tri = self.r_lo[sl], self.r_hi[sl], self.r_tri[sl]
        p = self.platform

        best = None
        best_tie = np.inf
        for dim in range(3):
            cent = lo[:, dim] + hi[:, dim]
            order = np.lexsort((tri, cent))  # centroid, then triIdx tiebreak
            slo, shi = lo[order], hi[order]

            # prefix (left) and suffix (right) bounds via cumulative min/max.
            left_lo = np.minimum.accumulate(slo, axis=0)
            left_hi = np.maximum.accumulate(shi, axis=0)
            right_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
            right_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]

            i = np.arange(1, num_ref)
            sah = (
                node_sah
                + _area(left_lo[:-1], left_hi[:-1]) * p.triangle_cost(i)
                + _area(right_lo[1:], right_hi[1:]) * p.triangle_cost(num_ref - i)
            ).astype(np.float32)
            tie = (i.astype(np.float64)) ** 2 + (num_ref - i).astype(np.float64) ** 2

            k = int(np.argmin(sah))
            # Emulate the reference's scan-order tie-break within the dim:
            # among equal-SAH candidates prefer the lowest tie value.
            ties = np.flatnonzero(sah == sah[k])
            k = int(ties[np.argmin(tie[ties])])

            if best is None or sah[k] < best["sah"] or (sah[k] == best["sah"] and tie[k] < best_tie):
                best = {
                    "sah": np.float32(sah[k]),
                    "dim": dim,
                    "num_left": k + 1,
                    "left_lo": left_lo[k],
                    "left_hi": left_hi[k],
                    "right_lo": right_lo[k + 1],
                    "right_hi": right_hi[k + 1],
                }
                best_tie = tie[k]
        return best

    def _perform_object_split(self, num_ref: int, split):
        sl = self._top(num_ref)
        lo, hi, tri = self.r_lo[sl], self.r_hi[sl], self.r_tri[sl]
        dim = split["dim"]
        order = np.lexsort((tri, lo[:, dim] + hi[:, dim]))
        n_left = split["num_left"]
        # Stack layout: left refs below, right refs on top.
        new_tri = tri[order]
        new_lo = lo[order]
        new_hi = hi[order]
        self._pop(num_ref)
        self._push(new_tri, new_lo, new_hi)
        return (
            n_left,
            (split["left_lo"], split["left_hi"]),
            num_ref - n_left,
            (split["right_lo"], split["right_hi"]),
        )

    # -- spatial split -------------------------------------------------------

    def _clip_refs_to_slabs(self, tri_ids, ref_lo, ref_hi, dim, lo_planes, hi_planes, clip_lo, clip_hi):
        """Vectorized triangle-slab clip (= reference splitReference algebra,
        SplitBVHBuilder.cc:441-485).  For each row: clip triangle tri_ids[i]
        to the slab [lo_planes[i], hi_planes[i]] along `dim` (applying the
        lo/hi plane only where clip_lo/clip_hi), intersect with the ref
        bounds.  Returns (out_lo, out_hi) [M,3]."""
        v = self.vtx[self.tri_vtx[tri_ids]]  # [M,3,3]
        c = v[:, :, dim]  # [M,3]

        pts_lo = np.full((tri_ids.shape[0], 3), np.inf, np.float32)
        pts_hi = np.full((tri_ids.shape[0], 3), -np.inf, np.float32)

        def grow(pmask, pts):
            # pts [M,3]; pmask [M] selects rows to grow.
            nonlocal pts_lo, pts_hi
            w = pmask[:, None]
            pts_lo = np.where(w, np.minimum(pts_lo, pts), pts_lo)
            pts_hi = np.where(w, np.maximum(pts_hi, pts), pts_hi)

        lo_p = lo_planes[:, None]  # [M,1]
        hi_p = hi_planes[:, None]

        # Vertices inside the slab (<=/>= inclusive, matching the reference's
        # v0p<=pos / v0p>=pos growth on both sides of a single plane).
        inside = np.ones_like(c, bool)
        if clip_hi:
            inside &= c <= hi_p
        if clip_lo:
            inside &= c >= lo_p
        for k in range(3):
            grow(inside[:, k], v[:, k, :])

        # Edge/plane crossings.
        for a, b in ((2, 0), (0, 1), (1, 2)):  # edge order of the reference
            va, vb = v[:, a, :], v[:, b, :]
            ca, cb = c[:, a], c[:, b]
            for plane, enabled in ((lo_planes, clip_lo), (hi_planes, clip_hi)):
                if not enabled:
                    continue
                strad = ((ca < plane) & (cb > plane)) | ((ca > plane) & (cb < plane))
                denom = cb - ca
                tt = np.clip(
                    np.divide(plane - ca, denom, out=np.zeros_like(denom), where=denom != 0),
                    0.0,
                    1.0,
                )[:, None]
                pt = va + (vb - va) * tt
                grow(strad, pt)

        out_lo, out_hi = pts_lo, pts_hi
        # Pin the split planes exactly (reference sets max[dim]=pos /
        # min[dim]=pos before intersecting with the ref bounds).
        if clip_lo:
            out_lo = out_lo.copy()
            out_lo[:, dim] = lo_planes
        if clip_hi:
            out_hi = out_hi.copy()
            out_hi[:, dim] = hi_planes
        out_lo = np.maximum(out_lo, ref_lo)
        out_hi = np.minimum(out_hi, ref_hi)
        return out_lo, out_hi

    def _find_spatial_split(self, num_ref: int, node_sah: np.ndarray):
        """128-bin chop with enter/exit counts (SplitBVHBuilder.cc:262-340)."""
        nb = self.num_bins
        sl = self._top(num_ref)
        lo, hi, tri = self.r_lo[sl], self.r_hi[sl], self.r_tri[sl]
        p = self.platform

        origin = lo.min(axis=0)
        top = hi.max(axis=0)
        bin_size = (top - origin) * np.float32(1.0 / nb)
        safe = np.where(bin_size > 0, bin_size, 1.0).astype(np.float32)
        inv = (1.0 / safe).astype(np.float32)

        first = np.clip(((lo - origin) * inv).astype(np.int32), 0, nb - 1)
        last = np.clip(((hi - origin) * inv).astype(np.int32), first, nb - 1)

        best = None
        for dim in range(3):
            if bin_size[dim] <= 0:
                continue
            f, l = first[:, dim], last[:, dim]

            enter = np.bincount(f, minlength=nb)
            exit_ = np.bincount(l, minlength=nb)

            # Per-(ref,bin) pairs for bound accumulation.
            spans = l - f + 1
            pair_ref = np.repeat(np.arange(num_ref), spans)
            # bin index within each ref's span
            cum = np.concatenate([[0], np.cumsum(spans)[:-1]])
            pair_bin = (np.arange(pair_ref.shape[0]) - cum[pair_ref]) + f[pair_ref]

            lo_planes = origin[dim] + bin_size[dim] * pair_bin.astype(np.float32)
            hi_planes = origin[dim] + bin_size[dim] * (pair_bin + 1).astype(np.float32)
            need_lo = pair_bin > f[pair_ref]
            need_hi = pair_bin < l[pair_ref]

            # Pairs needing no clipping at all keep the raw ref bounds.
            plain = ~(need_lo | need_hi)
            c_lo = np.empty((pair_ref.shape[0], 3), np.float32)
            c_hi = np.empty((pair_ref.shape[0], 3), np.float32)
            if plain.any():
                c_lo[plain] = lo[pair_ref[plain]]
                c_hi[plain] = hi[pair_ref[plain]]
            for mask, cl, ch in (
                (need_lo & need_hi, True, True),
                (need_lo & ~need_hi, True, False),
                (~need_lo & need_hi, False, True),
            ):
                if mask.any():
                    r = pair_ref[mask]
                    c_lo[mask], c_hi[mask] = self._clip_refs_to_slabs(
                        tri[r], lo[r], hi[r], dim, lo_planes[mask], hi_planes[mask], cl, ch
                    )

            # Scatter min/max into the bins.
            bin_lo = np.full((nb, 3), np.inf, np.float32)
            bin_hi = np.full((nb, 3), -np.inf, np.float32)
            np.minimum.at(bin_lo, pair_bin, c_lo)
            np.maximum.at(bin_hi, pair_bin, c_hi)

            right_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
            right_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
            left_lo = np.minimum.accumulate(bin_lo, axis=0)
            left_hi = np.maximum.accumulate(bin_hi, axis=0)

            i = np.arange(1, nb)
            left_num = np.cumsum(enter)[:-1]
            right_num = num_ref - np.cumsum(exit_)[:-1]
            sah = (
                node_sah
                + _area(left_lo[:-1], left_hi[:-1]) * p.triangle_cost(left_num)
                + _area(right_lo[1:], right_hi[1:]) * p.triangle_cost(right_num)
            ).astype(np.float32)

            k = int(np.argmin(sah))
            if best is None or sah[k] < best["sah"]:
                best = {
                    "sah": np.float32(sah[k]),
                    "dim": dim,
                    "pos": np.float32(origin[dim] + bin_size[dim] * (k + 1)),
                }
        return best

    def _perform_spatial_split(self, num_ref: int, split):
        """Classify refs; arbitrate straddlers sequentially
        (SplitBVHBuilder.cc:345-437)."""
        dim, pos = split["dim"], split["pos"]
        sl = self._top(num_ref)
        lo, hi, tri = self.r_lo[sl].copy(), self.r_hi[sl].copy(), self.r_tri[sl].copy()
        p = self.platform

        left_mask = hi[:, dim] <= pos
        right_mask = lo[:, dim] >= pos
        mid_mask = ~(left_mask | right_mask)

        left_tri = [tri[left_mask]]
        left_lo_parts = [lo[left_mask]]
        left_hi_parts = [hi[left_mask]]
        right_tri = [tri[right_mask]]
        right_lo_parts = [lo[right_mask]]
        right_hi_parts = [hi[right_mask]]

        def bounds_of(parts_lo, parts_hi):
            if sum(x.shape[0] for x in parts_lo) == 0:
                return (np.full(3, np.inf, np.float32), np.full(3, -np.inf, np.float32))
            return (
                np.concatenate(parts_lo).min(axis=0),
                np.concatenate(parts_hi).max(axis=0),
            )

        lb_lo, lb_hi = bounds_of(left_lo_parts, left_hi_parts)
        rb_lo, rb_hi = bounds_of(right_lo_parts, right_hi_parts)

        n_left = int(left_mask.sum())
        n_right = int(right_mask.sum())

        mids = np.flatnonzero(mid_mask)
        if mids.size:
            # Pre-split every straddler at the plane (vectorized); the
            # sequential loop then only arbitrates.
            planes = np.full(mids.size, pos, np.float32)
            sl_lo, sl_hi = self._clip_refs_to_slabs(
                tri[mids], lo[mids], hi[mids], dim, planes, planes, False, True
            )
            sr_lo, sr_hi = self._clip_refs_to_slabs(
                tri[mids], lo[mids], hi[mids], dim, planes, planes, True, False
            )

            for j in range(mids.size):
                m = mids[j]
                lub_lo = np.minimum(lb_lo, lo[m]); lub_hi = np.maximum(lb_hi, hi[m])
                rub_lo = np.minimum(rb_lo, lo[m]); rub_hi = np.maximum(rb_hi, hi[m])
                ldb_lo = np.minimum(lb_lo, sl_lo[j]); ldb_hi = np.maximum(lb_hi, sl_hi[j])
                rdb_lo = np.minimum(rb_lo, sr_lo[j]); rdb_hi = np.maximum(rb_hi, sr_hi[j])

                lac = p.triangle_cost(n_left)
                rac = p.triangle_cost(n_right)
                lbc = p.triangle_cost(n_left + 1)
                rbc = p.triangle_cost(n_right + 1)

                unsplit_l = _area(lub_lo, lub_hi) * lbc + _area(rb_lo, rb_hi) * rac
                unsplit_r = _area(lb_lo, lb_hi) * lac + _area(rub_lo, rub_hi) * rbc
                duplicate = _area(ldb_lo, ldb_hi) * lbc + _area(rdb_lo, rdb_hi) * rbc
                m_sah = min(float(unsplit_l), float(unsplit_r), float(duplicate))

                if m_sah == float(unsplit_l):
                    lb_lo, lb_hi = lub_lo, lub_hi
                    left_tri.append(tri[m : m + 1]); left_lo_parts.append(lo[m : m + 1]); left_hi_parts.append(hi[m : m + 1])
                    n_left += 1
                elif m_sah == float(unsplit_r):
                    rb_lo, rb_hi = rub_lo, rub_hi
                    right_tri.append(tri[m : m + 1]); right_lo_parts.append(lo[m : m + 1]); right_hi_parts.append(hi[m : m + 1])
                    n_right += 1
                else:
                    lb_lo, lb_hi = ldb_lo, ldb_hi
                    rb_lo, rb_hi = rdb_lo, rdb_hi
                    left_tri.append(tri[m : m + 1]); left_lo_parts.append(sl_lo[j : j + 1]); left_hi_parts.append(sl_hi[j : j + 1])
                    right_tri.append(tri[m : m + 1]); right_lo_parts.append(sr_lo[j : j + 1]); right_hi_parts.append(sr_hi[j : j + 1])
                    n_left += 1
                    n_right += 1

        self._pop(num_ref)
        # Push left first so the right child's refs end up on top.
        self._push(np.concatenate(left_tri), np.concatenate(left_lo_parts), np.concatenate(left_hi_parts))
        self._push(np.concatenate(right_tri), np.concatenate(right_lo_parts), np.concatenate(right_hi_parts))
        return n_left, (lb_lo, lb_hi), n_right, (rb_lo, rb_hi)


def _compute_sah_cost(root: BVHNode, platform: Platform) -> float:
    """Top-down SAH of the finished tree (reference
    BVHNode::computeSubtreeProbabilities, BVHNode.cc:34-77)."""
    root_area = max(root.area(), 1e-30)
    cost = 0.0
    stack = [(root, 1.0)]
    while stack:
        node, prob = stack.pop()
        if node.is_leaf:
            cost += prob * float(platform.triangle_cost(node.num_tris()))
        else:
            cost += prob * float(platform.node_cost(2))
            for ch in (node.left, node.right):
                stack.append((ch, prob * (ch.area() / root_area if root_area > 0 else 0.0)))
    return cost


def build_sbvh(scene, platform: Platform | None = None, params: BuildParams | None = None) -> BVH:
    """Build an SBVH for a Scene (tpu_rt_torch.scene.Scene or any object with
    tri_vtx_index / vtx_pos arrays).  Returns the pointer tree + stats."""
    platform = platform or Platform.gpu()
    params = params or BuildParams()

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10 * params.max_depth + 100))
    try:
        builder = _SBVHBuilder(scene.tri_vtx_index, scene.vtx_pos, platform, params)
        bvh = builder.run()
    finally:
        sys.setrecursionlimit(old_limit)

    # Stats pass.
    stats = bvh.stats
    stack = [bvh.root]
    while stack:
        node = stack.pop()
        if node.is_leaf:
            stats.num_leaf_nodes += 1
            stats.num_tris += node.num_tris()
        else:
            stats.num_inner_nodes += 1
            stats.num_child_nodes += 2
            stack.append(node.left)
            stack.append(node.right)
    stats.sah_cost = _compute_sah_cost(bvh.root, platform)
    if params.enable_prints:
        print(
            f"SBVH: {stats.num_inner_nodes} inner / {stats.num_leaf_nodes} leaves / "
            f"{stats.num_tris} refs, SAH {stats.sah_cost:.2f}, "
            f"duplicates {stats.duplicate_pct:.0f}%"
        )
    return bvh
