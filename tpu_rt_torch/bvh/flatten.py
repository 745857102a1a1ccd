"""Flatten the SBVH pointer tree into TPU-friendly arrays + Woop transform.

Equivalent of the reference's CudaBVH::createCompact + woopifyTri
(src/rt/cuda/CudaBVH.cc:270-380), with the layout deltas documented in
tpu_rt_torch.core.types.FlatBVH: row indices instead of byte offsets, explicit
per-leaf triangle counts instead of the -0.0f terminator, and the whole Woop
batch computed vectorized.

Woop transform (CudaBVH.cc:361-380): per triangle build the affine matrix
M = [v0-v2 | v1-v2 | (v0-v2)x(v1-v2) | v2], invert it, and store
    woopZ = (m20, m21, m22, -m23)       # z row, translation negated
    woopU = row 0
    woopV = row 1
so a ray hits the unit triangle (u>=0, v>=0, u+v<=1) in transformed space.
"""

from __future__ import annotations

import numpy as np

from tpu_rt_torch.bvh.builder import BVH, BVHNode
from tpu_rt_torch.core.types import FlatBVH


def woopify(tri_vtx_index: np.ndarray, vtx_pos: np.ndarray, tri_ids: np.ndarray) -> np.ndarray:
    """Vectorized Woop rows for the given triangles -> [R,12] f32
    (woopZ[4], woopU[4], woopV[4])."""
    tri_ids = np.asarray(tri_ids, np.int64).reshape(-1)
    idx = np.asarray(tri_vtx_index, np.int64)[tri_ids]  # [R,3]
    v = np.asarray(vtx_pos, np.float64)
    v0, v1, v2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]

    e1 = v0 - v2
    e2 = v1 - v2
    n = np.cross(e1, e2)

    # A = [e1 | e2 | n] columns; inverse via adjugate / det so degenerate
    # triangles yield inf/nan (matching the reference's non-throwing invert)
    # instead of raising.
    A = np.stack([e1, e2, n], axis=-1)  # [R,3,3]
    det = np.einsum("ri,ri->r", n, n)  # det(A) = n . (e1 x e2) = |n|^2
    # Cofactor (adjugate transpose) rows of A^-1.
    c = np.empty_like(A)
    a = A
    c[:, 0, 0] = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c[:, 0, 1] = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c[:, 0, 2] = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c[:, 1, 0] = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c[:, 1, 1] = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c[:, 1, 2] = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c[:, 2, 0] = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c[:, 2, 1] = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c[:, 2, 2] = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = c / det[:, None, None]
        t = -np.einsum("rij,rj->ri", inv, v2)  # translation column of M^-1

    out = np.empty((tri_ids.shape[0], 12), np.float32)
    out[:, 0:3] = inv[:, 2, :]
    out[:, 3] = -t[:, 2]
    out[:, 4:7] = inv[:, 0, :]
    out[:, 7] = t[:, 0]
    out[:, 8:11] = inv[:, 1, :]
    out[:, 11] = t[:, 1]
    return out


def flatten_bvh(bvh: BVH, tri_vtx_index: np.ndarray, vtx_pos: np.ndarray) -> FlatBVH:
    """DFS-flatten the pointer tree to the FlatBVH arrays (host numpy).

    Matches the reference's stack traversal (CudaBVH.cc:281-340): pop a node,
    allocate child rows for inner children, emit woop rows for leaf children.
    """
    root = bvh.root
    if root.is_leaf:
        # Single-leaf scene: synthesize one inner node whose child0 is the
        # leaf and child1 is an empty leaf, so the tracer needs no special
        # root handling (the reference asserts 2 children instead).
        n_tris = root.num_tris()
        nodes = np.zeros((1, 16), np.float32)
        box = np.array(
            [root.lo_b[0], root.hi_b[0], root.lo_b[1], root.hi_b[1]], np.float32
        )
        nodes[0, 0:4] = box
        nodes[0, 4:8] = [0, -1, 0, -1]  # inverted box: child1 never hits
        nodes[0, 8:10] = [root.lo_b[2], root.hi_b[2]]
        nodes[0, 10:12] = [0, -1]
        links = np.zeros(4, np.int32)
        links[0] = ~0
        links[1] = ~n_tris  # empty leaf at the end
        links[2] = n_tris
        links[3] = 0
        nodes[0, 12:16] = links.view(np.float32)
        order = bvh.tri_indices[root.lo : root.hi]
        woop = woopify(tri_vtx_index, vtx_pos, order)
        leaf_counts = np.zeros(n_tris + 1, np.int32)
        leaf_counts[0] = n_tris
        return FlatBVH(
            nodes=nodes,
            tri_woop=woop,
            tri_index=np.asarray(order, np.int32),
            leaf_counts=leaf_counts,
        )

    node_rows: list[np.ndarray] = []
    tri_order: list[np.ndarray] = []
    tri_count = 0

    # Stack of (node, row) with rows preallocated on push.
    node_rows.append(np.zeros(16, np.float32))
    stack: list[tuple[BVHNode, int]] = [(root, 0)]
    while stack:
        node, row = stack.pop()
        links = np.zeros(4, np.int32)
        boxes = np.zeros(12, np.float32)
        for i, child in enumerate((node.left, node.right)):
            if i == 0:
                boxes[0:4] = [child.lo_b[0], child.hi_b[0], child.lo_b[1], child.hi_b[1]]
                boxes[8:10] = [child.lo_b[2], child.hi_b[2]]
            else:
                boxes[4:8] = [child.lo_b[0], child.hi_b[0], child.lo_b[1], child.hi_b[1]]
                boxes[10:12] = [child.lo_b[2], child.hi_b[2]]
            if not child.is_leaf:
                links[i] = len(node_rows)
                node_rows.append(np.zeros(16, np.float32))
                stack.append((child, links[i]))
            else:
                links[i] = ~tri_count
                links[2 + i] = child.num_tris()
                tri_order.append(bvh.tri_indices[child.lo : child.hi])
                tri_count += child.num_tris()
        row_data = np.concatenate([boxes, links.view(np.float32)])
        node_rows[row] = row_data.astype(np.float32)

    nodes = np.stack(node_rows).astype(np.float32)
    order = np.concatenate(tri_order).astype(np.int64) if tri_order else np.zeros(0, np.int64)
    woop = woopify(tri_vtx_index, vtx_pos, order)

    links = np.ascontiguousarray(nodes[:, 12:16]).view(np.int32)
    leaf_counts = np.zeros(order.shape[0] + 1, np.int32)
    for i in range(2):
        is_leaf = links[:, i] < 0
        leaf_counts[~links[is_leaf, i]] = links[is_leaf, 2 + i]
    return FlatBVH(
        nodes=nodes,
        tri_woop=woop,
        tri_index=order.astype(np.int32),
        leaf_counts=leaf_counts,
    )


def node_links(flat: FlatBVH) -> np.ndarray:
    """[N,4] i32 copy of (child0, child1, count0, count1)."""
    return np.ascontiguousarray(np.asarray(flat.nodes)[:, 12:16]).view(np.int32)


def validate_flat_bvh(flat: FlatBVH, num_scene_tris: int) -> None:
    """Structural invariants (debug/tests): links in range, every triangle
    covered at least once, child boxes valid."""
    nodes = np.asarray(flat.nodes)
    links = np.ascontiguousarray(nodes[:, 12:16]).view(np.int32)
    n = nodes.shape[0]
    m = flat.tri_woop.shape[0]
    covered = np.zeros(num_scene_tris, bool)
    for row in range(n):
        for i in range(2):
            c = int(links[row, i])
            if c >= 0:
                assert c < n, (row, i, c)
            else:
                first = ~c
                count = int(links[row, 2 + i])
                assert 0 <= first <= m and first + count <= m, (row, i, first, count)
                covered[np.asarray(flat.tri_index)[first : first + count]] = True
    assert covered.all() or num_scene_tris == 0, f"{(~covered).sum()} triangles unreachable"
