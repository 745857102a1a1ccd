"""SAH-guided collapse of the binary SBVH into a 4-wide (MBVH4) BVH.

Host numpy, a verbatim counterpart of ``tpu_rt.bvh.collapse``: the same
tables bit for bit.  Collapsing two binary levels into one 4-wide node
halves the node fetches per traversal, and merging small subtrees into
wide leaves (up to MAX_LEAF4 = 16 triangles, deduplicating SBVH
spatial-split copies) drains more triangle tests per leaf visit.  On the
GPU each node record is one 128-byte cache line
(``tpu_rt_torch/csrc/quad_trace.cu``).

Layout (QuadBVH.nodes, [Q, 32] f32):

    cols 6j .. 6j+5   child j bounds: lo.x, hi.x, lo.y, hi.y, lo.z, hi.z
                      (empty child slots carry a NaN box so every slab
                      test misses them — no is-valid flag needed; an
                      inverted box would NOT work, the slab min/max
                      normalizes it back into a valid one)
    cols 24 .. 27     child links (bitcast i32): >= 0 quad node index,
                      < 0 leaf ~(first | count << 24), SENT empty
    col  28           traversal-order hint (bitcast i32): the axis along
                      which the children are stored ascending by box
                      center; a packet visits slots forward when its
                      direction is positive on that axis, reversed
                      otherwise (the 4-wide analog of packet2's
                      split-axis hint)
    cols 29 .. 31     zero padding (future: bf16 packing / octant orders)

tri_woop / tri_index are re-emitted contiguously per (possibly merged)
leaf, so a leaf's rows are always consecutive.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpu_rt_torch.core.types import FlatBVH

SENT = np.int32(0x7FFFFFFF)
COUNT_SHIFT = 24
FIRST_MASK = (1 << COUNT_SHIFT) - 1
MAX_LEAF4 = 16


class QuadBVH(NamedTuple):
    nodes: np.ndarray      # [Q, 32] f32 (cols 24:29 bitcast i32)
    tri_woop: np.ndarray   # [R, 12] f32
    tri_index: np.ndarray  # [R] i32

    @property
    def num_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def num_refs(self) -> int:
        return int(self.tri_woop.shape[0])


def _subtree_ref_counts(links: np.ndarray) -> np.ndarray:
    """Total leaf refs below each binary node (children always have a
    higher row index than their parent — flatten_bvh DFS order)."""
    n = links.shape[0]
    sub = np.zeros(n, np.int64)
    for row in range(n - 1, -1, -1):
        total = 0
        for i in (0, 1):
            c = links[row, i]
            total += links[row, 2 + i] if c < 0 else sub[c]
        sub[row] = total
    return sub


def _collect_subtree_rows(links: np.ndarray, root: int,
                          tri_index: np.ndarray) -> np.ndarray:
    """All woop-row indices below binary node `root`, deduplicated by
    original triangle id (SBVH spatial splits duplicate a triangle into
    sibling leaves with IDENTICAL woop rows; a merged leaf needs one)."""
    rows: list[int] = []
    stack = [root]
    while stack:
        m = stack.pop()
        for i in (0, 1):
            c = links[m, i]
            if c < 0:
                first = ~c
                rows.extend(range(first, first + int(links[m, 2 + i])))
            else:
                stack.append(c)
    seen: set[int] = set()
    out = []
    for r in rows:
        t = int(tri_index[r])
        if t not in seen:
            seen.add(t)
            out.append(r)
    return np.asarray(out, np.int64)


def collapse4(flat: FlatBVH, leaf_max: int = MAX_LEAF4) -> QuadBVH:
    """Collapse a binary FlatBVH into a QuadBVH.

    Per pending node: start from the binary node's two children and
    greedily expand the largest-surface-area inner element until four
    children exist (the standard SAH-greedy MBVH collapse); a subtree
    whose deduplicated triangle count fits ``leaf_max`` becomes one wide
    leaf.  Children are stored ascending by box center along the widest
    child-center axis (the traversal-order hint).
    """
    nodes = np.asarray(flat.nodes, np.float32)
    links = np.ascontiguousarray(nodes[:, 12:16]).view(np.int32)
    woop = np.asarray(flat.tri_woop, np.float32)
    tri_index = np.asarray(flat.tri_index, np.int32)
    n_bin = nodes.shape[0]
    sub = _subtree_ref_counts(links)

    # Child bounds live in the parent row (Compact2 order -> per-child
    # lo.x,hi.x,lo.y,hi.y,lo.z,hi.z).
    b0 = nodes[:, [0, 1, 2, 3, 8, 9]]
    b1 = nodes[:, [4, 5, 6, 7, 10, 11]]

    new_woop: list[np.ndarray] = []
    new_tri: list[np.ndarray] = []
    new_count = 0

    def emit_leaf(rows: np.ndarray) -> int:
        """Append a leaf run; returns its encoded link."""
        nonlocal new_count
        first, count = new_count, rows.shape[0]
        new_woop.append(woop[rows])
        new_tri.append(tri_index[rows])
        new_count += count
        return int(~(first | (count << COUNT_SHIFT)))

    def make_element(bounds: np.ndarray, link: int, count: int):
        """(bounds, kind, payload): kind 'leaf' payload=encoded link,
        kind 'inner' payload=binary node id.  Applies leaf widening."""
        if link < 0:
            first = ~link
            rows = np.arange(first, first + count, dtype=np.int64)
            # Dedup within the original run too (harmless, usually id).
            _, keep = np.unique(tri_index[rows], return_index=True)
            return (bounds, "leaf", emit_leaf(rows[np.sort(keep)]))
        if sub[link] <= leaf_max:
            rows = _collect_subtree_rows(links, link, tri_index)
            if rows.shape[0] <= leaf_max:
                return (bounds, "leaf", emit_leaf(rows))
        return (bounds, "inner", int(link))

    def area(b: np.ndarray) -> float:
        dx = max(b[1] - b[0], 0.0)
        dy = max(b[3] - b[2], 0.0)
        dz = max(b[5] - b[4], 0.0)
        return float(dx * dy + dy * dz + dz * dx)

    def expand(bin_node: int) -> list:
        """Children elements of a quad node rooted at binary `bin_node`."""
        elems = [
            make_element(b0[bin_node], int(links[bin_node, 0]),
                         int(links[bin_node, 2])),
            make_element(b1[bin_node], int(links[bin_node, 1]),
                         int(links[bin_node, 3])),
        ]
        while len(elems) < 4:
            inner = [i for i, e in enumerate(elems) if e[1] == "inner"]
            if not inner:
                break
            i = max(inner, key=lambda i: area(elems[i][0]))
            m = elems.pop(i)[2]
            elems.append(make_element(b0[m], int(links[m, 0]),
                                      int(links[m, 2])))
            elems.append(make_element(b1[m], int(links[m, 1]),
                                      int(links[m, 3])))
        return elems

    # BFS over quad nodes.  pending[q] = binary node id whose expansion
    # becomes quad node q.
    qrows: list[np.ndarray] = []
    pending: list[int] = [0]
    emitted = 0
    while emitted < len(pending):
        bin_node = pending[emitted]
        q = emitted
        emitted += 1
        elems = expand(bin_node)

        # Order ascending by center along the widest child-center axis.
        centers = np.stack([
            np.array([(e[0][0] + e[0][1]), (e[0][2] + e[0][3]),
                      (e[0][4] + e[0][5])]) for e in elems])
        axis = int(np.argmax(centers.max(axis=0) - centers.min(axis=0)))
        order = np.argsort(centers[:, axis], kind="stable")
        elems = [elems[i] for i in order]

        row = np.zeros(32, np.float32)
        ilinks = np.full(4, SENT, np.int32)
        for j in range(4):
            if j < len(elems):
                bounds, kind, payload = elems[j]
                row[6 * j:6 * j + 6] = bounds
                if kind == "leaf":
                    ilinks[j] = payload
                else:
                    ilinks[j] = len(pending)
                    pending.append(payload)
            else:
                # Empty slot: NaN box.  An INVERTED box does not work —
                # the slab test min/max-sorts each axis pair, which
                # turns any inverted box back into a valid one; NaN
                # propagates through min/max and fails the far >= near
                # compare in both the kernel and the oracle.
                row[6 * j:6 * j + 6] = np.nan
        extra = np.zeros(4, np.int32)
        extra[0] = axis
        row[24:28] = ilinks.view(np.float32)
        row[28:32] = extra.view(np.float32)
        qrows.append(row)

    qnodes = np.stack(qrows).astype(np.float32)
    woop_out = (np.concatenate(new_woop) if new_woop
                else np.zeros((0, 12), np.float32))
    tri_out = (np.concatenate(new_tri) if new_tri
               else np.zeros(0, np.int32))
    return QuadBVH(nodes=qnodes, tri_woop=woop_out.astype(np.float32),
                   tri_index=tri_out.astype(np.int32))


OOEPS = np.float32(2.0 ** -80)


def trace_quad_scalar(quad: QuadBVH, origin, dirn, tmin, tmax,
                      any_hit: bool = False):
    """Scalar per-ray QuadBVH traversal (float32-exact, same per-triangle
    arithmetic as the binary oracle trace_flat_scalar).  Children are
    visited in the stored-order / reversed-by-direction-sign discipline
    the packet4 kernel uses (per-ray sign here; the kernel votes a
    per-packet mean sign, so exact-t ties and anyHit stop points can
    differ between the two — closest-hit t values cannot).

    Returns (hit_tri original ids, t, u, v).
    """
    nodes = np.asarray(quad.nodes, np.float32)
    ilinks = np.ascontiguousarray(nodes[:, 24:28]).view(np.int32)
    hints = np.ascontiguousarray(nodes[:, 28:29]).view(np.int32)[:, 0]
    woop = np.asarray(quad.tri_woop, np.float32)
    tri_index = np.asarray(quad.tri_index, np.int32)
    origin = np.asarray(origin, np.float32).reshape(-1, 3)
    dirn = np.asarray(dirn, np.float32).reshape(-1, 3)
    tmin = np.asarray(tmin, np.float32).reshape(-1)
    tmax = np.asarray(tmax, np.float32).reshape(-1)
    n_rays = origin.shape[0]

    hit_row = np.full(n_rays, -1, np.int64)
    hit_t = tmax.copy()
    hit_u = np.zeros(n_rays, np.float32)
    hit_v = np.zeros(n_rays, np.float32)
    f32 = np.float32

    for r in range(n_rays):
        if tmax[r] < 0 or nodes.shape[0] == 0:
            continue
        o = origin[r]
        d = dirn[r]
        idir = np.empty(3, f32)
        for k in range(3):
            dk = d[k]
            idir[k] = f32(1.0) / (dk if abs(dk) > OOEPS
                                  else np.copysign(OOEPS, dk))
        ood = (o * idir).astype(f32)
        t_min = tmin[r]
        stack: list[int] = []
        node = 0
        done = False
        while not done:
            if node != SENT and node >= 0:
                row = nodes[node]
                hint = int(hints[node])
                fwd = d[hint] >= 0
                order = range(4) if fwd else range(3, -1, -1)
                hit_children = []
                for j in order:
                    b = row[6 * j:6 * j + 6]
                    lo = (b[[0, 2, 4]] * idir - ood).astype(f32)
                    hi = (b[[1, 3, 5]] * idir - ood).astype(f32)
                    near = max(np.minimum(lo, hi).max(), t_min)
                    far = min(np.maximum(lo, hi).min(), hit_t[r])
                    if far >= near:
                        hit_children.append(int(ilinks[node, j]))
                # Leaves first in visit order (the kernel enqueues them
                # FIFO while inner children continue/stack).
                leaves = [c for c in hit_children if c < 0]
                inners = [c for c in hit_children if c >= 0]
                for c in leaves:
                    first = (~c) & FIRST_MASK
                    count = ((~c) >> COUNT_SHIFT) & 0xFF
                    for j in range(first, first + count):
                        w = woop[j]
                        Oz = f32(w[3] - o[0] * w[0] - o[1] * w[1]
                                 - o[2] * w[2])
                        Dz = f32(d[0] * w[0] + d[1] * w[1] + d[2] * w[2])
                        with np.errstate(divide="ignore", invalid="ignore",
                                         over="ignore"):
                            inv_dz = f32(1.0) / Dz
                            t = f32(Oz * inv_dz)
                        if t > t_min and t < hit_t[r]:
                            Ox = f32(w[7] + o[0] * w[4] + o[1] * w[5]
                                     + o[2] * w[6])
                            Dx = f32(d[0] * w[4] + d[1] * w[5] + d[2] * w[6])
                            u = f32(Ox + t * Dx)
                            if u >= 0.0:
                                Oy = f32(w[11] + o[0] * w[8] + o[1] * w[9]
                                         + o[2] * w[10])
                                Dy = f32(d[0] * w[8] + d[1] * w[9]
                                         + d[2] * w[10])
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
                if done:
                    break
                if inners:
                    node = inners[0]
                    stack.extend(reversed(inners[1:]))
                    continue
            if not stack:
                break
            node = stack.pop()

    hit_tri = np.where(
        hit_row >= 0,
        tri_index[np.clip(hit_row, 0, max(0, tri_index.shape[0] - 1))],
        -1).astype(np.int32)
    return hit_tri, hit_t, hit_u, hit_v


def validate_quad(quad: QuadBVH, num_scene_tris: int) -> None:
    """Structural invariants: links in range, every scene triangle
    reachable, leaf runs in bounds."""
    ilinks = np.ascontiguousarray(
        np.asarray(quad.nodes)[:, 24:28]).view(np.int32)
    q = quad.nodes.shape[0]
    m = quad.tri_woop.shape[0]
    covered = np.zeros(num_scene_tris, bool)
    for row in range(q):
        for j in range(4):
            c = int(ilinks[row, j])
            if c == SENT:
                continue
            if c >= 0:
                assert c < q, (row, j, c)
            else:
                first = (~c) & FIRST_MASK
                count = ((~c) >> COUNT_SHIFT) & 0xFF
                assert first + count <= m, (row, j, first, count)
                covered[np.asarray(quad.tri_index)[first:first + count]] = True
    assert covered.all() or num_scene_tris == 0, (
        f"{(~covered).sum()} triangles unreachable")
