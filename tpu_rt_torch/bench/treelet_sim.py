"""Step-count simulator for two-phase (treelet re-binning) traversal.

Counterpart of the JAX package's ``tools/treelet_sim.py``:

    python -m tpu_rt_torch.bench.treelet_sim [scene] [ray_type] [T ...]

A packet kernel's cost is proportional to its SHARED steps (node visits +
leaf-triangle iterations) summed over packets: each step issues work for
the whole packet however few rays need it.  The two-phase scheme:

  Phase A: shared-cursor traversal restricted to a top TREELET (the T
    nodes with the largest subtrees, grown from the root).  Children
    outside the treelet are PORTALS: per-ray slab hits are recorded as
    (ray, portal) pairs instead of being pushed.  Treelet-level leaves are
    tested inline.
  Binning: pairs grouped by portal.
  Phase B: per portal, packets of up to TILE rays (Morton order kept)
    traverse the subtree rooted at the portal, with phase A's hit_t as
    tmax.

Per scene x ray type it prints steps per ray for single-phase against
two-phase at each treelet size, pair counts, portal-slot overflow at P_MAX
and phase B packet fill.  ``subtree_sizes``, ``build_cut``, ``Stepper`` and
``leaf_encode_links`` are the tool's numpy code, unchanged.

Environment (``env``): TS_TILE (2048), TS_MAX_PACKETS (48), TS_PMAX (8),
TS_WH (1024x768).  ``gen_rays`` makes the rays on ``device``: for
secondary rays the primary pre-trace runs the binary CUDA kernel
(``trace_flat``) on the card, as ``tpu_rt`` runs ``trace_packet2`` on its
accelerator, and the port's wavefront on the CPU, as ``tpu_rt`` does off
the TPU; then ``gen_ao_rays`` (radius 0.1 x the scene's extent for AO,
``camera.far`` for diffuse) and the 192-bit Morton sort on the device.
Everything after that is host numpy.  ``device="cpu"`` serves the tests.
"""

from __future__ import annotations

import argparse
import heapq
import os
from collections import defaultdict

import numpy as np
import torch

from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import morton_sort_device, permute_rays
from tpu_rt_torch.scene import Camera, Scene, procedural
from tpu_rt_torch.trace import device_bvh, trace_flat, trace_wavefront, upload_flat


def subtree_sizes(links: np.ndarray) -> np.ndarray:
    """Inner-node subtree node counts; children always have higher row
    indices than parents (flatten_bvh allocates on push)."""
    n = links.shape[0]
    size = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        for c in (links[i, 0], links[i, 1]):
            if c >= 0:
                size[i] += size[c]
    return size


def build_cut(links: np.ndarray, T: int):
    """Greedy treelet: grow from the root, always expanding the member
    candidate with the largest subtree, until T nodes.  Returns
    (in_treelet bool[N], portals list of node ids)."""
    n = links.shape[0]
    size = subtree_sizes(links)
    in_t = np.zeros(n, bool)
    heap = [(-size[0], 0)]
    members = 0
    while heap and members < T:
        _, node = heapq.heappop(heap)
        in_t[node] = True
        members += 1
        for c in (links[node, 0], links[node, 1]):
            if c >= 0:
                heapq.heappush(heap, (-size[c], c))
    portals = [node for _, node in heap]
    return in_t, portals


OOEPS = np.float32(2.0**-80)


def _rcp(x):
    safe = np.where(np.abs(x) > OOEPS, x, np.where(x >= 0, OOEPS, -OOEPS))
    return np.float32(1.0) / safe


class Stepper:
    """Shared-cursor packet traversal with optional treelet restriction.

    Counts node visits, leaf visits, leaf-tri steps, portal visits.
    Mirrors packet2's semantics: closest hit unless any_hit; padding via
    tmax<0; deferred leaves don't tighten hit_t ordering (conservative).
    """

    def __init__(self, rows, links, woop, in_treelet=None):
        self.rows, self.links, self.woop = rows, links, woop
        self.in_t = in_treelet

    def run(self, o, d, tmin, tmax, start=0, any_hit=False, hit_t0=None,
            hit_tri0=None):
        idir = _rcp(d)
        ood = o * idir
        hit_t = tmax.copy() if hit_t0 is None else hit_t0.copy()
        hit_tri = (np.full(o.shape[0], -1, np.int64) if hit_tri0 is None
                   else hit_tri0.copy())
        valid = tmax >= 0
        nv = lv = lts = pv = 0
        pairs = []  # (ray_local_idx array, portal node id)
        if not valid.any():
            return hit_t, hit_tri, (nv, lv, lts, pv), pairs
        stack = [start]
        while stack:
            if any_hit and not ((hit_tri < 0) & valid).any():
                break
            node = stack.pop()
            if node >= 0:
                nv += 1
                row, lnk = self.rows[node], self.links[node]

                def span(lox, hix, loy, hiy, loz, hiz):
                    tx0 = lox * idir[:, 0] - ood[:, 0]
                    tx1 = hix * idir[:, 0] - ood[:, 0]
                    ty0 = loy * idir[:, 1] - ood[:, 1]
                    ty1 = hiy * idir[:, 1] - ood[:, 1]
                    tz0 = loz * idir[:, 2] - ood[:, 2]
                    tz1 = hiz * idir[:, 2] - ood[:, 2]
                    near = np.maximum(
                        np.maximum(np.minimum(tx0, tx1), np.minimum(ty0, ty1)),
                        np.maximum(np.minimum(tz0, tz1), tmin))
                    far = np.minimum(
                        np.minimum(np.maximum(tx0, tx1), np.maximum(ty0, ty1)),
                        np.minimum(np.maximum(tz0, tz1), hit_t))
                    return near, far

                n0, f0 = span(row[0], row[1], row[2], row[3], row[8], row[9])
                n1, f1 = span(row[4], row[5], row[6], row[7], row[10], row[11])
                m0 = (f0 >= n0) & valid
                if any_hit:
                    m0 &= hit_tri < 0
                m1 = (f1 >= n1) & valid
                if any_hit:
                    m1 &= hit_tri < 0
                kids = []
                for ci, m in ((0, m0), (1, m1)):
                    if not m.any():
                        continue
                    c = lnk[ci]
                    if c >= 0 and self.in_t is not None and not self.in_t[c]:
                        pv += 1
                        pairs.append((np.nonzero(m)[0], c))
                    else:
                        kids.append((c if c >= 0
                                     else ~((~c) | (lnk[2 + ci] << 32)), m))
                # near-first by packet vote (min near distance)
                if len(kids) == 2:
                    big = np.float32(3e38)
                    if (np.where(m1, n1, big).min()
                            < np.where(m0, n0, big).min()):
                        kids.reverse()
                    stack.append(kids[1][0])
                    stack.append(kids[0][0])
                elif kids:
                    stack.append(kids[0][0])
            else:
                lv += 1
                enc = ~node
                first = enc & 0xFFFFFFFF
                count = enc >> 32
                lts += count
                for j in range(first, first + count):
                    w = self.woop[j]
                    oz_t = (w[3] - o[:, 0] * w[0] - o[:, 1] * w[1]
                            - o[:, 2] * w[2])
                    dz_t = d[:, 0] * w[0] + d[:, 1] * w[1] + d[:, 2] * w[2]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        t = oz_t / dz_t
                        u = ((w[7] + o[:, 0] * w[4] + o[:, 1] * w[5]
                              + o[:, 2] * w[6])
                             + t * (d[:, 0] * w[4] + d[:, 1] * w[5]
                                    + d[:, 2] * w[6]))
                        v = ((w[11] + o[:, 0] * w[8] + o[:, 1] * w[9]
                              + o[:, 2] * w[10])
                             + t * (d[:, 0] * w[8] + d[:, 1] * w[9]
                                    + d[:, 2] * w[10]))
                    ok = (valid & (t > tmin) & (t < hit_t) & (u >= 0)
                          & (v >= 0) & (u + v <= 1))
                    if any_hit:
                        ok &= hit_tri < 0
                    hit_t = np.where(ok, t, hit_t)
                    hit_tri = np.where(ok, j, hit_tri)
        return hit_t, hit_tri, (nv, lv, lts, pv), pairs


def leaf_encode_links(flat):
    """links with 64-bit-safe leaf encoding used by Stepper: inner = idx,
    leaf child stored as ~(first | count<<32)."""
    nodes = np.asarray(flat.nodes)
    raw = np.ascontiguousarray(nodes[:, 12:16]).view(np.int32).astype(np.int64)
    return raw


def gen_rays(scene_name, ray_type, width, height, samples=1, device="cuda",
             cache_dir: str | None = "bvhcache"):
    """(flat, o, d, tmin, tmax, any_hit): the scene's FlatBVH and its rays
    of ``ray_type`` as host arrays, secondary rays in 192-bit Morton order."""
    device = torch.device(device)
    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    lo, hi = scene.bbox()
    camera = Camera.for_bbox(lo, hi)
    rays, _, _ = RayGen().primary(camera, width, height, device=device)
    any_hit = False
    if ray_type != "primary":
        if device.type == "cuda":
            ph = trace_flat(upload_flat(flat, device), rays)
        else:
            ph = trace_wavefront(device_bvh(flat, device), rays)
        extent = float(np.linalg.norm(hi - lo))
        ao_radius = 0.1 * extent
        max_dist = ao_radius if ray_type == "ao" else float(camera.far)
        rays, _, _ = gen_ao_rays(rays.origin, rays.dirn, ph.t, ph.tri,
                                 torch.as_tensor(scene.tri_normal, device=device), samples,
                                 max_dist, 0)
        rays = permute_rays(rays, morton_sort_device(rays.origin, rays.dirn))
        any_hit = ray_type == "ao"
    o, d, tmin, tmax = (x.cpu().numpy() for x in rays)
    return flat, o, d, tmin, tmax, any_hit


def main(argv=None, env=None, device="cuda", cache_dir: str | None = "bvhcache") -> list[dict]:
    """The tool's run: prints its lines and returns the single-phase row,
    then one row per treelet size."""
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="bunny")
    ap.add_argument("ray_type", nargs="?", default="primary")
    ap.add_argument("Ts", nargs="*", type=int, help="treelet sizes (default 256 512 1024 2048)")
    args = ap.parse_args(argv)
    scene_name, ray_type = args.scene, args.ray_type
    Ts = args.Ts or [256, 512, 1024, 2048]
    tile = int(env.get("TS_TILE", 2048))
    max_packets = int(env.get("TS_MAX_PACKETS", 48))
    pmax = int(env.get("TS_PMAX", 8))
    width, height = (int(x) for x in env.get("TS_WH", "1024x768").split("x"))

    flat, o, d, tmin, tmax, any_hit = gen_rays(scene_name, ray_type, width, height,
                                               device=device, cache_dir=cache_dir)
    rows = np.asarray(flat.nodes)
    links = leaf_encode_links(flat)
    woop = np.asarray(flat.tri_woop)
    n = o.shape[0]
    n_nodes = rows.shape[0]

    num = n // tile
    sel = np.linspace(0, num - 1, min(num, max_packets)).astype(int)
    print(f"{scene_name} {ray_type}: {n} rays, {n_nodes} nodes, "
          f"{woop.shape[0]} refs, tile={tile}, sampling {len(sel)} packets, "
          f"any_hit={any_hit}", flush=True)

    # ---- single-phase baseline ----
    base = Stepper(rows, links, woop)
    tot = np.zeros(4, np.int64)
    for p in sel:
        s = slice(p * tile, (p + 1) * tile)
        _, _, cnt, _ = base.run(o[s], d[s], tmin[s], tmax[s], any_hit=any_hit)
        tot += cnt
    k = len(sel)
    base_steps = (tot[0] + tot[2]) / k
    print(f"single-phase: node {tot[0]/k:.0f} leafvisit {tot[1]/k:.0f} "
          f"tristeps {tot[2]/k:.0f} -> steps/packet {base_steps:.0f} "
          f"(per-ray {base_steps/tile:.3f}, tput ∝ {tile/base_steps:.2f})", flush=True)
    out = [{"scene": scene_name, "ray_type": ray_type, "T": None, "rays": n, "tile": tile,
            "packets": k, "node": tot[0] / k, "leaf_visits": tot[1] / k, "tri": tot[2] / k,
            "steps_per_packet": base_steps, "steps_per_ray": base_steps / tile}]

    for T in Ts:
        in_t, portals = build_cut(links, T)
        stepA = Stepper(rows, links, woop, in_treelet=in_t)
        # phase A over the sampled packets; pairs pooled globally
        a_tot = np.zeros(4, np.int64)
        pool = defaultdict(list)  # portal -> list of (global ray idx)
        hit_t_all = np.full(n, np.nan, np.float32)
        hit_tri_all = np.full(n, -2, np.int64)
        slot_hist = np.zeros(64, np.int64)
        for p in sel:
            s = slice(p * tile, (p + 1) * tile)
            ht, htri, cnt, pairs = stepA.run(o[s], d[s], tmin[s], tmax[s],
                                             any_hit=any_hit)
            a_tot += cnt
            hit_t_all[s] = ht
            hit_tri_all[s] = htri
            cnts = np.zeros(tile, np.int64)
            for ridx, portal in pairs:
                g = ridx + p * tile
                if any_hit:
                    g = g[htri[ridx] < 0]  # decided rays drop their pairs
                pool[portal].append(g)
                cnts[ridx] += 1
            slot_hist += np.bincount(np.minimum(cnts, 63), minlength=64)

        # ---- binning + phase B ----
        b_tot = np.zeros(4, np.int64)
        b_packets = 0
        fill = []
        stepB = Stepper(rows, links, woop)
        total_pairs = 0
        for portal, lists in pool.items():
            g = np.concatenate(lists)
            g.sort()
            total_pairs += g.shape[0]
            for c0 in range(0, g.shape[0], tile):
                idx = g[c0:c0 + tile]
                fill.append(idx.shape[0] / tile)
                _, _, cnt, _ = stepB.run(
                    o[idx], d[idx], tmin[idx], tmax[idx], start=portal,
                    any_hit=any_hit, hit_t0=hit_t_all[idx],
                    hit_tri0=np.full(idx.shape[0], -1, np.int64))
                b_tot += cnt
                b_packets += 1

        # Per-sampled-ray accounting: phase A steps amortize over k
        # packets; phase B steps amortize over ALL sampled rays (pairs
        # pooled).  tput metric = sampled rays / total steps.
        rays_sampled = k * tile
        a_steps = a_tot[0] + a_tot[2] + a_tot[3]  # portal visit ~ node cost
        b_steps = b_tot[0] + b_tot[2]
        steps_per_ray = (a_steps + b_steps) / rays_sampled
        over = slot_hist[pmax + 1:].sum() / rays_sampled
        print(f"T={T}: portals={len(portals)} "
              f"A/packet: node {a_tot[0]/k:.0f} tri {a_tot[2]/k:.0f} "
              f"portal {a_tot[3]/k:.0f} | pairs/ray {total_pairs/rays_sampled:.2f} "
              f"overflow>P{pmax} {over*100:.2f}% | "
              f"B: packets {b_packets} fill {np.mean(fill):.2f} "
              f"steps/pkt {(b_steps/max(b_packets,1)):.0f} | "
              f"TOTAL steps/ray {steps_per_ray:.3f} "
              f"(vs single {base_steps/tile:.3f}, "
              f"win {base_steps/tile/steps_per_ray:.2f}x)", flush=True)
        out.append({"scene": scene_name, "ray_type": ray_type, "T": T, "rays": n, "tile": tile,
                    "packets": k, "portals": len(portals), "a_node": a_tot[0] / k,
                    "a_tri": a_tot[2] / k, "a_portal": a_tot[3] / k,
                    "pairs_per_ray": total_pairs / rays_sampled, "overflow": over,
                    "b_packets": b_packets, "b_fill": float(np.mean(fill)),
                    "b_steps_per_packet": b_steps / max(b_packets, 1),
                    "steps_per_ray": steps_per_ray,
                    "win": base_steps / tile / steps_per_ray})
    return out


if __name__ == "__main__":
    main()
