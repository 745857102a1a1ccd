"""Host simulation of packet traversal: the shared steps per packet size.

Counterpart of the JAX package's ``tools/packet_stats.py``:

    python -m tpu_rt_torch.bench.packet_stats [scene] [tile ...]

Reports, per packet size (tile): node visits, leaf visits and leaf-triangle
iterations of one packet whose rays share one traversal cursor (the serial
step counts of the TPU's packet kernel), and per-ray averages.  It drove
the TPU kernel's design (tile, leaf fusion, wide nodes); a later traversal
redesign reads it the same way.  ``simulate_packet`` is the tool's numpy
function, unchanged in its arithmetic (f32, ``ooeps`` 2^-80, leaf links
packed as ``first | count << 24`` by ``packed_links``).

Defaults: bunny; tiles 1024, 2048, 4096; ``PS_MAX_PACKETS`` (64) packets
sampled evenly over the 1024x768 ``Camera.for_bbox`` primary frame.  The
rays come from the port's ``RayGen().primary`` on ``device`` and are copied
to the host; everything after that is host numpy.  ``main``'s
``device="cpu"`` and ``width`` / ``height`` serve the tests.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.scene import Camera, Scene, procedural


def simulate_packet(nodes, links, woop, o, d, tmin, tmax):
    """One packet's shared traversal; returns (node_visits, leaf_visits,
    leaf_tri_steps). Mirrors _packet_kernel's semantics (closest hit)."""
    ooeps = np.float32(2.0**-80)

    def rcp(x):
        safe = np.where(np.abs(x) > ooeps, x, np.where(x >= 0, ooeps, -ooeps))
        return np.float32(1.0) / safe

    idir = rcp(d)
    ood = o * idir
    hit_t = tmax.copy()
    valid = tmax >= 0

    stack: list[int] = []
    node = 0 if valid.any() else None
    nv = lv = lts = 0
    while node is not None:
        if node >= 0:
            nv += 1
            row = nodes[node]
            lnk = links[node]

            def span(lox, hix, loy, hiy, loz, hiz):
                tx0 = lox * idir[:, 0] - ood[:, 0]
                tx1 = hix * idir[:, 0] - ood[:, 0]
                ty0 = loy * idir[:, 1] - ood[:, 1]
                ty1 = hiy * idir[:, 1] - ood[:, 1]
                tz0 = loz * idir[:, 2] - ood[:, 2]
                tz1 = hiz * idir[:, 2] - ood[:, 2]
                near = np.maximum(
                    np.maximum(np.minimum(tx0, tx1), np.minimum(ty0, ty1)),
                    np.maximum(np.minimum(tz0, tz1), tmin),
                )
                far = np.minimum(
                    np.minimum(np.maximum(tx0, tx1), np.maximum(ty0, ty1)),
                    np.minimum(np.maximum(tz0, tz1), hit_t),
                )
                return near, far

            n0, f0 = span(row[0], row[1], row[2], row[3], row[8], row[9])
            n1, f1 = span(row[4], row[5], row[6], row[7], row[10], row[11])
            m0 = (f0 >= n0) & valid
            m1 = (f1 >= n1) & valid
            big = np.float32(3e38)
            near0 = np.where(m0, n0, big).min()
            near1 = np.where(m1, n1, big).min()
            any0, any1 = near0 < big, near1 < big
            first, second = lnk[0], lnk[1]
            if any0 and any1:
                if near1 < near0:
                    first, second = second, first
                stack.append(second)
                node = first
            elif any0:
                node = lnk[0]
            elif any1:
                node = lnk[1]
            else:
                node = stack.pop() if stack else None
        else:
            lv += 1
            enc = ~node
            first = enc & ((1 << 24) - 1)
            count = (enc >> 24) & 0xFF
            lts += count
            for j in range(first, first + count):
                w = woop[j]
                oz_t = w[3] - o[:, 0] * w[0] - o[:, 1] * w[1] - o[:, 2] * w[2]
                dz_t = d[:, 0] * w[0] + d[:, 1] * w[1] + d[:, 2] * w[2]
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = oz_t / dz_t
                    u = (w[7] + o[:, 0] * w[4] + o[:, 1] * w[5] + o[:, 2] * w[6]) + t * (
                        d[:, 0] * w[4] + d[:, 1] * w[5] + d[:, 2] * w[6]
                    )
                    v = (w[11] + o[:, 0] * w[8] + o[:, 1] * w[9] + o[:, 2] * w[10]) + t * (
                        d[:, 0] * w[8] + d[:, 1] * w[9] + d[:, 2] * w[10]
                    )
                ok = valid & (t > tmin) & (t < hit_t) & (u >= 0) & (v >= 0) & (u + v <= 1)
                hit_t = np.where(ok, t, hit_t)
            node = stack.pop() if stack else None
    return nv, lv, lts


def packed_links(flat) -> np.ndarray:
    """The FlatBVH's link columns [N, 4] int32 with each leaf child packed
    as ~(first | count << 24), the count from ``leaf_counts``."""
    links = np.ascontiguousarray(np.asarray(flat.nodes)[:, 12:16]).view(np.int32).copy()
    counts_tab = np.asarray(flat.leaf_counts)
    for c in range(2):
        leaf = links[:, c] < 0
        first = ~links[leaf, c]
        links[leaf, c] = ~(first | (counts_tab[first].astype(np.int64)
                                    << 24)).astype(np.int64).astype(np.int32)
    return links


def main(argv=None, env=None, device="cuda", cache_dir: str | None = "bvhcache", *,
         width: int = 1024, height: int = 768) -> list[dict]:
    """The tool's run: prints its lines and returns one row per tile."""
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="bunny")
    ap.add_argument("tiles", nargs="*", type=int, help="packet sizes (default 1024 2048 4096)")
    args = ap.parse_args(argv)
    scene_name, tiles = args.scene, args.tiles or [1024, 2048, 4096]

    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    lo, hi = scene.bbox()
    rays, _, _ = RayGen().primary(Camera.for_bbox(lo, hi), width, height, device=device)
    o, d, tmin, tmax = (x.cpu().numpy() for x in rays)

    rows = np.asarray(flat.nodes)
    n_nodes = rows.shape[0]
    links = packed_links(flat)
    woop = np.asarray(flat.tri_woop)

    n = o.shape[0]
    leaf_hist = np.bincount(
        np.asarray(flat.leaf_counts)[np.asarray(flat.leaf_counts) > 0], minlength=9
    )
    print(f"{scene_name}: {n} rays, {n_nodes} nodes, {woop.shape[0]} refs; "
          f"leaf-count histogram (1..8): {leaf_hist[1:9].tolist()}", flush=True)

    max_packets = int(env.get("PS_MAX_PACKETS", 64))
    out = []
    for tile in tiles:
        num = n // tile
        sel = np.linspace(0, num - 1, min(num, max_packets)).astype(int)
        NV = LV = LTS = 0
        for p in sel:
            s = slice(p * tile, (p + 1) * tile)
            nv, lv, lts = simulate_packet(rows, links, woop, o[s], d[s], tmin[s], tmax[s])
            NV += nv
            LV += lv
            LTS += lts
        k = len(sel)
        print(
            f"TILE={tile}: node_visits/packet {NV/k:.0f}, leaf_visits {LV/k:.0f}, "
            f"leaf_tri_steps {LTS/k:.0f}, total_serial {(NV+LTS)/k:.0f} "
            f"(fused-leaf {(NV+LV)/k:.0f}); per-ray node tests {NV*tile/k/tile:.2f}"
            f" -> steps/ray now {(NV+LTS)/k/tile:.3f}, fused {(NV+LV)/k/tile:.3f}", flush=True
        )
        out.append({"scene": scene_name, "tile": tile, "rays": n, "packets": k,
                    "node_visits": NV / k, "leaf_visits": LV / k, "leaf_tri_steps": LTS / k,
                    "total_serial": (NV + LTS) / k, "fused_leaf": (NV + LV) / k,
                    "steps_per_ray": (NV + LTS) / k / tile, "fused_per_ray": (NV + LV) / k / tile})
    return out


if __name__ == "__main__":
    main()
