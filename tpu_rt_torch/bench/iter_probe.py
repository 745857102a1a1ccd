"""Kernel iteration census per scene x ray type: the per-warp cost model's
ground truth and the knob-secondary diagnosis.

Counterpart of the JAX package's ``tools/iter_probe.py``:

    python -m tpu_rt_torch.bench.iter_probe [scene] [raytype ...] [--subsets]

For each requested ray type the probe runs the suite's schedule (the suite
camera at ``FRAME_W`` x ``FRAME_H``, the suite AO radius, the secondary
batch Morton-sorted) through the binary kernel on
``choose_node_format(flat, TABLE_BUDGET)`` tables, and prints the census
and the wall time of one ``with_stats`` trace.  Each secondary type also
runs a direction-octant-major order (``-diroct``).  With ``--subsets``
(knob-class scenes: the last 2 triangles are the ground plane) it also
traces the batch split by the surface its primary ray hit (``-plane``,
``-blob``), each subset padded with dead rays to ``tpu_rt``'s ``TILE * K``
rays and Morton-sorted, to localise union pathologies.

Known differences from the JAX tool:

- ``groups`` are 32-ray warps and ``iters`` a warp's largest per-ray
  ``node_tests + tri_tests`` (``trace.common.warp_work``, the kernel's
  ``with_stats`` counters), where ``tpu_rt`` counts while-loop iterations
  per Pallas grid step (``count_iters``).  The two are not comparable.
- ``wall`` is one stats trace between CUDA events (``bench.chain_times``),
  after one untimed trace whose counters give the census; ``tpu_rt``
  times one trace with the host clock and a ``jnp.sum`` fence.

Default: knob, primary ao diffuse.  ``main``'s ``device="cpu"`` and
``width`` / ``height`` serve the tests.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_rt_torch.bench.bench import chain_times
from tpu_rt_torch.bench.bench_suite import census
from tpu_rt_torch.bench.workload import FRAME_H, FRAME_W, suite_ao_radius, suite_camera
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import (_stable_lex_order, morton_sort_device, permute_rays,
                                      ray_morton_keys_device)
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import TABLE_BUDGET, choose_node_format, trace_flat, upload_flat
from tpu_rt_torch.trace.common import warp_work

# tpu_rt's packet kernel tile and interleave (tpu_rt/trace/packet2.py:66,
# :70, their defaults): a subset is padded to TILE * K rays, so the subset
# batches hold the same rays as tpu_rt's.
TILE, K = 2048, 2


take = permute_rays    # the tool's name for it


def sort_dir_octant(rays: Rays) -> torch.Tensor:
    """Direction-octant-major sort: the dead flag, then the 3 sign bits of
    the direction, then the standard 192-bit Morton key (stable): packets
    share a traversal order AND a rough direction, shrinking
    divergent-hemisphere unions."""
    keys = ray_morton_keys_device(rays.origin, rays.dirn)
    d = rays.dirn
    oct_ = ((d[:, 0] >= 0).long() | ((d[:, 1] >= 0).long() << 1)
            | ((d[:, 2] >= 0).long() << 2))
    dead = (rays.tmax < 0).long()
    return _stable_lex_order([dead, oct_] + [keys[:, 5 - k] for k in range(6)])


def pad_to_block(rays: Rays, block: int) -> Rays:
    """``rays`` padded with dead rays (origin 0, direction (1, 1, 1), tmin
    0, tmax -1) to a multiple of ``block``."""
    n = rays.num
    m = -(-n // block) * block
    if m == n:
        return rays
    p = m - n

    def pad(x, fill):
        return torch.cat([x, torch.full((p,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])

    return Rays(origin=pad(rays.origin, 0.0), dirn=pad(rays.dirn, 1.0),
                tmin=pad(rays.tmin, 0.0), tmax=pad(rays.tmax, -1.0))


def probe(name, tables, rays: Rays, any_hit: bool) -> tuple:
    """One stats trace of the binary kernel for the census, then one timed;
    prints the tool's line and returns (hits, row)."""
    hits, stats = trace_flat(tables, rays, any_hit, with_stats=True)
    device = rays.origin.device
    dt = chain_times(lambda: trace_flat(tables, rays, any_hit, with_stats=True), 1, 1,
                     device)[0]
    groups, total = census(stats)
    it = warp_work(stats).cpu().numpy()
    n = rays.num
    live = int((rays.tmax >= 0).sum())
    mean, p90, mx = float(it.mean()), float(np.percentile(it, 90)), int(it.max())
    print(f"{name:16s}: rays {n:7d} live {live:7d} groups {groups:4d} "
          f"iters total {total:8d} mean {mean:7.1f} "
          f"p90 {p90:7.0f} max {mx:7d} "
          f"wall {dt*1e3:7.2f} ms  {dt/max(total,1)*1e6:5.2f} us/iter "
          f"{total/max(live,1)*1e3:7.1f} iters/kray",
          flush=True)
    return hits, {"name": name, "rays": n, "live": live, "groups": groups, "iters": total,
                  "mean": mean, "p90": p90, "max": mx, "wall_s": dt,
                  "us_per_iter": dt / max(total, 1) * 1e6,
                  "iters_per_kray": total / max(live, 1) * 1e3}


def main(argv=None, env=None, device="cuda", cache_dir: str | None = "bvhcache", *,
         width: int = FRAME_W, height: int = FRAME_H) -> list[dict]:
    """The tool's run: prints one line per probe and returns their rows.
    The tool reads no environment setting; ``env`` is taken for the
    tools' common signature."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="knob")
    ap.add_argument("ray_types", nargs="*", help="default: primary ao diffuse")
    ap.add_argument("--subsets", action="store_true")
    args = ap.parse_args(argv)
    scene_name = args.scene
    ray_types = args.ray_types or ["primary", "ao", "diffuse"]
    device = torch.device(device)

    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    camera = suite_camera(scene_name, scene)
    rays, _, _ = RayGen().primary(camera, width, height, device=device)
    res, bf16 = choose_node_format(flat, TABLE_BUDGET)
    tables = upload_flat(flat, device, residency=res, bf16_nodes=bf16)

    out = []
    ph = None
    for rt in ray_types:
        if rt == "primary":
            ph, row = probe("primary", tables, rays, False)
            out.append(row)
            continue
        if ph is None:
            ph = trace_flat(tables, rays)
        max_dist = (suite_ao_radius(scene_name, scene)
                    if rt == "ao" else float(camera.far))
        any_hit = rt == "ao"
        arays, _, _ = gen_ao_rays(rays.origin, rays.dirn, ph.t, ph.tri,
                                  torch.as_tensor(scene.tri_normal, device=device), 1,
                                  max_dist, 0)
        srt = take(arays, morton_sort_device(arays.origin, arays.dirn))
        out.append(probe(f"{rt}-suite", tables, srt, any_hit)[1])
        octs = take(arays, sort_dir_octant(arays))
        out.append(probe(f"{rt}-diroct", tables, octs, any_hit)[1])

        if args.subsets:
            # Split by primary-hit surface: ground plane = the last 2
            # triangles of the knob-class blob mesh.
            n_tris = int(np.asarray(flat.tri_index).max()) + 1
            on_plane = ph.tri >= n_tris - 2
            live_m = arays.tmax >= 0
            for label, m in (("plane", on_plane & live_m),
                             ("blob", (~on_plane) & live_m)):
                idx = torch.nonzero(m).flatten()
                if idx.numel() == 0:
                    continue
                sub = take(arays, idx)
                sub = pad_to_block(sub, TILE * K)
                sub = take(sub, morton_sort_device(sub.origin, sub.dirn))
                out.append(probe(f"{rt}-{label}", tables, sub, any_hit)[1])
    return out


if __name__ == "__main__":
    main()
