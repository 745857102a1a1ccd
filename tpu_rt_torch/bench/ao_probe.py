"""AO-batch kernel time under different ray schedules.

Counterpart of the JAX package's ``tools/ao_probe.py``:

    python -m tpu_rt_torch.bench.ao_probe [scene] [ray_type]

One 1-sample AO (or diffuse) batch of the 1024x768 ``Camera.for_bbox``
primary frame (radius 0.1 x the scene's extent; ``camera.far`` for
diffuse), traced by the binary kernel (``trace_flat`` on ``upload_flat``
tables at the port's residency) under each schedule:

  unsorted  - no sort at all (control)
  natural   - 192-bit Morton sort of all rays, degenerates included
  compact   - dead-last Morton sort (``sort_dead_last_device``); only the
              live prefix, padded to a multiple of ``tile``, is traced
  spread    - the dead-last order strided round-robin over the
              n // tile packets, so each holds the same live fraction
  uns-t<T>k<K> - unsorted, the slot forms (flat_trace_k<K>.cu): K rays a
              thread, blocks claiming T rays at once (T 512, 1024; K 4, 8)
  uns-c2    - unsorted, 2 leaf cursors (``cursors=2``, flat_trace_c.cu)
  cmp-t512k8 - compact, the slot forms at T 512, K 8
  cmp-c2    - compact, 2 leaf cursors

Per schedule: the hit count of one trace, one warm trace, then the best of
3 chains of 3 traces (CUDA events around each chain, ``bench.chain_times``),
printed as ms per trace, hits and live Mray/s.  ``tile`` is
``TPU_RT_TILE2`` from ``env`` (2,048, the port's ``LIVE_PAD``), so the
permutations and prefix lengths equal ``tpu_rt``'s.  ``main``'s
``device="cpu"`` and ``width`` / ``height`` serve the tests.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu_rt_torch.bench.bench import chain_times
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import morton_sort_device, permute_rays, sort_dead_last_device
from tpu_rt_torch.scene import Camera, Scene, procedural
from tpu_rt_torch.trace import trace_flat, upload_flat


def schedules(arays: Rays, live: int, tile: int) -> dict:
    """{name: (rays, trace_flat's keywords)} of the tool's schedules, in its
    order."""
    n = arays.num
    dl = permute_rays(arays, sort_dead_last_device(arays))
    m = min(n, -(-live // tile) * tile)
    compact = Rays(*(x[:m] for x in dl))
    # Uniform live spread: stride live rays round-robin over all packets
    # so every packet carries the same live fraction (max ~ mean).
    order = np.argsort(np.arange(n) % (n // tile), kind="stable")
    out = {
        "unsorted": (arays, {}),
        "natural": (permute_rays(arays, morton_sort_device(arays.origin, arays.dirn)), {}),
        "compact": (compact, {}),
        "spread": (permute_rays(dl, torch.as_tensor(order, device=arays.origin.device)), {}),
    }
    for t in (512, 1024):
        for k in (4, 8):
            out[f"uns-t{t}k{k}"] = (arays, {"tile": t, "k": k})
    out["uns-c2"] = (arays, {"cursors": 2})
    out["cmp-t512k8"] = (compact, {"tile": 512, "k": 8})
    out["cmp-c2"] = (compact, {"cursors": 2})
    return out


def main(argv=None, env=None, device="cuda", cache_dir: str | None = "bvhcache", *,
         width: int = 1024, height: int = 768) -> list[dict]:
    """The tool's run: prints its lines and returns one row per schedule."""
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="knob")
    ap.add_argument("ray_type", nargs="?", default="ao")
    args = ap.parse_args(argv)
    scene_name, ray_type = args.scene, args.ray_type
    tile = int(env.get("TPU_RT_TILE2", 2048))
    device = torch.device(device)

    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    lo, hi = scene.bbox()
    camera = Camera.for_bbox(lo, hi)
    rays, _, _ = RayGen().primary(camera, width, height, device=device)
    tables = upload_flat(flat, device)

    ph = trace_flat(tables, rays)
    extent = float(np.linalg.norm(hi - lo))
    max_dist = 0.1 * extent if ray_type == "ao" else float(camera.far)
    any_hit = ray_type == "ao"
    arays, _, _ = gen_ao_rays(rays.origin, rays.dirn, ph.t, ph.tri,
                              torch.as_tensor(scene.tri_normal, device=device), 1,
                              max_dist, 0)
    live = int((arays.tmax >= 0).sum())
    n = arays.num
    print(f"{scene_name} {ray_type}: {n} rays, {live} live "
          f"({live/n*100:.1f}%)", flush=True)

    out = []
    for name, (rr, kw) in schedules(arays, live, tile).items():
        def trace(rr=rr, kw=kw):
            return trace_flat(tables, rr, any_hit, **kw)

        hits = int((trace().tri >= 0).sum())
        trace()
        best = min(chain_times(trace, 3, 3, device))
        print(f"{name:11s}: {best*1e3:7.2f} ms  hits {hits}  "
              f"metric {live/best/1e6:6.2f} Mray/s", flush=True)
        out.append({"name": name, "rays": n, "live": live, "rays_traced": rr.num,
                    "cursors": kw.get("cursors", 1), "tile": kw.get("tile"), "k": kw.get("k"),
                    "best_s": best, "hits": hits, "mrays": live / best / 1e6})
    return out


if __name__ == "__main__":
    main()
