"""Difficulty calibration of the suite's stand-in scenes, from the oracle.

Counterpart of the JAX package's ``tools/calibrate.py``.  For every suite
row it runs the scalar oracle (``trace_flat_scalar`` with ``RayStats``) on
a stride sample of the row's exact ray batch and records:

- node / triangle tests per LIVE ray (the workload-difficulty analog of the
  reference's IST / TRV percentages, README.md:61-81: those are hardware
  occupancies, but tests per ray is the quantity that drives them),
- hit fraction and live fraction (the secondary metric's numerator),
- the AO radius the row uses (``suite_ao_radius``, "grt").

It runs on the host by nature (numpy oracle, raygen on the CPU) and
touches no card.  Output: ``CALIB.json`` under ``--out`` (default
``build/bench``), which ``bench_suite``'s table reads as its calib column.

    python -m tpu_rt_torch.bench.calibrate [n_sample] [scene:ray_type ...] \\
        [--out build/bench] [--cache-dir bvhcache]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpu_rt_torch.bench.bench import OUT_DIR
from tpu_rt_torch.bench.bench_suite import CALIB_FILE, ROWS, _setup_scene
from tpu_rt_torch.bench.workload import (FRAME_H, FRAME_W, scene_extent, suite_ao_radius,
                                         suite_camera)
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.trace.cpu_reference import RayStats, trace_flat_scalar


def calibrate_row(scene_name: str, ray_type: str, n_sample: int,
                  cache_dir: str | None = "bvhcache", ao_spec: str = "grt") -> dict:
    """The oracle's counts on ``n_sample`` stride-sampled rays of the row
    (for a secondary row, one secondary ray per sampled primary ray)."""
    scene, flat = _setup_scene(scene_name, cache_dir)
    camera = suite_camera(scene_name, scene)
    rays, _, _ = RayGen().primary(camera, FRAME_W, FRAME_H, device="cpu")
    n = rays.num
    stride = max(1, n // n_sample)
    sl = slice(0, stride * n_sample, stride)
    o, d, tmin, tmax = (x.numpy()[sl] for x in rays)

    stats = RayStats()
    tri, t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, stats=stats)
    ao_radius = None
    any_hit = False
    if ray_type != "primary":
        ao_radius = suite_ao_radius(scene_name, scene, ao_spec)
        max_dist = ao_radius if ray_type == "ao" else float(camera.far)
        any_hit = ray_type == "ao"
        arays, _, _ = gen_ao_rays(
            torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t),
            torch.as_tensor(tri.astype(np.int32)), torch.as_tensor(scene.tri_normal), 1,
            max_dist, 0)
        o, d, tmin, tmax = (x.numpy() for x in arays)
        stats = RayStats()
        tri, t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit, stats=stats)
    live_m = tmax >= 0
    live = int(live_m.sum())
    hits = int(np.sum(tri[live_m] >= 0))
    return {
        "scene": scene_name, "ray_type": ray_type,
        "sampled_rays": int(o.shape[0]), "live_frac": round(live / o.shape[0], 4),
        "hit_frac": round(hits / max(live, 1), 4),
        "node_tests_per_ray": round(
            float(stats.per_ray_node_tests[live_m].mean()) if live else 0.0, 1),
        "tri_tests_per_ray": round(
            float(stats.per_ray_tri_tests[live_m].mean()) if live else 0.0, 1),
        "ao_radius": round(ao_radius, 4) if ao_radius else None,
        "extent": round(scene_extent(scene), 3),
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="[n_sample (2048)] [scene:ray_type ...]")
    ap.add_argument("--out", default=OUT_DIR, help=f"output directory (default {OUT_DIR})")
    ap.add_argument("--cache-dir", default="bvhcache")
    opts = ap.parse_args(argv)
    plain = [a for a in opts.args if ":" not in a]
    n_sample = int(plain[0]) if plain else 2048
    rows = [tuple(a.split(":")) for a in opts.args if ":" in a] or ROWS
    os.makedirs(opts.out, exist_ok=True)
    path = os.path.join(opts.out, CALIB_FILE)
    out = []
    for scene_name, ray_type in rows:
        try:
            r = calibrate_row(scene_name, ray_type, n_sample, opts.cache_dir or None,
                              os.environ.get("BS_AO_RADIUS", "grt"))
            print(f"{scene_name:11s} {ray_type:8s} "
                  f"tests/ray {r['node_tests_per_ray']:7.1f}n "
                  f"{r['tri_tests_per_ray']:6.1f}t  hit {r['hit_frac']:.2f} "
                  f"live {r['live_frac']:.2f} ao_r={r['ao_radius']}", flush=True)
        except Exception as e:  # noqa: BLE001
            r = {"scene": scene_name, "ray_type": ray_type,
                 "error": f"{type(e).__name__}: {e}"}
            print(f"{scene_name} {ray_type} FAILED: {r['error'][:100]}", flush=True)
        out.append(r)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
