"""Differentiable-path throughput: routing only, forward render and full
grad step in Mray/s, through the sharded path.

Counterpart of the JAX package's ``tools/bench_diff.py``.  The routing
trace runs on the routed kernel (``make_routing_tracer``); the
differentiable recompute and the shading are autograd ops.  Everything goes
through ``tpu_rt_torch.dist.sharding`` on ``make_ray_mesh(device)``: a
world of 1 without a process group, the default group's ranks when one is
initialized.

Rows reported:
- routing_s:   ``trace_sharded`` with the routed kernel (no diff work), the
               floor the diff path is measured against;
- forward_s:   ``render_diff_sharded`` (routing + recompute + shading);
- grad_step_s: ``grad_step_sharded`` (forward + backward + the three
               gradient / loss all-reduces);
- diff_overhead_s = forward - routing; backward_s = grad_step - forward;
- psum_bytes: the step's collective volume (vertex grads, material grads,
  loss).

Each time is the best of ``BD_REPEATS`` chains of ``BD_CHAIN`` calls, CUDA
events around each chain.  ``BD_PROFILE=<dir>`` writes a ``torch.profiler``
Chrome trace of one grad step there.  The row is appended to
``DIFF.jsonl`` under ``--out`` (default ``build/bench``); the newest row
wins for the same scene and width.

    python -m tpu_rt_torch.bench.bench_diff [scene] [width] [height] \\
        [--device cuda] [--cache-dir bvhcache] [--out build/bench]
Env: BD_REPEATS (3), BD_CHAIN (2), BD_PROFILE.  ``--device cpu`` runs the
plain versions on the host clock; that run only serves the tests.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from tpu_rt_torch.bench.bench import OUT_DIR, chain_times
from tpu_rt_torch.bench.bench_suite import DIFF_FILE, _setup_scene
from tpu_rt_torch.bench.tune_quad import device_name
from tpu_rt_torch.bench.workload import FRAME_H, FRAME_W, suite_camera
from tpu_rt_torch.dist.sharding import (grad_step_sharded, make_ray_mesh, render_diff_sharded,
                                        replicate_bvh, shard_rays, shard_rows, trace_sharded)
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.trace import make_routing_tracer, release_persisting_l2


def bench_diff(scene_name: str = "bunny", width: int = FRAME_W, height: int = FRAME_H,
               device="cuda", cache_dir: str | None = "bvhcache", repeats: int = 3,
               chain: int = 2, profile_dir: str | None = None) -> dict:
    """Routing, forward and grad-step times of the primary frame of
    ``scene_name`` on ``device``; returns the row."""
    device = torch.device(device)
    scene, flat = _setup_scene(scene_name, cache_dir)
    rays, _, _ = RayGen().primary(suite_camera(scene_name, scene), width, height, device=device)
    n = rays.num

    mesh = make_ray_mesh(device)
    routing, kind, tables = make_routing_tracer(flat, device=mesh.device, cache_dir=cache_dir)
    try:
        dflat = replicate_bvh(flat, mesh)
        srays = shard_rays(rays, mesh)
        vtx, tvi, mat = (torch.as_tensor(x, device=mesh.device)
                         for x in (scene.vtx_pos, scene.tri_vtx_index, scene.tri_material))
        target = shard_rows(torch.zeros((n, 3), dtype=torch.float32), mesh)

        def routing_only():
            return trace_sharded(dflat, srays, mesh, routing=routing, tables=tables)

        def fwd():
            return render_diff_sharded(mesh, dflat, srays, vtx, tvi, mat, routing=routing,
                                       tables=tables)

        def step():
            return grad_step_sharded(mesh, dflat, srays, vtx, tvi, mat, target,
                                     routing=routing, tables=tables)

        out = {"scene": scene_name, "rays": n, "routing": kind,
               "width": width, "height": height,
               "n_devices": mesh.size,
               "backend": device.type,
               "device": device_name(device),
               "psum_bytes": int(vtx.numel() * 4 + mat.numel() * 4 + 4)}
        for name, fn in (("routing", routing_only), ("forward", fwd), ("grad_step", step)):
            fn()
            fn()
            best = min(chain_times(fn, chain, repeats, device))
            out[f"{name}_s"] = best
            out[f"{name}_mrays"] = n / best / 1e6
            print(f"{name}: {best * 1e3:.4f} ms = {n / best / 1e6:.2f} Mray/s", flush=True)
        out["diff_overhead_s"] = out["forward_s"] - out["routing_s"]
        out["backward_s"] = out["grad_step_s"] - out["forward_s"]
        out["forward_vs_routing"] = out["routing_s"] / out["forward_s"]
        if profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                step()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            os.makedirs(profile_dir, exist_ok=True)
            trace = os.path.join(profile_dir, f"grad_step_{scene_name}_{width}x{height}.json")
            prof.export_chrome_trace(trace)
            out["profile_dir"] = profile_dir
            out["profile_trace"] = trace
    finally:
        if tables.residency == "mixed":
            release_persisting_l2()
    return out


def main(argv=None, env=None) -> dict:
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="bunny")
    ap.add_argument("width", nargs="?", type=int, default=FRAME_W)
    ap.add_argument("height", nargs="?", type=int, default=FRAME_H)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache-dir", default="bvhcache")
    ap.add_argument("--out", default=OUT_DIR, help=f"output directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    out = bench_diff(args.scene, args.width, args.height, args.device, args.cache_dir or None,
                     int(env.get("BD_REPEATS", 3)), int(env.get("BD_CHAIN", 2)),
                     env.get("BD_PROFILE") or None)
    print(json.dumps(out), flush=True)
    # One JSON line per (scene, width); the newest wins for the same key.
    path = os.path.join(args.out, DIFF_FILE)
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
    rows = [r for r in rows if not (r.get("scene") == args.scene
                                    and r.get("width") == args.width)]
    rows.append(out)
    os.makedirs(args.out, exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return out


if __name__ == "__main__":
    main()
