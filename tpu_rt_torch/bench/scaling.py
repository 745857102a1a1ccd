"""Rays/s scaling from one rank to every rank, with the collective audit.

Counterpart of ``scaling_main`` in the JAX package's ``bench.py``
(``BENCH_MODE=scaling``); it prints one JSON line with the same keys.  Run
one process per rank:

    torchrun --nproc_per_node=N -m tpu_rt_torch.bench.scaling [--scene bunny]
        [--width 640 --height 480 --tracer auto --repeats 5 --warmup 2]

Every rank traces with the port's routing tracer on its device.  Where
there are at least as many cards as ranks, the ranks join over NCCL, one
card each.  Otherwise they join over gloo and share the cards, and the
metric's name says so (``_SHARED_CARD``): such a run measures processes
sharing a card, not scaling.  ``--device cpu`` runs every rank on the CPU
over gloo.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.dist import collective_audit, init_multihost, measure_scaling
from tpu_rt_torch.dist.sharding import make_ray_mesh, shard_rays, shard_rows
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.scene import Camera, Scene, procedural
from tpu_rt_torch.trace import make_routing_tracer


def scaling_main(argv=None) -> dict:
    """Strong and weak scaling of the primary frame of ``--scene`` over the
    ranks of the default group, and the collective audit of one sharded
    trace and grad step.  Rank 0 prints the JSON line; every rank returns
    the result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="bunny")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--tracer", default="auto")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--cache-dir", default="bvhcache")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    shared = args.device == "cuda" and ranks > cards
    backend = "nccl" if args.device == "cuda" and not shared else "gloo"
    init_multihost(backend=backend)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda", local % cards) if args.device == "cuda" else torch.device("cpu")
    mesh = make_ray_mesh(device)
    try:
        scene = Scene(procedural.scene_by_name(args.scene))
        flat, _ = load_or_build_bvh(scene, cache_dir=args.cache_dir)
        camera = Camera.for_bbox(*scene.bbox())
        rays, _, _ = RayGen().primary(camera, args.width, args.height, device=device)
        routing, kind, tables = make_routing_tracer(flat, args.tracer, device=device,
                                                    cache_dir=args.cache_dir)
        common = {"routing": routing, "tables": tables, "repeats": args.repeats,
                  "warmup": args.warmup, "mesh": mesh}
        # Strong mode is the headline: fixed global work split across the
        # ranks.  Weak mode traces a copy of the batch per rank with no
        # communication and scales trivially; it is reported alongside.
        strong = measure_scaling(flat, rays, mode="strong", **common)
        weak = measure_scaling(flat, rays, mode="weak", **common)
        n = strong["n_devices"]

        take = (rays.num // n) * n
        sub = type(rays)(*(x[:take] for x in rays))
        vtx, tvi, mat = (torch.as_tensor(x, device=device)
                         for x in (scene.vtx_pos, scene.tri_vtx_index, scene.tri_material))
        target = shard_rows(torch.zeros((take, 3), dtype=torch.float32), mesh)
        audit = collective_audit(mesh, None, shard_rays(sub, mesh), vtx, tvi, mat, target,
                                 routing=routing, tables=tables)
        # Without a process group (no torchrun) there is nothing to reduce.
        audit_ok = not audit["forward"] and audit["grad_step"] == (
            {"all_reduce": 3} if mesh.group is not None else {})
        n_cores = os.cpu_count() or 1
        suffix = ("_SHARED_CARD" if shared and n > 1 else
                  "_CPU_OVERSUBSCRIBED" if args.device == "cpu" and n > n_cores else "")
        caveat = (f"CAVEAT: {n} ranks share {cards} card(s): rates measure processes sharing "
                  "a card, not scaling" if suffix == "_SHARED_CARD" else
                  f"CAVEAT: {n} ranks on {n_cores} CPU cores: rates measure host "
                  "oversubscription" if suffix else None)
        result = {
            "metric": f"{args.scene}_scaling_efficiency_{n}dev{suffix}",
            "value": round(strong["efficiency"], 4),
            "unit": "fraction",
            "vs_baseline": round(strong["efficiency"] / 0.85, 4),
            "detail": {
                "scene": args.scene, "tracer": kind, "mode": "strong",
                "caveat": caveat,
                "rate_1_mrays": round(strong["rate_1_rays_per_s"] / 1e6, 3),
                "rate_n_mrays": round(strong["rate_n_rays_per_s"] / 1e6, 3),
                "rate_1_small_mrays": round(
                    strong.get("rate_1_small_rays_per_s", 0.0) / 1e6, 3),
                "mechanism_efficiency": round(
                    strong.get("mechanism_efficiency", float("nan")), 4),
                "weak_efficiency": round(weak["efficiency"], 4),
                "weak_rate_n_mrays": round(weak["rate_n_rays_per_s"] / 1e6, 3),
                "n_devices": n,
                "physical_cores": n_cores,
                "backend": dist.get_backend() if dist.is_initialized() else None,
                "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu"),
                "collective_audit": dict(audit, verified=audit_ok),
            },
        }
        if mesh.rank == 0:
            print(json.dumps(result), flush=True)
        return result
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    scaling_main()
