#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path once through the entry points a user calls --
the procedural bunny (144,500 triangles), SBVH build, 4-wide collapse,
Morton-ordered primary rays at 640x480, the closest-hit trace through
``make_routing_tracer("auto")`` (the CUDA quad kernel), and image
reconstruction -- then checks the kernel against its plain PyTorch version
on every ray and against the host oracle ``trace_quad_scalar`` on a
strided subset, and times both versions with CUDA events.

Run from the root of the repository:  python3 chip_smoke.py
It needs a CUDA device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and g++;
it builds the kernels from the sources in the checkout.  Any failed phase
ends the run with a nonzero exit and no result line.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches on the main path, its largest deviation from the plain
version, and both versions' times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT = 640, 480
SCENE = "bunny"
WARMUP, REPEATS = 2, 5        # as bench.py: BENCH_WARMUP / BENCH_REPEATS
PLAIN_WARMUP, PLAIN_REPEATS = 1, 3
ORACLE_RAYS = 8192


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def phase(name: str, t0: float) -> None:
    print(f"[{time.perf_counter() - t0:8.2f} s] {name}", flush=True)


def time_ms(fn, warmup: int, repeats: int) -> list[float]:
    """Per-call milliseconds from CUDA events around each timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from tpu_rt_torch.bench.workload import suite_camera
    from tpu_rt_torch.bvh import load_or_collapse_quad
    from tpu_rt_torch.bvh.collapse import MAX_LEAF4, trace_quad_scalar
    from tpu_rt_torch.core.types import Rays
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.scene import Scene, procedural
    from tpu_rt_torch.shade.reconstruct import BG_COLOR
    from tpu_rt_torch.trace import quad_kernel

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. Build every kernel of the path from the checkout's sources.
    kernel = quad_kernel.KERNEL
    kernel.load()
    ptxas = [ln.strip() for ln in kernel.build_log.splitlines() if "ptxas" in ln and
             ("registers" in ln or "spill" in ln or "stack" in ln)]
    print(f"build: quad_trace.cu in {kernel.build_s:.2f} s; " + " | ".join(ptxas))
    phase("kernel built", t0)

    # 2. The main path: scene, SBVH, collapse, primary frame, image.
    t1 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(SCENE))
    camera = suite_camera(SCENE, scene)
    renderer = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=None, device="cuda"))
    renderer.set_scene(scene)
    print(f"scene: {SCENE} {scene.num_triangles} tris, {scene.num_vertices} vertices "
          f"({time.perf_counter() - t1:.2f} s)")
    kernel.launches = 0
    t2 = time.perf_counter()
    stats = renderer.render_frame(camera)
    image = renderer.update_result()
    torch.cuda.synchronize()
    launches = kernel.launches
    frame_s = time.perf_counter() - t2
    tables = renderer.tracer_tables
    flat = renderer.flat
    print(f"bvh: {flat.num_nodes} binary nodes, {flat.num_refs} refs, "
          f"{renderer.bvh_stats.num_duplicates} duplicates; quad: {tables.nodes.shape[0]} nodes "
          f"({tables.nodes.numel() * 4 / 1e6:.2f} MB), {tables.woop.shape[0]} woop rows "
          f"({tables.woop.numel() * 4 / 1e6:.2f} MB), depth {tables.depth}, leaf_max {MAX_LEAF4}")
    tri = renderer.primary.hits.tri
    hit_frac = float((tri >= 0).float().mean())
    print(f"frame: tracer {stats['tracer']} launches {launches} rays {stats['total_rays']} "
          f"hit fraction {hit_frac:.4f} first-frame trace {stats['trace_time_s'] * 1e3:.3f} ms "
          f"phase_s {json.dumps({k: round(v, 6) for k, v in renderer.phase_s.items()})} "
          f"wall {frame_s:.2f} s (BVH build included)")
    check(stats["tracer"] == "quad-cuda", f"auto tracer is {stats['tracer']}")
    check(launches >= 1, "the main path did not launch the quad kernel")
    check(image.shape == (HEIGHT, WIDTH, 4) and bool(np.isfinite(image).all()),
          "image shape or finiteness")
    check(0.05 < hit_frac < 0.95, f"hit fraction {hit_frac}")
    phase("main path done", t0)

    # 3. Kernel vs plain PyTorch version on every ray of the frame.
    rays = renderer.primary.rays
    got = kernel(tables, rays)
    want = quad_kernel.trace_quad_plain(tables, rays)
    torch.cuda.synchronize()
    tri_bad = int((got.tri != want.tri).sum())
    t_bad = int((got.t.view(torch.int32) != want.t.view(torch.int32)).sum())
    max_abs_err = float((got.t - want.t).abs().max())
    frame_bad = int((got.tri != tri).sum())
    print(f"kernel vs plain on {rays.num} rays: tri mismatches {tri_bad}, t bit mismatches {t_bad}, "
          f"max |dt| {max_abs_err}; vs the frame's own hits: {frame_bad} tri mismatches "
          "(tolerance: tri equal, t bit-equal)")
    check(tri_bad == 0 and t_bad == 0, "kernel differs from the plain version")
    check(frame_bad == 0, "repeat trace differs from the frame's")
    phase("kernel == plain", t0)

    # 4. Strided subset against the host oracle trace_quad_scalar.
    idx = torch.arange(0, rays.num, rays.num // ORACLE_RAYS, device=dev)[:ORACLE_RAYS]
    sub = Rays(*(x[idx].contiguous() for x in rays))
    quad = load_or_collapse_quad(flat, leaf_max=MAX_LEAF4, cache_dir=None)
    t3 = time.perf_counter()
    s_id, s_t, _, _ = trace_quad_scalar(quad, *(x.cpu().numpy() for x in sub))
    oracle_s = time.perf_counter() - t3
    k_sub = kernel(tables, sub)
    k_tri, k_t = k_sub.tri.cpu().numpy(), k_sub.t.cpu().numpy()
    o_tri_bad = int((k_tri != s_id).sum())
    o_t_bad = int((k_t.view(np.int32) != s_t.view(np.int32)).sum())
    # The image at those pixels is the oracle's hit colour.
    pix = renderer.primary.slot_to_id[idx].cpu().numpy()
    expect = np.where((s_id >= 0)[:, None], scene.tri_shaded[np.maximum(s_id, 0)], BG_COLOR[None, :])
    img_bad = int((image.reshape(-1, 4)[pix] != expect).any(axis=1).sum())
    print(f"kernel vs trace_quad_scalar on {idx.numel()} strided rays ({oracle_s:.1f} s on the host): "
          f"tri mismatches {o_tri_bad}, t bit mismatches {o_t_bad}, image pixel mismatches {img_bad}")
    check(o_tri_bad == 0 and o_t_bad == 0, "kernel differs from the host oracle")
    check(img_bad == 0, "image differs from the oracle's colours")
    phase("kernel == oracle", t0)

    # 5. Kernel-only times at the main-path shape (CUDA events).
    k_ms = time_ms(lambda: kernel(tables, rays), WARMUP, REPEATS)
    p_ms = time_ms(lambda: quad_kernel.trace_quad_plain(tables, rays), PLAIN_WARMUP, PLAIN_REPEATS)
    best = min(k_ms)
    mrays = WIDTH * HEIGHT / (best * 1e3)
    print(f"timing ({WIDTH}x{HEIGHT} = {rays.num} rays): kernel ms {[round(x, 4) for x in k_ms]} "
          f"best {best:.4f} median {float(np.median(k_ms)):.4f} -> {mrays:.2f} Mray/s at best; "
          f"plain ms {[round(x, 2) for x in p_ms]} median {float(np.median(p_ms)):.2f} "
          f"-> {WIDTH * HEIGHT / (float(np.median(p_ms)) * 1e3):.2f} Mray/s")
    phase("timed", t0)

    print(json.dumps({"kernels": [{
        "name": "quad_trace",
        "route": "cuda",
        "source": "tpu_rt_torch/csrc/quad_trace.cu",
        "replaces": "tpu_rt/trace/packet2.py:404",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": float(np.median(k_ms)),
        "plain_ms": float(np.median(p_ms)),
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
