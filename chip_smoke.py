#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main paths once through the entry points a user calls,
and holds every kernel against its plain PyTorch version and the host
oracle ``trace_quad_scalar``:

1-5. bunny (144,500 triangles), SBVH build, 4-wide collapse, Morton-ordered
     primary rays at 640x480, the closest-hit trace through
     ``make_routing_tracer("auto")`` (the CUDA quad kernel) and the image;
     the kernel against its plain version on every ray and the oracle on a
     strided subset; both timed with CUDA events.
6-7. conference (350,949 triangles) AO frame at 640x480, 8 samples, the
     suite camera and AO radius: a closest-hit primary trace, then two
     any-hit batches (2,097,152 + the rest); the any-hit kernel against
     its plain version on every ray of batch 1 and the oracle on 8,192
     rays, and the image at those pixels against the oracle's hit / miss.
8.   conference diffuse frame, 1 sample: the closest-hit kernel on
     secondary rays, against its plain version and the oracle.
9.   kernel-only times of the any-hit kernel (AO batch 1, and a 1-sample
     AO batch), its plain version, and the closest-hit kernel on the
     diffuse batch.

Run from the root of the repository:  python3 chip_smoke.py
It needs a CUDA device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and g++;
it builds the kernels from the sources in the checkout.  Any failed phase
ends the run with a nonzero exit and no result line.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches on the main paths, its largest deviation from the plain
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
SECONDARY_SCENE = "conference"
AO_SAMPLES = 8
AO_MAX_BATCH = 1 << 21        # the Renderer's default: 2 AO batches at 640x480
WARMUP, REPEATS = 2, 5        # as bench.py: BENCH_WARMUP / BENCH_REPEATS
PLAIN_WARMUP, PLAIN_REPEATS = 1, 3
ORACLE_RAYS = 8192
DEVICE = "cuda"


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


def median(xs) -> float:
    return float(np.median(xs))


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def subset(rays, idx):
    from tpu_rt_torch.core.types import Rays

    return Rays(*(x[idx].contiguous() for x in rays))


def against_plain(kernel, plain, tables, rays, any_hit, frame_tri, what):
    """The kernel against its plain version on every ray (tri equal, t
    bit-equal), and a repeat launch against the frame's own hits.  Returns
    the largest |t| deviation."""
    got = kernel(tables, rays, any_hit=any_hit)
    want = plain(tables, rays, any_hit=any_hit)
    torch.cuda.synchronize()
    tri_bad = int((got.tri != want.tri).sum())
    t_bad = bits_differ(got.t, want.t)
    max_abs_err = float((got.t - want.t).abs().max())
    frame_bad = int((got.tri != frame_tri).sum())
    print(f"{what}: kernel vs plain on {rays.num} rays: tri mismatches {tri_bad}, t bit "
          f"mismatches {t_bad}, max |dt| {max_abs_err}; vs the frame's own hits: {frame_bad} "
          "tri mismatches (tolerance: tri equal, t bit-equal)")
    check(tri_bad == 0 and t_bad == 0, f"{what}: kernel differs from the plain version")
    check(frame_bad == 0, f"{what}: repeat trace differs from the frame's")
    return max_abs_err


def against_oracle(kernel, tables, quad, sub, any_hit, what):
    """The kernel against ``trace_quad_scalar`` on ``sub`` (tri equal, t
    bit-equal).  Returns the oracle's hit ids."""
    from tpu_rt_torch.bvh.collapse import trace_quad_scalar

    t0 = time.perf_counter()
    s_id, s_t, _, _ = trace_quad_scalar(quad, *(x.cpu().numpy() for x in sub), any_hit=any_hit)
    oracle_s = time.perf_counter() - t0
    k = kernel(tables, sub, any_hit=any_hit)
    k_tri, k_t = k.tri.cpu().numpy(), k.t.cpu().numpy()
    tri_bad = int((k_tri != s_id).sum())
    t_bad = int((k_t.view(np.int32) != s_t.view(np.int32)).sum())
    print(f"{what}: kernel vs trace_quad_scalar(any_hit={any_hit}) on {sub.num} rays "
          f"({oracle_s:.1f} s on the host): tri mismatches {tri_bad}, t bit mismatches {t_bad}, "
          f"hit fraction {float(np.mean(s_id >= 0)):.4f}")
    check(tri_bad == 0 and t_bad == 0, f"{what}: kernel differs from the host oracle")
    return s_id


def render(renderer, camera, kernel):
    """One frame through the user's entry points, launch counts reset just
    before and read just after.  Returns (stats, image, counts, wall s)."""
    kernel.reset_counts()
    t0 = time.perf_counter()
    stats = renderer.render_frame(camera)
    image = renderer.update_result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return stats, image, dict(kernel.launches_by_form), wall


def frame_line(name, renderer, stats, counts, wall):
    tri = renderer.primary.hits.tri
    hit_frac = float((tri >= 0).float().mean())
    print(f"{name}: tracer {stats['tracer']} launches {counts} batches {stats.get('batches')} "
          f"total_rays {stats['total_rays']} rays_traced {stats['rays_traced']} primary hit "
          f"fraction {hit_frac:.4f} trace {stats['trace_time_s'] * 1e3:.3f} ms -> "
          f"{stats['mrays_per_s']:.2f} Mray/s; per-batch kernel ms "
          f"{[round(x * 1e3, 4) for x in stats.get('batch_trace_s', [])]}; phase_s "
          f"{json.dumps({k: round(v, 6) for k, v in renderer.phase_s.items()})}; set-up "
          f"{renderer.setup_s:.2f} s; wall {wall:.2f} s (set-up included)")
    return hit_frac


def check_image(image, what):
    check(image.shape == (HEIGHT, WIDTH, 4) and bool(np.isfinite(image).all()),
          f"{what}: image shape or finiteness")
    check(len(np.unique(image.reshape(-1, 4), axis=0)) > 2, f"{what}: image is uniform")


def bunny_primary(t0, kernel, dev):
    """Phases 2-5: the bunny primary frame, its checks and its timing."""
    from tpu_rt_torch.bench.workload import suite_camera
    from tpu_rt_torch.bvh import load_or_collapse_quad
    from tpu_rt_torch.bvh.collapse import MAX_LEAF4
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.scene import Scene, procedural
    from tpu_rt_torch.shade.reconstruct import BG_COLOR
    from tpu_rt_torch.trace import quad_kernel

    # 2. The main path: scene, SBVH, collapse, primary frame, image.
    t1 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(SCENE))
    camera = suite_camera(SCENE, scene)
    renderer = Renderer(WIDTH, HEIGHT, RendererParams(cache_dir=None, device=DEVICE))
    renderer.set_scene(scene)
    print(f"scene: {SCENE} {scene.num_triangles} tris, {scene.num_vertices} vertices "
          f"({time.perf_counter() - t1:.2f} s)")
    stats, image, counts, wall = render(renderer, camera, kernel)
    tables = renderer.tracer_tables
    flat = renderer.flat
    print(f"bvh: {flat.num_nodes} binary nodes, {flat.num_refs} refs, "
          f"{renderer.bvh_stats.num_duplicates} duplicates; quad: {tables.nodes.shape[0]} nodes "
          f"({tables.nodes.numel() * 4 / 1e6:.2f} MB), {tables.woop.shape[0]} woop rows "
          f"({tables.woop.numel() * 4 / 1e6:.2f} MB), depth {tables.depth}, leaf_max {MAX_LEAF4}")
    hit_frac = frame_line(f"{SCENE} primary frame", renderer, stats, counts, wall)
    check(stats["tracer"] == "quad-cuda", f"auto tracer is {stats['tracer']}")
    check(counts["closest"] >= 1 and counts["any"] == 0,
          f"the primary path launched {counts}, want the closest-hit kernel only")
    check_image(image, "primary")
    check(0.05 < hit_frac < 0.95, f"hit fraction {hit_frac}")
    phase("bunny main path done", t0)

    # 3. Kernel vs plain PyTorch version on every ray of the frame.
    rays = renderer.primary.rays
    tri = renderer.primary.hits.tri
    max_abs_err = against_plain(kernel, quad_kernel.trace_quad_plain, tables, rays, False, tri,
                                "bunny primary")
    phase("kernel == plain", t0)

    # 4. Strided subset against the host oracle trace_quad_scalar.
    idx = torch.arange(0, rays.num, rays.num // ORACLE_RAYS, device=dev)[:ORACLE_RAYS]
    quad = load_or_collapse_quad(flat, leaf_max=MAX_LEAF4, cache_dir=None)
    s_id = against_oracle(kernel, tables, quad, subset(rays, idx), False, "bunny primary")
    # The image at those pixels is the oracle's hit colour.
    pix = renderer.primary.slot_to_id[idx].cpu().numpy()
    expect = np.where((s_id >= 0)[:, None], scene.tri_shaded[np.maximum(s_id, 0)], BG_COLOR[None, :])
    img_bad = int((image.reshape(-1, 4)[pix] != expect).any(axis=1).sum())
    print(f"bunny primary: image pixel mismatches against the oracle's colours {img_bad}")
    check(img_bad == 0, "image differs from the oracle's colours")
    phase("kernel == oracle", t0)

    # 5. Kernel-only times at the main-path shape (CUDA events).
    k_ms = time_ms(lambda: kernel(tables, rays), WARMUP, REPEATS)
    p_ms = time_ms(lambda: quad_kernel.trace_quad_plain(tables, rays), PLAIN_WARMUP, PLAIN_REPEATS)
    best = min(k_ms)
    print(f"timing ({WIDTH}x{HEIGHT} = {rays.num} rays): kernel ms {[round(x, 4) for x in k_ms]} "
          f"best {best:.4f} median {median(k_ms):.4f} -> {WIDTH * HEIGHT / (best * 1e3):.2f} "
          f"Mray/s at best; plain ms {[round(x, 2) for x in p_ms]} median {median(p_ms):.2f} "
          f"-> {WIDTH * HEIGHT / (median(p_ms) * 1e3):.2f} Mray/s")
    phase("bunny timed", t0)
    return {"launches": counts["closest"], "max_abs_err": max_abs_err,
            "ms": median(k_ms), "plain_ms": median(p_ms)}


def conference(t0, kernel, dev):
    """Phases 6-9: the conference AO and diffuse frames, their checks and
    the timing of both kernel forms on their batches."""
    from tpu_rt_torch.bench.workload import suite_ao_radius, suite_camera
    from tpu_rt_torch.bvh import load_or_collapse_quad
    from tpu_rt_torch.bvh.collapse import MAX_LEAF4
    from tpu_rt_torch.raygen import RayGen
    from tpu_rt_torch.renderer import Renderer, RendererParams
    from tpu_rt_torch.scene import Scene, procedural
    from tpu_rt_torch.shade.reconstruct import BG_COLOR
    from tpu_rt_torch.trace import quad_kernel

    plain = quad_kernel.trace_quad_plain

    # 6. The AO frame through the user's entry points.
    t1 = time.perf_counter()
    scene = Scene(procedural.scene_by_name(SECONDARY_SCENE))
    camera = suite_camera(SECONDARY_SCENE, scene)
    radius = suite_ao_radius(SECONDARY_SCENE, scene)
    scene_s = time.perf_counter() - t1
    print(f"scene: {SECONDARY_SCENE} {scene.num_triangles} tris ({scene_s:.2f} s), "
          f"AO radius {radius:.4f}")
    ao = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="ao", num_samples=AO_SAMPLES, ao_radius=radius, max_batch=AO_MAX_BATCH,
        cache_dir=None, device=DEVICE))
    ao.set_scene(scene)
    stats, image, counts, wall = render(ao, camera, kernel)
    tables = ao.tracer_tables
    print(f"bvh: {ao.flat.num_nodes} binary nodes, {ao.flat.num_refs} refs; quad: "
          f"{tables.nodes.shape[0]} nodes ({tables.nodes.numel() * 4 / 1e6:.2f} MB), "
          f"{tables.woop.shape[0]} woop rows ({tables.woop.numel() * 4 / 1e6:.2f} MB), "
          f"depth {tables.depth}")
    hit_frac = frame_line(f"{SECONDARY_SCENE} AO frame", ao, stats, counts, wall)
    hits = int((ao.primary.hits.tri >= 0).sum())
    live = sum(int((b.rays.tmax >= 0).sum()) for b in ao._batches)
    occluded = sum(int(((b.rays.tmax >= 0) & (b.hits.tri >= 0)).sum()) for b in ao._batches)
    print(f"AO: primary hits {hits}, live AO rays {live}, occluded fraction {occluded / live:.4f}")
    check(stats["tracer"] == "quad-cuda", f"auto tracer is {stats['tracer']}")
    per_batch = AO_MAX_BATCH // AO_SAMPLES
    want_batches = -(-WIDTH * HEIGHT // per_batch)
    check(stats["batches"] == want_batches,
          f"AO frame has {stats['batches']} batches, want {want_batches}")
    check(counts == {"closest": 1, "any": stats["batches"]},
          f"AO frame launched {counts}: want 1 closest-hit (primary) and 1 any-hit per batch")
    check(stats["total_rays"] == hits * AO_SAMPLES == live, "AO Mray/s numerator")
    check(0.5 < hit_frac and 0.0 < occluded / live < 1.0, "AO hit / occluded fractions")
    check_image(image, "AO")
    ao_counts = counts
    phase("conference AO frame done", t0)

    # 7. Any-hit kernel vs plain on every ray of batch 1, vs the oracle on
    # 8,192 of its rays: all 8 samples of 1,024 pixel-strided primary slots.
    b1 = ao._batches[0]
    lo, hi = b1.input_range
    check(lo == 0 and b1.rays.num == (hi - lo) * AO_SAMPLES == per_batch * AO_SAMPLES,
          "AO batch 1 shape")
    any_err = against_plain(kernel, plain, tables, b1.rays, True, b1.hits.tri, "AO batch 1")
    quad = load_or_collapse_quad(ao.flat, leaf_max=MAX_LEAF4, cache_dir=None)
    n_px = ORACLE_RAYS // AO_SAMPLES
    slots = torch.arange(0, hi, hi // n_px, device=dev)[:n_px]
    ids = (slots[:, None] * AO_SAMPLES + torch.arange(AO_SAMPLES, device=dev)).reshape(-1)
    s_id = against_oracle(kernel, tables, quad, subset(b1.rays, b1.id_to_slot[ids].long()), True,
                          "AO batch 1")
    # The AO colour of those pixels from the oracle's hit / miss.
    colors = np.where((s_id >= 0)[:, None], np.float32([0, 0, 0, 1]), np.float32(1.0))
    expect = colors.reshape(n_px, AO_SAMPLES, 4).mean(axis=1, dtype=np.float32)
    primary_miss = (ao.primary.hits.tri[slots] < 0).cpu().numpy()
    expect[primary_miss] = BG_COLOR
    pix = ao.primary.slot_to_id[slots].cpu().numpy()
    img_bad = int((image.reshape(-1, 4)[pix] != expect).any(axis=1).sum())
    print(f"AO: image pixel mismatches against the oracle's hit / miss at {n_px} pixels: {img_bad}")
    check(img_bad == 0, "AO image differs from the oracle's occlusion")
    phase("any-hit kernel == plain, oracle", t0)

    # 8. The diffuse frame (1 sample): the closest-hit kernel on secondary rays.
    dif = Renderer(WIDTH, HEIGHT, RendererParams(
        ray_type="diffuse", num_samples=1, cache_dir=None, device=DEVICE))
    dif.set_scene(scene)
    stats_d, image_d, counts_d, wall_d = render(dif, camera, kernel)
    frame_line(f"{SECONDARY_SCENE} diffuse frame", dif, stats_d, counts_d, wall_d)
    check(bits_differ(dif.tracer_tables.nodes, tables.nodes) == 0
          and bits_differ(dif.tracer_tables.woop, tables.woop) == 0, "rebuilt tables differ")
    check(torch.equal(dif.primary.hits.tri, ao.primary.hits.tri), "primary hits differ")
    check(stats_d["batches"] == 1 and counts_d == {"closest": 2, "any": 0},
          f"diffuse frame launched {counts_d} in {stats_d['batches']} batches")
    check(stats_d["total_rays"] == hits, "diffuse Mray/s numerator")
    check_image(image_d, "diffuse")
    bd = dif._batches[0]
    dif_err = against_plain(kernel, plain, tables, bd.rays, False, bd.hits.tri, "diffuse batch")
    idx = torch.arange(0, bd.rays.num, bd.rays.num // ORACLE_RAYS, device=dev)[:ORACLE_RAYS]
    against_oracle(kernel, tables, quad, subset(bd.rays, idx), False, "diffuse batch")
    phase("diffuse frame, closest-hit kernel == plain, oracle", t0)

    # 9. Kernel-only times; Mray/s as bench.py counts it: primary hits x
    # samples over kernel time.
    def rate(n, ms):
        return n / (ms * 1e3)

    b1_live = int((b1.rays.tmax >= 0).sum())
    k_b1 = time_ms(lambda: kernel(tables, b1.rays, any_hit=True), WARMUP, REPEATS)
    rays_s1 = RayGen().ao(ao.primary.rays, ao.primary.hits,
                          torch.as_tensor(scene.tri_normal, device=dev), 1, radius, True)[0]
    k_s1 = time_ms(lambda: kernel(tables, rays_s1, any_hit=True), WARMUP, REPEATS)
    k_dif = time_ms(lambda: kernel(tables, bd.rays), WARMUP, REPEATS)
    p_b1 = time_ms(lambda: plain(tables, b1.rays, any_hit=True), PLAIN_WARMUP, PLAIN_REPEATS)
    for what, ms, n, rays in (("any-hit kernel, AO batch 1", k_b1, b1_live, b1.rays),
                              ("any-hit kernel, 1-sample AO batch", k_s1, hits, rays_s1),
                              ("closest-hit kernel, diffuse batch", k_dif, hits, bd.rays),
                              ("plain any-hit, AO batch 1", p_b1, b1_live, b1.rays)):
        print(f"timing {what} ({rays.num} rays, {n} live): ms {[round(x, 4) for x in ms]} "
              f"best {min(ms):.4f} median {median(ms):.4f} -> {rate(n, median(ms)):.2f} Mray/s "
              "at the median")
    phase("conference timed", t0)
    return ({"launches": ao_counts["any"], "max_abs_err": any_err,
             "ms": median(k_b1), "plain_ms": median(p_b1)},
            {"launches": ao_counts["closest"] + counts_d["closest"], "max_abs_err": dif_err})


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from tpu_rt_torch.trace import quad_kernel

    t0 = time.perf_counter()
    dev = torch.device(DEVICE, 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. Build every kernel of the path from the checkout's sources (both
    # forms are instantiations in one library).
    kernel = quad_kernel.KERNEL
    kernel.load()
    ptxas = [ln.strip() for ln in kernel.build_log.splitlines() if "ptxas" in ln and
             ("registers" in ln or "spill" in ln or "stack" in ln or "Compiling" in ln)]
    print(f"build: quad_trace.cu in {kernel.build_s:.2f} s; " + " | ".join(ptxas))
    phase("kernel built", t0)

    closest = bunny_primary(t0, kernel, dev)
    anyhit, closest_secondary = conference(t0, kernel, dev)

    print(json.dumps({"kernels": [{
        "name": "quad_trace",
        "route": "cuda",
        "source": "tpu_rt_torch/csrc/quad_trace.cu",
        "replaces": "tpu_rt/trace/packet2.py:404",
        "launches": closest["launches"] + closest_secondary["launches"],
        "max_abs_err": max(closest["max_abs_err"], closest_secondary["max_abs_err"]),
        "ms": closest["ms"],
        "plain_ms": closest["plain_ms"],
    }, {
        "name": "quad_trace_anyhit",
        "route": "cuda",
        "source": "tpu_rt_torch/csrc/quad_trace.cu",
        "replaces": "tpu_rt/trace/packet2.py:404 (any_hit=True, :552-567, :881-883)",
        **anyhit,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
