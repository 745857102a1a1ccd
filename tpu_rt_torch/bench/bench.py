"""Headline benchmark of the port: ONE JSON line with the headline metric.

Counterpart of ``main`` in the JAX package's ``bench.py``, with its settings
(the same environment variables and defaults), its rules and its keys:

    BENCH_SCENE=dragon BENCH_RAY_TYPE=primary python -m tpu_rt_torch.bench.bench \\
        [--device cuda] [--cache-dir bvhcache] [--out build/bench]

Metric discipline is the reference's (src/rt/App.cc:188-204 with
src/rt/cuda/Renderer.cc:221-238): Mray/s = rays / trace-kernel time only,
excluding raygen, sort and reconstruction; warmup traces excluded; for
secondary ray types the numerator is primary HITS x samples, not the count
of generated rays (which holds degenerate tmax = -1 rays for primary
misses).  The primary hits come from the port's wavefront tracer; the AO
radius defaults to the reference CLI's 5.0 (Main.cc:82).

Timing: ``BENCH_REPEATS`` chains of ``BENCH_CHAIN`` traces, CUDA events
around each chain; ``best_s`` and ``mean_s`` are per trace.  ``bench.py``
also reads back ``sum(hits.tri)`` after every trace, because
``block_until_ready`` did not fence on the TPU it ran on; a CUDA event does
fence, so that readback is dropped and the metric is trace-kernel time
only.

Before timing, a stride subset of ``BENCH_VERIFY_RAYS`` rays is traced by
the routed kernel and by the wavefront on the same device
(``verify_on_device``); disputed rays are adjudicated by the scalar oracle
``trace_flat_scalar``, and a kernel that is wrong fails the run.

``vs_baseline`` compares against the reference's published rate for the
scene and ray type (``BASELINES``, from BASELINE.md: the reference fork's
numbers on its own GPU, an sm_35 build).  ``detail.full_frame_verified``
reads only the full-frame file that the port's ``bench_suite
--verify-full`` wrote under ``--out`` (default ``build/bench``).

``BENCH_MODE=scaling`` hands over to ``tpu_rt_torch.bench.scaling``.
``--device cpu`` runs the kernels' plain versions on the host clock; that
run only serves the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpu_rt_torch.bench.tune_quad import device_name
from tpu_rt_torch.bench.workload import suite_camera
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import (device_bvh, make_routing_tracer, release_persisting_l2,
                                trace_flat_scalar, trace_wavefront)

# Where the port's harness writes (git-ignored); --out overrides it.
OUT_DIR = os.path.join("build", "bench")
FULLFRAME_FILE = "FULLFRAME.json"

# bench.py's settings: (environment variable, default).  The frame is the
# reference's committed 640x480 (App.cc:53).
SETTINGS = {
    "scene": ("BENCH_SCENE", "bunny"),
    "ray_type": ("BENCH_RAY_TYPE", "primary"),
    "width": ("BENCH_WIDTH", 640),
    "height": ("BENCH_HEIGHT", 480),
    "warmup": ("BENCH_WARMUP", 2),
    "repeats": ("BENCH_REPEATS", 5),
    "samples": ("BENCH_SAMPLES", 1),          # reference App.cc:155
    "ao_radius": ("BENCH_AO_RADIUS", 5.0),    # Main.cc:82
    "verify_rays": ("BENCH_VERIFY_RAYS", 8192),
    "tracer": ("BENCH_TRACER", "auto"),
    "chain": ("BENCH_CHAIN", 32),
}

# Reference Mray/s (BASELINE.md) keyed by (scene, ray_type).
BASELINES = {
    ("sponza", "primary"): 597.51, ("knob", "primary"): 1271.61,
    ("hairball", "primary"): 280.49, ("dragon", "primary"): 575.43,
    ("bunny", "primary"): 825.11,
    ("conference", "diffuse"): 831.28, ("fairy", "diffuse"): 678.77,
    ("sibenik", "diffuse"): 286.97, ("sanmiguel", "diffuse"): 132.28,
    ("sponza", "diffuse"): 325.33, ("knob", "diffuse"): 1466.05,
    ("conference", "ao"): 1478.43, ("fairy", "ao"): 1280.77,
    ("sibenik", "ao"): 1499.86, ("sanmiguel", "ao"): 556.89,
    ("sponza", "ao"): 1022.61, ("knob", "ao"): 2763.01,
}


def settings(env=None) -> dict:
    """bench.py's settings from ``env`` (default ``os.environ``), typed as
    their defaults."""
    env = os.environ if env is None else env
    return {k: type(default)(env.get(var, default)) for k, (var, default) in SETTINGS.items()}


def chain_times(trace, chain: int, repeats: int, device: torch.device) -> list[float]:
    """Seconds per trace of ``repeats`` chains of ``chain`` calls of
    ``trace()``: CUDA events around each chain on the card, the host clock
    on the CPU."""
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                trace()
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(chain):
                trace()
            s = time.perf_counter() - t0
        times.append(s / chain)
    return times


def verify_on_device(flat, dbvh, rays: Rays, any_hit: bool, trace_fn, n_check: int) -> int:
    """Hold the routed kernel (``trace_fn(rays, any_hit)``) to the wavefront
    tracer on the same device on a stride subset of about ``n_check`` rays.
    Disputed rays are adjudicated by the scalar oracle: the kernel fails
    only where it disagrees with the oracle beyond an fp tie or an
    edge-grazing hit (raises AssertionError).  Returns the number of rays
    checked."""
    step = max(1, rays.num // n_check)
    sub = Rays(*(x[::step].contiguous() for x in rays))
    got = trace_fn(sub, any_hit)
    want = trace_wavefront(dbvh, sub, any_hit=any_hit)
    got_tri, want_tri = got.tri.cpu().numpy(), want.tri.cpu().numpy()
    got_t, want_t = got.t.cpu().numpy(), want.t.cpu().numpy()
    if any_hit:
        # Any hit may pick different occluders: hit / miss only.
        bad = (got_tri >= 0) != (want_tri >= 0)
    else:
        bad = got_tri != want_tri
        bad |= (got_tri >= 0) & ~np.isclose(got_t, want_t, rtol=1e-4, atol=1e-6)
    if bad.any():
        # The wavefront divides Oz / Dz where the kernel and the oracle
        # multiply by 1 / Dz, so a few edge-grazing or tied rays may
        # diverge; the oracle decides each.
        idx = np.nonzero(bad)[0]
        o, d, tmin, tmax = (x.cpu().numpy()[idx] for x in sub)
        s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit)
        if any_hit:
            wrong = (got_tri[idx] >= 0) != (s_id >= 0)
        else:
            exact = got_tri[idx] == s_id
            tie = ~exact & np.isclose(got_t[idx], s_t, rtol=2e-4, atol=1e-5)
            margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
            graze = ~exact & ~tie & (s_id >= 0) & (margin < 1e-3)
            wrong = ~exact & ~tie & ~graze
        if wrong.any():
            w = idx[np.nonzero(wrong)[0][:8]]
            raise AssertionError(
                f"on-device kernel verification FAILED for "
                f"{int(wrong.sum())}/{got_tri.size} rays (oracle-"
                f"adjudicated); first at {w.tolist()}: "
                f"packet tri={got_tri[w].tolist()} t={got_t[w].tolist()}")
    return int(got_tri.size)


def full_frame_verified(out_dir: str = OUT_DIR):
    """{target: verified} of the full-frame file that the port's
    ``bench_suite --verify-full`` wrote under ``out_dir``, or None."""
    try:
        with open(os.path.join(out_dir, FULLFRAME_FILE)) as f:
            data = json.load(f)
    except OSError:
        return None
    return {k: bool(v.get("verified")) for k, v in data.items()}


def main(env=None, device="cuda", cache_dir: str | None = "bvhcache",
         out_dir: str = OUT_DIR) -> dict:
    """The headline run of ``env``'s settings on ``device``; prints the JSON
    line and returns it as a dict.  ``BENCH_MODE=scaling`` runs
    ``bench.scaling.scaling_main`` instead."""
    env = os.environ if env is None else env
    s = settings(env)
    if env.get("BENCH_MODE") == "scaling":
        from tpu_rt_torch.bench.scaling import scaling_main

        return scaling_main(["--scene", s["scene"], "--width", str(s["width"]),
                             "--height", str(s["height"]), "--tracer", s["tracer"],
                             "--repeats", str(s["repeats"]), "--warmup", str(s["warmup"]),
                             "--device", torch.device(device).type]
                            + (["--cache-dir", cache_dir] if cache_dir else []))
    device = torch.device(device)
    scene_name, ray_type, samples = s["scene"], s["ray_type"], s["samples"]

    t0 = time.time()
    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    build_s = time.time() - t0

    camera = suite_camera(scene_name, scene)
    rays, _, _ = RayGen().primary(camera, s["width"], s["height"], device=device)
    dbvh = device_bvh(flat, device)
    any_hit = False
    num_rays = s["width"] * s["height"]  # metric numerator (App.cc:188-204)

    # BENCH_TRACER: auto (4-wide, binary only for a quad tree too deep for
    # its stack), pallas, packet4, packet (binary), xla (the wavefront).
    routing_fn, tracer, tables = make_routing_tracer(flat, prefer=s["tracer"], device=device,
                                                     cache_dir=cache_dir)
    if tracer == "wavefront":
        routing_fn, tables = None, dbvh
    try:
        if ray_type != "primary":
            primary_hits = trace_wavefront(dbvh, rays)
            # Numerator = primary hits x samples (Renderer.cc:221-238).
            num_rays = int((primary_hits.tri >= 0).sum()) * samples
            max_dist = s["ao_radius"] if ray_type == "ao" else float(camera.far)
            rays, _, _ = gen_ao_rays(rays.origin, rays.dirn, primary_hits.t, primary_hits.tri,
                                     torch.as_tensor(scene.tri_normal, device=device), samples,
                                     max_dist, 0)
            any_hit = ray_type == "ao"

        verified = 0
        if routing_fn is not None:
            verified = verify_on_device(
                flat, dbvh, rays, any_hit,
                lambda r, ah: routing_fn(tables, r, any_hit=ah), s["verify_rays"])

        def trace():
            if routing_fn is not None:
                return routing_fn(tables, rays, any_hit=any_hit)
            return trace_wavefront(dbvh, rays, any_hit=any_hit)

        for _ in range(s["warmup"]):
            trace()
        times = chain_times(trace, s["chain"], s["repeats"], device)
    finally:
        if getattr(tables, "residency", None) == "mixed":
            release_persisting_l2()

    best = min(times)
    mrays = num_rays / (best * 1e6)
    baseline = BASELINES.get((scene_name, ray_type))
    result = {
        "metric": f"{scene_name}_{ray_type}_mrays_per_s",
        "value": mrays,
        "unit": "Mray/s",
        "vs_baseline": mrays / baseline if baseline else None,
        "detail": {
            "scene": scene_name,
            "ray_type": ray_type,
            "rays_metric": num_rays,
            "rays_traced": rays.num,
            "samples": samples,
            "ao_radius": s["ao_radius"] if ray_type == "ao" else None,
            "tris": scene.num_triangles,
            "bvh_refs": int(np.asarray(flat.tri_woop).shape[0]),
            "best_s": best,
            "mean_s": float(np.mean(times)),
            "build_s": build_s,
            "tracer": tracer,
            "verified_rays": verified,
            # The reference's committed 640x480 frame and the suite cameras
            # (tpu_rt_torch.bench.workload).
            "workload": "r4-calibrated-640x480",
            "full_frame_verified": full_frame_verified(out_dir),
            "backend": device.type,
            "device": device_name(device),
        },
    }
    print(json.dumps(result), flush=True)
    return result


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache-dir", default="bvhcache")
    ap.add_argument("--out", default=OUT_DIR,
                    help=f"where the port's full-frame file is read (default {OUT_DIR})")
    args = ap.parse_args(argv)
    main(device=args.device, cache_dir=args.cache_dir or None, out_dir=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
