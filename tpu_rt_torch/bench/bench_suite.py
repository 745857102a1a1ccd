"""The BASELINE.md scene x ray-type suite in ONE process, its cost model,
its table, and the full-frame checks.

Counterpart of the JAX package's ``tools/bench_suite.py``:

    python -m tpu_rt_torch.bench.bench_suite [scene:ray_type ...] [--out build/bench]
    python -m tpu_rt_torch.bench.bench_suite --verify-full
    python -m tpu_rt_torch.bench.bench_suite --verify-ao
    python -m tpu_rt_torch.bench.bench_suite --regen-md
        [--device cuda] [--cache-dir bvhcache]

Metric discipline is ``bench.py``'s: kernel-only time, numerator = primary
hits x samples for secondary types (App.cc:188-204, Renderer.cc:221-238).
Each row pre-traces its primary rays through the routed kernel, generates
the secondary rays with the suite's AO radius (``suite_ao_radius``, "grt"),
sorts them by the 192-bit Morton key on the device (not timed), and takes
the best of ``BS_REPEATS`` chains of ``BS_CHAIN`` traces, CUDA events
around each chain.  After each row the persisting L2 of ``mixed`` tables is
given back and the row's tables are dropped.

The census of a row, from one more trace with the kernel's per-ray
``with_stats`` counters (``tpu_rt`` reads ``count_iters`` per Pallas grid
step in their place):

    groups = the number of 32-ray warps, ceil(rays / 32);
    iters  = the sum over warps of the warp's largest per-ray
             node_tests + tri_tests: the steps a lock-step warp's loop
             runs, the quantity ``count_iters`` measured per packet.

``fit_cost_model`` fits ``best_s ~= g * groups + c * iters`` per route and
leaf width, so every row carries ``vs_model``.  ``--verify-full`` traces
whole primary frames through each of ``FULLFRAME_TARGETS`` and holds the
hit ids to the port's wavefront, the scalar oracle adjudicating every
disputed ray; ``--verify-ao`` does so for every batch of a multi-batch AO
frame through the ``Renderer``.

Every file goes under ``--out`` (default ``build/bench``, git-ignored):
``SUITE.json``, ``SUITE.md``, ``FULLFRAME.json``.  ``SUITE.md``'s calib
column reads the port's ``CALIB.json`` there (``tpu_rt_torch.bench.
calibrate``).  Environment: BS_WIDTH / BS_HEIGHT (640x480), BS_REPEATS (3),
BS_CHAIN (32), BS_TRACER (auto), BS_AO_RADIUS (grt); the frame size also
applies to ``--verify-full`` and ``--verify-ao``.  ``--device cpu``
runs the kernels' plain versions on the host clock; that run only serves
the tests.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import numpy as np
import torch

from tpu_rt_torch.bench.bench import BASELINES, FULLFRAME_FILE, OUT_DIR, chain_times
from tpu_rt_torch.bench.tune_quad import device_name
from tpu_rt_torch.bench.workload import FRAME_H, FRAME_W, suite_ao_radius, suite_camera
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import morton_sort_device, permute_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import (TABLE_BUDGET, device_bvh, make_routing_tracer, quad_policy,
                                release_persisting_l2, trace_flat_scalar, trace_wavefront)

ROWS = [
    ("sponza", "primary"), ("knob", "primary"), ("hairball", "primary"),
    ("dragon", "primary"), ("bunny", "primary"),
    ("conference", "diffuse"), ("fairy", "diffuse"), ("sibenik", "diffuse"),
    ("sanmiguel", "diffuse"), ("sponza", "diffuse"), ("knob", "diffuse"),
    ("conference", "ao"), ("fairy", "ao"), ("sibenik", "ao"),
    ("sanmiguel", "ao"), ("sponza", "ao"), ("knob", "ao"),
    # Non-baseline rows (the reference publishes no dragon secondary
    # numbers) kept for cost-model support: every route's fit should rest
    # on >= 2 rows.
    ("dragon", "ao"), ("dragon", "diffuse"),
]

TRIS = {"knob": "12.6K", "sponza": "121.4K", "bunny": "144.5K",
        "fairy": "174.1K", "conference": "350.9K", "sibenik": "75.3K",
        "dragon": "910.3K", "sanmiguel": "1.50M", "hairball": "6.47M"}

# Full-frame targets: (scene, prefer, residency, bf16_nodes), the forms the
# JAX tool's comments name.  On the card the placement policy routes every
# scene to vmem f32, so the binary forms are forced.
FULLFRAME_TARGETS = [
    ("bunny", "auto", None, None),          # the default route (4-wide)
    ("conference", "auto", None, None),
    ("dragon", "auto", None, None),
    ("bunny", "packet", "vmem", False),     # binary vmem f32
    ("conference", "packet", "mixed", False),   # binary mixed f32
    ("dragon", "packet", "mixed", True),    # binary mixed bf16
    ("dragon", "packet", "hbm", False),     # binary forced fully-streamed f32
]

SUITE_FILE, SUITE_MD, CALIB_FILE, DIFF_FILE = "SUITE.json", "SUITE.md", "CALIB.json", "DIFF.jsonl"
WARP = 32


@functools.lru_cache(maxsize=2)
def _setup_scene(scene_name: str, cache_dir: str | None = "bvhcache"):
    """(Scene, FlatBVH) of a suite scene; the last two stay in memory, so a
    run ordered by scene builds each mesh once."""
    scene = Scene(procedural.scene_by_name(scene_name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    return scene, flat


def warp_iters(stats: dict) -> torch.Tensor:
    """Each 32-ray warp's largest per-ray node_tests + tri_tests (int64,
    one per warp; the last warp padded with zeros)."""
    work = stats["node_tests"].long() + stats["tri_tests"].long()
    groups = -(-work.numel() // WARP)
    work = torch.nn.functional.pad(work, (0, groups * WARP - work.numel()))
    return work.view(groups, WARP).amax(1)


def census(stats: dict) -> tuple[int, int]:
    """(groups, iters) of a trace's per-ray counters: the number of 32-ray
    warps, and the sum over warps of the warp's largest per-ray
    node_tests + tri_tests."""
    it = warp_iters(stats)
    return it.numel(), int(it.sum())


def bench_row(scene_name: str, ray_type: str, width: int, height: int, repeats: int,
              chain: int, samples: int = 1, device="cuda", cache_dir: str | None = "bvhcache",
              tracer: str = "auto", ao_spec: str = "grt") -> dict:
    """One suite row on ``device``: Mray/s (best of ``repeats`` chains of
    ``chain`` traces), its baseline and census.  ``tracer`` is BS_TRACER,
    ``ao_spec`` BS_AO_RADIUS."""
    device = torch.device(device)
    scene, flat = _setup_scene(scene_name, cache_dir)
    camera = suite_camera(scene_name, scene)
    rays, _, _ = RayGen().primary(camera, width, height, device=device)
    num_rays = width * height
    any_hit = False

    # BS_TRACER: auto (4-wide, binary for a quad tree too deep for its
    # stack), pallas, packet4, packet (binary), xla (the wavefront).
    routing_fn, kind, tables = make_routing_tracer(flat, prefer=tracer, device=device,
                                                   cache_dir=cache_dir)
    try:
        leaf_max = quad_policy(flat, cache_dir, TABLE_BUDGET) if kind.startswith("quad") else None
        if kind == "wavefront":
            routing_fn = None
        dbvh = tables if routing_fn is None else None

        ao_radius = None
        if ray_type != "primary":
            # The primary pre-trace goes through the routed kernel; it is
            # not part of the metric.
            if routing_fn is not None:
                primary_hits = routing_fn(tables, rays)
            else:
                primary_hits = trace_wavefront(dbvh, rays)
            num_rays = int((primary_hits.tri >= 0).sum()) * samples
            ao_radius = suite_ao_radius(scene_name, scene, ao_spec)
            max_dist = ao_radius if ray_type == "ao" else float(camera.far)
            rays, _, _ = gen_ao_rays(rays.origin, rays.dirn, primary_hits.t, primary_hits.tri,
                                     torch.as_tensor(scene.tri_normal, device=device), samples,
                                     max_dist, 0)
            # Coherence sort on the device, not timed (the reference metric
            # excludes raygen, sort and reconstruction, App.cc:188-204).
            rays = permute_rays(rays, morton_sort_device(rays.origin, rays.dirn))
            any_hit = ray_type == "ao"

        def trace():
            if routing_fn is not None:
                return routing_fn(tables, rays, any_hit=any_hit)
            return trace_wavefront(dbvh, rays, any_hit=any_hit)

        trace()
        trace()
        times = chain_times(trace, chain, repeats, device)
        best = min(times)
        mrays = num_rays / best / 1e6
        base = BASELINES.get((scene_name, ray_type))
        row = {
            "scene": scene_name, "ray_type": ray_type,
            "mrays": mrays, "baseline": base,
            "vs_baseline": mrays / base if base else None,
            "best_s": best, "mean_s": float(np.mean(times)), "rays_metric": num_rays,
            "rays_traced": rays.num, "tracer": kind,
            "leaf_max": leaf_max,
            "width": width, "height": height,
            "ao_radius": ao_radius,
            "device": device_name(device),
        }
        if routing_fn is not None:
            # The census: one more, untimed trace with the per-ray counters.
            _, stats = routing_fn(tables, rays, any_hit=any_hit, with_stats=True)
            row["groups"], row["iters"] = census(stats)
        return row
    finally:
        if getattr(tables, "residency", None) == "mixed":
            release_persisting_l2()


def fit_cost_model(rows: list[dict]) -> dict:
    """Per-route linear model best_s ~= g * groups + c * iters,
    least-squares over the suite rows: where a row deviates, that row is
    the next target; where the model holds, the gap is structural."""
    out = {}
    by_res = {}
    for r in rows:
        if "iters" in r and r.get("best_s"):
            # Fit groups split by leaf width where recorded: one (g, c)
            # pair cannot span different leaf drains.
            key = r["tracer"] + (f"-leaf{r['leaf_max']}"
                                 if r.get("leaf_max") else "")
            by_res.setdefault(key, []).append(r)
    fits = {}
    shared_g = []
    for res, rs in by_res.items():
        A = np.array([[r["groups"], r["iters"]] for r in rs], np.float64)
        b = np.array([r["best_s"] for r in rs], np.float64)
        if len(rs) >= 2:
            coef, *_ = np.linalg.lstsq(A, b, rcond=None)
            g, c = float(max(coef[0], 0.0)), float(max(coef[1], 0.0))
            shared_g.append(g)
            fits[res] = (g, c, len(rs), False)
        else:
            fits[res] = (None, None, 1, True)
    for res, (g, c, n, single) in fits.items():
        rs = by_res[res]
        if single:
            # A 1-row route cannot support a 2-parameter fit: share
            # per_group from the multi-row routes and solve per_iter from
            # the single row.
            g = float(np.mean(shared_g)) if shared_g else 0.0
            r0 = rs[0]
            c = max((r0["best_s"] - g * r0["groups"]), 0.0) / max(
                r0["iters"], 1)
        out[res] = {"per_group_us": round(g * 1e6, 2),
                    "per_iter_us": round(c * 1e6, 3), "n_rows": n,
                    **({"per_group_shared": True} if single else {})}
        for r in rs:
            pred = g * r["groups"] + c * r["iters"]
            r["model_s"] = round(pred, 5)
            r["vs_model"] = round(r["best_s"] / pred, 3) if pred > 0 else None
    return out


def _load_json(path: str, default=None):
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return default


def write_suite_md(results, width, height, chain, model=None,
                   path: str = os.path.join(OUT_DIR, SUITE_MD), repeats: int | None = None) -> None:
    """The suite table as markdown at ``path``, with the calib column from
    the port's ``CALIB.json`` and the full-frame and diff results found
    beside it; the header names the card by the rows' ``device`` (the
    nvidia-smi line)."""
    ok = [r for r in results if "mrays" in r]
    if not ok:
        return
    out_dir = os.path.dirname(path)
    dev = ok[0]["device"]
    calib = {(c["scene"], c["ray_type"]): c
             for c in _load_json(os.path.join(out_dir, CALIB_FILE), []) if "error" not in c}
    timed = (f"best of {repeats} chains of {chain} traces" if repeats
             else f"chains of {chain} traces")
    clock = "the host clock" if dev == "cpu" else "CUDA events"
    lines = [
        "# Benchmark suite snapshot", "",
        f"Measured with `python -m tpu_rt_torch.bench.bench_suite` on {dev}, "
        f"{width}x{height} (the reference's committed frame, App.cc:53), "
        "kernel-time-only Mray/s (reference metric, App.cc:188-204; "
        "secondary numerator = primary hits x samples, "
        f"Renderer.cc:221-238), {timed}, {clock} around each chain.  "
        "Scenes are procedural stand-ins with the reference scenes' triangle "
        "counts; baselines are the reference's published GPU numbers "
        "(BASELINE.md).", "",
        "`calib` = the oracle's difficulty calibration "
        "(`python -m tpu_rt_torch.bench.calibrate`): mean node + tri tests "
        "per live ray / hit fraction.  `groups` = 32-ray warps; `iters` = "
        "the sum over warps of the warp's largest per-ray node + tri tests "
        "(the kernel's `with_stats` counters).  `vs_model` = measured / "
        "(fitted per-route g*groups + c*iters): rows far from 1.0 are "
        "scheduling anomalies, rows near 1.0 are iteration-bound.", "",
        "| Scene | Ray type | Mray/s | Baseline | vs_baseline | "
        "calib tests/ray | hit% | iters | vs_model |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in ok:
        cal = calib.get((r["scene"], r["ray_type"]), {})
        tests = (f"{cal['node_tests_per_ray'] + cal['tri_tests_per_ray']:.0f}"
                 if cal else "")
        hitp = f"{cal['hit_frac'] * 100:.0f}%" if cal else ""
        vsb = (f"{r['vs_baseline']:.3f}"
               if r.get("vs_baseline") is not None else "n/a")
        lines.append(
            f"| {r['scene']} ({TRIS.get(r['scene'], '?')}) "
            f"| {r['ray_type']} | {r['mrays']:.2f} | {r['baseline'] or 'n/a'} "
            f"| {vsb} | {tests} | {hitp} "
            f"| {r.get('iters', '')} | {r.get('vs_model', '')} |")
    for r in results:
        if "error" in r:
            lines.append(f"| {r['scene']} | {r['ray_type']} | "
                         f"FAILED: {r['error'][:60]} | | | | | | |")
    if model:
        lines += ["", "## Fitted cost model (per route)", "",
                  "```json", json.dumps(model, indent=1), "```"]
    for name, title in (
            (FULLFRAME_FILE, "Full-frame device parity (hit ids against the "
             "wavefront on every ray, disputes adjudicated by the oracle)"),
            (DIFF_FILE, "Differentiable path (routing, forward render, grad "
             "step; `python -m tpu_rt_torch.bench.bench_diff`)")):
        p = os.path.join(out_dir, name)
        if os.path.exists(p):
            lines += ["", f"## {title}", "", "```json"]
            with open(p) as f:
                lines += [ln.rstrip() for ln in f if ln.strip()]
            lines += ["```"]
    lines += ["", f"Updated: {time.strftime('%Y-%m-%d')}."]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _adjudicate(flat, rays_np, d_idx, tri, t):
    """The oracle's verdict on the disputed rays ``d_idx`` of a closest-hit
    frame: (exact, fp tie, edge graze, kernel wrong) masks."""
    o, dn, tn, tx = (x[d_idx] for x in rays_np)
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, dn, tn, tx)
    pk_tri, pk_t = tri[d_idx], t[d_idx]
    exact = pk_tri == s_id
    # An equal-t different-triangle hit, or a hit / miss flip within fp
    # noise of tmax, is a tie; a hit within fp noise of an edge may flip
    # under another (equally valid) f32 contraction.
    tie = ~exact & np.isclose(pk_t, s_t, rtol=2e-4, atol=1e-5)
    margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
    graze = ~exact & ~tie & (s_id >= 0) & (margin < 1e-3)
    return exact, tie, graze, ~exact & ~tie & ~graze


def _merge_fullframe(out_dir: str, entries: dict, fresh: bool) -> None:
    path = os.path.join(out_dir, FULLFRAME_FILE)
    results = {} if fresh else _load_json(path, {})
    results.update(entries)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def verify_full(out_dir: str = OUT_DIR, device="cuda", cache_dir: str | None = "bvhcache",
                width: int = FRAME_W, height: int = FRAME_H, targets=None) -> dict:
    """Full-frame device parity of each target -> ``FULLFRAME.json``: the
    whole primary frame through the forced form, hit ids against the
    port's wavefront on the same device, every disputed ray adjudicated by
    the scalar oracle (exact / fp tie / edge graze / kernel wrong).
    ``targets`` default: ``FULLFRAME_TARGETS``."""
    device = torch.device(device)
    dev_name = device_name(device)
    results = {}
    for scene_name, prefer, residency, bf16 in targets or FULLFRAME_TARGETS:
        scene, flat = _setup_scene(scene_name, cache_dir)
        rays, _, _ = RayGen().primary(suite_camera(scene_name, scene), width, height,
                                      device=device)
        fn, kind, tables = make_routing_tracer(flat, prefer, device, cache_dir=cache_dir,
                                               residency=residency, bf16_nodes=bf16)
        try:
            h = fn(tables, rays)
            # The JAX tool's keys: the binary forms by layout (vmem, mixed,
            # mixed-bf16, hbm), the default route by its kind.
            key = (tables.residency + ("-bf16" if bf16 else "")) if prefer == "packet" else kind
            key = f"{key}:{scene_name}" if key in results else key
            tri, t = h.tri.cpu().numpy(), h.t.cpu().numpy()
            wtri = trace_wavefront(device_bvh(flat, device), rays).tri.cpu().numpy()
        finally:
            if tables.residency == "mixed":
                release_persisting_l2()
        d_idx = np.flatnonzero(wtri != tri)
        exact, tie, graze, wrong = _adjudicate(flat, [x.cpu().numpy() for x in rays], d_idx,
                                               tri, t)
        bad = int(wrong.sum())
        results[key] = {
            "scene": scene_name, "tracer": kind, "rays": int(tri.size),
            "cross_tracer_disputes": int(d_idx.size),
            "oracle_adjudicated_exact": int(exact.sum()),
            "oracle_adjudicated_fp_tie": int(tie.sum()),
            "oracle_adjudicated_edge_graze": int(graze.sum()),
            "kernel_wrong": bad, "verified": bad == 0,
            "device": dev_name,
        }
        print(f"fullframe {scene_name:10s} [{key}, {kind}]: {tri.size} rays, "
              f"{d_idx.size} cross-tracer disputes -> oracle says "
              f"{int(exact.sum())} exact + {int(tie.sum())} fp-tie + "
              f"{int(graze.sum())} edge-graze + {bad} KERNEL-WRONG", flush=True)
    _merge_fullframe(out_dir, results, fresh=True)
    print(f"wrote {os.path.join(out_dir, FULLFRAME_FILE)}", flush=True)
    return results


def verify_ao_frame(scene_name: str = "knob", samples: int = 8, out_dir: str = OUT_DIR,
                    device="cuda", cache_dir: str | None = "bvhcache", width: int = FRAME_W,
                    height: int = FRAME_H, max_batch: int = 1 << 19) -> dict:
    """A device-verified secondary frame: an AO frame through the
    ``Renderer`` at ``samples`` with ``sort_secondary`` and ``max_batch``
    small enough for at least 3 batches (raygen, the batching cursor, the
    device sort, the any-hit kernel and the reassembly), each batch's
    hit / miss held to the wavefront's, disputes adjudicated by the oracle.
    Adds an "ao" entry to ``FULLFRAME.json``."""
    from tpu_rt_torch.renderer import Renderer, RendererParams

    scene, _ = _setup_scene(scene_name, cache_dir)
    cam = suite_camera(scene_name, scene)
    radius = suite_ao_radius(scene_name, scene)
    # max_batch counts OUTPUT rays: inputs per batch = max_batch // samples.
    r = Renderer(width, height, RendererParams(
        ray_type="ao", num_samples=samples, ao_radius=float(radius), sort_secondary=True,
        max_batch=max_batch, cache_dir=cache_dir, device=str(device)))
    r.set_scene(scene)
    stats = r.render_frame(cam)
    img = r.update_result()  # the reassembly, end to end
    batches = list(r._batches)
    if len(batches) < 3:
        raise AssertionError(f"want >=3 batches, got {len(batches)}")

    dbvh = device_bvh(r.flat, device)
    total = disputes = wrong = 0
    for b in batches:
        got = b.hits.tri.cpu().numpy()
        ref = trace_wavefront(dbvh, b.rays, any_hit=True).tri.cpu().numpy()
        d_idx = np.flatnonzero((got >= 0) != (ref >= 0))
        total += got.size
        disputes += int(d_idx.size)
        if d_idx.size:
            o, dn, tn, tx = (x.cpu().numpy()[d_idx] for x in b.rays)
            s_id, s_t, s_u, s_v = trace_flat_scalar(r.flat, o, dn, tn, tx)
            # The kernel is wrong only where it disagrees with the oracle
            # and the oracle's hit is not a border case (t within fp noise
            # of tmax, or an edge graze).
            kdis = (got[d_idx] >= 0) != (s_id >= 0)
            margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
            border = (s_id >= 0) & ((margin < 1e-3) | np.isclose(s_t, tx, rtol=2e-4))
            wrong += int(np.sum(kdis & ~border))
    entry = {
        "scene": scene_name, "ray_type": "ao", "samples": samples,
        "tracer": stats["tracer"], "batches": len(batches), "rays": int(total),
        "rays_metric": int(stats["total_rays"]),
        "cross_tracer_disputes": int(disputes),
        "kernel_wrong": int(wrong), "verified": wrong == 0,
        "image_nonempty": bool(np.any(img[..., :3] != img[0, 0, :3])),
        "device": device_name(torch.device(device)),
    }
    r.free()
    _merge_fullframe(out_dir, {"ao": entry}, fresh=False)
    print(f"ao fullframe {scene_name}: {len(batches)} batches, {total} rays, "
          f"{disputes} disputes -> {wrong} KERNEL-WRONG", flush=True)
    return entry


def main(argv=None, env=None):
    """The suite (or one of its modes) as the command line asks; returns
    the rows, the full-frame results or the AO entry."""
    env = os.environ if env is None else env
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*", help="scene:ray_type (default: the 19 ROWS)")
    ap.add_argument("--out", default=OUT_DIR, help=f"output directory (default {OUT_DIR})")
    ap.add_argument("--verify-full", action="store_true")
    ap.add_argument("--verify-ao", action="store_true")
    ap.add_argument("--regen-md", action="store_true",
                    help="rewrite SUITE.md from SUITE.json without tracing")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache-dir", default="bvhcache")
    args = ap.parse_args(argv)
    cache_dir = args.cache_dir or None
    width = int(env.get("BS_WIDTH", FRAME_W))
    height = int(env.get("BS_HEIGHT", FRAME_H))
    repeats = int(env.get("BS_REPEATS", 3))
    chain = int(env.get("BS_CHAIN", 32))
    json_path = os.path.join(args.out, SUITE_FILE)
    md_path = os.path.join(args.out, SUITE_MD)
    if args.verify_full:
        return verify_full(args.out, args.device, cache_dir, width, height)
    if args.verify_ao:
        return verify_ao_frame(out_dir=args.out, device=args.device, cache_dir=cache_dir,
                               width=width, height=height)
    if args.regen_md:
        with open(json_path) as f:
            results = json.load(f)
        model = fit_cost_model([r for r in results if "mrays" in r])
        write_suite_md(results, width, height, chain, model, path=md_path)
        print(f"regenerated {md_path}")
        return results
    rows = [tuple(a.split(":")) for a in args.rows] or ROWS
    os.makedirs(args.out, exist_ok=True)

    results = []
    for scene_name, ray_type in rows:
        try:
            r = bench_row(scene_name, ray_type, width, height, repeats, chain,
                          device=args.device, cache_dir=cache_dir,
                          tracer=env.get("BS_TRACER", "auto"),
                          ao_spec=env.get("BS_AO_RADIUS", "grt"))
            vsb = (f"(x{r['vs_baseline']:.3f} of {r['baseline']})"
                   if r.get("vs_baseline") is not None else "(non-baseline)")
            print(f"{scene_name:11s} {ray_type:8s} {r['mrays']:8.2f} Mray/s"
                  f"  {vsb}  [{r['tracer']}]", flush=True)
        except Exception as e:  # noqa: BLE001
            r = {"scene": scene_name, "ray_type": ray_type,
                 "error": f"{type(e).__name__}: {e}"}
            print(f"{scene_name:11s} {ray_type:8s} FAILED {r['error'][:100]}",
                  flush=True)
        results.append(r)
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()   # the row's tables, before the next scene
        with open(json_path, "w") as f:
            json.dump(results, f, indent=1)
    model = fit_cost_model([r for r in results if "mrays" in r])
    with open(json_path, "w") as f:
        json.dump(results, f, indent=1)
    write_suite_md(results, width, height, chain, model, path=md_path, repeats=repeats)
    print(f"wrote {md_path} + {json_path}", flush=True)
    return results


if __name__ == "__main__":
    main()
