"""Command-line benchmark app, the counterpart of ``tpu_rt.bench.cli`` (the
reference's FW::init + runBenchmark, src/framework/base/Main.cc:65-163,
src/rt/App.cc:137-210), with the same flags and behaviour and one more,
``--device``:

    python -m tpu_rt_torch.bench.cli --mesh=scene.obj --camera="<signature>" \\
        --sbvh-alpha=1e-5 --ao-radius=5 --samples=8 --sort=1 \\
        --warmup-repeats=2 --measure-repeats=10 --size=640x480 \\
        --ray-type=primary --scene=bunny --tracer=auto --log=out.log \\
        --image=out.ppm --device=cuda

Prints ``Results = <rate> M Rays/s`` exactly like the reference (App.cc:204),
the rate over the trace kernels' CUDA-event time.  ``--device cuda`` (the
default) launches the CUDA kernels, built at first use from the sources in
the checkout into the git-ignored ``build/``; ``--device cpu`` runs their
plain PyTorch versions.  ``--serve [PORT]`` starts the HTTP orbit viewer
(``tpu_rt_torch.bench.viewer``) instead of benchmarking; ``--grt-file`` /
``--grt-line`` replay a line of the reference's command cookbook.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time

import numpy as np

from tpu_rt_torch.core.math import to_abgr


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_rt_torch", description="CUDA wavefront ray-tracing benchmark"
    )
    # Reference flags (Main.cc:43-58).
    p.add_argument("--mesh", help="Mesh file (.obj) to benchmark")
    p.add_argument("--camera", action="append", default=[],
                   help="Camera signature (reference codec); repeatable")
    p.add_argument("--sbvh-alpha", type=float, default=1.0e-5,
                   help="Spatial split area threshold (default 1.0e-05)")
    p.add_argument("--ao-radius", type=float, default=5.0,
                   help="AO ray length (default 5)")
    p.add_argument("--samples", type=int, default=8,
                   help="Secondary rays per primary hit (default 8)")
    p.add_argument("--sort", type=int, default=0, choices=(0, 1),
                   help="Morton-sort secondary rays (default 0 — the "
                        "reference's committed benchmark forces the sort "
                        "off, App.cc:157, and it measures neutral for "
                        "the packet kernel)")
    p.add_argument("--warmup-repeats", type=int, default=2,
                   help="Warmup frames (default 2)")
    p.add_argument("--measure-repeats", type=int, default=10,
                   help="Measured frames (default 10)")
    # Advertised-but-dead reference flags, made real.
    p.add_argument("--log", help="Also append results to this log file")
    p.add_argument("--size", default="640x480", help="Frame size WxH (default 640x480)")
    # Hardcoded-in-reference knobs, promoted.
    p.add_argument("--ray-type", default="primary", choices=("primary", "ao", "diffuse"))
    p.add_argument("--scene", help="Procedural scene name (alternative to --mesh); "
                                   "see tpu_rt_torch.scene.procedural.suite_names()")
    p.add_argument("--tracer", default="auto", choices=("auto", "pallas", "xla"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default="bvhcache")
    p.add_argument("--image", help="Write the reconstructed frame (PPM or NPY)")
    p.add_argument("--json", action="store_true", help="Emit a JSON result line")
    # Interactive display path (the reference's GL window, App.cc:62-132,
    # re-imagined for a headless accelerator host: HTTP orbit viewer).
    p.add_argument("--serve", type=int, nargs="?", const=8787, default=None,
                   metavar="PORT",
                   help="Serve an interactive orbit viewer instead of "
                        "benchmarking (default port 8787)")
    # grtcmdline replay mode: run a reference command line verbatim
    # (grtcmdline.txt:1-61 — the reference's per-scene cookbook fed to
    # FW::init, Main.cc:86-158), proving drop-in CLI compatibility.
    p.add_argument("--grt-file",
                   help="Reference command cookbook (e.g. grtcmdline.txt); "
                        "replays one of its '--mesh=... --camera=...' lines")
    p.add_argument("--grt-line", type=int,
                   help="1-based flag-line index into --grt-file (omit to "
                        "list the lines)")
    p.add_argument("--mesh-root",
                   help="Directory to re-root the cookbook's --mesh paths "
                        "into (by basename); missing files fall back to the "
                        "procedural surrogate of the same scene")
    # The port's one flag of its own.
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="Device the frames run on: cuda launches the CUDA "
                        "kernels, cpu runs their plain PyTorch versions "
                        "(default cuda)")
    return p


# Reference scene-file stems -> procedural surrogate names (grtcmdline.txt
# mesh paths; surrogates match the scenes' triangle counts, README.md:46-58).
GRT_SURROGATES = {
    "conference": "conference", "fairyforest": "fairy",
    "sibenik": "sibenik", "sanmiguel": "sanmiguel",
    "testobj": "knob",  # scenes/rt_2/mori_knob/testObj.obj
    "dragon": "dragon", "hairball": "hairball", "bunny": "bunny",
    "sponza": "sponza",
}


def grt_flag_lines(path: str) -> list[str]:
    """The replayable flag lines of a reference command cookbook (lines
    starting with '--'; '##scene' headers and blanks are skipped)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip().startswith("--")]


def apply_grt(parser: argparse.ArgumentParser, args, argv: list[str]):
    """Re-parse: cookbook line first, the user's own argv after (so
    scalar user flags like --size/--ray-type override the line; the
    line's --camera stays the replay camera at index 0).  Then remap the
    line's --mesh: --mesh-root by basename if the file exists there,
    else the procedural surrogate for the scene stem."""
    lines = grt_flag_lines(args.grt_file)
    if args.grt_line is None:
        for i, ln in enumerate(lines, 1):
            print(f"{i:3d}: {ln}")
        raise SystemExit(f"{len(lines)} replayable lines; pick --grt-line=N")
    if not 1 <= args.grt_line <= len(lines):
        raise SystemExit(
            f"--grt-line must be 1..{len(lines)} for {args.grt_file}")
    tokens = shlex.split(lines[args.grt_line - 1])
    args = parser.parse_args(tokens + list(argv))
    if args.mesh:
        base = os.path.basename(args.mesh)
        if args.mesh_root:
            cand = os.path.join(args.mesh_root, base)
            if os.path.exists(cand):
                args.mesh = cand
                return args
        stem = os.path.splitext(base)[0].lower()
        surrogate = GRT_SURROGATES.get(stem)
        if surrogate is None:
            raise SystemExit(
                f"no local mesh for {args.mesh!r} and no procedural "
                f"surrogate for {stem!r}; pass --mesh-root with the file")
        print(f"grt replay: {args.mesh} -> procedural surrogate "
              f"{surrogate!r}")
        args.mesh = None
        args.scene = surrogate
    return args


def _frame_size(args) -> tuple[int, int]:
    try:
        width, height = (int(v) for v in args.size.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--size expects WxH, got {args.size!r}")
    return width, height


def _load_mesh(args):
    from tpu_rt_torch.scene import import_wavefront_mesh, procedural

    return (import_wavefront_mesh(args.mesh) if args.mesh
            else procedural.scene_by_name(args.scene))


def _renderer_params(args):
    from tpu_rt_torch.renderer import RendererParams

    return RendererParams(
        ray_type=args.ray_type, ao_radius=args.ao_radius,
        num_samples=args.samples, sort_secondary=bool(args.sort),
        seed=args.seed, cache_dir=args.cache_dir or None,
        tracer=args.tracer, device=args.device)


def run_viewer(args) -> None:
    from tpu_rt_torch.bench.viewer import ViewerState, serve
    from tpu_rt_torch.scene import Scene

    mesh = _load_mesh(args)
    width, height = _frame_size(args)
    serve(ViewerState(Scene(mesh), width, height, _renderer_params(args)),
          port=args.serve)


def run_benchmark(args) -> dict:
    from tpu_rt_torch.bvh import BuildParams
    from tpu_rt_torch.renderer import Renderer
    from tpu_rt_torch.scene import Camera, Scene

    if not args.mesh and not args.scene:
        raise SystemExit("specify --mesh=<file.obj> or --scene=<name>")
    width, height = _frame_size(args)

    t0 = time.time()
    scene = Scene(_load_mesh(args))
    print(f"Loaded scene: {scene.num_triangles} triangles, {scene.num_vertices} vertices "
          f"({time.time() - t0:.1f} s)")

    if args.camera:
        camera = Camera.decode_signature(args.camera[0])
    else:
        lo, hi = scene.bbox()
        camera = Camera.for_bbox(lo, hi)

    renderer = Renderer(width, height, _renderer_params(args))
    renderer.set_scene(scene)
    renderer.set_build_params(BuildParams(split_alpha=args.sbvh_alpha))

    for _ in range(args.warmup_repeats):
        renderer.render_frame(camera)

    rates = []
    stats = None
    for _ in range(args.measure_repeats):
        stats = renderer.render_frame(camera)
        rates.append(stats["mrays_per_s"])

    best = max(rates) if rates else 0.0
    total_rays = stats["total_rays"] if stats else 0
    # Reference output format (App.cc:204).
    print(f"Results = {best:.2f} M Rays/s")

    result = {
        "mrays_per_s": round(best, 3),
        "mean_mrays_per_s": round(float(np.mean(rates)), 3) if rates else 0.0,
        "total_rays": total_rays,
        "rays_traced_per_frame": stats["rays_traced"] if stats else 0,
        "ray_type": args.ray_type,
        "size": [width, height],
        "tris": scene.num_triangles,
        "tracer": renderer.active_tracer,
        "bvh": {
            "inner_nodes": renderer.bvh_stats.num_inner_nodes,
            "refs": renderer.bvh_stats.num_tris,
            "sah": round(renderer.bvh_stats.sah_cost, 3),
            "duplicates_pct": round(renderer.bvh_stats.duplicate_pct, 1),
        },
    }

    if args.image:
        img = renderer.update_result()
        if args.image.endswith(".npy"):
            np.save(args.image, img)
        else:
            _write_ppm(args.image, img)
        print(f"Wrote {args.image}")

    if args.log:
        with open(args.log, "a") as f:
            f.write(json.dumps(result) + "\n")
    if args.json:
        print(json.dumps(result))
    return result


def _write_ppm(path: str, img: np.ndarray) -> None:
    """P6 PPM from an [h,w,4] float image (no external image deps)."""
    u32 = to_abgr(img)
    r = (u32 & 0xFF).astype(np.uint8)
    g = ((u32 >> 8) & 0xFF).astype(np.uint8)
    b = ((u32 >> 16) & 0xFF).astype(np.uint8)
    rgb = np.stack([r, g, b], axis=-1)
    with open(path, "wb") as f:
        f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(rgb.tobytes())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.grt_file:
        args = apply_grt(parser, args, argv)
    if args.serve is not None:
        if not args.mesh and not args.scene:
            raise SystemExit("specify --mesh=<file.obj> or --scene=<name>")
        run_viewer(args)
        return 0
    run_benchmark(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
