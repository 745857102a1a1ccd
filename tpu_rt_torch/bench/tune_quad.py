"""Per-scene leaf width of the 4-wide BVH, measured on the card, recorded
in the port's tune file.

Counterpart of ``tools/tune_quad.py``: the leaf-width knee is scene-shaped,
so the static ``quad_policy`` rule (16, or 32 past the budget) can leave a
faster width unused.  For each candidate width this collapses the scene's
SBVH (``load_or_collapse_quad``), uploads the tables at the default budget
(``upload_quad``), traces the suite's primary rays (``suite_camera``,
640x480) ``chain`` times and times the quad kernel with CUDA events; the
best of ``repeats`` chains gives ms per frame.  The fastest width goes to
the port's tune file (``tpu_rt_torch.trace.tables._tune_path``, beside the
quad cache), which ``quad_policy`` reads in every later process.  A width
that ``tpu_rt``'s tool recorded is never read or written here.

    python -m tpu_rt_torch.bench.tune_quad [scenes...] --candidates 16,32 \\
        --chain 16 --repeats 3 --cache-dir bvhcache --device cuda

Without scenes it tunes dragon, hairball and sanmiguel, as the tool does;
without ``--candidates`` it measures the static width and
``min(2 x static, 127)``.  ``--device cpu`` times the plain PyTorch
version on the host clock; that run only serves the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from tpu_rt_torch.bench.workload import FRAME_H, FRAME_W, suite_camera
from tpu_rt_torch.bvh import load_or_build_bvh, load_or_collapse_quad
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import StackDepthError, trace_quad, upload_quad
from tpu_rt_torch.trace.tables import MAX_LEAF_LINK, TABLE_BUDGET, _tune_path, quad_policy

DEFAULT_SCENES = ("dragon", "hairball", "sanmiguel")


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (torch's name when
    nvidia-smi does not answer), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={index}"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)


def _chain_ms(tables, rays, chain: int, repeats: int, device: torch.device) -> float:
    """Best of ``repeats`` chains of ``chain`` closest-hit traces, in ms
    per trace: CUDA events on the card, the host clock on the CPU."""
    def run():
        for _ in range(chain):
            trace_quad(tables, rays)

    run()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            run()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / chain)
    return best


def tune(name: str, candidates=None, chain: int = 16, repeats: int = 3,
         cache_dir: str = "bvhcache", device="cuda", width: int = FRAME_W,
         height: int = FRAME_H) -> dict | None:
    """Measure each leaf width of ``name``'s 4-wide BVH on ``device`` and
    record the fastest in the port's tune file under ``cache_dir``.  Each
    width is collapsed and uploaded as given (``quad_policy``, which would
    read an existing tune file, only gives the default candidates).
    A width whose tree is too deep for the kernel's stack is skipped.
    Returns the record written (None when no width could be traced).
    ``width`` x ``height`` is the frame; the command line keeps 640x480."""
    device = torch.device(device)
    scene = Scene(procedural.scene_by_name(name))
    flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
    if candidates is None:
        base = quad_policy(flat, None, TABLE_BUDGET)  # the static rule
        candidates = sorted({base, min(base * 2, MAX_LEAF_LINK)})
    candidates = [int(c) for c in candidates]
    for c in candidates:
        if not 1 <= c <= MAX_LEAF_LINK:
            raise ValueError(f"leaf width {c} not in [1, {MAX_LEAF_LINK}]")
    rays, _, _ = RayGen().primary(suite_camera(name, scene), width, height, device=device)
    ms = {}
    for lm in candidates:
        quad = load_or_collapse_quad(flat, leaf_max=lm, cache_dir=cache_dir)
        try:
            tables = upload_quad(quad, device)
        except StackDepthError as e:
            print(f"{name} leaf{lm}: {e}", flush=True)
            continue
        ms[lm] = _chain_ms(tables, rays, chain, repeats, device)
        print(f"{name} leaf{lm}: {ms[lm]:8.4f} ms/frame "
              f"({rays.num / (ms[lm] * 1e3):.2f} Mray/s)", flush=True)
    if not ms:
        return None
    best = min(ms, key=ms.get)
    record = {"scene": name, "leaf_max": best, "best_ms": ms[best],
              "ms": {str(k): v for k, v in ms.items()}, "candidates": candidates,
              "device": device_name(device)}
    path = _tune_path(flat, cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)
    print(f"{name}: tuned leaf_max={best} -> {path}", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="*", default=list(DEFAULT_SCENES),
                    help="procedural scenes to tune (default dragon hairball sanmiguel)")
    ap.add_argument("--candidates",
                    help="comma list of leaf widths (default: the static width and twice it)")
    ap.add_argument("--chain", type=int, default=16, help="traces per timed chain (default 16)")
    ap.add_argument("--repeats", type=int, default=3, help="timed chains (default 3)")
    ap.add_argument("--cache-dir", default="bvhcache")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cands = [int(x) for x in args.candidates.split(",")] if args.candidates else None
    for name in args.scenes:
        tune(name, cands, args.chain, args.repeats, args.cache_dir, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
