"""Readings that the limits of ``rtbench/limits/<cell>.json`` are set from.

    python3 -m rtbench.calibrate --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 2] [--control N] [--device cuda]

For each seed, in one process (what a driver's set-up leaves in
``shared`` is set up once: the trace cells' scene, tree and kernels, the
frame cells' scene): the cell's work is made from the seed, a short window of
``--seconds`` runs as in a benchmark run, and the judge reads the program's
answers (the lower readings).  On the first ``--control`` seeds the
control (the reference in bfloat16, ``reference/control.py``) answers the
same items and the judge reads it too (the upper readings).  One JSON line per seed: the
largest gap of each compared number, and the judge's seconds.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from rtbench import paths, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0, metavar="N",
                    help="run the control on the first N seeds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.resolve(run.load_json(paths.ROOT, "BENCHMARK.json"), args.workload)
    print(json.dumps(calibrate(spec, args.seeds, args.seconds, args.control, args.device,
                               emit=lambda r: print(json.dumps(r), flush=True))))
    return 0


def calibrate(spec: dict, seeds, seconds: float, control: int, device: str, emit=None):
    """Per-seed readings; returns the largest program reading and the
    smallest control reading of each compared number."""
    import torch

    cfg, mix = spec["config"], spec["mix"]
    cls = run.load_module("drivers", mix["driver"]).Driver
    shared = None
    refs = {}
    lower, upper = {}, {}
    for i, seed in enumerate(seeds):
        spans, counters = {}, {}
        d = cls(cfg, mix, seed, device, spans, counters, shared=shared)
        d.prepare()
        shared = d.shared
        d.window(seconds)
        items, answers = d.outputs()
        d.free()
        gc.collect()
        if 64 not in refs:
            refs[64] = d.reference_scene(torch.float64, device)
        t0 = time.perf_counter()
        row = {"seed": seed, "program": {k: float(v.max())
                                         for k, v in d.judge(refs[64], items, answers).items()}}
        row["judge_s"] = time.perf_counter() - t0
        for k, v in row["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        if i < control:
            t0 = time.perf_counter()
            if 16 not in refs:
                refs[16] = d.reference_scene(torch.bfloat16, device)
            theirs = d.control(refs[16], items)
            row["control"] = {k: float(v.max())
                              for k, v in d.judge(refs[64], items, theirs).items()}
            row["control_s"] = time.perf_counter() - t0
            for k, v in row["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        if emit:
            emit(row)
    return {"lower": lower, "upper": upper, "seeds": list(seeds)}


if __name__ == "__main__":
    sys.exit(main())
