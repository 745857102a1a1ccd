"""Run one benchmark cell and print its result as the last line.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``rtbench/configs/<config>.json``) and a traffic mix
(``rtbench/traffic/<mix>.json``), whose ``driver`` names
``rtbench/drivers/<driver>.py``; each per-layer metric is read by
``rtbench/metrics/<metric>.py``; the limits of the comparison that decides
``correct`` are in ``rtbench/limits/<cell>.json``.

A run needs the CUDA card (no fallback to the CPU); it sets up the scene,
the port's tree and kernels and the cell's work, warms every shape, then
measures for ``--seconds``.  With ``--trace 1`` it then traces a window of
at most ``TRACED_S`` seconds under ``torch.profiler`` and prints the
per-layer metrics in place of the end-to-end ones.  Once the windows are
over it reads the peak memory, frees the program's state, and judges a
sample of the window's answers drawn from the seed against the plain
reference (``rtbench/reference/``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from rtbench import paths  # noqa: E402

TRACED_S = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_rt")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``rtbench/<kind>/<name>.py`` as a module (names may hold dots), loaded
    once a process: a driver imported by its own name is the same module."""
    path = os.path.join(paths.BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"rtbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell, its configuration, mix, limits and metrics, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": load_json(paths.ROOT, conf["file"]),
        "mix": load_json(paths.BENCH_DIR, "traffic", f"{cell['traffic']}.json"),
        "limits": load_json(paths.BENCH_DIR, "limits", f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if workload in m.get("workloads",
                                                                             [workload])],
        "per_layer": [m for m in bench["per_layer"] if workload in m.get("workloads",
                                                                           [workload])],
    }


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault=None) -> dict:
    """Set up, measure, judge; returns the result line as a dict.
    ``fault`` (tests) wraps the driver after its set-up to break the timed
    path."""
    import numpy as np
    import torch

    cfg, mix = spec["config"], spec["mix"]
    spans: dict = {}
    counters: dict = {}
    driver = load_module("drivers", mix["driver"]).Driver(cfg, mix, seed, device, spans,
                                                          counters)
    driver.prepare()
    if fault is not None:
        fault(driver)
    setup_s = time.perf_counter() - T0
    e2e = driver.window(seconds)
    e2e["setup_s"] = setup_s
    rec = {"spans": spans, "counters": counters, "trace": {}}
    if trace:
        driver.traced(min(float(seconds), TRACED_S), rec)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    items, answers = driver.outputs()
    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = driver.reference_scene(torch.float64, device)
    gaps = driver.judge(ref, items, answers)
    units = driver.units(items)
    checks, bad = {}, np.zeros(len(units), bool)
    for name, limit in spec["limits"].items():
        g = gaps[name]
        checks[name] = {"value": float(g.max()), "limit": float(limit)}
        bad |= g > limit
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = load_module("metrics", m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
           "count": int(spec["cell"]["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = float(rec["trace"].get("busy_s", 0.0))
        dev["window_s"] = float(rec["trace"].get("window_s", 0.0))
    line = {"correct": bool(correct), "attempted": int(driver.attempted),
            "failed": int(len(np.unique(units[bad]))), "metrics": metrics, "device": dev}
    if trace:
        from rtbench.profile import top

        line["breakdown"] = {"device_ops": top(rec["trace"].get("device_ops", {})),
                             "idle_gaps": top(rec["trace"].get("idle_gaps", {}))}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in paths.CACHE_ENV.items():
        os.environ[k] = v
    try:
        spec = resolve(load_json(paths.ROOT, "BENCHMARK.json"), args.workload)
        import tpu_rt_torch  # noqa: F401  (the program under test)
    except (OSError, KeyError, ImportError) as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # One process, one intra-op thread: the measured paths run on the card.
    torch.set_num_threads(1)
    line = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"rtbench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    limit = power_limit()
    if limit:
        line["device"]["power"] = limit
        line["checks"] = line.pop("checks")
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
