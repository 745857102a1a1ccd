"""A traced window: ``torch.profiler`` over CPU and CUDA, its Chrome trace
read back into what the per-layer readers and the line's ``breakdown``
need.

``summary``:
- ``window_s``: the traced window's wall time (host clock);
- ``busy_s``: the union of the device's operation intervals (kernels,
  memcpy, memset), 0 when the trace holds none (a CPU run);
- ``device_ops``: seconds by operation name;
- ``idle_gaps``: the gaps between device operations, each named by the
  innermost host operation running at its middle, seconds by that name.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from rtbench import paths

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "user_annotation"}
NEST = 32


class Profile:
    def __init__(self, device):
        self.device = device
        self.summary: dict = {}

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        os.makedirs(paths.TRACE_DIR, exist_ok=True)
        path = os.path.join(paths.TRACE_DIR, "window.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        self.summary = summarize(events, window)
        return False


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of sorted starts."""
    out_s, out_e = [], []
    for s, e in zip(starts, ends):
        if out_e and s <= out_e[-1]:
            out_e[-1] = max(out_e[-1], e)
        else:
            out_s.append(s)
            out_e.append(e)
    return np.asarray(out_s), np.asarray(out_e)


def summarize(events: list, window_s: float) -> dict:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    ops: dict = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    out = {"window_s": window_s, "busy_s": 0.0, "device_ops": ops, "idle_gaps": {}}
    if not dev:
        return out
    ts = np.array([float(e["ts"]) for e in dev])
    te = ts + np.array([float(e["dur"]) for e in dev])
    order = np.argsort(ts)
    s, e = _union(ts[order], te[order])
    out["busy_s"] = float((e - s).sum()) * 1e-6
    # Idle gaps between device work, each named by the innermost host op
    # running at its middle: the latest-starting op that still runs there
    # (ops nest a few deep, so the last NEST that started are searched).
    gap_s, gap_e = e[:-1], s[1:]
    if host and gap_s.size:
        order = np.argsort([float(x["ts"]) for x in host])
        hs = np.array([float(host[i]["ts"]) for i in order])
        he = hs + np.array([float(host[i]["dur"]) for i in order])
        names = np.array([host[i]["name"] for i in order] + ["host (no op)"])
        mid = 0.5 * (gap_s + gap_e)
        last = np.searchsorted(hs, mid, side="right") - 1
        label = np.full(mid.shape, len(host))
        for k in range(NEST):
            cand = last - k
            hit = (label == len(host)) & (cand >= 0) & (he[np.maximum(cand, 0)] >= mid)
            label[hit] = cand[hit]
        gaps: dict = {}
        for name, dur in zip(names[label], (gap_e - gap_s) * 1e-6):
            gaps[str(name)] = gaps.get(str(name), 0.0) + float(dur)
        out["idle_gaps"] = gaps
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
