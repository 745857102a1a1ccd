"""A cell at a size the CPU tests can run: the same configuration, mix
and limits, with a few thousand triangles, a 32 x 24 frame and two poses.
Importing this module also shrinks the drivers' judged samples and timed
host calls, for every run in the process."""

from __future__ import annotations

from rtbench import paths, run

CELLS = ("conference-ao8", "dragon-primary", "conference-ao8-frames")
SEED = 4_000_000_001

_trace = run.load_module("drivers", "trace")
_trace.CHECK_RAYS, _trace.HOST_CALLS = 64, 3
run.load_module("drivers", "frames").CHECK_PIXELS = 64


def spec(cell: str, tris: int = 3000) -> dict:
    s = run.resolve(run.load_json(paths.ROOT, "BENCHMARK.json"), cell)
    gen = s["config"]["generator"]
    s["config"] = dict(s["config"], generator=dict(gen, args=dict(gen["args"], target_tris=tris)))
    s["mix"] = dict(s["mix"], width=32, height=24, poses=2, max_batch=4096)
    return s


def line(cell: str, trace: bool = False, fault=None, seed: int = SEED) -> dict:
    return run.run_cell(spec(cell), seed, 0.3, trace, device="cpu", fault=fault)
