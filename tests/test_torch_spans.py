"""The port's span recorder (``tpu_rt_torch.spans``) on one tiny AO frame of
the plain route, and the benchmark's readers of its spans."""

import collections
import gc
import json
import os
import sys

import pytest
import torch

import tpu_rt_torch
from rtbench import paths, run
from tpu_rt_torch import spans
from tpu_rt_torch.bench.workload import suite_ao_radius, suite_camera
from tpu_rt_torch.renderer import Renderer, RendererParams
from tpu_rt_torch.scene import Scene, procedural

# 768 primary slots, 4 samples, 1,024 rays a batch: 3 sorted AO batches.
W, H, SAMPLES, MAX_BATCH, BATCHES = 32, 24, 4, 1024, 3

# Each span of a frame and the spans that may enclose it (None: a root).
PARENTS = {
    "frame": None,
    "raygen.primary": {"frame"},
    "raygen.ao": {"frame"},
    "sort": {"frame"},
    "trace.primary": {"frame"},
    "trace.batch": {"frame"},
    "trace.launch": {"trace.primary", "trace.batch"},
    "raygen.wait": {"raygen.primary", "raygen.ao"},
    "sort.wait": {"sort"},
    "trace.wait": {"trace.primary", "trace.batch"},
    "frame.wait": {"frame"},
    "image": None,
    "image.wait": {"image"},
}
PHASE_SPANS = {"raygen": {"raygen.primary", "raygen.ao"}, "sort": {"sort"},
               "trace": {"trace.primary", "trace.batch"}, "reconstruct": {"image"}}
READERS = ("host_wait_ms.frame", "pretrace_ms.frame", "launch_us_per_call.trace")


def _boom(*args, **kwargs):
    raise AssertionError("the recorder read the clock or opened an annotation")


@pytest.fixture(scope="module")
def scene():
    return Scene(procedural.make_blob(700, seed=80))


def _frame(scene):
    """One AO frame and its image; returns the renderer and the frame's stats."""
    r = Renderer(W, H, RendererParams(ray_type="ao", num_samples=SAMPLES, max_batch=MAX_BATCH,
                                      sort_secondary=True,
                                      ao_radius=suite_ao_radius("bunny", scene),
                                      cache_dir=None, device="cpu"))
    r.set_scene(scene)
    r.render_frame(suite_camera("bunny", scene))  # the BVH's set-up
    stats = r.render_frame(suite_camera("bunny", scene))
    r.update_result()
    return r, stats


@pytest.fixture(scope="module")
def profiled(scene, tmp_path_factory):
    """The frame under ``torch.profiler`` (CPU): the recorder's snapshot, the
    exported Chrome trace's events and the frame's stats."""
    spans.reset()
    r = Renderer(W, H, RendererParams(ray_type="ao", num_samples=SAMPLES, max_batch=MAX_BATCH,
                                      sort_secondary=True,
                                      ao_radius=suite_ao_radius("bunny", scene),
                                      cache_dir=None, device="cpu"))
    r.set_scene(scene)
    cam = suite_camera("bunny", scene)
    r.render_frame(cam)
    # One intra-op thread: no pool threads spinning beside the host code
    # whose clock readings are compared with the profiler's; and no garbage
    # collection, whose pauses can fall between a span's clock reading and
    # the profiler's stamp.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            stats = r.render_frame(cam)
            r.update_result()
    finally:
        gc.enable()
        torch.set_num_threads(threads)
    snap = spans.snapshot()
    spans.reset()
    path = str(tmp_path_factory.mktemp("spans") / "frame.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events["traceEvents"]
    return snap, events, stats


def test_off_records_nothing(scene, monkeypatch):
    """Off, a span opens no annotation and records nothing; the clock is read
    only by the timed spans that keep ``phase_s`` and ``setup_s``, one pair
    each."""
    spans.disable()
    spans.reset()
    reads, timers = [], []
    clock = spans._clock
    monkeypatch.setattr(spans, "_clock", lambda: reads.append(1) or clock())
    monkeypatch.setattr(spans, "_annotate", _boom)

    class Timer(spans._Timer):
        def __enter__(self):
            timers.append(self)
            return super().__enter__()

    monkeypatch.setattr(spans, "_Timer", Timer)
    assert spans.span("frame") is spans._OFF
    r, stats = _frame(scene)
    assert spans.snapshot() == {"spans": [], "counters": {}}
    assert len(reads) == 2 * len(timers) > 0
    assert stats["batches"] == BATCHES
    assert set(r.phase_s) == set(PHASE_SPANS)
    assert all(v > 0 for v in r.phase_s.values())


def test_profiled_frame_records_every_span(profiled):
    snap, _, stats = profiled
    recs = snap["spans"]
    names = collections.Counter(r[0] for r in recs)
    assert set(names) == set(PARENTS)
    assert names["frame"] == names["trace.primary"] == names["image"] == 1
    assert stats["batches"] == BATCHES
    # One raygen.ao per next_batch call: the batches, then the call that
    # finds the input used up.
    assert names["raygen.ao"] == BATCHES + 1
    assert names["sort"] == names["trace.batch"] == BATCHES
    assert names["trace.launch"] == names["trace.wait"] == BATCHES + 1
    for name, parent, t0, t1 in recs:
        assert t1 is not None and t0 <= t1
        if PARENTS[name] is None:
            assert parent == -1, name
            continue
        p_name, _, p0, p1 = recs[parent]
        assert p_name in PARENTS[name], (name, p_name)
        assert p0 <= t0 and t1 <= p1, name
    assert snap["counters"] == {}


def test_profiler_trace_holds_each_span(profiled):
    """Each span is a ``user_annotation`` of the same name, nested the same
    way, lasting as long within 50 us + 5%."""
    snap, events, _ = profiled
    recs = snap["spans"]
    ann = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in PARENTS:
            ann[e["name"]].append(e)
    match = {}
    for name in PARENTS:
        mine = sorted((i for i, r in enumerate(recs) if r[0] == name), key=lambda i: recs[i][2])
        theirs = sorted(ann[name], key=lambda e: float(e["ts"]))
        assert len(mine) == len(theirs), name
        match.update(zip(mine, theirs))
    for i, (name, parent, t0, t1) in enumerate(recs):
        a = match[i]
        own_us = (t1 - t0) / 1e3
        assert abs(float(a["dur"]) - own_us) <= 50 + 0.05 * own_us, name
        if parent >= 0:
            b = match[parent]
            a0, a1 = float(a["ts"]), float(a["ts"]) + float(a["dur"])
            b0, b1 = float(b["ts"]), float(b["ts"]) + float(b["dur"])
            assert b0 <= a0 + 1 and a1 <= b1 + 1, (name, recs[parent][0])


def test_phase_s_is_the_sum_of_its_spans(scene, monkeypatch):
    """With ``enable()`` and no profiler: records, opens no annotation, and
    each phase's spans add up to ``phase_s`` within 1%."""
    monkeypatch.setattr(spans, "_annotate", _boom)
    spans.reset()
    spans.enable()
    try:
        r, _ = _frame(scene)
    finally:
        spans.disable()
    recs = spans.snapshot()["spans"]
    spans.reset()
    # Only the second frame's spans: after the last "frame" root opened.
    last = max(i for i, rec in enumerate(recs) if rec[0] == "frame")
    recs = recs[last:]
    for phase, names in PHASE_SPANS.items():
        total = sum((rec[3] - rec[2]) * 1e-9 for rec in recs if rec[0] in names)
        assert total == pytest.approx(r.phase_s[phase], rel=0.01), phase


def test_cap_counts_dropped(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 2)
    spans.reset()
    spans.enable()
    try:
        with spans.span("a"):
            with spans.span("b"):
                with spans.span("c", timed=True) as c:
                    pass
        with spans.span("d"):
            pass
    finally:
        spans.disable()
    snap = spans.snapshot()
    assert [r[:2] for r in snap["spans"]] == [("a", -1), ("b", 0)]
    assert snap["counters"] == {"spans.dropped": 2}
    assert c.seconds >= 0  # a dropped span still times its block
    spans.reset()
    assert spans.snapshot() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("on", [False, True])
def test_timed_span_gives_seconds(monkeypatch, on):
    """On or off, a timed span's ``seconds`` is its one pair of clock
    readings; on, the same pair is its record."""
    ticks = iter([1_000, 251_000])
    monkeypatch.setattr(spans, "_clock", lambda: next(ticks))
    spans.reset()
    if on:
        spans.enable()
    try:
        with spans.span("x", timed=True) as s:
            pass
    finally:
        spans.disable()
    assert s.seconds == pytest.approx(250e-6)
    assert spans.snapshot()["spans"] == ([("x", -1, 1_000, 251_000)] if on else [])
    spans.reset()


def test_reset_forgets_open_spans():
    spans.reset()
    spans.enable()
    try:
        with spans.span("outer"):
            spans.reset()
            with spans.span("inner"):
                pass
    finally:
        spans.disable()
    recs = spans.snapshot()["spans"]
    spans.reset()
    assert [r[:2] for r in recs] == [("inner", -1)] and recs[0][3] is not None


# -- the benchmark's readers -------------------------------------------------

MS = 1_000_000
FRAME_SNAP = [
    ("frame", -1, 0, 10 * MS),
    ("raygen.primary", 0, 0, 1 * MS),
    ("raygen.wait", 1, 900_000, 1 * MS),                 # 0.1 ms
    ("trace.primary", 0, 1 * MS, 1_500_000),             # 0.5 ms
    ("trace.launch", 3, 1 * MS, 1_040_000),
    ("trace.wait", 3, 1_100_000, 1_500_000),             # 0.4 ms
    ("frame.wait", 0, 9 * MS, 10 * MS),                  # 1.0 ms
    ("frame", -1, 20 * MS, 30 * MS),
    ("trace.primary", 7, 20 * MS, 20_700_000),           # 0.7 ms
    ("trace.wait", 8, 20_200_000, 20_700_000),           # 0.5 ms
    ("image", -1, 30 * MS, 32 * MS),
    ("image.wait", 10, 30_500_000, 32 * MS),             # 1.5 ms
    ("frame", -1, 40 * MS, None),                        # still open: not counted
]
TRACE_SNAP = [
    ("trace.launch", -1, 0, 30_000),                     # 30 us
    ("trace.launch", -1, 100_000, 150_000),              # 50 us
    ("setup.kernel_load", 1, 110_000, 120_000),
    ("trace.launch", -1, 200_000, None),
]
TRACED = {"spans": {}, "counters": {}, "trace": {"window_s": 5.0, "busy_s": 4.9}}


def _reader(name):
    return run.load_module("metrics", name)


@pytest.mark.parametrize("name, snap, want", [
    ("host_wait_ms.frame", FRAME_SNAP, (0.1 + 0.4 + 1.0 + 0.5 + 1.5) / 2),
    ("pretrace_ms.frame", FRAME_SNAP, (0.5 + 0.7) / 2),
    ("launch_us_per_call.trace", TRACE_SNAP, (30 + 50) / 2),
])
def test_reader_value(monkeypatch, name, snap, want):
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": snap, "counters": {}})
    assert _reader(name).read(TRACED) == pytest.approx(want)


@pytest.mark.parametrize("name, snap", [
    ("host_wait_ms.frame", []), ("host_wait_ms.frame", TRACE_SNAP),
    ("pretrace_ms.frame", []), ("pretrace_ms.frame", TRACE_SNAP),
    ("launch_us_per_call.trace", []), ("launch_us_per_call.trace", FRAME_SNAP),
])
def test_reader_silent_without_its_spans(monkeypatch, name, snap):
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": snap, "counters": {}})
    assert _reader(name).read(TRACED) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_silent_on_a_cut_window(monkeypatch, name):
    """A window that filled the recorder has lost spans: nothing to read."""
    snap = FRAME_SNAP if name.endswith(".frame") else TRACE_SNAP
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"spans": snap, "counters": {"spans.dropped": 1}})
    assert _reader(name).read(TRACED) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_silent_without_traced_window_or_recorder(monkeypatch, name):
    snap = FRAME_SNAP if name.endswith(".frame") else TRACE_SNAP
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": snap, "counters": {}})
    assert _reader(name).read(dict(TRACED, trace={})) is None
    # A program without the recorder (an older checkout).
    monkeypatch.delattr(tpu_rt_torch, "spans")
    monkeypatch.setitem(sys.modules, "tpu_rt_torch.spans", None)
    assert _reader(name).read(TRACED) is None


def test_benchmark_entries_name_files():
    bench = run.load_json(paths.ROOT, "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_span"
        assert os.path.exists(os.path.join(paths.BENCH_DIR, "metrics", f"{name}.py"))
    assert entries["launch_us_per_call.trace"]["workloads"] == ["conference-ao8",
                                                                "dragon-primary",
                                                                "sanmiguel-diffuse",
                                                                "hairball-primary"]
    for name in ("host_wait_ms.frame", "pretrace_ms.frame"):
        assert entries[name]["workloads"] == ["conference-ao8-frames", "sanmiguel-diffuse-frames"]
