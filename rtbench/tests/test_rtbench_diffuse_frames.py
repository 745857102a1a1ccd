"""The diffuse frame cell, ``sanmiguel-diffuse-frames``, on the CPU: the
port's sorted diffuse frames at a tiny size (``rtbench.tests.tiny``, with
the port's plain versions) against the float64 diffuse frame reference
(``rtbench/reference/diffuse_frames.py``), the faults its judge must
catch, the control; the traced line's readers; and the renderer's
``frame_stats``, whose counters the cell's stats pass reads."""

import math

import numpy as np
import pytest
import torch

from rtbench import calibrate, paths, run
from rtbench.reference import diffuse_frames
from rtbench.tests import tiny
from tpu_rt_torch import spans
from tpu_rt_torch.bench import workload as port_workload
from tpu_rt_torch.rays.buffer import LIVE_PAD
from tpu_rt_torch.renderer import Renderer, RendererParams
from tpu_rt_torch.scene import Scene
from tpu_rt_torch.scene import procedural as port_procedural
from tpu_rt_torch.trace.common import warp_work

CELL = "sanmiguel-diffuse-frames"
COUNTERS = ("trace.stats_rays", "trace.node_tests", "trace.tri_tests", "trace.warp_tests",
            "trace.stack_entries")
NEW_READERS = ("tests_per_ray.frame", "simt_efficiency.frame", "trace_kernels_roofline.frame")
FRAME_READERS = ("raygen_ms.frame", "sort_ms.frame", "trace_ms.frame", "reconstruct_ms.frame",
                 "device_idle_pct.frame", "setup.renderer_s", "host_wait_ms.frame",
                 "pretrace_ms.frame")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny plain traces gain nothing from more,
    and beside the other test workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frame_cell():
    """The cell's driver, set up at the tiny size, and the float64 reference
    scene: shared by the checks that run its window again."""
    spec = tiny.spec(CELL)
    driver = run.load_module("drivers", spec["mix"]["driver"]).Driver(
        spec["config"], spec["mix"], tiny.SEED, "cpu", {}, {})
    driver.prepare()
    return spec, driver, driver.reference_scene(torch.float64, "cpu")


def _judged(driver, ref) -> dict:
    driver.window(0.01)
    items, pixels = driver.outputs()
    return {k: float(v.max()) for k, v in driver.judge(ref, items, pixels).items()}


def test_cell_and_mix_are_the_diffuse_frame_settings():
    bench = run.load_json(paths.ROOT, "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("sanmiguel-frames", "diffuse-frames", 1)
    mix = run.load_json(paths.BENCH_DIR, "traffic", "diffuse-frames.json")
    assert mix == {"driver": "diffuse_frames", "ray_type": "diffuse", "samples": 8,
                   "sort_secondary": True, "width": 640, "height": 480, "poses": 8,
                   "max_batch": 2097152}
    # The frame deployment renders the diffuse trace cell's scene, so both
    # share the mesh and SBVH caches; its renderer settings are the mix's.
    conf = run.load_json(paths.BENCH_DIR, "configs", "sanmiguel-frames.json")
    scene = run.load_json(paths.BENCH_DIR, "configs", "sanmiguel.json")
    shared = ("scene", "generator", "triangles", "precision", "tracer", "camera", "reduced")
    assert {k: conf[k] for k in shared} == {k: scene[k] for k in shared}
    assert conf["source"] != scene["source"]
    assert {k: conf["renderer"][k] for k in ("ray_type", "samples", "sort_secondary", "width",
                                            "height")} == \
        {k: mix[k] for k in ("ray_type", "samples", "sort_secondary", "width", "height")}
    # The frame cell's loop and the diffuse cell's rays.
    frames = run.load_json(paths.BENCH_DIR, "traffic", "ao8-frames.json")
    trace = run.load_json(paths.BENCH_DIR, "traffic", "diffuse-trace.json")
    assert {k: v for k, v in mix.items() if k not in ("driver", "ray_type")} == \
        {k: v for k, v in frames.items() if k not in ("driver", "ray_type")}
    assert {k: v for k, v in mix.items() if k not in ("driver", "sort_secondary")} == \
        {k: v for k, v in trace.items() if k not in ("driver", "sort_secondary")}
    driver = run.load_module("drivers", "diffuse_frames")
    assert issubclass(driver.Driver, run.load_module("drivers", "frames").Driver)


def test_benchmark_lists_the_cell():
    bench = run.load_json(paths.ROOT, "BENCHMARK.json")
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in NEW_READERS:
        m = metrics[name]
        assert (m["layer"], m["moves"], m["workloads"]) == ("trace kernels", "frame_ms", [CELL])
    assert metrics["trace_kernels_roofline.frame"]["source"] == "device_trace"
    for name in ("frame_ms", "frame_ms_p95") + FRAME_READERS:
        assert metrics[name]["workloads"] == ["conference-ao8-frames", CELL]
    listed = {m["name"] for m in metrics.values() if CELL in m.get("workloads", [CELL])}
    assert listed == {"frame_ms", "frame_ms_p95", "setup_s", *NEW_READERS, *FRAME_READERS}


@pytest.mark.parametrize("seed", [tiny.SEED, 2**31 + 977])
def test_line_correct(seed):
    line = tiny.line(CELL, seed=seed)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_sorted_frames_within_the_limit(frame_cell):
    spec, driver, ref = frame_cell
    r = driver.renderer
    assert r.params.sort_secondary and r.params.ray_type == "diffuse"
    far = np.float32(driver.cams[0]["far"])
    # The tiny frame makes two batches, each of camera-far rays.
    assert [b.rays.num for b in r._batches] == [4096, 32 * 24 * 8 - 4096]
    for b in r._batches:
        assert ((b.rays.tmax == far) | (b.rays.tmax == -1.0)).all()
    got = _judged(driver, ref)
    assert set(got) == set(spec["limits"])
    assert all(got[k] <= limit for k, limit in spec["limits"].items()), got


def _after_each_batch(edit):
    """A fault that edits each secondary batch's hits after its trace."""
    def plant(renderer):
        trace_batch = renderer.trace_batch

        def broken():
            out = trace_batch()
            edit(renderer, renderer._batch)
            return out
        renderer.trace_batch = broken
    return plant


def _miss(batch, gone):
    h = batch.hits
    batch.hits = h._replace(tri=torch.where(gone, -1, h.tri), t=torch.where(gone, batch.rays.tmax,
                                                                            h.t))


def _every_fifth_a_miss(renderer, batch):
    _miss(batch, torch.arange(batch.rays.num) % 5 == 0)


def _half_the_second_batch_untraced(renderer, batch):
    if len(renderer._batches) == 2:
        _miss(batch, torch.arange(batch.rays.num) >= batch.rays.num // 2)


def _any_hit_answers(renderer):
    trace_batch = renderer.trace_batch

    def broken():
        route = renderer.routing
        renderer.routing = lambda tables, rays, any_hit=False, **kw: route(tables, rays, True,
                                                                           **kw)
        try:
            return trace_batch()
        finally:
            renderer.routing = route
    renderer.trace_batch = broken


def _primary_material_dropped(renderer):
    renderer._tri_material_dev = torch.ones_like(renderer._tri_material_dev)


FAULTS = {"every_fifth_sample_a_miss": _after_each_batch(_every_fifth_a_miss),
          "any_hit_answers": _any_hit_answers,
          "primary_material_dropped": _primary_material_dropped,
          "half_the_second_batch_untraced": _after_each_batch(_half_the_second_batch_untraced)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_over_the_limit(frame_cell, fault):
    spec, driver, ref = frame_cell
    r = driver.renderer
    material = r._tri_material_dev
    FAULTS[fault](r)
    try:
        got = _judged(driver, ref)
    finally:
        r.__dict__.pop("trace_batch", None)
        r._tri_material_dev = material
    assert got["pixel_gap"] > spec["limits"]["pixel_gap"], got


def test_control_fails_on_three_seeds():
    spec = tiny.spec(CELL)
    got = calibrate.calibrate(spec, [11, 12, 13], 0.05, 3, "cpu")
    assert got["lower"]["pixel_gap"] <= spec["limits"]["pixel_gap"]
    assert got["upper"]["pixel_gap"] > spec["limits"]["pixel_gap"]


def test_choice_gap_takes_the_cheapest_level():
    """Two samples, a pixel of value 0.55: the cheapest choices (0.2 and
    0.4) make 0.3; taking the second sample's 0.7, which costs 0.01, makes
    0.45, 0.1 short; taking the first sample's 0.9 too (cost 0.05) makes
    the value itself."""
    inf = math.inf
    cost = torch.tensor([[[0.0, 0.05], [0.0, 0.01]]], dtype=torch.float64)
    colour = torch.tensor([[[0.2, 0.9], [0.4, 0.7]]], dtype=torch.float64)[..., None].expand(
        1, 2, 2, 4)
    value = torch.full((1, 4), 0.55, dtype=torch.float64)
    one = torch.ones((1, 4), dtype=torch.float64)
    got = diffuse_frames.choice_gap(cost, colour, one, value)
    assert got.item() == pytest.approx(0.05)
    # Costlier choices only: the colour's distance counts.
    got = diffuse_frames.choice_gap(cost.clone().index_fill_(2, torch.tensor([1]), inf), colour,
                                    one, value)
    assert got.item() == pytest.approx(0.25)
    # The material scales the intervals.
    got = diffuse_frames.choice_gap(cost, colour, one * 0.5, value * 0.5)
    assert got.item() == pytest.approx(0.05)


def _keep_record(seen: dict):
    def plant(driver):
        traced = driver.traced

        def wrapped(seconds, rec):
            traced(seconds, rec)
            seen.update(rec=rec, frame=driver.mix["width"] * driver.mix["height"]
                        * (1 + driver.mix["samples"]))
        driver.traced = wrapped
    return plant


def test_traced_line_reads_the_frame_counters():
    seen = {}
    line = tiny.line(CELL, trace=True, fault=_keep_record(seen))
    assert line["correct"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    rec = seen["rec"]
    c = rec["counters"]
    # On the CPU no device operation is traced: the device readers read
    # nothing, every other reader of the cell its value.
    assert set(got) == set(NEW_READERS + FRAME_READERS) - {"trace_kernels_roofline.frame",
                                                           "device_idle_pct.frame"}
    assert c["trace_rays"] == c["traced_frames"] * seen["frame"] > 0
    # The stats pass: each pose's frame, its batches once each.
    assert c["trace.stats_rays"] == 2 * 32 * 24 * 8
    assert got["tests_per_ray.frame"] == pytest.approx(
        (c["trace.node_tests"] + c["trace.tri_tests"]) / c["trace.stats_rays"])
    assert 0 < got["simt_efficiency.frame"] <= 100
    # The roofline reader on the window's rays and a traced kernel's time.
    reader = run.load_module("metrics", "trace_kernels_roofline.frame")
    fake = dict(rec, trace={"device_ops": {"void flat_trace_kernel<false>(TraceArgs)": 0.002,
                                           "raygen_ao_kernel": 1.0}})
    assert reader.read(fake) == pytest.approx(c["trace_rays"] * 40 / 3.35e12 / 0.002 * 100)
    assert all(run.load_module("metrics", n).read({"spans": {}, "counters": {}, "trace": {}})
               is None for n in NEW_READERS)


def test_traced_line_without_frame_stats(monkeypatch):
    """A port whose renderer lacks ``frame_stats`` (this cell's parent):
    the traced line is whole, and the two counter readers read nothing."""
    monkeypatch.delattr(Renderer, "frame_stats")
    seen = {}
    line = tiny.line(CELL, trace=True, fault=_keep_record(seen))
    assert line["correct"]
    assert not set(line["metrics"]) & {"tests_per_ray.frame", "simt_efficiency.frame"}
    assert "trace_ms.frame" in line["metrics"] and seen["rec"]["counters"]["trace_rays"] > 0
    assert not set(COUNTERS) & set(seen["rec"]["counters"])


# -- Renderer.frame_stats -------------------------------------------------------

@pytest.fixture(scope="module")
def small_scene():
    scene = Scene(port_procedural.make_interior(1_500, seed=17))
    return scene, port_workload.suite_camera("sanmiguel", scene)


def _renderer(scene, **kw):
    r = Renderer(16, 12, RendererParams(num_samples=2, max_batch=256, cache_dir=None,
                                        device="cpu", **kw))
    r.set_scene(scene)
    return r


@pytest.mark.parametrize("kw", [dict(ray_type="diffuse", sort_secondary=True),
                                dict(ray_type="ao", sort_secondary=False),
                                dict(ray_type="diffuse", compact_degenerate=True),
                                dict(ray_type="primary")], ids=["diffuse-sorted", "ao",
                                                                "diffuse-compact", "primary"])
def test_frame_stats_counts_each_batch_and_changes_nothing(small_scene, kw):
    scene, cam = small_scene
    r = _renderer(scene, **kw)
    with pytest.raises(RuntimeError):
        r.frame_stats()
    r.render_frame(cam)
    image = r.update_result()
    phase, hits = dict(r.phase_s), [b.hits.tri.clone() for b in r._batches]
    timed = (r.trace_time_s, r.rays_traced, list(r.batch_trace_s))
    # What count_stats adds for each batch, routed as the frame routed it.
    any_hit = kw["ray_type"] == "ao"
    want = dict.fromkeys(COUNTERS, 0)
    for b in r._batches:
        rays = b.rays
        if kw.get("compact_degenerate"):
            live = int((rays.tmax >= 0).sum())
            rays = type(rays)(*(x[:min(rays.num, -(-live // LIVE_PAD) * LIVE_PAD)] for x in rays))
        _, st = r.routing(r.tracer_tables, rays, any_hit=any_hit, with_stats=True)
        for k, v in (("stats_rays", rays.num), ("node_tests", st["node_tests"].long().sum()),
                     ("tri_tests", st["tri_tests"].long().sum()),
                     ("warp_tests", warp_work(st).sum()), ("stack_entries", st["stack"].long().sum())):
            want[f"trace.{k}"] += int(v)
    assert len(r._batches) == (1 if kw["ray_type"] == "primary" else 2)
    spans.reset()
    spans.enable()
    try:
        r.frame_stats()
    finally:
        spans.disable()
    snap = spans.snapshot()
    spans.reset()
    assert {k: snap["counters"][k] for k in COUNTERS} == want
    assert want["trace.node_tests"] > 0
    assert [s[0] for s in snap["spans"]].count("trace.stats") == 1
    assert r.phase_s == phase and (r.trace_time_s, r.rays_traced, r.batch_trace_s) == timed
    assert all(torch.equal(b.hits.tri, t) for b, t in zip(r._batches, hits))
    np.testing.assert_array_equal(r.update_result(), image)


def test_sorted_and_unsorted_batches_test_alike(small_scene):
    """The sort permutes a batch's rays: the node and triangle test sums
    are the same, only their grouping into warps moves."""
    scene, cam = small_scene
    got = {}
    for sort in (False, True):
        r = _renderer(scene, ray_type="diffuse", sort_secondary=sort)
        r.render_frame(cam)
        spans.reset()
        r.frame_stats()
        got[sort] = spans.snapshot()["counters"]
    spans.reset()
    for k in ("trace.stats_rays", "trace.node_tests", "trace.tri_tests", "trace.stack_entries"):
        assert got[True][k] == got[False][k] > 0
