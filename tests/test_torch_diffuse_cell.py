"""The benchmark's diffuse cell, ``sanmiguel-diffuse``, at a tiny size on
the CPU (``rtbench.tests.tiny``: 3,000 triangles, 32 x 24, two poses), with
the port's plain versions: its rays and closest hits against the plain
reference (``rtbench/reference/diffuse.py``), its run and traced run, the
faults its judge must catch, the control; and the port's traversal-work
counters (``tpu_rt_torch.spans.count``, ``trace.common.count_stats``) that
its two new readers read, and the diffuse raygen span."""

import collections
import math

import numpy as np
import pytest
import torch

from rtbench import calibrate, paths, run
from rtbench.data import procedural, workload
from rtbench.tests import tiny
from tpu_rt_torch import spans
from tpu_rt_torch.bench import workload as port_workload
from tpu_rt_torch.bench.bench_suite import census
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.renderer import Renderer, RendererParams
from tpu_rt_torch.scene import Scene
from tpu_rt_torch.scene import procedural as port_procedural
from tpu_rt_torch.trace import make_routing_tracer

CELL = "sanmiguel-diffuse"
COUNTERS = ("trace.stats_rays", "trace.node_tests", "trace.tri_tests", "trace.warp_tests",
            "trace.stack_entries")
NEW_READERS = ("tests_per_ray.trace", "simt_efficiency.trace")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny plain traces gain nothing from more,
    and beside the other test workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cell():
    """The cell's driver, set up at the tiny size, and the float64 reference
    scene: shared by the checks that run its window again."""
    spec = tiny.spec(CELL)
    driver = run.load_module("drivers", spec["mix"]["driver"]).Driver(
        spec["config"], spec["mix"], tiny.SEED, "cpu", {}, {})
    driver.prepare()
    return spec, driver, driver.reference_scene(torch.float64, "cpu")


def _judged(driver, ref) -> dict:
    driver.window(0.01)
    items, answers = driver.outputs()
    return {k: float(v.max()) for k, v in driver.judge(ref, items, answers).items()}


def test_configuration_is_the_suites_sanmiguel():
    """The generator and its arguments are the port suite's San Miguel, and
    the framing key ``conference`` gives the suite's San Miguel camera."""
    cfg = run.load_json(paths.BENCH_DIR, "configs", "sanmiguel.json")
    src = port_procedural._SUITE["sanmiguel"].__code__
    assert cfg["generator"]["name"] in src.co_names
    assert set(cfg["generator"]["args"].values()) <= set(src.co_consts)
    assert cfg["triangles"] == cfg["generator"]["args"]["target_tris"]
    args = dict(cfg["generator"]["args"], target_tris=5_000)
    mesh = procedural.GENERATORS[cfg["generator"]["name"]](**args)
    ours = workload.suite_camera(cfg["scene"], mesh.positions)
    theirs = port_workload.suite_camera("sanmiguel", Scene(port_procedural.make_interior(**args)))
    for k in ("position", "forward", "up"):
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))
    for k in ("fov", "near", "far"):
        assert ours[k] == getattr(theirs, k)


def test_rays_and_closest_hits_within_limits(cell):
    spec, driver, ref = cell
    far = np.float32(driver.cams[0]["far"])
    assert all(np.float32(c["far"]) == far for c in driver.cams)
    for b in driver.batches:
        tmax = b["rays"].tmax
        assert ((tmax == far) | (tmax == -1.0)).all()
        assert b["count"] == int((tmax >= 0).sum()) > 0
    got = _judged(driver, ref)
    assert set(got) == set(spec["limits"])
    assert all(got[k] <= limit for k, limit in spec["limits"].items()), got


def test_line_correct():
    line = tiny.line(CELL)
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"mrays_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_traced_line_reads_the_counters():
    """The traced rehearsal reads both new metrics; the stats pass runs
    after the traced window and adds no ``trace.launch`` span to it."""
    seen = {}

    def keep(driver):
        traced = driver.traced

        def wrapped(seconds, rec):
            traced(seconds, rec)
            seen.update(rec["counters"], rays=sum(r.num for r in driver.rays))
        driver.traced = wrapped

    spans.reset()
    line = tiny.line(CELL, trace=True, fault=keep)
    launches = collections.Counter(r[0] for r in spans.snapshot()["spans"])["trace.launch"]
    spans.reset()
    assert line["correct"]
    got = {k: line["metrics"][k]["value"] for k in NEW_READERS}
    assert all(math.isfinite(v) for v in got.values())
    assert got["tests_per_ray.trace"] > 1
    assert 0 < got["simt_efficiency.trace"] <= 100
    assert launches == seen["trace_calls"] > 0
    assert seen["trace.stats_rays"] == seen["rays"]
    want = (seen["trace.node_tests"] + seen["trace.tri_tests"]) / seen["trace.stats_rays"]
    assert got["tests_per_ray.trace"] == pytest.approx(want)


def _drop_half(driver):
    route = driver.route

    def broken(tables, rays, any_hit=False, **kw):
        hits = route(tables, rays, any_hit=any_hit, **kw)
        gone = torch.arange(rays.num) >= rays.num // 2
        return hits._replace(tri=torch.where(gone, -1, hits.tri),
                             t=torch.where(gone, rays.tmax, hits.t))
    driver.route = broken


def _alter(driver):
    route = driver.route

    def broken(tables, rays, any_hit=False, **kw):
        hits = route(tables, rays, any_hit=any_hit, **kw)
        pick = (torch.arange(rays.num) % 5 == 0) & (rays.tmax >= 0)
        hit = hits.tri >= 0
        tri = torch.where(pick, torch.where(hit, -1, 0), hits.tri).to(hits.tri.dtype)
        t = torch.where(pick, torch.where(hit, rays.tmax, rays.tmax * 0.5), hits.t)
        return hits._replace(tri=tri, t=t)
    driver.route = broken


def _any_hit(driver):
    route = driver.route
    driver.route = lambda tables, rays, any_hit=False, **kw: route(tables, rays, True, **kw)


def _ao_radius(driver):
    """The AO radius in place of the camera's far, in the traced rays."""
    for r in driver.rays:
        r.tmax.copy_(torch.where(r.tmax >= 0, float(np.float32(driver.radius)), r.tmax))


FAULTS = {"half_the_batch_left_out": _drop_half, "every_fifth_answer_altered": _alter,
          "any_hit_answers": _any_hit, "ao_radius_for_far": _ao_radius}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_over_a_limit(cell, fault):
    spec, driver, ref = cell
    route, tmax = driver.route, [r.tmax.clone() for r in driver.rays]
    FAULTS[fault](driver)
    try:
        got = _judged(driver, ref)
    finally:
        driver.route = route
        for r, t in zip(driver.rays, tmax):
            r.tmax.copy_(t)
    assert any(got[k] > limit for k, limit in spec["limits"].items()), got


def test_control_fails_on_three_seeds():
    spec = tiny.spec(CELL)
    got = calibrate.calibrate(spec, [11, 12, 13], 0.05, 3, "cpu")
    assert all(got["lower"][k] <= limit for k, limit in spec["limits"].items())
    # One of the cell's numbers fails on every seed.
    assert any(got["upper"][k] > limit for k, limit in spec["limits"].items())


# -- the port's counters ------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    scene = Scene(port_procedural.make_interior(2_000, seed=17))
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    lo, hi = scene.bbox()
    rng = np.random.default_rng(5)
    n = 203  # not a whole number of warps
    d = rng.normal(size=(n, 3))
    rays = make_rays(np.tile((lo + hi) * 0.5, (n, 1)), d / np.linalg.norm(d, axis=1)[:, None],
                     np.zeros(n), np.full(n, 1e30), device="cpu")
    return flat, rays


def test_count_adds_and_reset_clears():
    spans.reset()
    spans.count("x", 3)
    spans.count("x", 4)
    spans.count("y", 0)
    assert spans.snapshot()["counters"] == {"x": 7, "y": 0}
    spans.reset()
    assert spans.snapshot()["counters"] == {}


@pytest.mark.parametrize("prefer", ["auto", "packet", "xla"])
def test_stats_route_records_its_sums(tree, prefer):
    flat, rays = tree
    fn, _, tables = make_routing_tracer(flat, prefer=prefer, device="cpu")
    spans.reset()
    fn(tables, rays, any_hit=False)
    fn(tables, rays, any_hit=True)
    assert spans.snapshot()["counters"] == {}
    _, stats = fn(tables, rays, any_hit=False, with_stats=True)
    _, stats2 = fn(tables, rays, any_hit=True, with_stats=True)
    got = spans.snapshot()["counters"]
    spans.reset()
    assert set(got) == set(COUNTERS)
    assert got["trace.stats_rays"] == 2 * rays.num
    for k, name in (("node_tests", "node_tests"), ("tri_tests", "tri_tests"),
                    ("stack", "stack_entries")):
        assert got[f"trace.{name}"] == int(stats[k].sum()) + int(stats2[k].sum())
    assert got["trace.stack_entries"] > 0
    assert got["trace.warp_tests"] == census(stats)[1] + census(stats2)[1]


def test_warp_tests_equal_census(tree):
    flat, rays = tree
    fn, _, tables = make_routing_tracer(flat, prefer="auto", device="cpu")
    spans.reset()
    _, stats = fn(tables, rays, with_stats=True)
    got = spans.snapshot()["counters"]["trace.warp_tests"]
    spans.reset()
    work = (stats["node_tests"].long() + stats["tri_tests"].long()).tolist()
    by_loop = sum(max(work[i:i + 32]) for i in range(0, len(work), 32))
    groups, iters = census(stats)
    assert got == iters == by_loop
    assert groups == -(-rays.num // 32)


def test_readers_read_the_counters_and_nothing_else():
    rec = {"spans": {}, "counters": {"trace.stats_rays": 64, "trace.node_tests": 1_000,
                                     "trace.tri_tests": 600, "trace.warp_tests": 100},
           "trace": {"window_s": 5.0}}
    tests, simt = (run.load_module("metrics", n) for n in NEW_READERS)
    assert tests.read(rec) == pytest.approx(1_600 / 64)
    assert simt.read(rec) == pytest.approx(1_600 / (32 * 100) * 100)
    # A port without the counters (an older checkout) gives nothing.
    bare = dict(rec, counters={"trace_calls": 8, "trace_rays": 1_000})
    assert tests.read(bare) is None and simt.read(bare) is None
    bench = run.load_json(paths.ROOT, "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_READERS:
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
            "program_counter", "trace kernels", "mrays_per_s", [CELL, "hairball-primary"])


def test_diffuse_frame_names_its_raygen_span():
    """A diffuse frame's secondary raygen is the span ``raygen.diffuse``,
    in the ``raygen`` phase."""
    scene = Scene(port_procedural.make_interior(1_500, seed=17))
    r = Renderer(16, 12, RendererParams(ray_type="diffuse", num_samples=2, max_batch=256,
                                        cache_dir=None, device="cpu"))
    r.set_scene(scene)
    cam = port_workload.suite_camera("sanmiguel", scene)
    r.render_frame(cam)
    spans.reset()
    spans.enable()
    try:
        r.render_frame(cam)
    finally:
        spans.disable()
    recs = spans.snapshot()["spans"]
    spans.reset()
    names = collections.Counter(rec[0] for rec in recs)
    assert "raygen.ao" not in names
    assert names["raygen.diffuse"] == 3  # two batches, then the call that ends the frame
    spent = sum((rec[3] - rec[2]) * 1e-9 for rec in recs
                if rec[0] in ("raygen.primary", "raygen.diffuse"))
    assert spent == pytest.approx(r.phase_s["raygen"], rel=0.01)
