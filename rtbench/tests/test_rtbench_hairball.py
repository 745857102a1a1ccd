"""The hairball cell, ``hairball-primary``, on the CPU: the frozen copy of
the port's hairball generator and framing (``rtbench/data/hairball.py``),
which its import registers without changing any other scene; the
configuration against the port suite's stand-in; the ``primary_stats``
driver at a tiny size (``rtbench.tests.tiny``, with the port's plain
versions), its counters and the reader of the stack high-water; and a
planted fault its judge must catch."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtbench import paths, run
from rtbench.data import hairball, procedural, workload
from rtbench.tests import tiny
from tpu_rt_torch.bench import workload as port_workload
from tpu_rt_torch.scene import Scene
from tpu_rt_torch.scene import procedural as port_procedural

CELL = "hairball-primary"
TRIS = 20_000  # the tiny cell's triangles: enough strands that a few judged rays hit
COUNTERS = ("trace.stats_rays", "trace.node_tests", "trace.tri_tests", "trace.warp_tests",
            "trace.stack_entries")
TABLES = ("tables.depth", "tables.nodes", "tables.woop_rows")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny plain traces gain nothing from more,
    and beside the other test workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("tris", [20_000, 200_000])
def test_generator_equals_port_byte_for_byte(tris):
    ours = hairball.make_hairball(tris, seed=18)
    theirs = port_procedural.make_hairball(tris, seed=18)
    assert ours.positions.dtype == theirs.positions.dtype == np.float32
    assert ours.positions.tobytes() == theirs.positions.tobytes()
    assert len(ours.submeshes) == len(theirs.submeshes) == 1
    a, b = ours.submeshes[0], theirs.submeshes[0]
    assert a.dtype == b.dtype and a.shape == b.shape == (tris, 3) and a.tobytes() == b.tobytes()
    assert ours.diffuse[0].tobytes() == theirs.materials[0].diffuse.tobytes()
    assert ours.names == [m.name for m in theirs.materials]
    assert procedural.GENERATORS["make_hairball"] is hairball.make_hairball


def test_configuration_is_the_suites_hairball():
    cfg = run.load_json(paths.BENCH_DIR, "configs", "hairball.json")
    src = port_procedural._SUITE["hairball"].__code__
    assert cfg["scene"] == "hairball" and cfg["tracer"] == "auto" and cfg["reduced"] == []
    assert cfg["generator"]["name"] in src.co_names
    assert set(cfg["generator"]["args"].values()) <= set(src.co_consts)
    assert cfg["triangles"] == cfg["generator"]["args"]["target_tris"] == 6_469_561
    dragon = run.load_json(paths.BENCH_DIR, "configs", "dragon.json")
    assert cfg["camera"] == dragon["camera"] and cfg["precision"] == dragon["precision"]
    assert len(cfg["source"]) <= 200


def test_camera_and_radius_equal_port():
    mesh = hairball.make_hairball(TRIS, seed=18)
    port_scene = Scene(port_procedural.make_hairball(TRIS, seed=18))
    ours = workload.suite_camera("hairball", mesh.positions)
    theirs = port_workload.suite_camera("hairball", port_scene)
    for k in ("position", "forward", "up"):
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))
    for k in ("fov", "near", "far"):
        assert ours[k] == getattr(theirs, k)
    assert ours["fov"] == 73.7
    assert workload.suite_ao_radius("hairball", mesh.positions) == \
        port_workload.suite_ao_radius("hairball", port_scene)


# Before and after the import, in a fresh interpreter: the other
# configurations' meshes (at their generators' arguments, TRIS triangles),
# cameras and radii, and the tables' other entries.
_SNAPSHOT = """
import hashlib, json, sys
import numpy as np
from rtbench import paths, run
from rtbench.data import procedural, workload

def snap():
    out = {"tables": [sorted((k, v) for k, v in t.items() if k != "hairball")
                      for t in (workload.SCENE_FOV, workload.REF_AO_RADIUS,
                                workload.REF_EXTENT_EST)],
           "generators": sorted((k, f.__module__ + "." + f.__name__)
                                for k, f in procedural.GENERATORS.items()
                                if k != "make_hairball")}
    for name in ("conference", "dragon", "sanmiguel"):
        cfg = run.load_json(paths.BENCH_DIR, "configs", name + ".json")
        gen = cfg["generator"]
        mesh = procedural.GENERATORS[gen["name"]](**dict(gen["args"], target_tris=%d))
        cam = workload.suite_camera(cfg["scene"], mesh.positions)
        h = hashlib.sha256()
        for x in [mesh.positions, *mesh.submeshes, *mesh.diffuse,
                  *(cam[k] for k in ("position", "forward", "up"))]:
            h.update(np.ascontiguousarray(x).tobytes())
        out[name] = [h.hexdigest(), list(mesh.names), [cam[k] for k in ("fov", "near", "far")],
                     workload.suite_ao_radius(cfg["scene"], mesh.positions)]
    return out

before = snap()
assert "make_hairball" not in procedural.GENERATORS and "hairball" not in workload.SCENE_FOV
import rtbench.data.hairball  # noqa: F401
assert "make_hairball" in procedural.GENERATORS and "hairball" in workload.SCENE_FOV
print(json.dumps([before, snap()]))
""" % TRIS


def test_import_leaves_the_other_scenes_byte_equal():
    env = dict(os.environ, PYTHONPATH=paths.ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _SNAPSHOT], capture_output=True, text=True,
                         cwd=paths.ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    before, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == after
    assert set(before) == {"tables", "generators", "conference", "dragon", "sanmiguel"}


def _run(trace=False, fault=None):
    return run.run_cell(tiny.spec(CELL, TRIS), tiny.SEED, 0.3, trace, device="cpu", fault=fault)


def test_traced_line_correct_with_the_five_counters():
    seen = {}

    def keep(driver):
        traced = driver.traced

        def wrapped(seconds, rec):
            traced(seconds, rec)
            seen.update(rec["counters"], rays=sum(r.num for r in driver.rays),
                        depth=driver.tables.depth)
        driver.traced = wrapped

    line = _run(trace=True, fault=keep)
    assert line["correct"] and line["failed"] == 0
    assert set(COUNTERS + TABLES) <= set(seen)
    assert seen["trace.stats_rays"] == seen["rays"]
    assert seen["tables.depth"] == seen["depth"] >= 1
    got = {k: line["metrics"][k]["value"] for k in ("stack_per_ray.trace", "tests_per_ray.trace",
                                                     "simt_efficiency.trace")}
    assert all(math.isfinite(v) for v in got.values())
    assert got["stack_per_ray.trace"] == pytest.approx(
        seen["trace.stack_entries"] / seen["trace.stats_rays"])
    # A stack holds at most 3 entries a level of the quad tree.
    assert 0 < got["stack_per_ray.trace"] <= 3 * seen["depth"]
    assert 0 < got["simt_efficiency.trace"] <= 100


def test_untraced_line_correct():
    line = _run()
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"mrays_per_s", "setup_s"}


def _drop_half_the_hits(driver):
    """Every second hit of each batch, in ray order, reported a miss."""
    route = driver.route

    def broken(tables, rays, any_hit=False, **kw):
        hits = route(tables, rays, any_hit=any_hit, **kw)
        hit = hits.tri >= 0
        gone = hit & (torch.cumsum(hit.long(), 0) % 2 == 0)
        return hits._replace(tri=torch.where(gone, -1, hits.tri),
                             t=torch.where(gone, rays.tmax, hits.t))
    driver.route = broken


def test_planted_fault_judged_incorrect():
    line = _run(fault=_drop_half_the_hits)
    assert not line["correct"] and line["failed"] > 0
    assert line["checks"]["hit_gap"]["value"] > line["checks"]["hit_gap"]["limit"]


def test_stack_reader_reads_its_counter_and_nothing_else():
    reader = run.load_module("metrics", "stack_per_ray.trace")
    rec = {"spans": {}, "counters": {"trace.stats_rays": 64, "trace.stack_entries": 200},
           "trace": {}}
    assert reader.read(rec) == pytest.approx(200 / 64)
    # A port without the counter (the parent of this cell) gives nothing.
    assert reader.read(dict(rec, counters={"trace.stats_rays": 64, "trace.node_tests": 9})) is None
    assert reader.read(dict(rec, counters={})) is None
    bench = run.load_json(paths.ROOT, "BENCHMARK.json")
    m = {x["name"]: x for x in bench["per_layer"]}["stack_per_ray.trace"]
    assert (m["source"], m["layer"], m["moves"], m["workloads"], m["unit"], m["better"]) == (
        "program_counter", "trace kernels", "mrays_per_s", [CELL], "entries", "lower")
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hairball",
                                                                "primary-stats-trace", 1)
    listed = [x["name"] for x in bench["end_to_end"] + bench["per_layer"]
              if CELL in x.get("workloads", [])]
    assert sorted(listed) == sorted([
        "mrays_per_s", "trace_kernels_roofline", "host_us_per_call.trace",
        "device_idle_pct.trace", "setup.bvh_s", "setup.kernels_s", "launch_us_per_call.trace",
        "tests_per_ray.trace", "simt_efficiency.trace", "stack_per_ray.trace"])


def test_traffic_is_the_primary_mix_with_its_own_driver():
    mix = run.load_json(paths.BENCH_DIR, "traffic", "primary-stats-trace.json")
    primary = run.load_json(paths.BENCH_DIR, "traffic", "primary-trace.json")
    assert mix == dict(primary, driver="primary_stats")
    driver = run.load_module("drivers", "primary_stats")
    assert issubclass(driver.Driver, run.load_module("drivers", "trace").Driver)
