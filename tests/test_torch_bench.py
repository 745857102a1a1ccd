"""The port's measurement harness (``tpu_rt_torch.bench.bench``,
``bench_suite``, ``calibrate``, ``bench_diff``) against the JAX package's
``bench.py`` and ``tools/``: the calibration rows, the cost model, the
headline line's keys and counts, the on-device check, where the outputs go,
a suite row's numerator and census, the full-frame checks and the diff
bench, on knob at 32x24 with the kernels' plain versions."""

import builtins
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_rt_torch.bench import bench, bench_diff, bench_suite, calibrate
from tpu_rt_torch.bench.workload import suite_camera
from tpu_rt_torch.core.types import Hits
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import morton_sort_device, permute_rays
from tpu_rt_torch.trace import (RayStats, device_bvh, make_routing_tracer, trace_flat_scalar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "knob"
W, H = 32, 24
SMALL = {"BENCH_SCENE": SCENE, "BENCH_WIDTH": str(W), "BENCH_HEIGHT": str(H),
         "BENCH_REPEATS": "1", "BENCH_WARMUP": "0", "BENCH_CHAIN": "1"}


def _root_bench():
    """The repository's ``bench.py`` as a module (its settings are read at
    import; ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_settings_and_tables_equal_tpu_rt(monkeypatch):
    from tools import bench_suite as t_suite

    for var, _ in bench.SETTINGS.values():
        monkeypatch.delenv(var, raising=False)
    root = _root_bench()
    s = bench.settings({})
    assert (s["scene"], s["ray_type"], s["width"], s["height"], s["warmup"], s["repeats"],
            s["samples"], s["ao_radius"], s["verify_rays"]) == (
        root.SCENE, root.RAY_TYPE, root.WIDTH, root.HEIGHT, root.WARMUP, root.REPEATS,
        root.SAMPLES, root.AO_RADIUS, root.VERIFY_RAYS)
    assert (s["tracer"], s["chain"]) == ("auto", 32)   # read in bench.py's main
    assert bench.settings({"BENCH_WIDTH": "64", "BENCH_AO_RADIUS": "2.5"})["width"] == 64
    assert bench.BASELINES == root.BASELINES == t_suite.BASELINES
    assert bench_suite.BASELINES is bench.BASELINES
    assert bench_suite.ROWS == t_suite.ROWS and bench_suite.TRIS == t_suite.TRIS
    assert [t[:2] for t in bench_suite.FULLFRAME_TARGETS] == [
        (s_, "packet" if m in ("packet", "hbm-f32") else m) for s_, m in t_suite.FULLFRAME_TARGETS]


@pytest.mark.parametrize("ray_type", ["primary", "ao", "diffuse"])
def test_calibrate_row_equals_tpu_rt(ray_type, tmp_path, monkeypatch):
    # Bit-equal raygen and oracles: the rows are equal field for field.
    from tools import calibrate as t_calibrate

    monkeypatch.chdir(tmp_path)   # the tool's cache is ./bvhcache
    want = t_calibrate.calibrate_row(SCENE, ray_type, 64)
    got = calibrate.calibrate_row(SCENE, ray_type, 64, cache_dir=str(tmp_path / "port"))
    assert got == want
    assert got["sampled_rays"] == 64 and got["node_tests_per_ray"] > 0


def _cost_rows(single: bool, leaf: bool):
    # The rows of tests/test_workload.py's cost-model test, plus a route of
    # one row (the shared per_group branch) and a leaf-width split.
    g, c = 8e-6, 0.8e-6
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        groups = int(rng.integers(30, 80))
        iters = int(rng.integers(5_000, 300_000))
        rows.append({"tracer": "pallas-vmem", "groups": groups, "iters": iters,
                     "best_s": g * groups + c * iters, "mrays": 1.0})
    if single:
        rows.append({"tracer": "quad-cuda", "groups": 9600, "iters": 2_000_000,
                     "best_s": 3.1e-4, "mrays": 1.0})
    if leaf:
        rows += [{"tracer": "quad-cuda", "leaf_max": lm, "groups": 9600 + k,
                  "iters": 1_000_000 + 7 * k, "best_s": 2e-4 + 1e-6 * k, "mrays": 1.0}
                 for lm in (16, 32) for k in range(3)]
    rows.append({"tracer": "flat-cuda", "best_s": 1e-4, "mrays": 1.0})   # no census
    return rows


@pytest.mark.parametrize("single,leaf", [(False, False), (True, False), (True, True)])
def test_fit_cost_model_equals_tpu_rt(single, leaf):
    from tools.bench_suite import fit_cost_model as t_fit

    a, b = _cost_rows(single, leaf), _cost_rows(single, leaf)
    got, want = bench_suite.fit_cost_model(a), t_fit(b)
    assert got.keys() == want.keys()
    if single:
        assert got["quad-cuda"]["per_group_shared"] is True
    for k in want:
        assert got[k].keys() == want[k].keys()
        for f in want[k]:
            assert got[k][f] == pytest.approx(want[k][f], rel=1e-12, abs=1e-12), (k, f)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for f in ("model_s", "vs_model"):
            if f in rb:
                assert ra[f] == pytest.approx(rb[f], rel=1e-12, abs=1e-12)


@pytest.fixture(scope="module")
def root_lines(tmp_path_factory):
    """The root bench.py's JSON line for primary and AO rays on knob at
    32x24, the two runs in parallel subprocesses."""
    procs = {}
    for ray_type in ("primary", "ao"):
        cwd = tmp_path_factory.mktemp(f"root_{ray_type}")
        env = dict(os.environ, **SMALL, JAX_PLATFORMS="cpu", BENCH_TRACER="xla",
                   BENCH_RAY_TYPE=ray_type, PYTHONPATH=REPO)
        procs[ray_type] = subprocess.Popen([sys.executable, os.path.join(REPO, "bench.py")],
                                           cwd=cwd, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
    lines = {}
    for ray_type, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        lines[ray_type] = json.loads(out.strip().splitlines()[-1])
    return lines


@pytest.mark.parametrize("ray_type", ["primary", "ao"])
def test_headline_line_equals_bench_py(ray_type, root_lines, tmp_path):
    want = root_lines[ray_type]
    got = bench.main(dict(SMALL, BENCH_RAY_TYPE=ray_type), device="cpu",
                     cache_dir=str(tmp_path / "cache"), out_dir=str(tmp_path / "out"))
    assert got.keys() == want.keys() and got["detail"].keys() == want["detail"].keys()
    assert got["metric"] == want["metric"] == f"{SCENE}_{ray_type}_mrays_per_s"
    for k in ("rays_metric", "rays_traced", "tris", "bvh_refs", "samples", "ao_radius"):
        assert got["detail"][k] == want["detail"][k], k
    assert got["value"] > 0
    assert got["vs_baseline"] == got["value"] / bench.BASELINES[(SCENE, ray_type)]
    d = got["detail"]
    assert d["tracer"] == "quad-plain" and d["backend"] == "cpu" and d["device"] == "cpu"
    assert d["verified_rays"] == W * H and d["full_frame_verified"] is None
    assert d["best_s"] <= d["mean_s"]


@pytest.fixture(scope="module")
def knob(tmp_path_factory):
    scene, flat = bench_suite._setup_scene(SCENE, None)
    rays, _, _ = RayGen().primary(suite_camera(SCENE, scene), W, H, device="cpu")
    return scene, flat, rays


def _ao_rays(scene, flat, rays):
    hits = Hits(*(torch.as_tensor(x) for x in trace_flat_scalar(flat, *(x.numpy() for x in rays))))
    ao, _, _ = gen_ao_rays(rays.origin, rays.dirn, hits.t, hits.tri.to(torch.int32),
                           torch.as_tensor(scene.tri_normal), 1, 5.0, 0)
    return hits, ao


@pytest.mark.parametrize("any_hit", [False, True])
def test_verify_on_device(any_hit, knob):
    scene, flat, rays = knob
    if any_hit:
        rays = _ao_rays(scene, flat, rays)[1]
    fn, kind, tables = make_routing_tracer(flat, device="cpu")
    dbvh = device_bvh(flat, "cpu")
    trace = lambda r, ah: fn(tables, r, any_hit=ah)   # noqa: E731
    assert bench.verify_on_device(flat, dbvh, rays, any_hit, trace, 100) == len(range(0, W * H, 7))
    assert bench.verify_on_device(flat, dbvh, rays, any_hit, trace, 10_000) == W * H

    def shifted(r, ah):
        # Every ray gets its neighbour's hit.
        return Hits(*(torch.roll(x, 1) for x in fn(tables, r, any_hit=ah)))

    with pytest.raises(AssertionError, match="on-device kernel verification FAILED"):
        bench.verify_on_device(flat, dbvh, rays, any_hit, shifted, 100)


def test_outputs_stay_under_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    planted = {"bunny": {"verified": False}, "vmem": {"verified": False}}
    (tmp_path / "BENCH_FULLFRAME.json").write_text(json.dumps(planted))
    before = {p for p in tmp_path.rglob("*")}
    opened = []
    real_open = builtins.open

    def spy(file, *a, **k):
        opened.append(os.path.basename(str(file)))
        return real_open(file, *a, **k)

    monkeypatch.setattr(builtins, "open", spy)
    env = {"BS_WIDTH": str(W), "BS_HEIGHT": str(H), "BS_REPEATS": "1", "BS_CHAIN": "1"}
    calibrate.main(["16", f"{SCENE}:primary", f"{SCENE}:ao", "--out", "o", "--cache-dir", ""])
    rows = bench_suite.main([f"{SCENE}:primary", f"{SCENE}:ao", "--out", "o", "--device", "cpu",
                             "--cache-dir", ""], env=env)
    assert [r["ray_type"] for r in rows] == ["primary", "ao"] and all("mrays" in r for r in rows)
    bench_suite.main(["--regen-md", "--out", "o"], env=env)
    line = bench.main(SMALL, device="cpu", cache_dir=None, out_dir="o")
    assert line["detail"]["full_frame_verified"] is None   # not the planted TPU file
    monkeypatch.setattr(builtins, "open", real_open)

    made = {p for p in tmp_path.rglob("*")} - before
    assert made and all(p.is_relative_to(tmp_path / "o") for p in made), made
    assert {p.name for p in made if p.is_file()} == {"CALIB.json", "SUITE.json", "SUITE.md"}
    assert not any(n.startswith("BENCH_") for n in opened), opened
    assert json.loads((tmp_path / "BENCH_FULLFRAME.json").read_text()) == planted
    md = (tmp_path / "o" / "SUITE.md").read_text()
    assert "TPU" not in md and "ROUND" not in md and "tunnel" not in md
    assert f"| {SCENE} (12.6K) | ao |" in md
    calib = json.loads((tmp_path / "o" / "CALIB.json").read_text())
    tests = calib[1]["node_tests_per_ray"] + calib[1]["tri_tests_per_ray"]
    assert f"| {tests:.0f} | {calib[1]['hit_frac'] * 100:.0f}% |" in md
    suite = json.loads((tmp_path / "o" / "SUITE.json").read_text())
    assert suite == rows and all("vs_model" in r for r in suite)


def test_census_definition():
    node = torch.arange(70, dtype=torch.int32)
    tri = torch.zeros(70, dtype=torch.int32)
    tri[5] = 100
    groups, iters = bench_suite.census({"node_tests": node, "tri_tests": tri})
    # Warps [0, 32), [32, 64), [64, 70): maxima 105, 63, 69.
    assert (groups, iters) == (3, 105 + 63 + 69)


def test_bench_row_ao_numerator_and_census(knob):
    scene, flat, rays = knob
    samples = 2
    row = bench_suite.bench_row(SCENE, "ao", W, H, 1, 1, samples=samples, device="cpu",
                                cache_dir=None, tracer="packet")
    hits, _ = _ao_rays(scene, flat, rays)
    assert row["rays_metric"] == int((hits.tri >= 0).sum()) * samples
    assert row["rays_traced"] == W * H * samples and row["tracer"] == "flat-plain"
    assert row["leaf_max"] is None and row["vs_baseline"] == row["mrays"] / 2763.01
    # The census from the oracle's RayStats (the binary counters equal
    # them) on the row's rays: the AO rays in 192-bit Morton order.
    radius = bench_suite.suite_ao_radius(SCENE, scene)
    ao, _, _ = gen_ao_rays(rays.origin, rays.dirn, hits.t, hits.tri.to(torch.int32),
                           torch.as_tensor(scene.tri_normal), samples, radius, 0)
    ao = permute_rays(ao, morton_sort_device(ao.origin, ao.dirn))
    stats = RayStats()
    trace_flat_scalar(flat, *(x.numpy() for x in ao), any_hit=True, stats=stats)
    work = stats.per_ray_node_tests + stats.per_ray_tri_tests
    groups = -(-work.size // 32)
    work = np.concatenate([work, np.zeros(groups * 32 - work.size, work.dtype)])
    assert row["groups"] == groups
    assert row["iters"] == int(work.reshape(groups, 32).max(1).sum())
    quad = bench_suite.bench_row(SCENE, "primary", W, H, 1, 1, device="cpu", cache_dir=None)
    assert quad["tracer"] == "quad-plain" and quad["leaf_max"] == 16
    assert quad["groups"] == W * H // 32 and quad["iters"] > 0


def test_verify_full_on_knob(tmp_path):
    targets = [(SCENE, "auto", None, None), (SCENE, "packet", "vmem", False),
               (SCENE, "packet", "mixed", True), (SCENE, "packet", "hbm", False),
               (SCENE, "packet", "vmem", True)]
    res = bench_suite.verify_full(str(tmp_path), "cpu", None, W, H, targets)
    assert list(res) == ["quad-plain", "vmem", "mixed-bf16", "hbm", "vmem-bf16"]
    for key, e in res.items():
        assert e["rays"] == W * H and e["kernel_wrong"] == 0 and e["verified"], key
        assert e["cross_tracer_disputes"] == (e["oracle_adjudicated_exact"]
                                              + e["oracle_adjudicated_fp_tie"]
                                              + e["oracle_adjudicated_edge_graze"])
    assert bench.full_frame_verified(str(tmp_path)) == dict.fromkeys(res, True)


def test_verify_ao_frame_on_knob(tmp_path):
    (tmp_path / bench.FULLFRAME_FILE).write_text(json.dumps({"vmem": {"verified": True}}))
    e = bench_suite.verify_ao_frame(SCENE, 8, str(tmp_path), "cpu", None, W, H, max_batch=2048)
    assert e["batches"] == 3 and e["rays"] == W * H * 8 and e["kernel_wrong"] == 0
    assert e["verified"] and e["image_nonempty"] and e["tracer"] == "quad-plain"
    assert bench.full_frame_verified(str(tmp_path)) == {"vmem": True, "ao": True}
    with pytest.raises(AssertionError, match="want >=3 batches"):
        bench_suite.verify_ao_frame(SCENE, 8, str(tmp_path), "cpu", None, W, H, max_batch=4096)


def test_bench_diff_row(tmp_path):
    from tpu_rt.scene import Scene as TScene
    from tpu_rt.scene import procedural as t_proc

    out = bench_diff.bench_diff(SCENE, W, H, "cpu", None, repeats=1, chain=1,
                                profile_dir=str(tmp_path / "prof"))
    t_scene = TScene(t_proc.scene_by_name(SCENE))
    # tools/bench_diff.py: vtx.size * 4 + mat.size * 4 + 4.
    assert out["psum_bytes"] == t_scene.vtx_pos.size * 4 + t_scene.tri_material.size * 4 + 4
    for name in ("routing", "forward", "grad_step"):
        assert out[f"{name}_s"] > 0 and out[f"{name}_mrays"] == W * H / out[f"{name}_s"] / 1e6
    assert out["diff_overhead_s"] == out["forward_s"] - out["routing_s"]
    assert out["backward_s"] == out["grad_step_s"] - out["forward_s"]
    assert out["forward_vs_routing"] == out["routing_s"] / out["forward_s"]
    assert (out["rays"], out["n_devices"], out["routing"]) == (W * H, 1, "quad-plain")
    with open(out["profile_trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_bench_diff_jsonl_newest_wins(tmp_path):
    env = {"BD_REPEATS": "1", "BD_CHAIN": "1"}
    args = ["--device", "cpu", "--cache-dir", "", "--out", str(tmp_path)]
    a = bench_diff.main([SCENE, str(W), str(H), *args], env=env)
    b = bench_diff.main([SCENE, str(W), str(H), *args], env=env)
    c = bench_diff.main([SCENE, "16", "12", *args], env=env)
    with open(tmp_path / bench_suite.DIFF_FILE) as f:
        rows = [json.loads(ln) for ln in f]
    assert len(a) == len(b) and rows == [b, c]


def test_bench_mode_scaling_hands_over(tmp_path, monkeypatch):
    # BENCH_MODE=scaling runs bench/scaling.py's scaling_main, as bench.py's
    # __main__ runs its scaling_main.
    monkeypatch.chdir(tmp_path)
    res = bench.main({"BENCH_MODE": "scaling", "BENCH_SCENE": SCENE, "BENCH_WIDTH": "16",
                      "BENCH_HEIGHT": "12", "BENCH_REPEATS": "1", "BENCH_WARMUP": "0"},
                     device="cpu", cache_dir=str(tmp_path / "cache"))
    assert res["metric"] == f"{SCENE}_scaling_efficiency_1dev" and res["value"] == 1.0
    d = res["detail"]
    assert (d["scene"], d["tracer"], d["n_devices"]) == (SCENE, "quad-plain", 1)
    assert d["collective_audit"]["verified"]
