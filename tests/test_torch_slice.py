"""The port's primary, AO and diffuse frames, end to end, against tpu_rt's."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tpu_rt.bench.workload import suite_ao_radius as t_suite_ao_radius
from tpu_rt.bench.workload import suite_camera as t_suite_camera
from tpu_rt.renderer import Renderer as TRenderer
from tpu_rt.renderer import RendererParams as TParams
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc
from tpu_rt.trace import trace_flat_scalar

from tpu_rt_torch.bench.workload import suite_ao_radius as p_suite_ao_radius
from tpu_rt_torch.bench.workload import suite_camera as p_suite_camera
from tpu_rt_torch.renderer import Renderer as PRenderer
from tpu_rt_torch.renderer import RendererParams as PParams
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import procedural as p_proc

W, H = 64, 48
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frames():
    t_scene = TScene(t_proc.make_blob(700, seed=80))
    p_scene = PScene(p_proc.make_blob(700, seed=80))
    t_r = TRenderer(W, H, TParams(tracer="xla", cache_dir=None))
    t_r.set_scene(t_scene)
    t_r.render_frame(t_suite_camera("bunny", t_scene))
    p_r = PRenderer(W, H, PParams(cache_dir=None, device="cpu"))
    p_r.set_scene(p_scene)
    stats = p_r.render_frame(p_suite_camera("bunny", p_scene))
    return t_r, t_r.update_result(), p_r, p_r.update_result(), stats


def test_primary_frame_matches_tpu_rt(frames):
    t_r, t_img, p_r, p_img, _ = frames
    _check_primary(t_r, t_img, p_r, p_img)


def _check_primary(t_r, t_img, p_r, p_img):
    # Per-pixel hit ids of both frames.
    t_tri = np.asarray(t_r._batches[0].hits.tri)[np.asarray(t_r.primary.id_to_slot)]
    p_tri = p_r.primary.hits.tri.numpy()[p_r.primary.id_to_slot.numpy()]
    differ = t_tri != p_tri
    np.testing.assert_array_equal(p_img.reshape(-1, 4)[~differ], t_img.reshape(-1, 4)[~differ])
    if differ.any():
        # Adjudicate disputed pixels with the oracle, under bench.py's
        # verify_on_device rules: an fp tie or an edge graze is allowed.
        ids = np.nonzero(differ)[0]
        rays = p_r.primary.rays
        slots = p_r.primary.id_to_slot.numpy()[ids]
        got_t = p_r.primary.hits.t.numpy()[slots]
        s_id, s_t, s_u, s_v = trace_flat_scalar(
            t_r.flat, rays.origin.numpy()[slots], rays.dirn.numpy()[slots],
            rays.tmin.numpy()[slots], rays.tmax.numpy()[slots])
        exact = p_tri[ids] == s_id
        tie = ~exact & np.isclose(got_t, s_t, rtol=2e-4, atol=1e-5)
        margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
        graze = ~exact & ~tie & (s_id >= 0) & (margin < 1e-3)
        wrong = ~exact & ~tie & ~graze
        assert not wrong.any(), ids[wrong]
    assert differ.sum() <= 3
    hit = p_tri >= 0
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(p_r.update_result_u32(), t_r.update_result_u32())


def test_render_stats(frames):
    _, _, p_r, p_img, stats = frames
    assert stats["total_rays"] == stats["rays_traced"] == W * H
    assert stats["tracer"] == "quad-plain" and stats["timer"] == "host"
    assert stats["trace_time_s"] > 0 and stats["mrays_per_s"] > 0
    assert set(stats["phase_s"]) == {"raygen", "sort", "trace", "reconstruct"}
    assert p_img.shape == (H, W, 4) and np.isfinite(p_img).all()


# Secondary frames: 4 samples, and a batch budget of 4096 rays, so the
# 3072 primary slots go out in 3 batches of 1024.
SAMPLES, MAX_BATCH = 4, 4096


@pytest.fixture(scope="module")
def secondary_frames():
    t_scene = TScene(t_proc.make_blob(700, seed=80))
    p_scene = PScene(p_proc.make_blob(700, seed=80))
    radius = t_suite_ao_radius("bunny", t_scene)
    assert radius == p_suite_ao_radius("bunny", p_scene)
    out = {}
    for ray_type in ("ao", "diffuse"):
        t_r = TRenderer(W, H, TParams(ray_type=ray_type, num_samples=SAMPLES, ao_radius=radius,
                                      max_batch=MAX_BATCH, tracer="xla", cache_dir=None))
        t_r.set_scene(t_scene)
        t_stats = t_r.render_frame(t_suite_camera("bunny", t_scene))
        p_r = PRenderer(W, H, PParams(ray_type=ray_type, num_samples=SAMPLES, ao_radius=radius,
                                      max_batch=MAX_BATCH, cache_dir=None, device="cpu"))
        p_r.set_scene(p_scene)
        p_stats = p_r.render_frame(p_suite_camera("bunny", p_scene))
        out[ray_type] = (t_r, t_stats, t_r.update_result(), p_r, p_stats, p_r.update_result())
    return out


def _frame_samples(batches, s, to_np):
    """Per-(primary slot, sample) hit ids and rays of a secondary frame,
    assembled over its batches as Renderer.update_result does."""
    n_all = W * H * s
    tri = np.full(n_all, -1, np.int32)
    rays = [np.zeros((n_all, 3), np.float32), np.zeros((n_all, 3), np.float32),
            np.zeros(n_all, np.float32), np.full(n_all, -1.0, np.float32)]
    for b in batches:
        lo, hi = b.input_range
        n = (hi - lo) * s
        slots = to_np(b.id_to_slot)[:n]
        tri[lo * s:lo * s + n] = to_np(b.hits.tri)[slots]
        for dst, src in zip(rays, b.rays):
            dst[lo * s:lo * s + n] = to_np(src)[slots]
    return tri, rays


@pytest.mark.parametrize("ray_type", ["ao", "diffuse"])
def test_secondary_frame_matches_tpu_rt(secondary_frames, ray_type):
    _check_secondary(*secondary_frames[ray_type], ray_type, "quad-plain")


def _check_secondary(t_r, t_stats, t_img, p_r, p_stats, p_img, ray_type, kind):
    assert p_stats["total_rays"] == t_stats["total_rays"]
    assert p_stats["rays_traced"] == t_stats["rays_traced"] == W * H * SAMPLES
    assert p_stats["batches"] == len(t_r._batches) == 3
    assert p_stats["tracer"] == kind and len(p_stats["batch_trace_s"]) == 3
    # Mray/s numerator: primary hits x samples, not the rays traced.
    p_hits = int((p_r.primary.hits.tri >= 0).sum())
    assert p_stats["total_rays"] == p_hits * SAMPLES < p_stats["rays_traced"]

    any_hit = ray_type == "ao"
    t_tri, t_rays = _frame_samples(t_r._batches, SAMPLES, np.asarray)
    p_tri, p_rays = _frame_samples(p_r._batches, SAMPLES, lambda x: x.numpy())
    np.testing.assert_array_equal(p_r.frame_sample_tri().numpy(), p_tri)
    # Samples classify alike: hit vs miss for AO, the hit triangle for
    # diffuse (closest hit).
    differ = (t_tri >= 0) != (p_tri >= 0) if any_hit else t_tri != p_tri
    pixel = p_r.primary.slot_to_id.numpy()
    bad_px = np.unique(pixel[np.nonzero(differ)[0] // SAMPLES])
    same = np.ones(W * H, bool)
    same[bad_px] = False
    t_flat, p_flat = t_img.reshape(-1, 4), p_img.reshape(-1, 4)
    if any_hit:
        np.testing.assert_array_equal(p_flat[same], t_flat[same])
    else:
        np.testing.assert_allclose(p_flat[same], t_flat[same], rtol=0, atol=1e-6)
    # Each disputed sample is adjudicated on each side's own ray by the
    # binary oracle: either side may differ from it only on a borderline
    # hit (an edge graze, or t within fp noise of tmax; the rule of
    # tools/bench_suite.py verify_ao_frame), or on an exact-t tie (diffuse).
    ids = np.nonzero(differ)[0]
    for tri, rays in ((t_tri, t_rays), (p_tri, p_rays)):
        if not ids.size:
            break
        o, dn, tn, tx = (x[ids] for x in rays)
        s_id, s_t, s_u, s_v = trace_flat_scalar(t_r.flat, o, dn, tn, tx, any_hit=any_hit)
        margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
        border = (s_id >= 0) & ((margin < 1e-3) | np.isclose(s_t, tx, rtol=2e-4))
        if any_hit:
            wrong = ((tri[ids] >= 0) != (s_id >= 0)) & ~border
        else:
            wrong = (tri[ids] != s_id) & ~border
        assert not wrong.any(), ids[wrong]
    assert ids.size <= 3
    assert 0.2 < p_hits / (W * H) < 0.9
    if any_hit:
        # Occluded and open samples both occur; blocked AO pixels are dark.
        assert 0.0 < np.mean(p_tri[p_rays[3] >= 0] >= 0) < 1.0
    assert np.isfinite(p_img).all() and len(np.unique(p_flat, axis=0)) > 2


@pytest.mark.parametrize("ray_type", ["primary", "ao", "diffuse"])
def test_empty_scene_frame_is_background(ray_type):
    from tpu_rt_torch.scene import Camera
    from tpu_rt_torch.scene.objio import Mesh
    from tpu_rt_torch.shade.reconstruct import BG_COLOR

    r = PRenderer(8, 6, PParams(ray_type=ray_type, num_samples=2, cache_dir=None, device="cpu"))
    r.set_mesh(Mesh(np.zeros((0, 3), np.float32), None, None, [], []))
    stats = r.render_frame(Camera.for_bbox(np.zeros(3), np.ones(3)))
    assert stats["total_rays"] == (48 if ray_type == "primary" else 0)
    np.testing.assert_array_equal(r.update_result(), np.broadcast_to(BG_COLOR, (6, 8, 4)))


def test_secondary_ray_types_not_ported():
    # The secondary-ray sort and dead-ray compaction (rays/buffer.py) are
    # ported: each renders the unsorted frame's image (tests/test_torch_
    # buffer.py holds them to tpu_rt's); unknown ray types and tracers raise.
    scene = PScene(p_proc.make_blob(200, seed=3))
    images = []
    for flags in ({}, {"sort_secondary": True}, {"compact_degenerate": True}):
        r = PRenderer(8, 8, PParams(ray_type="ao", num_samples=2, ao_radius=0.5, cache_dir=None,
                                    device="cpu", **flags))
        r.set_scene(scene)
        stats = r.render_frame(p_suite_camera("bunny", scene))
        assert stats["rays_traced"] + stats["rays_skipped"] == 128
        images.append(r.update_result())
    np.testing.assert_array_equal(images[1], images[0])
    np.testing.assert_array_equal(images[2], images[0])
    with pytest.raises(ValueError):
        PRenderer(8, 8, PParams(ray_type="shadow", device="cpu"))
    with pytest.raises(ValueError, match="tracer"):
        PRenderer(8, 8, PParams(tracer="bvh8", device="cpu"))
    # Every tracer route runs and names itself.
    images = {}
    for tracer, kind in (("auto", "quad-plain"), ("packet4", "quad-plain"),
                         ("pallas", "quad-plain"), ("packet", "flat-plain"),
                         ("xla", "wavefront")):
        r = PRenderer(8, 8, PParams(ray_type="diffuse", tracer=tracer, cache_dir=None,
                                    device="cpu"))
        r.set_mesh(p_proc.make_blob(200, seed=3))
        stats = r.render_frame(p_suite_camera("bunny", r.scene))
        assert stats["tracer"] == r.active_tracer == kind
        images[tracer] = r.update_result()
    for tracer in ("packet4", "pallas", "packet", "xla"):
        np.testing.assert_array_equal(images[tracer], images["auto"])


# The binary kernel's and the wavefront's routes, rendered through the
# Renderer, against the same tpu_rt frames.
ROUTES = {"packet": "flat-plain", "xla": "wavefront"}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route_frames(request, frames, secondary_frames):
    tracer = request.param
    t_r, t_img = frames[:2]
    p_scene = PScene(p_proc.make_blob(700, seed=80))
    p_r = PRenderer(W, H, PParams(cache_dir=None, device="cpu", tracer=tracer))
    p_r.set_scene(p_scene)
    stats = p_r.render_frame(p_suite_camera("bunny", p_scene))
    out = {"primary": (t_r, t_img, p_r, p_r.update_result(), stats)}
    radius = p_suite_ao_radius("bunny", p_scene)
    for ray_type in ("ao", "diffuse"):
        t_r2, t_stats, t_img2 = secondary_frames[ray_type][:3]
        p_r2 = PRenderer(W, H, PParams(ray_type=ray_type, num_samples=SAMPLES, ao_radius=radius,
                                       max_batch=MAX_BATCH, cache_dir=None, device="cpu",
                                       tracer=tracer))
        p_r2.set_scene(p_scene)
        p_stats = p_r2.render_frame(p_suite_camera("bunny", p_scene))
        out[ray_type] = (t_r2, t_stats, t_img2, p_r2, p_stats, p_r2.update_result())
    return tracer, out


def test_route_primary_frame_matches_tpu_rt(route_frames):
    tracer, out = route_frames
    t_r, t_img, p_r, p_img, stats = out["primary"]
    assert stats["tracer"] == ROUTES[tracer] and stats["total_rays"] == W * H
    _check_primary(t_r, t_img, p_r, p_img)


@pytest.mark.parametrize("ray_type", ["ao", "diffuse"])
def test_route_secondary_frame_matches_tpu_rt(route_frames, ray_type):
    tracer, out = route_frames
    _check_secondary(*out[ray_type], ray_type, ROUTES[tracer])


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        import tpu_rt_torch
        from tpu_rt_torch.renderer import Renderer, RendererParams
        from tpu_rt_torch.scene import Camera, procedural
        r = Renderer(16, 12, RendererParams(cache_dir=None, device="cpu"))
        r.set_mesh(procedural.make_blob(200, seed=3))
        stats = r.render_frame(Camera.for_bbox(*r.scene.bbox()))
        img = r.update_result()
        assert img.shape == (12, 16, 4) and stats["total_rays"] == 192
        ao = Renderer(16, 12, RendererParams(ray_type="ao", num_samples=2, max_batch=256,
                                             ao_radius=0.5, cache_dir=None, device="cpu"))
        ao.set_scene(r.scene)
        stats = ao.render_frame(Camera.for_bbox(*r.scene.bbox()))
        img = ao.update_result()
        assert img.shape == (12, 16, 4) and stats["batches"] == 2
        import tpu_rt_torch.trace.common, tpu_rt_torch.trace.cpu_reference
        import tpu_rt_torch.trace.flat_kernel, tpu_rt_torch.trace.wavefront
        import tpu_rt_torch.probes.mxu_ablate, tpu_rt_torch.native
        import tpu_rt_torch.probes.ablate2, tpu_rt_torch.probes.mosaic_probe3
        import tpu_rt_torch.rays, tpu_rt_torch.diff, tpu_rt_torch.diff.train
        import tpu_rt_torch.debug, tpu_rt_torch.debug.dumps, tpu_rt_torch.core.intersect
        from tpu_rt_torch.diff.train import fit
        sr = Renderer(16, 12, RendererParams(ray_type="ao", num_samples=2, ao_radius=0.5,
                                             cache_dir=None, device="cpu",
                                             compact_degenerate=True))
        sr.set_scene(r.scene)
        assert sr.render_frame(Camera.for_bbox(*r.scene.bbox()))["rays_skipped"] >= 0
        rays = r.primary.rays
        state, losses = fit(r.flat, rays, r.scene.tri_vtx_index, torch.zeros(rays.num, 3),
                            r.scene.vtx_pos, r.scene.tri_material, steps=2, device="cpu")
        assert state.step == 2 and len(losses) == 2
        for tracer in ("packet", "xla"):
            rr = Renderer(16, 12, RendererParams(ray_type="ao", num_samples=2, ao_radius=0.5,
                                                 cache_dir=None, tracer=tracer, device="cpu"))
            rr.set_scene(r.scene)
            assert rr.render_frame(Camera.for_bbox(*r.scene.bbox()))["total_rays"] > 0
        import tpu_rt_torch.dist, tpu_rt_torch.dist.dryrun, tpu_rt_torch.bench.scaling
        import tpu_rt_torch.image, tpu_rt_torch.scene.objio
        from tpu_rt_torch.dist import grad_step_sharded, make_ray_mesh, shard_rays, trace_sharded
        from tpu_rt_torch.dist.sharding import replicate_bvh
        mesh = make_ray_mesh("cpu")
        srays = shard_rays(rays, mesh)
        hits = trace_sharded(replicate_bvh(r.flat, mesh), srays, mesh)
        assert torch.equal(hits.tri, r.primary.hits.tri)
        vtx, tvi, mat = (torch.as_tensor(x) for x in (r.scene.vtx_pos, r.scene.tri_vtx_index,
                                                      r.scene.tri_material))
        loss, g_vtx, g_mat = grad_step_sharded(mesh, replicate_bvh(r.flat, mesh), srays, vtx,
                                               tvi, mat, torch.zeros(rays.num, 3))
        assert g_vtx.shape == vtx.shape and g_mat.shape == mat.shape
        import tpu_rt_torch.bench.viewer, tpu_rt_torch.bench.tune_quad
        from tpu_rt_torch.bench import cli
        assert tpu_rt_torch.native.native_available() in (True, False)
        assert cli.main(["--scene", "knob", "--size", "16x12", "--warmup-repeats", "0",
                         "--measure-repeats", "1", "--device", "cpu", "--cache-dir", ""]) == 0
        import tpu_rt_torch.bench.bench, tpu_rt_torch.bench.bench_suite
        import tpu_rt_torch.bench.calibrate, tpu_rt_torch.bench.bench_diff
        row = tpu_rt_torch.bench.bench_suite.bench_row("knob", "ao", 16, 12, 1, 1, device="cpu",
                                                       cache_dir=None)
        assert row["mrays"] > 0 and row["groups"] == 6
        import tpu_rt_torch.bench.packet_stats, tpu_rt_torch.bench.treelet_sim
        import tpu_rt_torch.bench.iter_probe, tpu_rt_torch.bench.ao_probe
        import tpu_rt_torch.bench.quad_probe
        rows = tpu_rt_torch.bench.iter_probe.main(["knob", "primary"], {}, device="cpu",
                                                  cache_dir=None, width=16, height=12)
        assert rows[0]["groups"] == 6
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "tpu_rt", "optax", "orbax", "tools"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_profile_dir_writes_chrome_trace(tmp_path):
    # RendererParams.profile_dir: render_frame runs under torch.profiler and
    # writes a Chrome trace there; off by default.
    import json

    scene = PScene(p_proc.make_blob(200, seed=3))
    r = PRenderer(8, 6, PParams(cache_dir=None, device="cpu", profile_dir=str(tmp_path / "prof")))
    r.set_scene(scene)
    stats = r.render_frame(p_suite_camera("bunny", scene))
    path = stats["profile_trace"]
    assert os.path.dirname(path) == str(tmp_path / "prof") and os.path.isfile(path)
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    r2 = PRenderer(8, 6, PParams(cache_dir=None, device="cpu"))
    r2.set_scene(scene)
    assert r2.render_frame(p_suite_camera("bunny", scene))["profile_trace"] is None
