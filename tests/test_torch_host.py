"""The port's host code (scene, camera, pixel LUTs, SBVH, flatten, collapse)
is bit-equal to tpu_rt's on the same inputs."""

import dataclasses
import os

import numpy as np
import pytest

import tpu_rt.bench.workload as t_workload
import tpu_rt.bvh as t_bvh
import tpu_rt.core.math as t_math
from tpu_rt.bench.workload import suite_camera as t_suite_camera
from tpu_rt.bvh.collapse import collapse4 as t_collapse4
from tpu_rt.scene import Camera as TCamera
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

import tpu_rt_torch.bench.workload as p_workload
import tpu_rt_torch.bvh as p_bvh
import tpu_rt_torch.core.math as p_math
from tpu_rt_torch.bench.workload import suite_camera as p_suite_camera
from tpu_rt_torch.bvh.collapse import collapse4 as p_collapse4
from tpu_rt_torch.bvh.collapse import validate_quad
from tpu_rt_torch.scene import Camera as PCamera
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import procedural as p_proc

SCENES = {
    "blob": lambda proc: proc.make_blob(700, seed=80),
    "interior": lambda proc: proc.make_interior(900, seed=81),
}


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    make = SCENES[request.param]
    return TScene(make(t_proc)), PScene(make(p_proc))


def test_scene_arrays_bit_equal(scenes):
    ts, ps = scenes
    for name in ("vtx_pos", "tri_vtx_index", "tri_normal", "tri_material",
                 "tri_material_u32", "tri_shaded", "tri_shaded_u32"):
        assert bits_equal(getattr(ts, name), getattr(ps, name)), name
    assert ts.hash() == ps.hash()
    assert [bits_equal(x, y) for x, y in zip(ts.bbox(), ps.bbox())] == [True, True]


def test_scene_by_name_bit_equal():
    ts, ps = TScene(t_proc.scene_by_name("knob")), PScene(p_proc.scene_by_name("Mori-Knob"))
    assert ps.num_triangles == 12_570
    assert bits_equal(ts.vtx_pos, ps.vtx_pos)
    assert bits_equal(ts.tri_vtx_index, ps.tri_vtx_index)
    assert p_proc.suite_names() == t_proc.suite_names()


def test_native_source_is_the_ports_own_copy():
    # The port compiles its own sbvh.cc, never a file of the JAX package;
    # below its header comment the code is tpu_rt's line for line.
    import tpu_rt.native as t_native
    import tpu_rt_torch.native as p_native

    src = os.path.abspath(p_native.SRC)
    assert src.startswith(os.path.dirname(os.path.abspath(p_native.__file__)))

    def code(path):
        lines = open(path).read().splitlines()
        return lines[next(i for i, ln in enumerate(lines) if not ln.startswith("//")):]

    assert code(src) == code(os.path.join(os.path.dirname(t_native.__file__), "sbvh.cc"))


def test_native_available_equals_tpu_rt(monkeypatch):
    import tpu_rt.native as t_native
    import tpu_rt_torch.native as p_native

    assert p_native.native_available() is t_native.native_available() is True
    assert p_native.build_error() is None
    # A build that failed reports False and its error, as in tpu_rt.
    monkeypatch.setattr(p_native, "_lib", None)
    monkeypatch.setattr(p_native, "_build_error", "g++: not found")
    assert p_native.native_available() is False
    assert p_native.build_error() == "g++: not found"


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_flat_bvh_bit_equal(scenes, backend):
    ts, ps = scenes
    t_flat, t_stats = t_bvh.load_or_build_bvh(ts, cache_dir=None, backend=backend)
    p_flat, p_stats = p_bvh.load_or_build_bvh(ps, cache_dir=None, backend=backend)
    for name in ("nodes", "tri_woop", "tri_index", "leaf_counts"):
        assert bits_equal(getattr(t_flat, name), getattr(p_flat, name)), name
    assert dataclasses.asdict(t_stats) == dataclasses.asdict(p_stats)


def test_quad_bvh_bit_equal(scenes):
    ts, ps = scenes
    t_flat, _ = t_bvh.load_or_build_bvh(ts, cache_dir=None)
    p_flat, _ = p_bvh.load_or_build_bvh(ps, cache_dir=None)
    t_quad, p_quad = t_collapse4(t_flat), p_collapse4(p_flat)
    for name in ("nodes", "tri_woop", "tri_index"):
        assert bits_equal(getattr(t_quad, name), getattr(p_quad, name)), name
    validate_quad(p_quad, ps.num_triangles)


def test_quad_cache_round_trip(scenes, tmp_path):
    _, ps = scenes
    flat, _ = p_bvh.load_or_build_bvh(ps, cache_dir=str(tmp_path))
    built = p_bvh.load_or_collapse_quad(flat, cache_dir=str(tmp_path))
    cached = p_bvh.load_or_collapse_quad(flat, cache_dir=str(tmp_path))
    again, _ = p_bvh.load_or_build_bvh(ps, cache_dir=str(tmp_path))
    assert all(bits_equal(a, b) for a, b in zip(built, cached))
    assert all(bits_equal(a, b) for a, b in zip(flat, again))


def test_camera_matrices_bit_equal(scenes):
    ts, ps = scenes
    cams = [
        (t_suite_camera("bunny", ts), p_suite_camera("bunny", ps)),
        (t_suite_camera("sponza", ts), p_suite_camera("sponza", ps)),
        (TCamera.for_bbox(*ts.bbox(), elevation_deg=25.0),
         PCamera.for_bbox(*ps.bbox(), elevation_deg=25.0)),
    ]
    for tc, pc in cams:
        for m in ("orientation", "camera_to_world", "world_to_camera", "world_to_clip"):
            assert bits_equal(getattr(tc, m)(), getattr(pc, m)()), m
        assert bits_equal(tc.nscreen_to_world(64, 48), pc.nscreen_to_world(64, 48))
        assert tc.encode_signature() == pc.encode_signature()
    assert p_workload.SCENE_FOV == t_workload.SCENE_FOV


def test_camera_signature_codec():
    sig = '"6omr/04j3200bR6Z/0/3ZEAz/x4smy19///c/05frY109Qx7w////m100",'
    tc, pc = TCamera.decode_signature(sig), PCamera.decode_signature(sig)
    assert pc.encode_signature() == sig == tc.encode_signature()
    assert bits_equal(tc.world_to_clip(), pc.world_to_clip())


@pytest.mark.parametrize("size", [(64, 48), (67, 45), (5, 3), (640, 480)])
def test_pixel_luts_bit_equal(size):
    t_i2p, t_p2i = t_math.pixel_morton_luts(*size)
    p_i2p, p_p2i = p_math.pixel_morton_luts(*size)
    assert bits_equal(t_i2p, p_i2p) and bits_equal(t_p2i, p_p2i)
    np.testing.assert_array_equal(p_p2i[p_i2p], np.arange(size[0] * size[1]))


def test_math_helpers_bit_equal():
    rng = np.random.default_rng(3)
    rgba = rng.uniform(-0.2, 1.2, (257, 4)).astype(np.float32)
    assert bits_equal(t_math.to_abgr(rgba), p_math.to_abgr(rgba))
    words = rng.integers(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
    assert t_math.hash_buffer(words) == p_math.hash_buffer(words)
    assert t_math.hash_bits(1, 2, 3, 4, 5) == p_math.hash_bits(1, 2, 3, 4, 5)
    a, b, c = words[:30], words[30:60], words[60:90]
    for x, y in zip(t_math.jenkins_mix(a, b, c), p_math.jenkins_mix(a, b, c)):
        assert bits_equal(x, y)
    f = rng.normal(size=64).astype(np.float32)
    assert bits_equal(t_math.float_to_bits(f), p_math.float_to_bits(f))
    assert bits_equal(p_math.bits_to_float(p_math.float_to_bits(f)), f)
    assert bits_equal(t_math.normalize(f.reshape(16, 4)), p_math.normalize(f.reshape(16, 4)))
