"""The port's host intersection primitives (core/intersect.py) and golden
dumps (debug/dumps.py) against tpu_rt's: equal outputs, byte-equal files."""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_rt.debug as t_debug
from tpu_rt.core import intersect as t_intersect
from tpu_rt.core.types import Hits as THits
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.debug.dumps import load_rays as t_load_rays

import tpu_rt_torch.debug as p_debug
from tpu_rt_torch.bvh import build_sbvh, flatten_bvh, woopify
from tpu_rt_torch.core import intersect as p_intersect
from tpu_rt_torch.core.types import Hits, make_rays
from tpu_rt_torch.debug.dumps import load_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import device_bvh


@pytest.fixture(scope="module")
def small():
    scene = Scene(procedural.make_blob(300, seed=90))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    return scene, flat


def same_files(a_dir, b_dir, names):
    assert sorted(os.listdir(a_dir)) == sorted(os.listdir(b_dir)) == sorted(names)
    for n in names:
        assert filecmp.cmp(os.path.join(a_dir, n), os.path.join(b_dir, n), shallow=False), n


def test_hex_dump_roundtrip_and_bytes(tmp_path):
    vals = np.array([0.0, -0.0, 1.5, -2.25, np.float32(np.pi), np.inf, np.nan], np.float32)
    (tmp_path / "p").mkdir()
    (tmp_path / "t").mkdir()
    p_debug.dump_hex_words(str(tmp_path / "p" / "w.txt"), torch.tensor(vals))
    t_debug.dump_hex_words(str(tmp_path / "t" / "w.txt"), vals)
    same_files(tmp_path / "p", tmp_path / "t", ["w.txt"])
    lines = (tmp_path / "p" / "w.txt").read_text().splitlines()
    assert lines[0] == "00000000" and lines[1] == "80000000"
    back = p_debug.load_hex_words(str(tmp_path / "p" / "w.txt"))
    np.testing.assert_array_equal(back.view(np.uint32), vals.view(np.uint32))


@pytest.mark.parametrize("where", ["host", "device"])
def test_bvh_and_triangle_dumps_byte_equal(small, tmp_path, where):
    _, flat = small
    src = flat if where == "host" else device_bvh(flat, "cpu")
    p_dir, t_dir = str(tmp_path / "p"), str(tmp_path / "t")
    p_files = p_debug.dump_bvh_nodes(src, p_dir) + p_debug.dump_woop_triangles(src, p_dir)
    t_files = t_debug.dump_bvh_nodes(flat, t_dir) + t_debug.dump_woop_triangles(flat, t_dir)
    assert len(p_files) == 20
    assert [os.path.basename(f) for f in p_files] == [os.path.basename(f) for f in t_files]
    same_files(p_dir, t_dir, [os.path.basename(f) for f in p_files])
    tx = p_debug.load_hex_words(os.path.join(p_dir, "triangle_x.txt"))
    np.testing.assert_array_equal(tx.reshape(-1, 3), flat.tri_woop[:, [0, 4, 8]])


def test_ray_dump_byte_equal_and_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    args = (rng.normal(size=(32, 3)), rng.normal(size=(32, 3)), np.zeros(32), np.ones(32))
    p_path, t_path = str(tmp_path / "p.dump"), str(tmp_path / "t.dump")
    rays = make_rays(*args, device="cpu")
    p_debug.dump_rays(rays, p_path)
    t_debug.dump_rays(t_make_rays(*args), t_path)
    assert filecmp.cmp(p_path, t_path, shallow=False)
    assert np.fromfile(p_path, dtype="<f4").size == 32 * 8
    back = load_rays(p_path, device="cpu")
    t_back = t_load_rays(t_path)
    for x, y, z in zip(back, rays, t_back):
        assert x.is_contiguous() and torch.equal(x, y)
        np.testing.assert_array_equal(x.numpy(), np.asarray(z))


def test_ray_result_dump_byte_equal(tmp_path):
    tri, t = np.array([3, -1, 7], np.int32), np.array([1.5, 8.0, 1e-7], np.float32)
    zero = np.zeros(3, np.float32)
    p_path, t_path = str(tmp_path / "p.txt"), str(tmp_path / "t.txt")
    p_debug.dump_ray_results(Hits(*(torch.tensor(x) for x in (tri, t, zero, zero))), p_path)
    t_debug.dump_ray_results(THits(jnp.asarray(tri), jnp.asarray(t), zero, zero), t_path)
    assert filecmp.cmp(p_path, t_path, shallow=False)
    assert open(p_path).read().splitlines() == ["3 1.5", "-1 8", "7 1e-07"]


def test_ray_box_equal():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(200, 3)).astype(np.float32) * 3
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d[:5, 0] = 0.0  # axis-parallel rays: infinite slabs
    lo, hi = rng.normal(size=(200, 3)) - 1, rng.normal(size=(200, 3)) + 1
    for box in (([-1, -1, -1], [1, 1, 1]), (lo, hi)):
        got = p_intersect.ray_box(*box, o, d, 0.0, 10.0)
        want = t_intersect.ray_box(*box, o, d, 0.0, 10.0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    hit, near, far = p_intersect.ray_box([-1, -1, -1], [1, 1, 1], [[-2, 0, 0]], [[1, 0, 0]], 0.0, 10.0)
    assert hit[0] and np.isclose(near[0], 1.0) and np.isclose(far[0], 3.0)


def test_ray_triangle_and_woop_equal(small):
    scene, _ = small
    rng = np.random.default_rng(3)
    k = 64
    ids = rng.integers(0, scene.num_triangles, k)
    tris = scene.triangles()[ids]
    centroid = tris.mean(axis=1)
    o = centroid + rng.normal(size=(k, 3)).astype(np.float32)
    d = centroid - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7] = -d[::7]  # some rays point away
    mt = p_intersect.ray_triangle(tris[:, 0], tris[:, 1], tris[:, 2], o, d, 0.0, 100.0)
    for a, b in zip(mt, t_intersect.ray_triangle(tris[:, 0], tris[:, 1], tris[:, 2], o, d,
                                                 0.0, 100.0)):
        np.testing.assert_array_equal(a, b)
    w = woopify(scene.tri_vtx_index, scene.vtx_pos, ids)
    wp = p_intersect.ray_triangle_woop(w, o, d, 0.0, 100.0)
    for a, b in zip(wp, t_intersect.ray_triangle_woop(w, o, d, 0.0, 100.0)):
        np.testing.assert_array_equal(a, b)
    hit_mt, t_mt = mt[0], mt[1]
    hit_w, t_w = wp[0], wp[1]
    np.testing.assert_array_equal(hit_w, hit_mt)
    assert hit_mt.any() and not hit_mt.all()
    np.testing.assert_allclose(t_w[hit_w], t_mt[hit_mt], rtol=1e-4, atol=1e-5)
