"""The plain reference against hand-built rays and hits, and its ray
generation against the port's on the same inputs (the port is read here
only by the tests; the reference imports none of it)."""

import ast
import os

import numpy as np
import pytest
import torch

from rtbench import paths
from rtbench.reference import intersect, judge, raygen

F64 = torch.float64
# One unit triangle in the z = 0 plane, a second behind it at z = -1.
POS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, -1], [1, 0, -1], [0, 1, -1],
                [5, 5, 5], [6, 5, 5], [5, 6, 5]], np.float32)
IDX = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)


def _scene():
    return judge.RefScene.build(POS, IDX, np.tile([0.5, 0.5, 0.5, 1.0], (3, 1)).astype(
        np.float32), F64, "cpu")


def _rays(xy, tmax=10.0):
    n = len(xy)
    o = torch.tensor([[x, y, 1.0] for x, y in xy], dtype=F64)
    d = torch.tensor([[0.0, 0.0, -1.0]] * n, dtype=F64)
    return o, d, torch.zeros(n, dtype=F64), torch.full((n,), tmax, dtype=F64)


def test_scan_depths_and_candidates():
    sc = _scene()
    s = intersect.scan(sc.tris, *_rays([(0.25, 0.25), (2.0, 2.0), (0.5, 0.5)]))
    # Inside both triangles by 0.25, the far one 2 / L past tmin; the
    # hypotenuse is hit exactly.
    assert s.depth[0].item() == pytest.approx(min(0.25, 2.0 / sc.extent))
    assert s.depth[1].item() < -0.5
    assert abs(s.depth[2].item()) < 1e-12
    assert s.tri[0, :2].tolist() == [0, 1]
    assert s.t[0, :2].tolist() == pytest.approx([1.0, 2.0])


def test_hit_gap_closest():
    sc = _scene()
    rays = _rays([(0.25, 0.25)] * 4)
    gap = judge.hit_gap(sc, rays, [0, 1, -1, 2], [1.0, 2.0, 10.0, 1.0], any_hit=False)
    assert gap[0] == 0.0
    # The far triangle is hit, but a nearer one is, by 0.25 and 1 / L.
    assert gap[1] == pytest.approx(min(0.25, 1.0 / sc.extent))
    assert gap[2] == pytest.approx(min(0.25, 2.0 / sc.extent))  # a miss of a hit
    assert gap[3] == 1.0                           # a triangle the ray misses


def test_hit_gap_any_hit_and_t():
    sc = _scene()
    rays = _rays([(0.25, 0.25)] * 3)
    gap = judge.hit_gap(sc, rays, [1, 0, 0], [2.0, 1.0, 1.5], any_hit=True)
    assert gap[0] == 0.0 and gap[1] == 0.0
    assert gap[2] == pytest.approx(0.5 / sc.extent)
    # tmax cuts the far triangle: an any hit on it is out of range.
    short = _rays([(0.25, 0.25)], tmax=1.5)
    assert judge.hit_gap(sc, short, [1], [2.0], any_hit=True)[0] > 0


def test_morton_table_equals_port():
    from tpu_rt_torch.core.math import pixel_morton_luts

    for w, h in ((640, 480), (32, 24), (37, 29), (5, 3)):
        np.testing.assert_array_equal(raygen.morton_index_to_pixel(w, h),
                                      pixel_morton_luts(w, h)[0])


def test_rotation_word_and_halton_equal_port():
    from tpu_rt_torch.raygen import generators

    slots = np.arange(0, 5000, 7)
    seed = 3_987_654_321
    _, _, c = generators._hash_words(seed, 0, 5000, "cpu")
    np.testing.assert_array_equal(raygen.rotation_word(seed, slots), c.numpy()[slots])
    j = np.arange(64)
    np.testing.assert_allclose(raygen.halton(j, 2),
                               generators._halton2(torch.as_tensor(j)).double(), atol=1e-7)
    np.testing.assert_allclose(raygen.halton(j, 3),
                               generators._halton3(torch.as_tensor(j)).double(), atol=1e-6)


def _cam():
    return {"position": np.array([0.3, 1.2, 4.0], np.float32),
            "forward": np.array([-0.1, -0.2, -1.0], np.float32) / np.float32(
                np.linalg.norm([-0.1, -0.2, -1.0])),
            "up": np.array([0, 1, 0], np.float32), "fov": 46.8, "near": 0.002, "far": 6.0}


def test_primary_and_ao_rays_near_port():
    from tpu_rt_torch.raygen import RayGen
    from tpu_rt_torch.scene import Camera
    from tpu_rt_torch.core.types import Hits

    cam = _cam()
    w, h = 40, 30
    rays, s2i, _ = RayGen().primary(Camera(**cam), w, h, device="cpu")
    ours = raygen.primary_rays(cam, w, h, s2i.numpy(), F64, "cpu")
    # Both form and apply the camera matrix in float32.
    assert (ours[1] - rays.dirn.double()).abs().max() < 1e-6
    assert (ours[3] == rays.tmax.double()).all()
    # AO rays around hand-made hits on a tilted plane.
    n = rays.num
    normal = torch.tensor([[0.0, 0.6, 0.8]]).expand(n, 3).contiguous()
    t = torch.linspace(1.0, 3.0, n)
    tri = torch.where(torch.arange(n) % 7 == 0, -1, 0).int()
    out = RayGen(1 << 20).ao(rays, Hits(tri, t, t * 0, t * 0), normal, 4, 0.7, True, seed=99)
    ao = out[0]
    k = torch.arange(n * 4)
    mine = raygen.ao_rays(rays.origin.double()[k // 4], rays.dirn.double()[k // 4],
                          t.double()[k // 4], normal.double()[k // 4], (tri >= 0)[k // 4],
                          (k % 4).numpy(), raygen.rotation_word(99, (k // 4).numpy()), 0.7,
                          F64)
    live = ao.tmax >= 0
    assert (mine[3] == ao.tmax.double()).all()
    assert (mine[0] - ao.origin.double())[live].abs().max() < 1e-5
    assert (mine[1] - ao.dirn.double())[live].abs().max() < 1e-5


def test_reference_imports_nothing_of_the_program():
    banned = {"tpu_rt", "tpu_rt_torch", "jax", "jaxlib", "flax"}
    for root in ("reference", "data"):
        d = os.path.join(paths.BENCH_DIR, root)
        for f in os.listdir(d):
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                assert not {n.split(".")[0] for n in names} & banned, (f, names)
