"""The frozen generators and camera rules equal the port's, bit for bit."""

import numpy as np
import pytest

from rtbench.data import procedural, workload
from tpu_rt_torch.bench import workload as port_workload
from tpu_rt_torch.scene import Scene
from tpu_rt_torch.scene import procedural as port_procedural

CASES = [
    ("make_interior", {"target_tris": 350_949, "seed": 13}),
    ("make_interior", {"target_tris": 4_321, "seed": 2}),
    ("make_blob", {"target_tris": 20_000, "seed": 16, "roughness": 0.3}),
    ("make_blob", {"target_tris": 12_570, "seed": 10, "roughness": 0.08, "ground": True}),
]


def _same(ours: procedural.Mesh, theirs):
    assert ours.positions.dtype == theirs.positions.dtype == np.float32
    np.testing.assert_array_equal(ours.positions, theirs.positions)
    assert len(ours.submeshes) == len(theirs.submeshes)
    for a, b in zip(ours.submeshes, theirs.submeshes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for d, n, m in zip(ours.diffuse, ours.names, theirs.materials):
        np.testing.assert_array_equal(d, m.diffuse)
        assert n == m.name


@pytest.mark.parametrize("name,args", CASES)
def test_generator_equals_port(name, args):
    _same(procedural.GENERATORS[name](**args), getattr(port_procedural, name)(**args))


@pytest.mark.parametrize("config", ["conference", "dragon"])
def test_configured_generator_is_the_suites(config):
    """Each configuration names the suite's own stand-in (scene_by_name)."""
    import json
    import os

    from rtbench import paths

    with open(os.path.join(paths.BENCH_DIR, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    src = port_procedural._SUITE[config].__code__
    assert cfg["generator"]["name"] in src.co_names
    assert set(cfg["generator"]["args"].values()) <= set(src.co_consts)
    assert cfg["triangles"] == cfg["generator"]["args"]["target_tris"]


@pytest.mark.parametrize("scene,name,args", [
    ("conference", "make_interior", {"target_tris": 20_000, "seed": 13}),
    ("dragon", "make_blob", {"target_tris": 20_000, "seed": 16, "roughness": 0.3}),
])
def test_camera_and_radius_equal_port(scene, name, args):
    mesh = procedural.GENERATORS[name](**args)
    port_scene = Scene(getattr(port_procedural, name)(**args))
    ours = workload.suite_camera(scene, mesh.positions)
    theirs = port_workload.suite_camera(scene, port_scene)
    for k in ("position", "forward", "up"):
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))
    for k in ("fov", "near", "far"):
        assert ours[k] == getattr(theirs, k)
    assert workload.suite_ao_radius(scene, mesh.positions) == \
        port_workload.suite_ao_radius(scene, port_scene)


def test_poses_same_set_in_the_same_order_for_every_seed():
    mesh = procedural.make_interior(5_000, seed=13)
    conf = {"mode": "yaw", "spread_deg": 4.0, "jitter_deg": 0.5, "jitter_pos": 0.002,
            "count": 8}
    a = workload.camera_poses("conference", mesh.positions, conf, np.random.default_rng(1))
    b = workload.camera_poses("conference", mesh.positions, conf, np.random.default_rng(2))
    base = workload.suite_camera("conference", mesh.positions)

    def yaw(c):
        return np.degrees(np.arctan2(c["forward"][0], c["forward"][2]))

    spread = np.array([yaw(c) - yaw(base) for c in a])
    other = np.array([yaw(c) - yaw(base) for c in b])
    # The same spread of poses 4 degrees apart, moved by at most the jitter.
    np.testing.assert_allclose(spread, other, atol=1.01)
    np.testing.assert_allclose(np.diff(spread), 4.0, atol=1.01)
    assert not np.allclose(spread, other, atol=1e-6)
