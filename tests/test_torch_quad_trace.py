"""The plain PyTorch quad tracer on tables that tpu_rt built: exact against
tpu_rt's scalar oracle, and against the Pallas packet4 kernel (interpret
mode) up to its division-vs-reciprocal rounding."""

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.bvh.collapse import collapse4, trace_quad_scalar
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace.packet2 import trace_packet4

from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.trace import make_routing_tracer, quad_kernel
from tpu_rt_torch.trace.quad_kernel import (
    STACK_SIZE,
    trace_quad,
    trace_quad_plain,
    upload_quad,
)

SCENES = {
    "blob": lambda: procedural.make_blob(700, seed=80),
    "interior": lambda: procedural.make_interior(900, seed=81),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    scene = Scene(SCENES[request.param]())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    quad = collapse4(flat)
    return scene, flat, quad, upload_quad(quad, "cpu")


def _rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 4 * size, np.float32)
    tmax[::7] = -1.0
    return origin, d.astype(np.float32), np.zeros(n, np.float32), tmax


def test_plain_equals_quad_oracle(setup):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _rays(scene, 1500, seed=10)
    # Axis-aligned and -0.0 direction components take the OOEPS clamp.
    d[:40] = np.array([0.0, -0.0, -1.0], np.float32)
    d[40:80] = np.array([-0.0, 1.0, 0.0], np.float32)
    s_id, s_t, _, _ = trace_quad_scalar(quad, o, d, tmin, tmax)
    hits = trace_quad_plain(tables, make_rays(o, d, tmin, tmax))
    np.testing.assert_array_equal(hits.tri.numpy(), s_id)
    np.testing.assert_array_equal(hits.t.numpy().view(np.int32), s_t.view(np.int32))
    assert np.all(hits.tri.numpy()[::7] == -1)
    assert 0.2 < np.mean(s_id >= 0) < 0.95


def test_plain_matches_packet4_kernel(setup):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _rays(scene, 600, seed=11)
    want = trace_packet4(quad, t_make_rays(o, d, tmin, tmax), interpret=True,
                         tile=512, k=2)
    got = trace_quad_plain(tables, make_rays(o, d, tmin, tmax))
    want_tri = np.asarray(want.tri)
    np.testing.assert_array_equal(got.tri.numpy(), want_tri)
    hit = want_tri >= 0
    # packet4 divides Oz / Dz where the oracle multiplies by 1 / Dz.
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)


def test_upload_keeps_bits(setup):
    _, _, quad, tables = setup
    assert tables.nodes.numpy().tobytes() == np.ascontiguousarray(quad.nodes).tobytes()
    woop = tables.woop.numpy()
    np.testing.assert_array_equal(woop[:, :12], quad.tri_woop)
    np.testing.assert_array_equal(woop[:, 12].view(np.int32), quad.tri_index)
    assert not woop[:, 13:].any()
    assert 1 <= tables.depth and 3 * tables.depth <= STACK_SIZE


def _chain_quad(depth):
    """A quad tree that is a chain of ``depth`` nodes ending in one leaf."""
    nodes = np.full((depth, 32), np.nan, np.float32)
    links = np.full((depth, 4), 0x7FFFFFFF, np.int32)
    for q in range(depth):
        nodes[q, 0:6] = [-1, 1, -1, 1, -1, 1]
        links[q, 0] = q + 1 if q + 1 < depth else ~(0 | (1 << 24))
    nodes[:, 24:28] = links.view(np.float32)
    nodes[:, 28:32] = np.zeros((depth, 4), np.int32).view(np.float32)
    woop = np.zeros((1, 12), np.float32)
    return type("Quad", (), {"nodes": nodes, "tri_woop": woop,
                             "tri_index": np.zeros(1, np.int32)})()


def test_upload_depth_check():
    ok = STACK_SIZE // 3
    assert upload_quad(_chain_quad(ok), "cpu").depth == ok
    with pytest.raises(ValueError, match="STACK_SIZE"):
        upload_quad(_chain_quad(ok + 1), "cpu")


def test_cpu_dispatch_and_routing(setup):
    scene, flat, quad, tables = setup
    o, d, tmin, tmax = _rays(scene, 64, seed=12)
    rays = make_rays(o, d, tmin, tmax)
    before = quad_kernel.KERNEL.launches
    fn, kind, routed = make_routing_tracer(flat, device="cpu")
    assert kind == "quad-plain" and fn is trace_quad
    assert routed.nodes.numpy().tobytes() == tables.nodes.numpy().tobytes()
    a, b = fn(routed, rays), trace_quad_plain(tables, rays)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    assert quad_kernel.KERNEL.launches == before
    with pytest.raises(NotImplementedError):
        fn(routed, rays, any_hit=True)
    for prefer in ("xla", "packet"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_routing_tracer(flat, prefer=prefer)
    with pytest.raises(ValueError):
        quad_kernel.KERNEL(tables, rays)


def test_empty_tree_misses():
    quad = type("Quad", (), {"nodes": np.zeros((0, 32), np.float32),
                             "tri_woop": np.zeros((0, 12), np.float32),
                             "tri_index": np.zeros(0, np.int32)})()
    tables = upload_quad(quad, "cpu")
    rays = make_rays(np.zeros((3, 3)), np.ones((3, 3)), np.zeros(3), [1.0, 2.0, -1.0])
    hits = trace_quad_plain(tables, rays)
    assert hits.tri.tolist() == [-1, -1, -1]
    assert hits.t.tolist() == [1.0, 2.0, -1.0]
