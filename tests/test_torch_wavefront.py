"""The port's wavefront tracer (the "xla" route) against tpu_rt's
``trace_wavefront`` on the CPU: the same function in PyTorch ops, with
tpu_rt's arithmetic (a true division for t), so hits agree to
tests/test_trace.py's tolerances and the per-ray counters exactly."""

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace import device_bvh as t_device_bvh
from tpu_rt.trace import trace_wavefront as t_trace_wavefront

from tpu_rt_torch.core.types import FlatBVH, make_rays
from tpu_rt_torch.trace import (
    RayStats,
    StackDepthError,
    make_routing_tracer,
    trace_flat_scalar,
)
from tpu_rt_torch.trace.flat_kernel import trace_flat_plain, upload_flat
from tpu_rt_torch.trace.wavefront import STACK_DEPTH, device_bvh, trace_wavefront

SCENES = {
    "blob": lambda: procedural.make_blob(1500, seed=21),
    "interior": lambda: procedural.make_interior(1200, seed=22),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    scene = Scene(SCENES[request.param]())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    return scene, flat, t_device_bvh(flat), device_bvh(flat, "cpu")


def _rays(scene, n, seed):
    """As tests/test_trace.py's rays from outside, with tmax = -1 on every
    5th ray and a quarter of short rays from points inside the scene."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = (lo + hi) / 2 + rng.normal(size=(n, 3)) * size
    target = rng.uniform(lo, hi, (n, 3))
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 4 * size, np.float32)
    inside = slice(3 * n // 4, n)
    origin[inside] = rng.uniform(lo, hi, (n - 3 * n // 4, 3))
    tmax[inside] = 0.2 * size
    tmax[::5] = -1.0
    return (origin.astype(np.float32), d.astype(np.float32), np.zeros(n, np.float32), tmax)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_wavefront_matches_tpu_rt(setup, any_hit):
    scene, flat, t_dbvh, p_dbvh = setup
    o, d, tmin, tmax = _rays(scene, 600, seed=30)
    want, want_st = t_trace_wavefront(t_dbvh, t_make_rays(o, d, tmin, tmax), any_hit=any_hit,
                                      with_stats=True)
    got, got_st = trace_wavefront(p_dbvh, make_rays(o, d, tmin, tmax, device="cpu"),
                                  any_hit=any_hit, with_stats=True)
    w_tri = np.asarray(want.tri)
    np.testing.assert_array_equal(got.tri.numpy(), w_tri)
    hit = w_tri >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.t.numpy()[~hit], tmax[~hit])
    # tests/test_trace.py's u, v tolerance vs the oracle is 1e-3 / 1e-4;
    # between the two wavefronts (XLA contracts and reorders the sums; a
    # last-bit change of t moves u by t's error times the Woop row's D,
    # up to ~1e-4 relative) 1e-4 / 1e-5 holds.
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[hit], np.asarray(want.v)[hit], rtol=1e-4, atol=1e-5)
    for k in ("node_tests", "tri_tests"):
        assert got_st[k].dtype == torch.int32
        np.testing.assert_array_equal(got_st[k].numpy(), np.asarray(want_st[k]))
    assert 0.2 < hit.mean() < 0.95


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_wavefront_matches_oracle_and_binary_plain(setup, any_hit):
    scene, flat, _, p_dbvh = setup
    o, d, tmin, tmax = _rays(scene, 500, seed=31)
    st = RayStats()
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit, stats=st)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    got, counts = trace_wavefront(p_dbvh, rays, any_hit=any_hit, with_stats=True)
    # tests/test_trace.py's tolerances (test_wavefront_matches_scalar).
    np.testing.assert_array_equal(got.tri.numpy(), s_id)
    hit = s_id >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], s_t[hit], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.u.numpy()[hit], s_u[hit], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[hit], s_v[hit], rtol=1e-3, atol=1e-4)
    # The binary kernel's plain version takes the oracle's hits and counts.
    # The wavefront divides where they multiply by 1 / Dz, so its hit
    # distance can differ in the last bit mid-walk and flip a later slab
    # test: its counters are held equal on nearly every ray only.
    k_hits, k_counts = trace_flat_plain(upload_flat(flat, "cpu"), rays, any_hit=any_hit,
                                        with_stats=True)
    np.testing.assert_array_equal(k_hits.tri.numpy(), got.tri.numpy())
    np.testing.assert_array_equal(k_counts["node_tests"].numpy(), st.per_ray_node_tests)
    for k in ("node_tests", "tri_tests", "stack"):
        same = (k_counts[k] == counts[k]).float().mean()
        assert same >= 0.99, (k, same)


def test_device_bvh_keeps_bits_and_refuses_deep_trees(setup):
    _, flat, _, p_dbvh = setup
    for got, want in zip(p_dbvh, flat):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()
    # tpu_rt clips the stack at STACK_DEPTH silently; the port refuses a
    # tree deeper than that when it uploads it.
    depth = STACK_DEPTH + 1
    nodes = np.zeros((depth, 16), np.float32)
    links = np.zeros((depth, 4), np.int32)
    links[:, 0] = ~0
    links[:-1, 1] = np.arange(1, depth)
    links[-1, 1] = ~0
    nodes[:, 12:16] = links.view(np.float32)
    deep = FlatBVH(nodes=nodes, tri_woop=np.zeros((1, 12), np.float32),
                   tri_index=np.zeros(1, np.int32), leaf_counts=np.array([1, 0], np.int32))
    with pytest.raises(StackDepthError, match="STACK_SIZE"):
        device_bvh(deep, device="cpu")
    shallow = FlatBVH(nodes[1:].copy(), deep.tri_woop, deep.tri_index, deep.leaf_counts)
    links[1:, 1] -= 1
    shallow.nodes[:, 12:16] = links[1:].view(np.float32)
    assert device_bvh(shallow, device="cpu").nodes.shape == (STACK_DEPTH, 16)


def test_empty_tree_and_degenerate_rays():
    empty = FlatBVH(nodes=np.zeros((0, 16), np.float32), tri_woop=np.zeros((0, 12), np.float32),
                    tri_index=np.zeros(0, np.int32), leaf_counts=np.zeros(1, np.int32))
    rays = make_rays(np.zeros((3, 3)), np.ones((3, 3)), np.zeros(3), [1.0, 2.0, -1.0], device="cpu")
    for any_hit in (False, True):
        hits, counts = trace_wavefront(device_bvh(empty, device="cpu"), rays, any_hit=any_hit,
                                       with_stats=True)
        assert hits.tri.tolist() == [-1, -1, -1] and hits.t.tolist() == [1.0, 2.0, -1.0]
        assert not counts["node_tests"].any() and not counts["tri_tests"].any()


def test_xla_route(setup):
    scene, flat, _, p_dbvh = setup
    o, d, tmin, tmax = _rays(scene, 64, seed=32)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    fn, kind, tables = make_routing_tracer(flat, prefer="xla", device="cpu")
    assert kind == "wavefront" and fn is trace_wavefront
    for a, b in zip(tables, p_dbvh):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for any_hit in (False, True):
        got = fn(tables, rays, any_hit=any_hit)
        want = trace_wavefront(p_dbvh, rays, any_hit=any_hit)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert np.all(got.tri.numpy()[::5] == -1)
