"""The plain PyTorch quad tracer on tables that tpu_rt built, closest hit
and any hit, with and without u, v and the per-ray counters: exact against
tpu_rt's scalar oracle, and against the Pallas packet4 kernel (interpret
mode) up to its division-vs-reciprocal rounding (closest hit) or on hit vs
miss (any hit, whose packet vote may pick another occluder)."""

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
from tpu_rt_torch.trace.common import FORMS
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
    hits = trace_quad_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"))
    np.testing.assert_array_equal(hits.tri.numpy(), s_id)
    np.testing.assert_array_equal(hits.t.numpy().view(np.int32), s_t.view(np.int32))
    assert np.all(hits.tri.numpy()[::7] == -1)
    assert 0.2 < np.mean(s_id >= 0) < 0.95


def _any_hit_rays(scene, n, seed):
    """Long rays through the scene (several occluders each) and, in the
    second half, short AO-like rays from points inside it, with
    axis-aligned, -0.0 and tmax = -1 rays among them."""
    o, d, tmin, tmax = _rays(scene, n, seed=seed)
    d[:40] = np.array([0.0, -0.0, -1.0], np.float32)
    d[40:80] = np.array([-0.0, 1.0, 0.0], np.float32)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    rng = np.random.default_rng(seed + 1)
    short = slice(n // 2, n)
    o[short] = rng.uniform(lo, hi, (n - n // 2, 3)).astype(np.float32)
    tmax[short] = np.float32(0.15 * size)
    tmax[short][::7] = -1.0
    return o, d, tmin, tmax


def test_plain_any_hit_equals_quad_oracle(setup):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _any_hit_rays(scene, 1200, seed=13)
    s_id, s_t, _, _ = trace_quad_scalar(quad, o, d, tmin, tmax, any_hit=True)
    hits = trace_quad_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=True)
    # The first accepted hit in the oracle's visit order: tri equal (which
    # occluder, too) and t bit-equal.
    np.testing.assert_array_equal(hits.tri.numpy(), s_id)
    np.testing.assert_array_equal(hits.t.numpy().view(np.int32), s_t.view(np.int32))
    assert np.all(hits.tri.numpy()[tmax < 0] == -1)
    assert 0.1 < np.mean(s_id >= 0) < 0.95
    # Any hit stops early: on some rays it reports another, farther
    # occluder than the closest hit, never a nearer one.
    c_id, c_t, _, _ = trace_quad_scalar(quad, o, d, tmin, tmax)
    np.testing.assert_array_equal(s_id >= 0, c_id >= 0)
    assert np.any(s_id != c_id) and np.all(s_t >= c_t)


def test_plain_any_hit_matches_packet4_kernel(setup):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _any_hit_rays(scene, 1000, seed=14)
    want = trace_packet4(quad, t_make_rays(o, d, tmin, tmax), any_hit=True, interpret=True,
                         tile=512, k=2)
    got = trace_quad_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=True)
    # The packet kernel orders children by a packet vote, so only hit vs
    # miss is held equal (as tests/test_pallas.py holds it).
    np.testing.assert_array_equal(got.tri.numpy() >= 0, np.asarray(want.tri) >= 0)


def test_plain_matches_packet4_kernel(setup):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _rays(scene, 600, seed=11)
    want = trace_packet4(quad, t_make_rays(o, d, tmin, tmax), interpret=True,
                         tile=512, k=2)
    got = trace_quad_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"))
    want_tri = np.asarray(want.tri)
    np.testing.assert_array_equal(got.tri.numpy(), want_tri)
    hit = want_tri >= 0
    # packet4 divides Oz / Dz where the oracle multiplies by 1 / Dz.
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_uv_and_counters(setup, any_hit):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _any_hit_rays(scene, 1000, seed=15)
    s_id, s_t, s_u, s_v = trace_quad_scalar(quad, o, d, tmin, tmax, any_hit=any_hit)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    hits, counts = trace_quad_plain(tables, rays, any_hit=any_hit, want_uv=True,
                                    with_stats=True)
    # u, v of the accepted hit bit-equal to the oracle's, as t is.
    np.testing.assert_array_equal(hits.tri.numpy(), s_id)
    for got, want in ((hits.t, s_t), (hits.u, s_u), (hits.v, s_v)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # The other forms give the same (tri, t); the frame forms u = v = 0.
    for want_uv in (False, True):
        for with_stats in (False, True):
            out = trace_quad(tables, rays, any_hit, want_uv, with_stats)
            h = out[0] if with_stats else out
            assert torch.equal(h.tri, hits.tri) and torch.equal(h.t, hits.t)
            assert torch.equal(h.u, hits.u) if want_uv else not h.u.any()
    # Counters: a live ray visits the root at least; a dead one does
    # nothing.  Any hit walks the closest-hit path up to its first accepted
    # hit and stops there, so it never does more work.
    live = tmax >= 0
    nt, tt = counts["node_tests"].numpy(), counts["tri_tests"].numpy()
    sk = counts["stack"].numpy()
    assert counts["node_tests"].dtype == counts["stack"].dtype == torch.int32
    assert np.all(nt[live] >= 1) and not nt[~live].any() and not tt[~live].any()
    # The stack holds at most 3 entries a level.  A closest-hit ray tests
    # every node it pushes, so one that tested one node pushed none.
    assert not sk[~live].any() and sk.max() <= 3 * tables.depth and sk.max() > 0
    assert any_hit or not sk[nt == 1].any()
    assert np.all(tt[hits.tri.numpy() >= 0] >= 1)
    if any_hit:
        _, c_counts = trace_quad_plain(tables, rays, with_stats=True)
        assert np.all(nt <= c_counts["node_tests"].numpy())
        assert np.all(sk <= c_counts["stack"].numpy())
        assert np.all(tt <= c_counts["tri_tests"].numpy())
        assert np.any(tt < c_counts["tri_tests"].numpy())


def test_plain_uv_matches_packet4_kernel(setup):
    scene, _, quad, tables = setup
    o, d, tmin, tmax = _rays(scene, 600, seed=16)
    want = trace_packet4(quad, t_make_rays(o, d, tmin, tmax), interpret=True, tile=512, k=2,
                         want_uv=True)
    got = trace_quad_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), want_uv=True)
    want_tri = np.asarray(want.tri)
    np.testing.assert_array_equal(got.tri.numpy(), want_tri)
    hit = want_tri >= 0
    # tests/test_pallas.py's tolerance for packet4's u, v.
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[hit], np.asarray(want.v)[hit], rtol=1e-3, atol=1e-4)


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


def _comb_quad(levels):
    """A quad tree of ``levels`` comb nodes over one level of empty inner
    nodes (depth ``levels`` + 1): comb node q holds, in stored order, comb
    node q + 1 (the last: a leaf of one triangle) and three inner nodes
    with no children; every box is [-1, 1]^3, every hint axis x."""
    rows = 4 * levels
    nodes = np.full((rows, 32), np.nan, np.float32)
    links = np.full((rows, 4), 0x7FFFFFFF, np.int32)
    for q in range(levels):
        nodes[q, 0:24] = [-1, 1] * 12
        links[q] = [q + 1 if q + 1 < levels else ~(0 | (1 << 24)),
                    *(levels + 3 * q + j for j in range(3))]
    nodes[:, 24:28] = links.view(np.float32)
    nodes[:, 28:32] = np.zeros((rows, 4), np.int32).view(np.float32)
    woop = np.zeros((1, 12), np.float32)
    return type("Quad", (), {"nodes": nodes, "tri_woop": woop,
                             "tri_index": np.zeros(1, np.int32)})()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_stack_counter_by_hand(any_hit):
    # Along +x every comb node is visited in stored order: it goes to the
    # next comb node and pushes its three empty nodes, and the last pushes
    # two (its first child is the leaf), so the stack holds 3 L - 1 entries
    # at once.  Along -x (reversed order) each comb node pushes three, the
    # walk pops the two empty ones and the next comb node: 3 at once.  A
    # ray that misses the root's boxes or has nothing to trace pushes none.
    # None passes the 3 x depth that the upload allows.
    levels = STACK_SIZE // 3 - 1
    tables = upload_quad(_comb_quad(levels), "cpu")
    assert tables.depth == levels + 1
    o = np.float32([[-5, 0.1, 0.2], [5, 0.1, 0.2], [-5, 3, 3], [-5, 0.1, 0.2],
                    [-5, 0.1, 0.2]])
    d = np.float32([[1, 0, 0], [-1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]])
    tmax = np.float32([100, 100, 100, 1, -1])
    _, counts = trace_quad_plain(tables, make_rays(o, d, np.zeros(5), tmax, device="cpu"),
                                 any_hit=any_hit, with_stats=True)
    assert counts["stack"].dtype == torch.int32
    assert counts["stack"].tolist() == [3 * levels - 1, 3, 0, 0, 0]
    assert int(counts["stack"].max()) <= 3 * tables.depth <= STACK_SIZE


def test_upload_depth_check():
    ok = STACK_SIZE // 3
    assert upload_quad(_chain_quad(ok), "cpu").depth == ok
    with pytest.raises(ValueError, match="STACK_SIZE"):
        upload_quad(_chain_quad(ok + 1), "cpu")


def test_cpu_dispatch_and_routing(setup):
    scene, flat, quad, tables = setup
    o, d, tmin, tmax = _rays(scene, 64, seed=12)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    before = quad_kernel.KERNEL.launches
    fn, kind, routed = make_routing_tracer(flat, device="cpu")
    assert kind == "quad-plain" and fn.func is trace_quad
    assert routed.nodes.numpy().tobytes() == tables.nodes.numpy().tobytes()
    a, b = fn(routed, rays), trace_quad_plain(tables, rays)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    c, d = fn(routed, rays, any_hit=True), trace_quad_plain(tables, rays, any_hit=True)
    assert torch.equal(c.tri, d.tri) and torch.equal(c.t, d.t)
    assert quad_kernel.KERNEL.launches == before
    assert quad_kernel.KERNEL.launches_by_form == dict.fromkeys(FORMS, 0)
    # The binary kernel and the wavefront run and name their route.
    for prefer, want_kind in (("packet", "flat-plain"), ("xla", "wavefront"),
                              ("pallas", "quad-plain"), ("packet4", "quad-plain")):
        fn2, kind2, tables2 = make_routing_tracer(flat, prefer=prefer, device="cpu")
        assert kind2 == want_kind
        assert torch.equal(fn2(tables2, rays).tri, a.tri)
    with pytest.raises(ValueError, match="unknown tracer"):
        make_routing_tracer(flat, prefer="packet8", device="cpu")
    with pytest.raises(ValueError):
        quad_kernel.KERNEL(tables, rays)
    with pytest.raises(ValueError):
        quad_kernel.KERNEL(tables, rays, any_hit=True)


def test_empty_tree_misses():
    quad = type("Quad", (), {"nodes": np.zeros((0, 32), np.float32),
                             "tri_woop": np.zeros((0, 12), np.float32),
                             "tri_index": np.zeros(0, np.int32)})()
    tables = upload_quad(quad, "cpu")
    rays = make_rays(np.zeros((3, 3)), np.ones((3, 3)), np.zeros(3), [1.0, 2.0, -1.0], device="cpu")
    for any_hit in (False, True):
        hits = trace_quad_plain(tables, rays, any_hit=any_hit)
        assert hits.tri.tolist() == [-1, -1, -1]
        assert hits.t.tolist() == [1.0, 2.0, -1.0]


@pytest.mark.parametrize("residency", ["mixed", "hbm"])
def test_wide_leaves_plain_equals_quad_oracle(setup, residency):
    # The large-scene collapse (quad_policy's 32-wide leaves) in a streamed
    # residency: the plain version still equals tpu_rt's oracle on that
    # tree bit for bit, closest and any hit.
    scene, flat, _, _ = setup
    quad = collapse4(flat, leaf_max=32)
    tables = upload_quad(quad, "cpu", residency=residency)
    assert tables.residency == residency
    o, d, tmin, tmax = _rays(scene, 800, seed=14)
    for any_hit in (False, True):
        s_id, s_t, _, _ = trace_quad_scalar(quad, o, d, tmin, tmax, any_hit=any_hit)
        hits = trace_quad_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=any_hit)
        np.testing.assert_array_equal(hits.tri.numpy(), s_id)
        np.testing.assert_array_equal(hits.t.numpy().view(np.int32),
                                      np.asarray(s_t, np.float32).view(np.int32))
