"""Postponed leaves (tpu_rt's C > 1 leaf cursors) in both tracers' plain
versions, on tables that tpu_rt built: t bit-equal to the host oracles on
every ray, tri equal to theirs but at exact-t ties, any-hit hit / miss
equal; tri equal to tpu_rt's Pallas kernels with ``c=`` (interpret mode);
cursors = 1 the default forms' results, counters included; the routes
and their kinds."""

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.bvh.collapse import collapse4 as t_collapse4
from tpu_rt.bvh.collapse import trace_quad_scalar
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace import RayStats, trace_flat_scalar
from tpu_rt.trace.packet2 import trace_packet2, trace_packet4

from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.trace import MAX_CURSORS, make_routing_tracer
from tpu_rt_torch.trace.flat_kernel import trace_flat, trace_flat_plain, upload_flat
from tpu_rt_torch.trace.quad_kernel import trace_quad, trace_quad_plain, upload_quad

SCENES = {
    "blob": lambda: procedural.make_blob(700, seed=80),
    "interior": lambda: procedural.make_interior(900, seed=81),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    scene = Scene(SCENES[request.param]())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    quad = t_collapse4(flat)
    return scene, flat, quad, upload_flat(flat, "cpu", "vmem", False), upload_quad(quad, "cpu",
                                                                                   "vmem")


def _rays(scene, n, seed):
    """Rays from around the scene at it, with axis-aligned and -0.0
    directions, and tmax = -1 on every 7th; in the second half short
    AO-like rays from points inside it."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:40] = np.array([0.0, -0.0, -1.0], np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    short = slice(n // 2, n)
    origin[short] = rng.uniform(lo, hi, (n - n // 2, 3)).astype(np.float32)
    tmax[short] = np.float32(0.15 * size)
    tmax[::7] = -1.0
    return origin, d, np.zeros(n, np.float32), tmax


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _woop_t(flat, tri, o, d):
    """The Woop distance of triangle ``tri`` along each ray, in the
    kernels' f32 ops and order (trace_common.cuh ``drain``)."""
    rows = np.array([np.flatnonzero(flat.tri_index == i)[0] for i in tri])
    w = np.asarray(flat.tri_woop, np.float32)[rows]
    oz = w[:, 3] - o[:, 0] * w[:, 0] - o[:, 1] * w[:, 1] - o[:, 2] * w[:, 2]
    dz = d[:, 0] * w[:, 0] + d[:, 1] * w[:, 1] + d[:, 2] * w[:, 2]
    return oz * (np.float32(1.0) / dz)


def _check_oracle(flat, got_tri, got_t, s_id, s_t, o, d):
    """t bit-equal to the oracle's on every ray; where tri differs, the
    result's own triangle is hit at exactly the oracle's t."""
    np.testing.assert_array_equal(_bits(got_t), _bits(s_t))
    disputed = np.flatnonzero(got_tri != s_id)
    if disputed.size:
        assert (got_tri[disputed] >= 0).all() and (s_id[disputed] >= 0).all()
        np.testing.assert_array_equal(
            _bits(_woop_t(flat, got_tri[disputed], o[disputed], d[disputed])),
            _bits(s_t[disputed]))
    assert disputed.size <= 3


TRACERS = {"flat": (trace_flat_plain, 3), "quad": (trace_quad_plain, 4)}


@pytest.mark.parametrize("cursors", [2, 3])
@pytest.mark.parametrize("tree", sorted(TRACERS))
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_postponed_leaves_keep_the_oracles_hits(setup, tree, cursors, any_hit):
    scene, flat, quad, ft, qt = setup
    o, d, tmin, tmax = _rays(scene, 1500, seed=50 + cursors)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    plain = TRACERS[tree][0]
    tables = ft if tree == "flat" else qt
    hits, counts = plain(tables, rays, any_hit, True, True, cursors=cursors)
    base, base_counts = plain(tables, rays, any_hit, True, True)
    if tree == "flat":
        s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit)
    else:
        s_id, s_t, _, _ = trace_quad_scalar(quad, o, d, tmin, tmax, any_hit=any_hit)
    tri, t = hits.tri.numpy(), hits.t.numpy()
    np.testing.assert_array_equal(tri >= 0, s_id >= 0)
    if not any_hit:
        _check_oracle(flat, tri, t, s_id, s_t, o, d)
        # Leaves tighten the hit distance later: at least as many tests.
        assert int(counts["node_tests"].sum()) >= int(base_counts["node_tests"].sum())
        assert int(counts["tri_tests"].sum()) >= int(base_counts["tri_tests"].sum())
    # Rays skipped (tmax < 0) stay untouched.
    skip = tmax < 0
    assert (tri[skip] == -1).all() and (counts["node_tests"].numpy()[skip] == 0).all()


@pytest.mark.parametrize("cursors", [2, 3])
def test_flat_postponed_matches_packet2_cursors(setup, cursors):
    scene, flat, _, ft, _ = setup
    o, d, tmin, tmax = _rays(scene, 2 * 512 + 131, seed=9)
    want = trace_packet2(flat, t_make_rays(o, d, tmin, tmax), interpret=True, tile=512, k=2,
                         c=cursors, hbm=cursors == 3)
    got = trace_flat_plain(ft, make_rays(o, d, tmin, tmax, device="cpu"), cursors=cursors)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    # packet2 divides Oz / Dz where the port multiplies by 1 / Dz:
    # test_pallas.py's tolerance.
    hit = np.asarray(want.tri) >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5, atol=1e-6)


def test_flat_postponed_any_hit_matches_packet2(setup):
    scene, flat, _, ft, _ = setup
    o, d, tmin, tmax = _rays(scene, 700, seed=10)
    want = trace_packet2(flat, t_make_rays(o, d, tmin, tmax), any_hit=True, interpret=True,
                         tile=512, k=2, c=3)
    got = trace_flat_plain(ft, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=True,
                           cursors=3)
    np.testing.assert_array_equal(got.tri.numpy() >= 0, np.asarray(want.tri) >= 0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_quad_postponed_matches_packet4_cursors(setup, any_hit):
    scene, flat, quad, _, qt = setup
    o, d, tmin, tmax = _rays(scene, 700, seed=11)
    want = trace_packet4(quad, t_make_rays(o, d, tmin, tmax), any_hit=any_hit, interpret=True,
                         c=2)
    got = trace_quad_plain(qt, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=any_hit,
                           cursors=2)
    want_tri = np.asarray(want.tri)
    if any_hit:
        np.testing.assert_array_equal(got.tri.numpy() >= 0, want_tri >= 0)
    else:
        np.testing.assert_array_equal(got.tri.numpy(), want_tri)


@pytest.mark.parametrize("tree", sorted(TRACERS))
def test_one_cursor_is_the_first_versions_trace(setup, tree):
    scene, flat, _, ft, qt = setup
    o, d, tmin, tmax = _rays(scene, 600, seed=12)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    for any_hit in (False, True):
        if tree == "flat":
            a = trace_flat(ft, rays, any_hit, True, True, cursors=1)
            b = trace_flat_plain(ft, rays, any_hit, True, True)
        else:
            a = trace_quad(qt, rays, any_hit, True, True, cursors=1)
            b = trace_quad_plain(qt, rays, any_hit, True, True)
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    if tree == "flat":
        # ... whose counters are RayStats'.
        rs = RayStats()
        trace_flat_scalar(flat, o, d, tmin, tmax, stats=rs)
        _, counts = trace_flat(ft, rays, with_stats=True, cursors=1)
        np.testing.assert_array_equal(counts["node_tests"].numpy(), rs.per_ray_node_tests)
        np.testing.assert_array_equal(counts["tri_tests"].numpy(), rs.per_ray_tri_tests)


@pytest.mark.parametrize("tree", sorted(TRACERS))
def test_postponed_visits_mark_the_rows_their_counters_count(setup, tree):
    # The bound of chip_smoke.py counts the rows a plain trace marks.
    scene, flat, _, ft, qt = setup
    o, d, tmin, tmax = _rays(scene, 300, seed=13)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    seen = {}
    plain, _ = TRACERS[tree]
    _, counts = plain(ft if tree == "flat" else qt, rays, False, False, True, visited=seen,
                      cursors=3)
    assert int(seen["nodes"].sum()) <= int(counts["node_tests"].sum())
    assert 0 < int(seen["woop"].sum()) <= int(counts["tri_tests"].sum())


def test_routes_take_cursors(setup):
    scene, flat, *_ = setup
    o, d, tmin, tmax = _rays(scene, 300, seed=14)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    for prefer, kind in (("packet", "flat-plain-c2"), ("packet4", "quad-plain-c2"),
                         ("auto", "quad-plain-c2"), ("pallas", "quad-plain-c2")):
        fn, got_kind, tables = make_routing_tracer(flat, prefer, "cpu", cursors=2)
        assert got_kind == kind
        plain = trace_flat_plain if kind.startswith("flat") else trace_quad_plain
        a, b = fn(tables, rays), plain(tables, rays, cursors=2)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    _, kind, _ = make_routing_tracer(flat, "packet", "cpu", cursors=1)
    assert kind == "flat-plain"
    for bad in (0, MAX_CURSORS + 1):
        with pytest.raises(ValueError):
            make_routing_tracer(flat, "packet", "cpu", cursors=bad)
    with pytest.raises(TypeError):
        make_routing_tracer(flat, "packet", "cpu", cursors=2.0)
    with pytest.raises(ValueError):
        make_routing_tracer(flat, "xla", "cpu", cursors=2)
