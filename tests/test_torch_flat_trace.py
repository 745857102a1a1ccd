"""The port's binary-BVH tracer on tables that tpu_rt built: its host oracle
copy bit-equal to tpu_rt's; the plain PyTorch version of the binary kernel
exact against the oracle (tri, t, u, v and both counters, closest and any
hit) and against the Pallas packet2 kernel (interpret mode) up to its
division-vs-reciprocal rounding (closest hit) or on hit vs miss (any hit,
whose packet vote may pick another occluder); the table upload, the
stack-depth refusal and the routing."""

import warnings

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace import RayStats as TRayStats
from tpu_rt.trace import assign_treelets as t_assign_treelets
from tpu_rt.trace import intersect_brute as t_intersect_brute
from tpu_rt.trace import trace_flat_scalar as t_trace_flat_scalar
from tpu_rt.trace.packet2 import trace_packet2

from tpu_rt_torch.bvh.flatten import woopify
from tpu_rt_torch.core.types import FlatBVH, make_rays
from tpu_rt_torch.trace import (
    RayStats,
    TRACERS,
    StackDepthError,
    assign_treelets,
    flat_kernel,
    intersect_brute,
    make_routing_tracer,
    quad_kernel,
    trace_flat_scalar,
)
from tpu_rt_torch.trace.common import FORMS, STACK_SIZE
from tpu_rt_torch.trace.flat_kernel import trace_flat, trace_flat_plain, upload_flat

SCENES = {
    "blob": lambda: procedural.make_blob(700, seed=80),
    "interior": lambda: procedural.make_interior(900, seed=81),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    scene = Scene(SCENES[request.param]())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    return scene, flat, upload_flat(flat, "cpu")


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
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    d[:40] = np.array([0.0, -0.0, -1.0], np.float32)
    d[40:80] = np.array([-0.0, 1.0, 0.0], np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    short = slice(n // 2, n)
    origin[short] = rng.uniform(lo, hi, (n - n // 2, 3)).astype(np.float32)
    tmax[short] = np.float32(0.15 * size)
    tmax[::7] = -1.0
    return origin, d, np.zeros(n, np.float32), tmax


def _bits(x):
    return np.asarray(x).view(np.int32)


def test_cpu_reference_bit_equal(setup):
    scene, flat, _ = setup
    o, d, tmin, tmax = _rays(scene, 300, seed=20)
    for any_hit in (False, True):
        t_st, p_st = TRayStats(), RayStats()
        tl = t_assign_treelets(flat, max_nodes=16)
        np.testing.assert_array_equal(assign_treelets(flat, max_nodes=16), tl)
        want = t_trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit, stats=t_st,
                                   treelets=tl)
        got = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit, stats=p_st, treelets=tl)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for field in ("num_rays", "num_node_tests", "num_triangle_tests", "num_treelets"):
            assert getattr(p_st, field) == getattr(t_st, field), field
        for field in ("per_ray_node_tests", "per_ray_tri_tests", "per_ray_treelets"):
            np.testing.assert_array_equal(getattr(p_st, field), getattr(t_st, field))
    got = intersect_brute(scene.triangles(), o, d, tmin, tmax)
    want = t_intersect_brute(scene.triangles(), o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_equals_flat_oracle(setup, any_hit):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 1200, seed=21)
    st = RayStats()
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit, stats=st)
    hits, counts = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"),
                                    any_hit=any_hit, want_uv=True, with_stats=True)
    # tri (for any hit: the same occluder), t, u and v bit-equal; the
    # counters count what RayStats counts.
    np.testing.assert_array_equal(hits.tri.numpy(), s_id)
    for got, want in ((hits.t, s_t), (hits.u, s_u), (hits.v, s_v)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(counts["node_tests"].numpy(), st.per_ray_node_tests)
    np.testing.assert_array_equal(counts["tri_tests"].numpy(), st.per_ray_tri_tests)
    assert counts["node_tests"].dtype == counts["tri_tests"].dtype == torch.int32
    dead = tmax < 0
    assert np.all(hits.tri.numpy()[dead] == -1) and not counts["node_tests"].numpy()[dead].any()
    assert 0.1 < np.mean(s_id >= 0) < 0.95
    # The frame form returns the same (tri, t) and u = v = 0.
    frame = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=any_hit)
    assert torch.equal(frame.tri, hits.tri) and torch.equal(frame.t, hits.t)
    assert not frame.u.any() and not frame.v.any()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_matches_packet2_kernel(setup, any_hit):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 700, seed=22)
    want = trace_packet2(flat, t_make_rays(o, d, tmin, tmax), any_hit=any_hit, interpret=True,
                         tile=512, k=2)
    got = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=any_hit)
    want_tri = np.asarray(want.tri)
    if any_hit:
        # The packet kernel orders children by a split-axis vote, so only
        # hit vs miss is held equal (as tests/test_pallas.py holds it).
        np.testing.assert_array_equal(got.tri.numpy() >= 0, want_tri >= 0)
    else:
        np.testing.assert_array_equal(got.tri.numpy(), want_tri)
        # packet2 divides Oz / Dz where the oracle multiplies by 1 / Dz, and
        # sums Oz in another order: t is held to test_pallas.py's tolerance
        # on the long rays from outside (the first half); the short rays
        # start at points near surfaces, where Oz cancels.
        hit = (want_tri >= 0) & (np.arange(len(want_tri)) < len(want_tri) // 2)
        np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5,
                                   atol=1e-6)


def test_upload_keeps_bits(setup):
    _, flat, tables = setup
    # torch.equal is False on NaN patterns, so compare int32 views.
    assert torch.equal(tables.nodes.view(torch.int32),
                       torch.from_numpy(np.ascontiguousarray(flat.nodes).view(np.int32)))
    woop = tables.woop.numpy()
    np.testing.assert_array_equal(_bits(woop[:, :12]), _bits(flat.tri_woop))
    np.testing.assert_array_equal(woop[:, 12].view(np.int32), flat.tri_index)
    assert not woop[:, 13:].any()
    np.testing.assert_array_equal(tables.leaf_counts.numpy(), flat.leaf_counts)
    assert tables.leaf_counts.dtype == torch.int32
    assert 1 <= tables.depth <= STACK_SIZE


def _chain_flat(depth, per_leaf=1):
    """A binary tree that is a chain of ``depth`` inner nodes along x: node i
    holds leaf i as child 0 and node i + 1 (the last: leaf ``depth``) as
    child 1; leaf i is ``per_leaf`` copies of the unit triangle at x = i.
    Returns the FlatBVH and its triangles [(depth + 1) * per_leaf, 3, 3]."""
    k, m = depth + 1, per_leaf
    tris = np.zeros((k * m, 3, 3), np.float32)
    tris[:, :, 0] = np.repeat(np.arange(k), m)[:, None]
    tris[:, 1, 1] = 1.0
    tris[:, 2, 2] = 1.0
    nodes = np.zeros((depth, 16), np.float32)
    links = np.zeros((depth, 4), np.int32)
    for i in range(depth):
        # child 0: leaf i's box; child 1: the rest of the chain.
        nodes[i, 0:4] = [i, i, 0, 1]
        nodes[i, 8:10] = [0, 1]
        nodes[i, 4:8] = [i + 1, depth, 0, 1]
        nodes[i, 10:12] = [0, 1]
        last = i + 1 == depth
        links[i] = [~(i * m), ~(depth * m) if last else i + 1, m, m if last else 0]
    nodes[:, 12:16] = links.view(np.float32)
    woop = woopify(np.arange(3 * k * m).reshape(-1, 3), tris.reshape(-1, 3), np.arange(k * m))
    counts = np.zeros(k * m + 1, np.int32)
    counts[np.arange(k) * m] = m
    flat = FlatBVH(nodes=nodes, tri_woop=woop, tri_index=np.arange(k * m, dtype=np.int32),
                   leaf_counts=counts)
    return flat, tris


def test_deep_tree_refused_and_traced():
    # A tree of STACK_SIZE levels is traced as the oracle traces it (every
    # level pushes); one level more is refused, not clipped.
    flat, tris = _chain_flat(STACK_SIZE)
    tables = upload_flat(flat, "cpu")
    assert tables.depth == STACK_SIZE
    n = 64
    rng = np.random.default_rng(23)
    o = np.stack([np.full(n, -1.0), rng.uniform(0.05, 0.3, n), rng.uniform(0.05, 0.3, n)], 1)
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1))
    o, tmin = o.astype(np.float32), np.zeros(n, np.float32)
    tmax = rng.uniform(0.5, STACK_SIZE + 3, n).astype(np.float32)
    for any_hit in (False, True):
        st = RayStats()
        s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit, stats=st)
        hits, counts = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"),
                                        any_hit=any_hit, with_stats=True)
        np.testing.assert_array_equal(hits.tri.numpy(), s_id)
        np.testing.assert_array_equal(_bits(hits.t.numpy()), _bits(s_t))
        np.testing.assert_array_equal(counts["node_tests"].numpy(), st.per_ray_node_tests)
        np.testing.assert_array_equal(counts["tri_tests"].numpy(), st.per_ray_tri_tests)
    b_id, _, _, _ = intersect_brute(tris, o, d, tmin, tmax)
    np.testing.assert_array_equal(s_id >= 0, b_id >= 0)
    with pytest.raises(StackDepthError, match="STACK_SIZE"):
        upload_flat(_chain_flat(STACK_SIZE + 1)[0], "cpu")


def test_auto_falls_to_binary_only_for_a_deep_quad_tree():
    # A 64-level chain with 9-triangle leaves (two cannot merge into one
    # 16-wide leaf) collapses to a quad tree of 22 levels, deeper than the
    # quad stack holds (3 * 22 > STACK_SIZE); the binary stack holds its 64
    # levels.  "auto" and "pallas" warn and take the binary kernel,
    # "packet4" raises.
    flat, _ = _chain_flat(STACK_SIZE, per_leaf=9)
    for prefer in ("auto", "pallas"):
        with pytest.warns(RuntimeWarning, match="flat-plain"):
            fn, kind, tables = make_routing_tracer(flat, prefer=prefer, device="cpu")
        assert kind == "flat-plain" and fn.func is trace_flat and tables.depth == STACK_SIZE
    with pytest.raises(StackDepthError, match="quad"):
        make_routing_tracer(flat, prefer="packet4", device="cpu")
    # A tree neither stack holds raises: "auto" never falls to the
    # wavefront, whose stack is no deeper.
    deep, _ = _chain_flat(STACK_SIZE + 1, per_leaf=9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for prefer in TRACERS:
            with pytest.raises(StackDepthError):
                make_routing_tracer(deep, prefer=prefer, device="cpu")


def test_empty_tree_and_degenerate_rays():
    empty = FlatBVH(nodes=np.zeros((0, 16), np.float32), tri_woop=np.zeros((0, 12), np.float32),
                    tri_index=np.zeros(0, np.int32), leaf_counts=np.zeros(1, np.int32))
    tables = upload_flat(empty, "cpu")
    assert tables.depth == 0 and tables.woop.shape == (1, 16)
    rays = make_rays(np.zeros((3, 3)), np.ones((3, 3)), np.zeros(3), [1.0, 2.0, -1.0], device="cpu")
    for any_hit in (False, True):
        hits, counts = trace_flat_plain(tables, rays, any_hit=any_hit, want_uv=True,
                                        with_stats=True)
        assert hits.tri.tolist() == [-1, -1, -1]
        assert hits.t.tolist() == [1.0, 2.0, -1.0]
        assert not hits.u.any() and not counts["node_tests"].any()


def test_port_flat_uploads_alike():
    # The port's own build of a scene gives tpu_rt's device tables.
    from tpu_rt_torch.bvh import load_or_build_bvh as p_load_or_build_bvh
    from tpu_rt_torch.scene import Scene as PScene
    from tpu_rt_torch.scene import procedural as p_proc

    t_flat, _ = load_or_build_bvh(Scene(procedural.make_blob(300, seed=26)), cache_dir=None)
    p_flat, _ = p_load_or_build_bvh(PScene(p_proc.make_blob(300, seed=26)), cache_dir=None)
    a, b = upload_flat(p_flat, "cpu"), upload_flat(t_flat, "cpu")
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and x.numpy().tobytes() == y.numpy().tobytes()
    assert a.depth == b.depth >= 1


def test_cpu_dispatch_and_routing(setup):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 64, seed=25)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    before = flat_kernel.KERNEL.launches, quad_kernel.KERNEL.launches
    fn, kind, routed = make_routing_tracer(flat, prefer="packet", device="cpu", want_uv=True)
    assert kind == "flat-plain" and fn.func is trace_flat
    assert torch.equal(routed.nodes.view(torch.int32), tables.nodes.view(torch.int32))
    for any_hit in (False, True):
        a = fn(routed, rays, any_hit=any_hit)
        b = trace_flat_plain(tables, rays, any_hit=any_hit, want_uv=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        (c, cs), (e, es) = (fn(routed, rays, any_hit=any_hit, with_stats=True),
                            trace_flat_plain(tables, rays, any_hit, True, True))
        assert torch.equal(c.tri, e.tri) and torch.equal(cs["tri_tests"], es["tri_tests"])
    # On the CPU no kernel launched; the wrapper refuses CPU tensors.
    assert (flat_kernel.KERNEL.launches, quad_kernel.KERNEL.launches) == before
    assert flat_kernel.KERNEL.launches_by_form == dict.fromkeys(FORMS, 0)
    for any_hit in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            flat_kernel.KERNEL(tables, rays, any_hit=any_hit)
    with pytest.raises(ValueError, match="unknown tracer"):
        make_routing_tracer(flat, prefer="bvh8", device="cpu")


def test_upload_bf16_records(setup):
    # bf16 tables: the node records of tables.pack_bf16_nodes, the same
    # Woop rows, leaf counts and depth as the f32 tables.
    from tpu_rt_torch.trace.tables import pack_bf16_nodes

    _, flat, f32 = setup
    for residency in ("vmem", "mixed", "hbm"):
        t = upload_flat(flat, "cpu", residency=residency, bf16_nodes=True)
        assert (t.residency, t.bf16_nodes, t.depth) == (residency, True, f32.depth)
        assert t.nodes.dtype == torch.int32 and t.nodes.shape == (flat.nodes.shape[0], 8)
        np.testing.assert_array_equal(t.nodes.numpy(), pack_bf16_nodes(flat.nodes))
        assert torch.equal(t.woop.view(torch.int32), f32.woop.view(torch.int32))
        assert torch.equal(t.leaf_counts, f32.leaf_counts)
