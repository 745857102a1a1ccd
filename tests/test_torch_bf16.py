"""The binary tracer's bf16 node records and streamed residencies on tables
that tpu_rt built: the plain PyTorch version on bf16 records against the
Pallas packet2 kernel's bf16 forms (interpret mode) in each residency, and
against the f32 oracle ``trace_flat_scalar`` (t bit-equal on every ray, tri
only at exact-t ties); the mixed and hbm tables of both kernels giving the
vmem tables' results bit for bit."""

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace.packet2 import trace_packet2

from tpu_rt_torch.bvh.collapse import collapse4
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.trace import trace_flat_scalar
from tpu_rt_torch.trace.flat_kernel import trace_flat, trace_flat_plain, upload_flat
from tpu_rt_torch.trace.quad_kernel import trace_quad_plain, upload_quad
from tpu_rt_torch.trace.tables import RESIDENCIES

SCENES = {
    "blob": lambda: procedural.make_blob(700, seed=80),
    "interior": lambda: procedural.make_interior(900, seed=81),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    scene = Scene(SCENES[request.param]())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    return scene, flat, upload_flat(flat, "cpu", "vmem", True)


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
    return np.asarray(x, np.float32).view(np.int32)


def _woop_t(flat, tri, o, d):
    """The Woop distance of triangle ``tri`` along each ray, in the
    kernels' f32 ops and order (trace_common.cuh ``drain``)."""
    rows = np.array([np.flatnonzero(flat.tri_index == i)[0] for i in tri])
    w = np.asarray(flat.tri_woop, np.float32)[rows]
    oz = w[:, 3] - o[:, 0] * w[:, 0] - o[:, 1] * w[:, 1] - o[:, 2] * w[:, 2]
    dz = d[:, 0] * w[:, 0] + d[:, 1] * w[:, 1] + d[:, 2] * w[:, 2]
    return oz * (np.float32(1.0) / dz)


@pytest.mark.parametrize("residency", RESIDENCIES)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bf16_plain_matches_packet2_bf16(setup, residency, any_hit):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 600, seed=40)
    want = trace_packet2(flat, t_make_rays(o, d, tmin, tmax), any_hit=any_hit, interpret=True,
                         tile=512, k=2, bf16_nodes=True, hbm=residency)
    got = trace_flat_plain(upload_flat(flat, "cpu", residency, True),
                           make_rays(o, d, tmin, tmax, device="cpu"), any_hit=any_hit)
    want_tri = np.asarray(want.tri)
    if any_hit:
        # The packet kernel orders children by a split-axis vote: hit vs
        # miss is what both hold equal.
        np.testing.assert_array_equal(got.tri.numpy() >= 0, want_tri >= 0)
    else:
        np.testing.assert_array_equal(got.tri.numpy(), want_tri)
        # packet2 divides Oz / Dz where the port multiplies by 1 / Dz, and
        # sums Oz in another order: test_torch_flat_trace.py's tolerance on
        # the long rays from outside.
        hit = (want_tri >= 0) & (np.arange(len(want_tri)) < len(want_tri) // 2)
        np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_bf16_plain_keeps_the_f32_hits(setup, any_hit):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 1500, seed=41)
    s_id, s_t, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=any_hit)
    hits, counts = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"),
                                    any_hit=any_hit, want_uv=True, with_stats=True)
    tri, t = hits.tri.numpy(), hits.t.numpy()
    np.testing.assert_array_equal(tri >= 0, s_id >= 0)
    if any_hit:
        return
    # Outward-rounded boxes lose no hit: t bit-equal on every ray; tri may
    # differ only where another triangle is hit at exactly the same t.
    np.testing.assert_array_equal(_bits(t), _bits(s_t))
    disputed = np.flatnonzero(tri != s_id)
    if disputed.size:
        np.testing.assert_array_equal(
            _bits(_woop_t(flat, tri[disputed], o[disputed], d[disputed])), _bits(s_t[disputed]))
    assert disputed.size <= 3
    # Larger boxes: at least as many node visits in total as the f32 tree.
    f32 = trace_flat_plain(upload_flat(flat, "cpu", "vmem", False),
                           make_rays(o, d, tmin, tmax, device="cpu"), with_stats=True)[1]
    assert int(counts["node_tests"].sum()) >= int(f32["node_tests"].sum())


def test_bf16_dispatch_on_the_cpu(setup):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 200, seed=42)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    for any_hit in (False, True):
        a = trace_flat(tables, rays, any_hit=any_hit, want_uv=True, with_stats=True)
        b = trace_flat_plain(tables, rays, any_hit, True, True)
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])


@pytest.mark.parametrize("residency", ["mixed", "hbm"])
def test_streamed_residencies_give_the_vmem_results(setup, residency):
    # The residency is a cache policy of the kernels' loads: the plain
    # results of both kernels, every form, are the vmem tables' bit for bit.
    scene, flat, _ = setup
    o, d, tmin, tmax = _rays(scene, 400, seed=43)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    quad = collapse4(flat)
    pairs = [(trace_flat_plain, upload_flat(flat, "cpu", "vmem", bf16),
              upload_flat(flat, "cpu", residency, bf16)) for bf16 in (False, True)]
    pairs.append((trace_quad_plain, upload_quad(quad, "cpu", "vmem"),
                  upload_quad(quad, "cpu", residency)))
    for plain, vmem, streamed in pairs:
        assert streamed.residency == residency and vmem.residency == "vmem"
        assert torch.equal(streamed.nodes.view(torch.int32), vmem.nodes.view(torch.int32))
        for any_hit in (False, True):
            (a, ac), (b, bc) = (plain(streamed, rays, any_hit, True, True),
                                plain(vmem, rays, any_hit, True, True))
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))
            assert all(torch.equal(ac[k], bc[k]) for k in ac)
