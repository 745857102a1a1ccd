"""The port's secondary-ray sort (rays/buffer.py) against tpu_rt's: Morton
keys bit-equal, every permutation equal (the order of equal keys included),
the live-prefix trace, RayBuffer addressing, and sorted / compacted frames
through the Renderer."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_rt.core.math as t_math
from tpu_rt.bench.workload import suite_ao_radius as t_suite_ao_radius
from tpu_rt.bench.workload import suite_camera as t_suite_camera
from tpu_rt.core.types import Hits as THits
from tpu_rt.core.types import Rays as TRays
from tpu_rt.rays import RayBuffer as TRayBuffer
from tpu_rt.rays import buffer as t_buf
from tpu_rt.renderer import Renderer as TRenderer
from tpu_rt.renderer import RendererParams as TParams
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

import tpu_rt_torch.core.math as p_math
from tpu_rt_torch.bench.workload import suite_camera as p_suite_camera
from tpu_rt_torch.bvh import build_sbvh, flatten_bvh
from tpu_rt_torch.core.types import Hits, Rays, make_rays
from tpu_rt_torch.rays import RayBuffer
from tpu_rt_torch.rays import buffer as p_buf
from tpu_rt_torch.renderer import Renderer as PRenderer
from tpu_rt_torch.renderer import RendererParams as PParams
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import procedural as p_proc
from tpu_rt_torch.trace import trace_flat_scalar


def ray_batch(case: str, n: int = 4000, seed: int = 0):
    """(origin, dirn, tmax) as numpy.  "random": normal origins and
    directions; "special": also rows of NaN / +-inf / 1e20 origins, zero,
    NaN and inf directions, and a block of identical rays (equal keys);
    "ties": a few distinct rays repeated many times, shuffled."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tmax = rng.uniform(-1, 1, n).astype(np.float32)
    if case == "special":
        o[:6] = [[np.nan, 0, 0], [np.inf, 1, 1], [-np.inf, 0, 0], [1e20, 0, 0],
                 [0, 0, np.nan], [-1e20, 2, 3]]
        d[6:9] = 0
        d[9] = [np.nan, 1, 0]
        d[10] = [np.inf, 0, 0]
        o[100:900] = o[100]
        d[100:900] = d[100]
    elif case == "ties":
        pick = rng.integers(0, 7, n)
        o, d = o[pick], d[pick]
    return o, d, tmax


CASES = ("random", "special", "ties")


@pytest.mark.parametrize("case", CASES)
def test_device_keys_bit_equal(case):
    o, d, _ = ray_batch(case)
    want = np.asarray(t_buf.ray_morton_keys_device(o, d)).astype(np.int64)
    got = p_buf.ray_morton_keys_device(torch.tensor(o), torch.tensor(d)).numpy()
    assert got.dtype == np.int64 and got.shape == (o.shape[0], 6)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got <= 0xFFFFFFFF).all()


@pytest.mark.parametrize("case", CASES)
def test_host_keys_bit_equal(case):
    # The host oracle copy equals tpu_rt's everywhere.  The device keys
    # (tpu_rt's and the port's) normalize the direction with another norm
    # than the host's np.linalg.norm: on rows of a finite origin and
    # direction they equal the host keys, computed in the batch box of the
    # finite origins, wherever the two normalized directions are equal.
    o, d, _ = ray_batch(case)
    fin = np.isfinite(o).all(1)
    lo, hi = o[fin].min(0), o[fin].max(0)
    with np.errstate(invalid="ignore"):
        host = p_math.ray_morton_keys(o, d, lo, hi)
        np.testing.assert_array_equal(host, t_math.ray_morton_keys(o, d, lo, hi))
        n_host = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    dev = p_buf.ray_morton_keys_device(torch.tensor(o), torch.tensor(d)).numpy()
    td = torch.tensor(d)
    n_dev = (td / torch.linalg.vector_norm(td, dim=1, keepdim=True).clamp_min(1e-30)).numpy()
    rows = fin & np.isfinite(d).all(1)
    same_n = (n_host == n_dev).all(1)
    np.testing.assert_array_equal(dev[rows & same_n], host[rows & same_n].astype(np.int64))
    assert (rows & same_n).sum() > 0.5 * len(o)


def _sort_batch(o, d, tmax, s2i):
    """The port's ``sort_batch_coarse`` on CPU tensors with the maps
    ``s2i`` and its inverse; returns (Rays, slot_to_id, id_to_slot)."""
    rays = make_rays(o, d, np.zeros(len(o), np.float32), tmax, device="cpu")
    s2i = torch.tensor(s2i, dtype=torch.int32)
    i2s = torch.empty_like(s2i)
    i2s[s2i.long()] = torch.arange(len(o), dtype=torch.int32)
    return p_buf.sort_batch_coarse(rays, s2i, i2s)


def _perm(kind, lib, o, d, tmax):
    if kind == "sort_batch_coarse":
        if lib is t_buf:
            return np.asarray(t_buf.morton_sort_device_coarse(o, d))
        # With identity maps the sorted slot_to_id is the permutation.
        return _sort_batch(o, d, tmax, np.arange(len(o)))[1].long().numpy()
    if lib is t_buf:
        if kind == "dead_last":
            return np.asarray(lib.sort_dead_last_device(
                TRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros(len(o)), jnp.asarray(tmax))))
        return np.asarray(getattr(lib, kind)(o, d))
    to = torch.tensor
    if kind == "dead_last":
        return lib.sort_dead_last_device(Rays(to(o), to(d), torch.zeros(len(o)), to(tmax))).numpy()
    return getattr(lib, kind)(to(o), to(d)).numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["morton_sort_device", "morton_sort_device_coarse", "dead_last",
                                  "sort_batch_coarse"])
def test_permutations_equal(kind, case):
    o, d, tmax = ray_batch(case)
    got = _perm(kind, p_buf, o, d, tmax)
    want = _perm(kind, t_buf, o, d, tmax)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(len(o)))
    if kind == "sort_batch_coarse":
        # tpu_rt's coarse permutation applied to the rays and to maps that
        # are not the identity: slot_to_id gathered, id_to_slot composed
        # with the inverse permutation.
        s2i = np.random.default_rng(5).permutation(len(o))
        rays, got_s2i, got_i2s = _sort_batch(o, d, tmax, s2i)
        for x, y in zip(rays, (o, d, np.zeros(len(o), np.float32), tmax)):
            np.testing.assert_array_equal(x.numpy(), y[want])
        inv = np.empty_like(want)
        inv[want] = np.arange(len(o))
        np.testing.assert_array_equal(got_s2i.numpy(), s2i[want])
        np.testing.assert_array_equal(got_i2s.numpy(), inv[np.argsort(s2i)])
        assert got_s2i.dtype == got_i2s.dtype == torch.int32


@pytest.mark.parametrize("case", ["random", "ties"])
def test_host_morton_order_equal(case):
    o, d, _ = ray_batch(case)
    got = p_math.morton_sort_order(o, d)
    np.testing.assert_array_equal(got, t_math.morton_sort_order(o, d))
    # As tpu_rt's test_device_morton_matches_host: stable sorts of the same
    # keys agree.
    np.testing.assert_array_equal(
        p_buf.morton_sort_device(torch.tensor(o), torch.tensor(d)).numpy(), got)


def test_empty_batch():
    z = torch.zeros((0, 3))
    assert p_buf.ray_morton_keys_device(z, z).shape == (0, 6)
    assert p_buf.morton_sort_device(z, z).numel() == 0
    assert p_buf.morton_sort_device_coarse(z, z).numel() == 0


# Deterministic stand-in tracers for both packages: tri from the origin,
# t = tmin + 1.
def _t_trace(rays):
    one = rays.tmin + 1.0
    tri = (jnp.abs(rays.origin[:, 0]) * 1000).astype(jnp.int32)
    return THits(tri=tri, t=one, u=one * 0.5, v=one * 0.25)


def _p_trace(rays):
    one = rays.tmin + 1.0
    tri = (rays.origin[:, 0].abs() * 1000).to(torch.int32)
    return Hits(tri=tri, t=one, u=one * 0.5, v=one * 0.25)


@pytest.mark.parametrize("live,pad_to", [(0, 2048), (1, 2048), (2047, 2048), (2048, 2048),
                                          (2049, 2048), (5000, 2048), (9000, 2048), (37, 16)])
def test_trace_live_prefix_equal(live, pad_to):
    o, d, tmax = ray_batch("random", n=5000)
    tmax = np.abs(tmax)
    tr = TRays(jnp.asarray(o), jnp.asarray(d), jnp.zeros(len(o)), jnp.asarray(tmax))
    pr = Rays(torch.tensor(o), torch.tensor(d), torch.zeros(len(o)), torch.tensor(tmax))
    want = t_buf.trace_live_prefix(_t_trace, tr, live, pad_to)
    got = p_buf.trace_live_prefix(_p_trace, pr, live, pad_to)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.tri.dtype == torch.int32


@pytest.fixture(scope="module")
def small():
    scene = PScene(p_proc.make_blob(300, seed=90))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    return scene, flat


def test_ray_buffer_sort_preserves_addressing(small):
    # tests/test_components.py's RayBuffer test on the port, and the maps
    # equal to tpu_rt's RayBuffer on the same rays.
    scene, flat = small
    rng = np.random.default_rng(2)
    n = 256
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    o = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    t = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 4 * size, np.float32)

    buf = RayBuffer(make_rays(o, d, tmin, tmax, device="cpu"))
    assert buf.size == n and buf.hits is None
    ray0 = buf.get_ray_for_id(17)
    buf.morton_sort()
    ray1 = buf.get_ray_for_id(17)
    for a, b in zip(ray0, ray1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(buf.slot_to_id[buf.id_to_slot.long()].numpy(), np.arange(n))

    t_rb = TRayBuffer(TRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax)))
    t_rb.morton_sort()
    np.testing.assert_array_equal(buf.slot_to_id.numpy(), t_rb.slot_to_id)
    np.testing.assert_array_equal(buf.id_to_slot.numpy(), t_rb.id_to_slot)
    np.testing.assert_array_equal(buf.rays.origin.numpy(), np.asarray(t_rb.rays.origin))

    # Trace after sort and address results by id: identical to unsorted.
    tri_a, t_a, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax)
    s = buf.rays
    tri_b, t_b, _, _ = trace_flat_scalar(flat, s.origin.numpy(), s.dirn.numpy(), tmin, tmax)
    buf.hits = Hits(torch.tensor(tri_b), torch.tensor(t_b), torch.zeros(n), torch.zeros(n))
    for ray_id in range(0, n, 17):
        assert buf.get_result_for_id(ray_id) == (int(tri_a[ray_id]), float(t_a[ray_id]))
    buf.morton_sort()  # already sorted: the identity, results dropped
    assert buf.hits is None
    with pytest.raises(RuntimeError):
        buf.get_result_for_id(0)


# Sorted and compacted secondary frames at 64x48 against tpu_rt's (its
# wavefront route on the CPU) and against the port's own unsorted frame.
W, H, SAMPLES, MAX_BATCH = 64, 48, 4, 4096
SWITCHES = {"sort": {"sort_secondary": True}, "compact": {"compact_degenerate": True},
            "both": {"sort_secondary": True, "compact_degenerate": True}}


@pytest.fixture(scope="module")
def blob_scenes():
    t_scene = TScene(t_proc.make_blob(700, seed=80))
    p_scene = PScene(p_proc.make_blob(700, seed=80))
    return t_scene, p_scene, t_suite_ao_radius("bunny", t_scene)


def _frame(renderer_cls, params, scene, camera):
    r = renderer_cls(W, H, params)
    r.set_scene(scene)
    stats = r.render_frame(camera)
    return r, stats, r.update_result()


@pytest.fixture(scope="module")
def unsorted(blob_scenes):
    t_scene, p_scene, radius = blob_scenes
    out = {}
    for ray_type in ("ao", "diffuse"):
        params = PParams(ray_type=ray_type, num_samples=SAMPLES, ao_radius=radius,
                         max_batch=MAX_BATCH, cache_dir=None, device="cpu")
        out[ray_type] = _frame(PRenderer, params, p_scene, p_suite_camera("bunny", p_scene))
    return out


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("ray_type", ["ao", "diffuse"])
def test_sorted_frame_matches_tpu_rt(blob_scenes, unsorted, ray_type, switch):
    t_scene, p_scene, radius = blob_scenes
    kw = dict(ray_type=ray_type, num_samples=SAMPLES, ao_radius=radius, max_batch=MAX_BATCH,
              cache_dir=None, **SWITCHES[switch])
    t_r, t_stats, t_img = _frame(TRenderer, TParams(tracer="xla", **kw), t_scene,
                                 t_suite_camera("bunny", t_scene))
    p_r, p_stats, p_img = _frame(PRenderer, PParams(device="cpu", **kw), p_scene,
                                 p_suite_camera("bunny", p_scene))
    u_r, u_stats, u_img = unsorted[ray_type]
    # A permutation of the batch changes no ray's result: the image equals
    # the port's unsorted frame bit for bit, and the port's unsorted frame
    # equals tpu_rt's (tests/test_torch_slice.py), so the sorted one does.
    np.testing.assert_array_equal(p_img, u_img)
    if ray_type == "ao":
        np.testing.assert_array_equal(p_img, t_img)
    else:
        # Diffuse shading rounds differently in the last bits (as unsorted).
        np.testing.assert_allclose(p_img, t_img, rtol=0, atol=1e-6)
    assert p_stats["total_rays"] == t_stats["total_rays"] == u_stats["total_rays"]
    assert p_stats["rays_traced"] == t_stats["rays_traced"]
    assert p_stats["rays_skipped"] == t_stats["rays_skipped"]
    assert p_stats["rays_traced"] + p_stats["rays_skipped"] == W * H * SAMPLES
    assert p_stats["batches"] == len(t_r._batches) == 3
    assert p_r.phase_s["sort"] > 0
    lives = [int((b.rays.tmax >= 0).sum()) for b in p_r._batches]
    if "compact_degenerate" in SWITCHES[switch]:
        skipped = sum(b.rays.num - min(b.rays.num, -(-n // 2048) * 2048)
                      for b, n in zip(p_r._batches, lives))
        assert p_stats["rays_skipped"] == skipped > 0
        for b, n in zip(p_r._batches, lives):
            # Live rays first, dead rays last, dead results misses at tmax.
            assert bool((b.rays.tmax[:n] >= 0).all()) and bool((b.rays.tmax[n:] < 0).all())
            assert bool((b.hits.tri[n:] == -1).all())
            assert torch.equal(b.hits.t[n:], b.rays.tmax[n:])
    else:
        assert p_stats["rays_skipped"] == 0 and p_stats["rays_traced"] == W * H * SAMPLES
    for b, ub in zip(p_r._batches, u_r._batches):
        # Each batch is the unsorted batch under the port's own sort of its
        # rays, and the maps follow it.
        order = (p_buf.sort_dead_last_device(ub.rays) if "compact_degenerate" in SWITCHES[switch]
                 else p_buf.morton_sort_device_coarse(ub.rays.origin, ub.rays.dirn))
        for x, y in zip(b.rays, ub.rays):
            assert torch.equal(x, y[order])
        assert torch.equal(b.slot_to_id, ub.slot_to_id[order])
        assert torch.equal(b.hits.tri[b.id_to_slot.long()], ub.hits.tri[ub.id_to_slot.long()])
