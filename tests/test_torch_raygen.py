"""The port's ray generation (primary, AO / diffuse, shadow, batching)
matches tpu_rt's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rt.bench.workload import suite_camera as t_suite_camera
from tpu_rt.core import math as tm
from tpu_rt.core.types import Hits as THits
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.raygen import RayGen as TRayGen
from tpu_rt.raygen import generators as tg
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

from tpu_rt_torch.bench.workload import suite_camera as p_suite_camera
from tpu_rt_torch.core import math as pm
from tpu_rt_torch.core.types import Hits, make_rays, pad_rays
from tpu_rt_torch.raygen import RayGen as PRayGen
from tpu_rt_torch.raygen import generators as pg
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import procedural as p_proc


@pytest.fixture(scope="module")
def cameras():
    ts = TScene(t_proc.make_blob(700, seed=80))
    ps = PScene(p_proc.make_blob(700, seed=80))
    ti = TScene(t_proc.make_interior(900, seed=81))
    pi = PScene(p_proc.make_interior(900, seed=81))
    return {
        "bunny-framing": (t_suite_camera("bunny", ts), p_suite_camera("bunny", ps)),
        "interior-framing": (t_suite_camera("sponza", ti), p_suite_camera("sponza", pi)),
    }


# At 64x48 the screen divisions are by powers of two and exact.  At 67x45
# XLA's CPU backend divides by the width as a multiply by its reciprocal
# (off by up to 1 ulp of sx) while the port divides, which moves a
# direction component by up to about 1.1e-6.
@pytest.mark.parametrize("framing", ["bunny-framing", "interior-framing"])
@pytest.mark.parametrize("size,atol", [((64, 48), 1e-6), ((67, 45), 2e-6)])
def test_gen_primary_rays_matches(cameras, framing, size, atol):
    tc, pc = cameras[framing]
    w, h = size
    t_rays, t_s2i, t_i2s = TRayGen().primary(tc, w, h)
    p_rays, p_s2i, p_i2s = PRayGen().primary(pc, w, h, device="cpu")
    np.testing.assert_array_equal(p_s2i.numpy(), np.asarray(t_s2i))
    np.testing.assert_array_equal(p_i2s.numpy(), np.asarray(t_i2s))
    assert p_s2i.dtype == torch.int32 and p_i2s.dtype == torch.int32
    np.testing.assert_array_equal(p_rays.origin.numpy(), np.asarray(t_rays.origin))
    np.testing.assert_allclose(p_rays.dirn.numpy(), np.asarray(t_rays.dirn), rtol=0, atol=atol)
    np.testing.assert_array_equal(p_rays.tmin.numpy(), np.asarray(t_rays.tmin))
    np.testing.assert_array_equal(p_rays.tmax.numpy(), np.asarray(t_rays.tmax))
    # id_to_slot inverts slot_to_id.
    np.testing.assert_array_equal(p_i2s.numpy()[p_s2i.numpy()], np.arange(w * h))


def test_pad_rays_marks_padding_degenerate():
    rng = np.random.default_rng(0)
    rays = make_rays(rng.normal(size=(5, 3)), rng.normal(size=(5, 3)), np.zeros(5), np.ones(5),
                     device="cpu")
    padded, n = pad_rays(rays, 4)
    assert n == 5 and padded.num == 8
    assert padded.tmax[5:].tolist() == [-1.0] * 3
    assert torch.equal(padded.origin[:5], rays.origin)
    same, n2 = pad_rays(padded, 4)
    assert same is padded and n2 == 8


# --- Secondary rays -----------------------------------------------------------
#
# The Jenkins words, Halton points and the Sobol / Hammersley tables are
# bit-equal to tpu_rt's.  Origins, directions and shadow tmax may differ by a
# rounding: XLA's CPU backend contracts o + d * t into one FMA (the port
# rounds the product first), and torch's cos / sin / sqrt differ from XLA's in
# the last bit on a few per cent of inputs.  Tolerance: EPS32 times the
# magnitude of the operands that were summed (origins: |o| + |d * t|;
# unit directions: 1; shadow distances: their value).
EPS32 = float(np.finfo(np.float32).eps)
SEED_NEAR_2_32 = 2**32 - 7


def _hits(n, num_tris, seed):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 5.0, n).astype(np.float32)
    t[:5] = [0.0, 5e-5, 1e-4, 2e-4, 1.0]  # around the backtrack epsilon
    tri = rng.integers(-1, num_tris, n).astype(np.int32)
    nrm = rng.normal(size=(num_tris, 3)).astype(np.float32)
    # Axis-aligned and tied-magnitude normals take each perp branch.
    nrm[:6] = [[0, 0, 1], [1, 0, 0], [0, -1, 0], [0.6, 0.8, 0], [0, 0.6, -0.8], [1, 1, 1]]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return o, d, t, tri, nrm


def _torch(*xs):
    return [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("seed,offset", [(0, 0), (12345, 777), (SEED_NEAR_2_32, 2**31 + 5)])
def test_hash_words_and_halton_bit_equal(seed, offset):
    r = 4096
    a = jnp.uint32(seed) + (jnp.arange(r, dtype=jnp.uint32) + jnp.uint32(offset))
    g = jnp.full((r,), tg.GOLDEN, jnp.uint32)
    want = tg._jenkins_mix_jnp(*tg._jenkins_mix_jnp(a, g, g))
    got = pg._hash_words(seed, offset, r, "cpu")
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w).astype(np.int64))
    # Radical inverses over a wide index range, the top of uint32 included.
    i = np.concatenate([np.arange(0, 200_000, 13), [2**32 - 2, 2**32 - 1]]).astype(np.int64)
    it = torch.tensor(i)
    ju = jnp.asarray(i.astype(np.uint32))
    np.testing.assert_array_equal(pg._halton2(it).numpy().view(np.int32),
                                  np.asarray(tg._halton2_jnp(ju)).view(np.int32))
    np.testing.assert_array_equal(pg._halton3(it).numpy().view(np.int32),
                                  np.asarray(tg._halton3_jnp(ju)).view(np.int32))


def test_sobol_hammersley_bit_equal():
    i = np.arange(300)
    np.testing.assert_array_equal(pm.sobol2d(i).view(np.int32), tm.sobol2d(i).view(np.int32))
    np.testing.assert_array_equal(pm.sobol2d(5), tm.sobol2d(5))
    for n in (1, 8, 17):
        np.testing.assert_array_equal(pm.hammersley(np.arange(n), n), tm.hammersley(np.arange(n), n))


def _origin_tol(o, d, t, s):
    back = np.maximum(t - np.float32(1e-4), np.float32(0.0))
    scale = np.repeat(np.abs(o) + np.abs(d * back[:, None]), s, axis=0)
    return scale * EPS32


@pytest.mark.parametrize("num_samples", [1, 8])
@pytest.mark.parametrize("seed,offset", [(0, 0), (SEED_NEAR_2_32, 4093)])
def test_gen_ao_rays_matches(num_samples, seed, offset):
    o, d, t, tri, nrm = _hits(2000, 40, seed=7)
    want, w_s2i, _ = tg.gen_ao_rays(o, d, t, tri, nrm, num_samples, jnp.float32(3.87),
                           jnp.uint32(seed), task_offset=offset)
    got, g_s2i, g_i2s = pg.gen_ao_rays(*_torch(o, d, t, tri, nrm), num_samples, 3.87, seed,
                              task_offset=offset)
    np.testing.assert_array_equal(g_s2i.numpy(), np.asarray(w_s2i))
    np.testing.assert_array_equal(g_i2s.numpy(), np.asarray(w_s2i))
    tol = _origin_tol(o, d, t, num_samples)
    assert np.all(np.abs(got.origin.numpy() - np.asarray(want.origin)) <= tol)
    np.testing.assert_allclose(got.dirn.numpy(), np.asarray(want.dirn), rtol=0, atol=4 * EPS32)
    np.testing.assert_array_equal(got.tmin.numpy(), np.asarray(want.tmin))
    np.testing.assert_array_equal(got.tmax.numpy(), np.asarray(want.tmax))
    assert np.all((got.tmax.numpy() < 0) == np.repeat(tri < 0, num_samples))
    for x in got:
        assert x.dtype == torch.float32 and x.is_contiguous()


@pytest.mark.parametrize("num_samples", [1, 6])
def test_gen_shadow_rays_matches(num_samples):
    o, d, t, tri, _ = _hits(1500, 40, seed=8)
    light = np.array([3.0, 4.0, -2.0], np.float32)
    want, _, _ = tg.gen_shadow_rays(o, d, t, tri, num_samples, jnp.asarray(light), jnp.float32(0.75),
                       jnp.uint32(SEED_NEAR_2_32), task_offset=99)
    got, _, _ = pg.gen_shadow_rays(*_torch(o, d, t, tri), num_samples, light, 0.75, SEED_NEAR_2_32,
                      task_offset=99)
    tol = _origin_tol(o, d, t, num_samples)
    assert np.all(np.abs(got.origin.numpy() - np.asarray(want.origin)) <= tol)
    # The direction and the distance inherit the origin's rounding, relative
    # to the distance to the light (>= 1 here).
    np.testing.assert_allclose(got.dirn.numpy(), np.asarray(want.dirn), rtol=0, atol=8 * EPS32)
    w_tmax = np.asarray(want.tmax)
    np.testing.assert_allclose(got.tmax.numpy(), w_tmax, rtol=4 * EPS32, atol=0)
    assert np.all((w_tmax < 0) == np.repeat(tri < 0, num_samples))


# 4 samples per input: 1, 2 and 3 batches of 3072 inputs, and a budget
# below the sample count, which still takes one input per batch.
@pytest.mark.parametrize("max_rays,n,n_batches", [(1 << 21, 3072, 1), (6144, 3072, 2),
                                                  (4100, 3072, 3), (2, 5, 5)])
def test_raygen_ao_batching_matches(max_rays, n, n_batches):
    o, d, t, tri, nrm = _hits(n, 40, seed=9)
    zeros = np.zeros(n, np.float32)
    t_rays = t_make_rays(o, d, zeros, t)
    p_rays = make_rays(o, d, zeros, t, device="cpu")
    t_hits = THits(tri=tri, t=t, u=zeros, v=zeros)
    p_hits = Hits(*_torch(tri, t, zeros, zeros))
    t_gen, p_gen = TRayGen(max_rays), PRayGen(max_rays)
    ranges, new = [], True
    while True:
        w = t_gen.ao(t_rays, t_hits, nrm, 4, 2.5, new, seed=SEED_NEAR_2_32)
        g = p_gen.ao(p_rays, p_hits, torch.tensor(nrm), 4, 2.5, new, seed=SEED_NEAR_2_32)
        new = False
        assert (w is None) == (g is None)
        if w is None:
            break
        assert g[3] == w[3]
        ranges.append(g[3])
        # Hash words depend on where the batch starts: the tangent frames,
        # hence the directions, match tpu_rt's batch for batch.
        np.testing.assert_allclose(g[0].dirn.numpy(), np.asarray(w[0].dirn), rtol=0, atol=4 * EPS32)
    assert len(ranges) == n_batches
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_cpu_ao_rays_never_load_the_cuda_kernel(monkeypatch):
    # On CPU tensors gen_ao_rays (and RayGen.ao through it) is
    # gen_ao_rays_plain: the kernel's library is neither built nor loaded
    # nor launched.
    from tpu_rt_torch.raygen import ao_kernel

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA kernel was reached from CPU tensors")

    monkeypatch.setattr(ao_kernel, "build_shared", refuse)
    monkeypatch.setattr(ao_kernel.KERNEL, "load", refuse)
    launches = ao_kernel.KERNEL.launches
    o, d, t, tri, nrm = _torch(*_hits(300, 40, seed=10))
    got = pg.gen_ao_rays(o, d, t, tri, nrm, 4, 1.5, SEED_NEAR_2_32, task_offset=17)
    want = pg.gen_ao_rays_plain(o, d, t, tri, nrm, 4, 1.5, SEED_NEAR_2_32, task_offset=17)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    zeros = torch.zeros(300)
    out = PRayGen(1 << 20).ao(make_rays(o, d, zeros, t, device="cpu"),
                              Hits(tri, t, zeros, zeros), nrm, 4, 1.5, True, seed=5)
    assert out[0].num == 1200 and out[0].origin.device.type == "cpu"
    assert ao_kernel.KERNEL.launches == launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ao_kernel.RaygenAoKernel()(o, d, t, tri, nrm, 4, 1.5, 0)
