"""The port's primary ray generation matches tpu_rt's."""

import numpy as np
import pytest
import torch

from tpu_rt.bench.workload import suite_camera as t_suite_camera
from tpu_rt.raygen import RayGen as TRayGen
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

from tpu_rt_torch.bench.workload import suite_camera as p_suite_camera
from tpu_rt_torch.core.types import make_rays, pad_rays
from tpu_rt_torch.raygen import RayGen as PRayGen
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
    rays = make_rays(rng.normal(size=(5, 3)), rng.normal(size=(5, 3)), np.zeros(5), np.ones(5))
    padded, n = pad_rays(rays, 4)
    assert n == 5 and padded.num == 8
    assert padded.tmax[5:].tolist() == [-1.0] * 3
    assert torch.equal(padded.origin[:5], rays.origin)
    same, n2 = pad_rays(padded, 4)
    assert same is padded and n2 == 8
