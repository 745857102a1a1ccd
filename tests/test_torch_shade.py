"""The port's reconstruct_image against tpu_rt's on the same hit arrays, for
primary, AO and diffuse frames."""

import numpy as np
import pytest
import torch

from tpu_rt.shade import count_hits as t_count_hits
from tpu_rt.shade import reconstruct_image as t_reconstruct

from tpu_rt_torch.shade import count_hits, reconstruct_image
from tpu_rt_torch.shade.reconstruct import BG_COLOR

P, T = 600, 30


def _frame(num_samples, seed):
    """A random pixel permutation, primary hits with misses, per-sample
    batch hits in a shuffled slot order, and colour tables."""
    rng = np.random.default_rng(seed)
    s2i = rng.permutation(P).astype(np.int32)
    primary_tri = rng.integers(-1, T, P).astype(np.int32)
    b = P * num_samples
    i2s = rng.permutation(b).astype(np.int32)
    batch_tri = rng.integers(-1, T, b).astype(np.int32)
    shaded = rng.uniform(0, 1, (T, 4)).astype(np.float32)
    material = rng.uniform(0, 1, (T, 4)).astype(np.float32)
    return s2i, primary_tri, i2s, batch_tri, shaded, material


# AO colours are 0, 1 and their sample means: bit-equal.  Diffuse means sum
# num_samples floats, whose order may differ between XLA and torch: 1e-6.
@pytest.mark.parametrize("ray_type,num_samples,atol", [
    ("primary", 1, 0.0), ("ao", 1, 0.0), ("ao", 8, 0.0), ("diffuse", 1, 1e-6), ("diffuse", 5, 1e-6),
])
def test_reconstruct_matches_tpu_rt(ray_type, num_samples, atol):
    s2i, ptri, i2s, btri, shaded, material = _frame(num_samples, seed=num_samples)
    if ray_type == "primary":
        i2s = np.argsort(s2i).astype(np.int32)  # a primary batch is its own frame
        btri = ptri
    want = np.asarray(t_reconstruct(s2i, ptri, i2s, btri, shaded, material, ray_type,
                                    num_samples, P))
    got = reconstruct_image(*(torch.tensor(x) for x in (s2i, ptri, i2s, btri, shaded, material)),
                            ray_type, num_samples, P).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if ray_type != "diffuse":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if ray_type == "ao":
        miss_px = s2i[ptri == -1]
        np.testing.assert_array_equal(got[miss_px], np.tile(BG_COLOR, (miss_px.size, 1)))
        assert set(np.unique(got[:, 3])) == {1.0}


def test_reconstruct_empty_scene_and_unknown_type():
    s2i, ptri, i2s, btri, _, _ = _frame(2, seed=3)
    ptri[:] = -1
    btri[:] = -1
    empty = np.zeros((0, 4), np.float32)
    for ray_type in ("ao", "diffuse"):
        want = np.asarray(t_reconstruct(s2i, ptri, i2s, btri, empty, empty, ray_type, 2, P))
        got = reconstruct_image(*(torch.tensor(x) for x in (s2i, ptri, i2s, btri, empty, empty)),
                                ray_type, 2, P).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        reconstruct_image(*(torch.tensor(x) for x in (s2i, ptri, i2s, btri, empty, empty)),
                          "shadow", 2, P)
    tri = np.array([-1, 0, 5, -1, 2], np.int32)
    assert int(count_hits(torch.tensor(tri))) == int(t_count_hits(tri)) == 3
