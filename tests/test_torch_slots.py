"""The slot forms' settings (tpu_rt's ``tile``, ``k`` and ``u`` of
``trace_packet2`` / ``trace_packet4`` and ``make_routing_tracer``) on the
CPU: ``trace_flat`` / ``trace_quad`` take them with tpu_rt's names and give
the default forms' results, held to the Pallas kernels (interpret mode) run
with the same settings under ``tests/test_torch_flat_trace.py``'s rule
(closest hit: the same ids, t to the division's rounding; any hit: hit vs
miss); ``make_routing_tracer`` passes them to either kernel and names them
in its kind; every combination the slot forms leave out, and every value
out of range, raises ValueError naming the setting, on CPU tensors as on
the card.  The CUDA slot forms themselves run in
``tests/test_torch_kernel_emulation.py``."""

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh as t_load_or_build_bvh
from tpu_rt.bvh.collapse import collapse4 as t_collapse4
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_procedural
from tpu_rt.trace.packet2 import trace_packet2, trace_packet4

from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.bvh.collapse import collapse4
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import (
    MAX_UNITS,
    SLOTS,
    check_schedule,
    make_routing_tracer,
    trace_flat,
    trace_quad,
    upload_flat,
    upload_quad,
)
from tpu_rt_torch.trace import common, flat_kernel, quad_kernel

SCENES = {"blob": (lambda: procedural.make_blob(700, seed=80),
                   lambda: t_procedural.make_blob(700, seed=80)),
          "interior": (lambda: procedural.make_interior(900, seed=81),
                       lambda: t_procedural.make_interior(900, seed=81))}
# The settings held to tpu_rt's kernels: a tile, K and U together, and K alone.
SETTINGS = [{"tile": 512, "k": 2, "u": 3}, {"k": 4}]


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    """(scene, the port's FlatBVH and tables, tpu_rt's FlatBVH, the quad
    trees and tables of both)."""
    mine, theirs = SCENES[request.param]
    scene = Scene(mine())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    t_flat, _ = t_load_or_build_bvh(TScene(theirs()), cache_dir=None)
    quad = collapse4(flat)
    return (scene, flat, upload_flat(flat, "cpu"), t_flat, upload_quad(quad, "cpu"),
            t_collapse4(t_flat))


def _rays(scene, n, seed):
    """Rays from around the scene at it, and short AO-like rays from inside
    it in the second half; tmax = -1 on every 7th."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    inside = slice(n // 2, n)
    origin[inside] = rng.uniform(lo, hi, (n - n // 2, 3)).astype(np.float32)
    tmax[inside] = np.float32(0.15 * size)
    tmax[::7] = -1.0
    return origin, d, np.zeros(n, np.float32), tmax


def _hold(got, want, any_hit):
    """tests/test_torch_flat_trace.py's rule against a Pallas kernel."""
    want_tri = np.asarray(want.tri)
    if any_hit:
        np.testing.assert_array_equal(got.tri.numpy() >= 0, want_tri >= 0)
        return
    np.testing.assert_array_equal(got.tri.numpy(), want_tri)
    hit = (want_tri >= 0) & (np.arange(len(want_tri)) < len(want_tri) // 2)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("setting", SETTINGS, ids=["t512k2u3", "k4"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_trace_flat_matches_packet2_with_settings(setup, setting, any_hit):
    scene, _, tables, t_flat, _, _ = setup
    o, d, tmin, tmax = _rays(scene, 700, 31)
    want = trace_packet2(t_flat, t_make_rays(o, d, tmin, tmax), any_hit=any_hit, interpret=True,
                         **setting)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    got = trace_flat(tables, rays, any_hit, **setting)
    _hold(got, want, any_hit)
    # The settings do not change the function: the default form's hits.
    default = trace_flat(tables, rays, any_hit)
    assert torch.equal(got.tri, default.tri) and torch.equal(got.t, default.t)


@pytest.mark.parametrize("setting", SETTINGS, ids=["t512k2u3", "k4"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_trace_quad_matches_packet4_with_settings(setup, setting, any_hit):
    scene, _, _, _, tables, t_quad = setup
    o, d, tmin, tmax = _rays(scene, 600, 32)
    want = trace_packet4(t_quad, t_make_rays(o, d, tmin, tmax), any_hit=any_hit, interpret=True,
                         **setting)
    rays = make_rays(o, d, tmin, tmax, device="cpu")
    got, stats = trace_quad(tables, rays, any_hit, with_stats=True, **setting)
    _hold(got, want, any_hit)
    d_hits, d_stats = trace_quad(tables, rays, any_hit, with_stats=True)
    assert torch.equal(got.tri, d_hits.tri) and torch.equal(got.t, d_hits.t)
    assert all(torch.equal(stats[c], d_stats[c]) for c in stats)


@pytest.mark.parametrize("prefer", ["packet4", "packet"])
def test_routing_tracer_takes_the_settings(setup, prefer):
    scene, flat, _, _, _, _ = setup
    rays = make_rays(*_rays(scene, 300, 33), device="cpu")
    fn, kind, tables = make_routing_tracer(flat, prefer, device="cpu", tile=256, k=8, u=16)
    base = "quad" if prefer == "packet4" else "flat"
    assert kind == f"{base}-plain-k8-u16-t256"
    assert fn.keywords["tile"] == 256 and fn.keywords["k"] == 8 and fn.keywords["u"] == 16
    d_fn, d_kind, _ = make_routing_tracer(flat, prefer, device="cpu")
    assert d_kind == f"{base}-plain" and d_fn.keywords.get("k") is None
    for any_hit in (False, True):
        got, want = fn(tables, rays, any_hit), d_fn(tables, rays, any_hit)
        assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t)
    # One setting alone; the others keep the default forms' schedule.
    _, kind, _ = make_routing_tracer(flat, prefer, device="cpu", u=3)
    assert kind == f"{base}-plain-u3"
    assert check_schedule(u=3) == (1, 3, 0) and check_schedule() is None


@pytest.mark.parametrize("kw, setting", [
    ({"k": 3}, "k"), ({"k": 0}, "k"), ({"k": 16}, "k"), ({"k": 2.0}, "k"), ({"k": True}, "k"),
    ({"u": 0}, "u"), ({"u": MAX_UNITS + 1}, "u"), ({"u": "3"}, "u"),
    ({"tile": 100}, "tile"), ({"tile": 0}, "tile"), ({"tile": -128}, "tile"),
    ({"tile": 127}, "tile"),
    ({"k": 2, "mxu": True}, "k=2"), ({"tile": 512, "mxu": True}, "tile=512"),
    ({"u": 3, "cursors": 2}, "u=3"), ({"k": 1, "tile": 128, "cursors": 4}, "k=1, tile=128"),
])
def test_refusals_name_the_setting(setup, kw, setting):
    # On CPU tensors, as the kernels' wrappers on the card: the plain
    # versions, the public tracers and the routing tracer all refuse.
    scene, flat, ftab, _, qtab, _ = setup
    rays = make_rays(*_rays(scene, 64, 34), device="cpu")
    mxu = kw.get("mxu", False)
    cursors = kw.get("cursors", 1)
    slots = {k: v for k, v in kw.items() if k in ("tile", "k", "u")}
    calls = [lambda: trace_flat(ftab, rays, **kw),
             lambda: flat_kernel.trace_flat_plain(ftab, rays, **kw),
             lambda: make_routing_tracer(flat, "packet", device="cpu", **kw)]
    if not mxu:
        calls += [lambda: trace_quad(qtab, rays, **kw),
                  lambda: quad_kernel.trace_quad_plain(qtab, rays, **kw),
                  lambda: make_routing_tracer(flat, "packet4", device="cpu", cache_dir=None, **kw)]
    for call in calls:
        with pytest.raises(ValueError, match=setting):
            call()
    with pytest.raises(ValueError, match=setting):
        check_schedule(mxu=mxu, cursors=cursors, **slots)


def test_wavefront_and_wrappers_refuse(setup):
    _, flat, ftab, _, _, _ = setup
    with pytest.raises(ValueError, match="tile, k or u"):
        make_routing_tracer(flat, "xla", device="cpu", k=2)
    # A library without slots takes no u or tile; a slot library takes
    # them within range (its launch refuses before any CUDA call).
    rays = make_rays(*_rays(Scene(procedural.make_blob(50, seed=1)), 8, 35), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        flat_kernel.KERNEL_K[2](ftab, rays, units=3, tile=512)
    assert [w.slots for w in flat_kernel.KERNEL_K.values()] == list(SLOTS)
    assert [w.slots for w in quad_kernel.KERNEL_K.values()] == list(SLOTS)
    assert flat_kernel.KERNEL_K[4].forms[0] == "closest_k4"
    assert common.form_name(True, False, True, k=2, u=3, tile=512) == "any_stats_k2_u3_t512"
    assert common.form_name(False, False, False) == "closest"
