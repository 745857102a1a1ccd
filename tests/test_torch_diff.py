"""The port's differentiable path (diff/) against tpu_rt's: the hit
recompute, trace_diff and render_image_diff with their gradients against
jax.value_and_grad, Adam against optax, and fit with checkpoint / resume.

Tolerances, and why: the forward recompute is the same f32 arithmetic in
the same order (bit-equal here); gradients are sums of many scatter-added
terms whose order differs between XLA and torch, so they agree to rtol
1e-4 with an atol of 1e-5 x the largest |gradient| (measured: 2e-5 / 4e-7);
the loss to rtol 1e-6 (measured 6e-8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_rt.bvh import build_sbvh as t_build_sbvh
from tpu_rt.bvh import flatten_bvh as t_flatten_bvh
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.diff import moller_trumbore_tuv as t_mt
from tpu_rt.diff import render_image_diff as t_render
from tpu_rt.diff import shade_hits_diff as t_shade
from tpu_rt.diff import trace_diff as t_trace
from tpu_rt.diff.train import fit as t_fit
from tpu_rt.scene import Camera as TCamera
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc
from tpu_rt.trace import device_bvh as t_device_bvh

import tpu_rt_torch.diff as p_diff
from tpu_rt_torch.bvh import build_sbvh, flatten_bvh
from tpu_rt_torch.core.types import Rays, make_rays
from tpu_rt_torch.diff import moller_trumbore_tuv, render_image_diff, shade_hits_diff, trace_diff
from tpu_rt_torch.diff import train as p_train
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import device_bvh, trace_wavefront


def grads_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def setup():
    """tests/test_diff.py's scene and 24x24 camera rays, for both packages."""
    t_scene = TScene(t_proc.make_blob(600, seed=40))
    scene = Scene(procedural.make_blob(600, seed=40))
    host = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    t_host = t_flatten_bvh(t_build_sbvh(t_scene), t_scene.tri_vtx_index, t_scene.vtx_pos)
    lo, hi = t_scene.bbox()
    cam = TCamera.for_bbox(lo, hi)
    w = h = 24
    m = cam.nscreen_to_world(w, h)
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    sx = 2.0 * (px.ravel() + 0.5) / w - 1.0
    sy = 2.0 * (py.ravel() + 0.5) / h - 1.0
    ns = np.stack([sx, sy, np.zeros_like(sx), np.ones_like(sx)], axis=1)
    world = ns @ m.T
    wp = world[:, :3] / world[:, 3:4]
    d = wp - cam.position
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = (np.tile(cam.position, (w * h, 1)), d, np.zeros(w * h), np.full(w * h, cam.far))
    return {"scene": scene, "flat": device_bvh(host, "cpu"), "rays": make_rays(*args, device="cpu"),
            "t_flat": t_device_bvh(t_host), "t_rays": t_make_rays(*args)}


def test_moller_trumbore_matches_tpu_rt():
    rng = np.random.default_rng(0)
    v0, v1, v2 = rng.normal(size=(3, 8, 3)).astype(np.float32)
    o = rng.normal(size=(8, 3)).astype(np.float32) * 3
    target = (v0 + v1 + v2) / 3
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = t_mt(jnp.asarray(o), jnp.asarray(d), v0, v1, v2)
    got = moller_trumbore_tuv(*(torch.tensor(x) for x in (o, d, v0, v1, v2)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    t, u, v = (x.numpy() for x in got)
    np.testing.assert_allclose(u, 1 / 3, atol=1e-5)
    np.testing.assert_allclose(v, 1 / 3, atol=1e-5)
    np.testing.assert_allclose(o + t[:, None] * d, target, atol=1e-5)


@pytest.mark.parametrize("routing", ["wavefront", "raw"])
def test_trace_diff_forward_and_gradient(setup, routing):
    s = setup
    scene = s["scene"]
    tvi = jnp.asarray(scene.tri_vtx_index)

    def t_loss(vp):
        hits = t_trace(False, s["t_flat"], s["t_rays"], vp, tvi)
        return jnp.sum(jnp.where(hits.tri >= 0, hits.t, 0.0)), hits

    (t_l, t_hits), t_g = jax.value_and_grad(t_loss, has_aux=True)(jnp.asarray(scene.vtx_pos))
    raw = None
    if routing == "raw":
        raw = trace_wavefront(s["flat"], s["rays"])
    vp = torch.tensor(scene.vtx_pos, requires_grad=True)
    hits = trace_diff(False, s["flat"], s["rays"], vp, torch.tensor(scene.tri_vtx_index), raw)
    hit = hits.tri >= 0
    loss = torch.where(hit, hits.t, torch.zeros_like(hits.t)).sum()
    loss.backward()
    np.testing.assert_array_equal(hits.tri.numpy(), np.asarray(t_hits.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(getattr(hits, f).detach().numpy(),
                                      np.asarray(getattr(t_hits, f)))
    # Misses keep t = tmax with zero gradient.
    assert torch.equal(hits.t[~hit], s["rays"].tmax[~hit]) and bool((~hit).any())
    np.testing.assert_allclose(loss.item(), float(t_l), rtol=1e-6)
    grads_close(vp.grad.numpy(), t_g)
    assert np.isfinite(vp.grad.numpy()).all() and (vp.grad != 0).any()


def test_trace_diff_gradient_to_rays(setup):
    # t is differentiable w.r.t. the rays too; the routing is not.
    s = setup
    scene = s["scene"]
    r = s["rays"]
    o = r.origin.clone().requires_grad_(True)
    hits = trace_diff(False, s["flat"], Rays(o, r.dirn, r.tmin, r.tmax),
                      torch.tensor(scene.vtx_pos), torch.tensor(scene.tri_vtx_index))
    hits.t[hits.tri >= 0].sum().backward()

    def t_loss(origin):
        tr = s["t_rays"]._replace(origin=origin)
        h = t_trace(False, s["t_flat"], tr, jnp.asarray(scene.vtx_pos),
                    jnp.asarray(scene.tri_vtx_index))
        return jnp.sum(jnp.where(h.tri >= 0, h.t, 0.0))

    grads_close(o.grad.numpy(), jax.grad(t_loss)(s["t_rays"].origin))


@pytest.mark.parametrize("target", [0.0, 0.5])
def test_render_image_diff_value_and_grad(setup, target):
    s = setup
    scene = s["scene"]
    tvi = scene.tri_vtx_index

    def t_loss(vp, mat):
        rgb = t_render(s["t_flat"], s["t_rays"], vp, jnp.asarray(tvi), mat)
        return jnp.mean((rgb - target) ** 2)

    t_l, (t_gv, t_gm) = jax.value_and_grad(t_loss, argnums=(0, 1))(
        jnp.asarray(scene.vtx_pos), jnp.asarray(scene.tri_material))
    vp = torch.tensor(scene.vtx_pos, requires_grad=True)
    mat = torch.tensor(scene.tri_material, requires_grad=True)
    loss = torch.mean((render_image_diff(s["flat"], s["rays"], vp, torch.tensor(tvi), mat)
                       - target) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(t_l), rtol=1e-6)
    grads_close(vp.grad.numpy(), t_gv)
    grads_close(mat.grad.numpy(), t_gm)
    assert (mat.grad[:, 3] == 0).all()  # alpha unused by RGB shading
    assert (vp.grad != 0).any() and (mat.grad[:, :3] != 0).any()


def test_shade_hits_diff_matches_tpu_rt(setup):
    scene = setup["scene"]
    rng = np.random.default_rng(5)
    tri = rng.integers(-1, scene.num_triangles, 500).astype(np.int32)
    want = t_shade(jnp.asarray(tri), jnp.asarray(scene.vtx_pos),
                   jnp.asarray(scene.tri_vtx_index), jnp.asarray(scene.tri_material))
    got = shade_hits_diff(torch.tensor(tri), torch.tensor(scene.vtx_pos),
                          torch.tensor(scene.tri_vtx_index), torch.tensor(scene.tri_material))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(p_diff.shading.LIGHT, np.float32([1, 2, 3]) /
                                  np.linalg.norm(np.float32([1, 2, 3])))


def test_adam_matches_optax():
    # On identical gradients (of scales from 10 down to below eps) Adam's
    # update equals optax.adam's to rounding: torch computes the bias
    # corrections in Python doubles, optax in f32 (measured: at most 1.4e-6
    # after 5 steps on parameters of unit scale, lr 0.05).
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(50, 3)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * s for s in (1, 1e-3, 1e-6, 1e-9, 10)]
    opt = optax.adam(5e-2)
    st = opt.init(jnp.asarray(p0))
    pj = jnp.asarray(p0)
    pt = torch.tensor(p0, requires_grad=True)
    topt = p_train.make_optimizer([pt], 5e-2)
    for k, g in enumerate(grads, 1):
        upd, st = opt.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0, atol=5e-7 * k)


@pytest.fixture(scope="module")
def fit_case():
    """tests/test_diff.py's checkpoint / resume case: a 120-triangle blob,
    256 random rays, the true image as target, perturbed materials."""
    scene = Scene(procedural.make_blob(120, seed=9))
    host = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    rng = np.random.default_rng(4)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    n = 256
    o = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    t = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = t - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    args = (o, d, np.zeros(n, np.float32), np.full(n, 4 * size, np.float32))
    rays = make_rays(*args, device="cpu")
    target = render_image_diff(device_bvh(host, "cpu"), rays, torch.tensor(scene.vtx_pos),
                               torch.tensor(scene.tri_vtx_index),
                               torch.tensor(scene.tri_material))
    mat0 = scene.tri_material + 0.3 * rng.normal(size=scene.tri_material.shape).astype(np.float32)
    return {"scene": scene, "host": host, "args": args, "rays": rays, "target": target,
            "mat0": mat0}


def _fit(c, steps, **kw):
    s = c["scene"]
    return p_train.fit(c["host"], c["rays"], s.tri_vtx_index, c["target"], s.vtx_pos, c["mat0"],
                       steps=steps, lr=5e-2, device="cpu", **kw)


def test_fit_losses_match_tpu_rt(fit_case):
    # The same 6-step fit in both packages.  Gradients agree to ~1e-5
    # (summation order) and Adam's updates to rounding; Adam normalizes
    # each coordinate, so a coordinate whose gradient is near zero can take
    # another step, and the losses drift apart by up to 5e-6 (measured).
    # Held to 1e-4; parameters after several steps are not compared as if
    # they were exact.
    c, s = fit_case, fit_case["scene"]
    t_host = t_flatten_bvh(t_build_sbvh(TScene(t_proc.make_blob(120, seed=9))),
                           s.tri_vtx_index, s.vtx_pos)
    t_target = c["target"].numpy()
    _, t_losses = t_fit(t_device_bvh(t_host), t_make_rays(*c["args"]),
                        jnp.asarray(s.tri_vtx_index), t_target, jnp.asarray(s.vtx_pos),
                        jnp.asarray(c["mat0"]), steps=6, lr=5e-2)
    state, losses = _fit(c, 6)
    assert state.step == 6 and len(losses) == 6
    np.testing.assert_allclose(losses, t_losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_fit_resume_bit_identical(fit_case, tmp_path):
    """An interrupted run restored from its checkpoint produces
    bit-identical params to the uninterrupted run, and so does a repeat."""
    s_full, losses_full = _fit(fit_case, 6)
    s_again, losses_again = _fit(fit_case, 6)
    ck = str(tmp_path / "ckpt")
    s_a, losses_a = _fit(fit_case, 3, ckpt_dir=ck)
    assert s_a.step == 3 and len(losses_a) == 3
    s_b, losses_b = _fit(fit_case, 6, ckpt_dir=ck)  # restores step 3, runs 3 more
    assert s_b.step == 6 and len(losses_b) == 3
    assert losses_a + losses_b == losses_full == losses_again
    for st in (s_b, s_again):
        assert torch.equal(st.vtx_pos, s_full.vtx_pos)
        assert torch.equal(st.tri_material, s_full.tri_material)
        for k in (0, 1):
            for name in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(st.opt_state[k][name], s_full.opt_state[k][name])
    assert not torch.are_deterministic_algorithms_enabled()


def test_train_step_is_pure(fit_case):
    c, s = fit_case, fit_case["scene"]
    flat = device_bvh(c["host"], "cpu")
    tvi = torch.tensor(s.tri_vtx_index)
    state = p_train.init_state(s.vtx_pos, c["mat0"], lr=5e-2, device="cpu")
    s1, _ = p_train.train_step(state, flat, c["rays"], tvi, c["target"], lr=5e-2)
    snap = [s1.vtx_pos.clone(), s1.tri_material.clone(), s1.opt_state[1]["exp_avg"].clone()]
    a, loss_a = p_train.train_step(s1, flat, c["rays"], tvi, c["target"], lr=5e-2)
    b, loss_b = p_train.train_step(s1, flat, c["rays"], tvi, c["target"], lr=5e-2)
    # The input state is not written; the same input gives the same output.
    assert torch.equal(snap[0], s1.vtx_pos) and torch.equal(snap[1], s1.tri_material)
    assert torch.equal(snap[2], s1.opt_state[1]["exp_avg"])
    assert torch.equal(loss_a, loss_b) and torch.equal(a.vtx_pos, b.vtx_pos)
    # Routing given as raw hits gives the same step.
    raw = trace_wavefront(flat, c["rays"])
    r, loss_r = p_train.train_step(s1, None, c["rays"], tvi, c["target"], lr=5e-2, raw=raw)
    assert torch.equal(loss_r, loss_a) and torch.equal(r.tri_material, a.tri_material)
    # The deterministic switch is the caller's again after the step, either way.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        p_train.train_step(s1, flat, c["rays"], tvi, c["target"], lr=5e-2)
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


def test_checkpoints_keep_newest_three(fit_case, tmp_path):
    ck = str(tmp_path / "ckpt")
    _fit(fit_case, 5, ckpt_dir=ck, save_every=1)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000003.pt", "step_00000004.pt", "step_00000005.pt"]
    template = p_train.init_state(fit_case["scene"].vtx_pos, fit_case["mat0"], device="cpu")
    restored = p_train.restore_checkpoint(ck, template)
    assert restored.step == 5 and restored.opt_state[0]["step"].item() == 5
    assert p_train.restore_checkpoint(str(tmp_path / "none"), template) is None
