"""The plain reference of the diffuse frame cell: the pixel the reference
renderer's diffuse frame gives, the judge of the program's pixels against
it, and the control.

A diffuse frame (Renderer::beginFrame, Renderer::nextBatch's diffuse
branch, Renderer::updateResult; Renderer.cc:112-152, :242-291, :274-279,
:421-445) traces each pixel's primary ray (``raygen.primary_rays``) closest
hit (``intersect.scan``), then S diffuse rays around that hit (the AO rays
of ``raygen.ao_rays`` with the camera's far, in float32, as tmax; as
``reference/diffuse.py``) closest hit, and reconstructKernel's diffuse
branch (RendererKernels.cu:60-108) makes the pixel

    mean_j(miss_j ? white : shaded[tri_j]) x (primary miss ? background
                                                : material[primary tri])

with ``shaded`` the headlight-shaded RGBA (``judge.RefScene.shaded``) and
``material`` the triangle's diffuse RGBA.  Everything is float64 but the
rays, which are made in the float32 the configurations state (``raygen``).

Departures from Renderer.cc and RendererKernels.cu:

- colours are float RGBA, not the reference's ABGR8 words (the program's
  image is float RGBA);
- each pixel's rays are made directly, with no batches and no secondary
  sort: the batching (``max_batch``) and the sort (``sortSecondary``,
  Main.cc's default) only change which ray is traced when, and the pixel
  does not depend on it;
- a primary miss makes S degenerate rays (tmax -1) that miss, so the pixel
  is white times the background: the background, which is what the
  reference here gives it directly;
- the AO generator's departures (``raygen.py``), and the far of
  ``reference/diffuse.py``: the configuration's camera rule.

- ``judge_diffuse_frames``: ``pixel_gap`` per judged pixel, capped at 1.
  For each primary hit the reference could accept (``judge.candidates``,
  within ``judge.PRUNE`` of the cheapest, on both facing sides where the
  facing test is nearly even, as ``judge._ao_pixel_gap``) the S diffuse
  rays are made and scanned, and each sample's acceptable closest hits are
  those ``judge.candidates`` gives, each with its cost (a triangle: how far
  it is missed and how surely a nearer one is hit; the miss: the deepest
  hit).  Accepting every choice that costs at most c lets each channel of
  the pixel lie anywhere in the sum over samples of the interval [least,
  greatest colour of a sample's choices] / S, times the material; the gap
  at c is what lies outside those intervals, and never less than c.  The
  pixel's gap is the least over c (each cost the choices have) and over
  the primary candidates, with each candidate's own cost.
- ``control_pixels``: the same pixels made by the reference in bfloat16
  (``control.scene``'s tables, the material rounded to bfloat16), for
  ``calibrate.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import control, intersect, judge, raygen

# Rows (a primary candidate's S rays) judged at once: the choice levels
# take rows x (S x C)^2 x 4 values.
CHOICE_ROWS = 128


def _pixel_slots(w: int, h: int) -> np.ndarray:
    """Each pixel's primary slot: the inverse of the Morton table."""
    i2p = raygen.morton_index_to_pixel(w, h)
    p2i = np.empty_like(i2p)
    p2i[i2p] = np.arange(i2p.size)
    return p2i


def judge_diffuse_frames(scene: judge.RefScene, cams, mix: dict, items: dict,
                         pixels: np.ndarray, seed: int, material: np.ndarray) -> dict:
    """``pixel_gap`` per item: ``items`` pose and pixel; ``pixels`` the judged
    side's RGBA value [N, 4] there; ``material`` each triangle's diffuse
    RGBA [T, 4]."""
    w, h = mix["width"], mix["height"]
    p2i = _pixel_slots(w, h)
    out = np.zeros(len(items["pixel"]))
    bg = torch.as_tensor(judge.BG_COLOR, device=scene.device).double()
    mat = torch.as_tensor(np.asarray(material), device=scene.device).double()
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        px = items["pixel"][sel]
        prim = raygen.primary_rays(cams[p], w, h, px, scene.dtype, scene.device)
        ctri, ct, ccost = judge.candidates(scene, intersect.scan(scene.tris, *prim))
        value = torch.as_tensor(pixels[sel], device=scene.device).double()
        # The primary miss: the background.
        best = torch.maximum(ccost[:, -1].double(), (value - bg).abs().amax(1))
        out[sel] = _hit_pixel_gap(scene, prim, ctri, ct, ccost, value, best, p2i[px], seed,
                                  cams[p]["far"], int(mix["samples"]), mat)
    return {"pixel_gap": out}


def _hit_pixel_gap(scene, prim, ctri, ct, ccost, value, best, slots, seed, far, samples,
                   mat) -> np.ndarray:
    """``best`` lowered by each primary hit candidate worth tracing."""
    rows, cols = torch.nonzero(ccost[:, :-1] < ccost.amin(1, keepdim=True) + judge.PRUNE,
                               as_tuple=True)
    if rows.numel():
        tri, t = ctri[rows, cols], ct[rows, cols]
        normal = scene.normal(tri)
        _, facing = raygen.facing_normal(normal, prim[1][rows])
        both = facing.abs() < judge.FACING_EVEN
        r_idx = torch.cat([torch.arange(rows.numel(), device=rows.device),
                           torch.nonzero(both).reshape(-1)])
        flip = torch.cat([facing > 0, ~(facing[both] > 0)])
        cost = torch.cat([ccost[rows, cols], torch.maximum(ccost[rows, cols][both],
                                                          facing[both].abs())])
        m = r_idx.numel()
        rr = r_idx.repeat_interleave(samples)
        words = raygen.rotation_word(seed, slots[rows.cpu().numpy()][r_idx.cpu().numpy()])
        rays = raygen.ao_rays(prim[0][rows][rr], prim[1][rows][rr], t[rr].to(scene.dtype),
                              normal[rr], torch.ones_like(rr, dtype=torch.bool),
                              np.tile(np.arange(samples), m), np.repeat(words, samples), far,
                              scene.dtype, flip=flip.repeat_interleave(samples))
        stri, _, scost = judge.candidates(scene, intersect.scan(scene.tris, *rays))
        shaded = torch.as_tensor(scene.shaded, device=scene.device).double()
        colour = torch.where((stri >= 0)[..., None], shaded[stri.clamp(min=0)],
                             torch.ones((), dtype=torch.float64, device=scene.device))
        k = stri.shape[1]
        item = rows[r_idx]
        g = choice_gap(scost.double().reshape(m, samples, k), colour.reshape(m, samples, k, 4),
                       mat[tri[r_idx]], value[item])
        best = best.scatter_reduce(0, item, torch.maximum(g, cost.double()), reduce="amin")
    return torch.nan_to_num(best, nan=1.0).clamp(max=1.0).cpu().numpy()


def choice_gap(cost: torch.Tensor, colour: torch.Tensor, material: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """The gap of pixel ``value`` [M, 4] from the pixels that each sample's
    choices allow: ``cost`` [M, S, C] of each choice (inf: none), ``colour``
    [M, S, C, 4] its colour, ``material`` [M, 4] the primary hit's.  At a
    level c every choice that costs at most c is accepted (each sample's
    cheapest always); returns, per row, the least over the levels of the
    larger of c and the colour distance outside the accepted intervals."""
    out = []
    for r0 in range(0, cost.shape[0], CHOICE_ROWS):
        c, col = cost[r0:r0 + CHOICE_ROWS], colour[r0:r0 + CHOICE_ROWS]
        m, s, k = c.shape
        floor = c.amin(2)                                              # [m, S]
        levels = torch.maximum(c.reshape(m, 1, s * k), floor.amax(1)[:, None, None])
        levels = levels.reshape(m, s * k)                              # [m, L]
        ok = c[:, None] <= torch.maximum(levels[:, :, None, None], floor[:, None, :, None])
        picked = col[:, None]                                          # [m, 1, S, C, 4]
        inf = torch.tensor(np.inf, dtype=col.dtype, device=col.device)
        lo = torch.where(ok[..., None], picked, inf).amin(3).sum(2) / s       # [m, L, 4]
        hi = torch.where(ok[..., None], picked, -inf).amax(3).sum(2) / s
        mat = material[r0:r0 + CHOICE_ROWS, None]
        v = value[r0:r0 + CHOICE_ROWS, None]
        outside = torch.maximum(lo * mat - v, v - hi * mat).clamp(min=0).amax(2)
        out.append(torch.nan_to_num(torch.maximum(outside, levels), nan=np.inf).amin(1))
    return torch.cat(out)


def control_pixels(ref: judge.RefScene, cams, mix: dict, items: dict, seed: int,
                   material: np.ndarray) -> np.ndarray:
    """RGBA values of the sampled diffuse frame pixels, in bfloat16."""
    w, h = mix["width"], mix["height"]
    p2i = _pixel_slots(w, h)
    samples = int(mix["samples"])
    dt, dev = ref.dtype, ref.device
    shaded = torch.as_tensor(ref.shaded, device=dev).to(dt)
    mat = torch.as_tensor(np.asarray(material), device=dev).to(dt)
    bg = torch.as_tensor(judge.BG_COLOR, device=dev).to(dt)
    out = np.zeros((len(items["pixel"]), 4))
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        px = items["pixel"][sel]
        rays = raygen.primary_rays(cams[p], w, h, px, dt, dev)
        tri, t = control._closest(intersect.scan(ref.tris, *rays))
        m = len(sel)
        rr = torch.arange(m, device=dev).repeat_interleave(samples)
        words = np.repeat(raygen.rotation_word(seed, p2i[px]), samples)
        diffuse = raygen.ao_rays(rays[0][rr], rays[1][rr], torch.nan_to_num(t, posinf=0.0)[rr],
                                 ref.normal(tri)[rr], (tri >= 0)[rr],
                                 np.tile(np.arange(samples), m), words, cams[p]["far"], dt)
        stri, _ = control._closest(intersect.scan(ref.tris, *diffuse))
        colour = torch.where((stri >= 0)[:, None], shaded[stri.clamp(min=0)],
                             torch.ones((), dtype=dt, device=dev))
        colour = colour.reshape(m, samples, 4).mean(1)
        value = torch.where((tri >= 0)[:, None], colour * mat[tri.clamp(min=0)], bg)
        out[sel] = value.double().cpu().numpy()
    return out
