"""The control: the reference put in the program's place, computed in
bfloat16, the nearest precision below the float32 the configurations
state.  It produces what the program would (rays and hits for the sampled
rays of a trace cell, pixel values for the sampled pixels of a frame
cell), and the judge reads them as it reads the program's.  Its readings
set the upper end of each limit (PERF.md)."""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import intersect, raygen
from rtbench.reference.judge import BG_COLOR, LIGHT, RefScene


def scene(positions, indices, tri_diffuse, device) -> RefScene:
    """The scene with every derived table (normals, shading, coefficient
    rows) in bfloat16."""
    ref = RefScene.build(positions, indices, tri_diffuse, torch.bfloat16, device)
    v = torch.as_tensor(positions[indices], device=device).to(torch.bfloat16)
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], dim=1)
    n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True)
    ref.normals = n.float().cpu().numpy()
    lam = (n @ torch.as_tensor(LIGHT, device=device).to(torch.bfloat16)) * 0.5 + 0.5
    d = torch.as_tensor(tri_diffuse, device=device).to(torch.bfloat16)
    shaded = torch.cat([d[:, :3] * lam[:, None], torch.ones_like(d[:, :1])], 1)
    ref.shaded = shaded.float().cpu().numpy()
    return ref


def _closest(s: intersect.Scan):
    """The nearest candidate that is a hit (h >= 0), else a miss."""
    ok = (s.h >= 0) & (s.tri >= 0)
    first = torch.where(ok.any(1), ok.float().argmax(1), torch.full_like(s.tri[:, 0], -1))
    rows = torch.arange(s.tri.shape[0], device=s.tri.device)
    pick = first.clamp(min=0)
    hit = first >= 0
    return (torch.where(hit, s.tri[rows, pick], torch.full_like(pick, -1)),
            torch.where(hit, s.t[rows, pick], torch.full_like(s.t[:, 0], np.inf)))


def trace_answers(ref: RefScene, cams, mix: dict, items: dict, ao_seed: int,
                  radius: float) -> dict:
    """Rays and hits of the sampled trace items, in bfloat16."""
    w, h = mix["width"], mix["height"]
    i2p = raygen.morton_index_to_pixel(w, h)
    n = len(items["slot"])
    out = {"origin": np.zeros((n, 3)), "dirn": np.zeros((n, 3)), "tmin": np.zeros(n),
           "tmax": np.zeros(n), "tri": np.zeros(n, np.int64), "t": np.zeros(n)}
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        rays = raygen.primary_rays(cams[p], w, h, i2p[items["slot"][sel]], ref.dtype,
                                   ref.device)
        any_hit = mix["ray_type"] == "ao"
        if any_hit:
            ptri, pt = _closest(intersect.scan(ref.tris, *rays))
            words = raygen.rotation_word(ao_seed, items["slot"][sel])
            rays = raygen.ao_rays(rays[0], rays[1], torch.nan_to_num(pt, posinf=0.0),
                                  ref.normal(ptri), ptri >= 0, items["sample"][sel], words,
                                  radius, ref.dtype)
        s = intersect.scan(ref.tris, *rays)
        tri, t = _closest(s)
        t = torch.where(tri >= 0, t, rays[3])
        for k, x in zip(("origin", "dirn", "tmin", "tmax"), rays):
            out[k][sel] = x.double().cpu().numpy()
        out["tri"][sel] = tri.cpu().numpy()
        out["t"][sel] = t.double().cpu().numpy()
    return out


def frame_pixels(ref: RefScene, cams, mix: dict, items: dict, ao_seed: int,
                 radius: float) -> np.ndarray:
    """RGBA values of the sampled frame pixels, in bfloat16."""
    w, h = mix["width"], mix["height"]
    i2p = raygen.morton_index_to_pixel(w, h)
    p2i = np.empty_like(i2p)
    p2i[i2p] = np.arange(i2p.size)
    out = np.zeros((len(items["pixel"]), 4))
    samples = int(mix["samples"])
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        px = items["pixel"][sel]
        rays = raygen.primary_rays(cams[p], w, h, px, ref.dtype, ref.device)
        tri, t = _closest(intersect.scan(ref.tris, *rays))
        hit = (tri >= 0).cpu().numpy()
        value = np.tile(BG_COLOR.astype(np.float64), (len(sel), 1))
        if mix["ray_type"] == "primary":
            value[hit] = ref.shaded[tri.cpu().numpy()[hit]]
        else:
            m = len(sel)
            rr = torch.arange(m, device=ref.device).repeat_interleave(samples)
            j = np.tile(np.arange(samples), m)
            words = np.repeat(raygen.rotation_word(ao_seed, p2i[px]), samples)
            ao = raygen.ao_rays(rays[0][rr], rays[1][rr],
                                torch.nan_to_num(t, posinf=0.0)[rr], ref.normal(tri)[rr],
                                (tri >= 0)[rr], j, words, radius, ref.dtype)
            blocked = (intersect.scan(ref.tris, *ao).depth > 0).reshape(m, samples)
            grey = 1.0 - blocked.double().mean(1).cpu().numpy()
            value[hit, :3] = grey[hit, None]
            value[hit, 3] = 1.0
        out[sel] = value
    return out
