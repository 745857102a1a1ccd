"""The comparison that decides ``correct``: the program's rays, hits and
pixels against the plain reference's, worked out again from the same
scene, cameras and seed.

Each judged item gets a graded gap, 0 where the answer is one the
reference accepts and growing with how surely it is wrong, capped at 1:

- ``ray_gap``: the program's ray against the reference's ray for the same
  pixel, slot and sample: the largest of the origin and tmin / tmax
  distances over the scene's extent and the direction's distance.  An AO
  ray depends on its primary hit, so each primary hit the reference could
  accept is tried (``candidates``), and each side of a facing test that is
  nearly even; the cost of choosing it counts in the gap.
- ``hit_gap``: the program's hit for a ray, judged on that ray itself
  (whose own gap is ``ray_gap``) against every triangle
  (``intersect.scan``): a miss where the reference hits by depth h costs
  h; a triangle the ray misses by h costs h; a reported t off by dt costs
  dt / L; for a closest hit, a nearer hit of depth h that is nearer by dt
  costs min(h, dt / L).
- ``pixel_gap``: an image pixel against every pixel value the reference
  could produce from its candidate primary hits and the AO rays around
  them, in color units beside the costs of the choices made.

The same judge reads the control's answers (the reference in bfloat16,
``control.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtbench.reference import intersect, raygen

BG_COLOR = np.array([0.2, 0.4, 0.8, 1.0], np.float32)
LIGHT = np.array([1.0, 2.0, 3.0], np.float32) / np.float32(np.linalg.norm([1.0, 2.0, 3.0]))
# Candidates costlier than this are not tried for a pixel (each costs a
# block of AO rays); the gap is then that of a cheaper one.
PRUNE = 1e-3
# Both sides of a facing test this close to even are tried.
FACING_EVEN = 1e-3


@dataclass
class RefScene:
    """The reference's view of a scene, from the generator's arrays."""

    normals: np.ndarray
    shaded: np.ndarray
    tris: intersect.Triangles
    extent: float

    @classmethod
    def build(cls, positions, indices, tri_diffuse, dtype, device):
        normals = intersect.tri_normals_f32(positions, indices)
        lambert = (normals @ LIGHT) * 0.5 + 0.5
        shaded = np.concatenate([tri_diffuse[:, :3] * lambert[:, None],
                                 np.ones((len(indices), 1), np.float32)], 1).astype(np.float32)
        tris = intersect.Triangles(positions, indices, dtype, device)
        return cls(normals, shaded, tris, tris.extent)

    @property
    def device(self):
        return self.tris.device

    @property
    def dtype(self):
        return self.tris.dtype

    def normal(self, tri: torch.Tensor) -> torch.Tensor:
        n = torch.as_tensor(self.normals, device=self.device).to(self.dtype)
        safe = tri.clamp(min=0).long()
        default = torch.tensor([1.0, 0.0, 0.0], dtype=self.dtype, device=self.device)
        return torch.where((tri >= 0)[:, None], n[safe], default)


def _f(x, scene: RefScene):
    return torch.as_tensor(np.asarray(x), device=scene.device).to(scene.dtype)


# ---------------------------------------------------------------------------
# Hits
# ---------------------------------------------------------------------------

def hit_gap(scene: RefScene, rays, tri, t, any_hit: bool) -> np.ndarray:
    """Gap of each answer (tri, t) for ``rays``."""
    o, d, tmin, tmax = rays
    s = intersect.scan(scene.tris, o, d, tmin, tmax)
    tri = torch.as_tensor(np.asarray(tri), device=scene.device).long()
    t = _f(t, scene)
    inv_l = 1.0 / scene.extent
    miss_gap = s.depth.clamp(min=0)
    t_p, h_p = intersect.eval_tris(scene.tris, o, d, tmin, tmax, tri.clamp(min=0))
    g = torch.maximum((-h_p).clamp(min=0), (t - t_p).abs() * inv_l)
    if not any_hit:
        nearer = torch.minimum(s.h, (t_p[:, None] - s.t) * inv_l)
        nearer = torch.where((s.tri >= 0) & (s.tri != tri[:, None]), nearer,
                             torch.full_like(nearer, -np.inf))
        g = torch.maximum(g, nearer.amax(1).clamp(min=0))
    gap = torch.where(tri < 0, miss_gap, g)
    gap = torch.nan_to_num(gap, nan=1.0).clamp(max=1.0)
    return gap.double().cpu().numpy()


def candidates(scene: RefScene, s: intersect.Scan):
    """The primary hits the reference could accept for each ray: its
    CANDIDATES nearest triangles, then a miss.  Returns (tri, t, cost) as
    [N, CANDIDATES + 1]: a triangle costs how far it is missed and how
    surely a nearer one is hit; the miss costs the deepest hit."""
    inv_l = 1.0 / scene.extent
    k = s.t.shape[1]
    costs = []
    for j in range(k):
        c = (-s.h[:, j]).clamp(min=0)
        for i in range(j):
            nearer = torch.minimum(s.h[:, i], (s.t[:, j] - s.t[:, i]) * inv_l)
            c = torch.maximum(c, torch.where(s.tri[:, i] >= 0, nearer, torch.zeros_like(c)))
        costs.append(torch.where(s.tri[:, j] >= 0, c, torch.full_like(c, np.inf)))
    costs.append(s.depth.clamp(min=0))
    n = s.t.shape[0]
    tri = torch.cat([s.tri, torch.full((n, 1), -1, dtype=s.tri.dtype, device=s.tri.device)], 1)
    t = torch.cat([s.t, torch.zeros((n, 1), dtype=s.t.dtype, device=s.t.device)], 1)
    return tri, t, torch.nan_to_num(torch.stack(costs, 1), nan=np.inf)


def _ray_distance(scene: RefScene, a, b) -> torch.Tensor:
    """Distance of rays ``a`` from rays ``b`` (both (o, d, tmin, tmax))."""
    inv_l = 1.0 / scene.extent
    ends = torch.maximum((a[2] - b[2]).abs(), (a[3] - b[3]).abs()) * inv_l
    shape = torch.maximum((a[0] - b[0]).abs().amax(1) * inv_l, (a[1] - b[1]).abs().amax(1))
    live = (a[3] >= 0) & (b[3] >= 0)
    return torch.nan_to_num(torch.where(live, torch.maximum(ends, shape), ends), nan=1.0)


def _expand(x, reps: int):
    return x.repeat_interleave(reps, dim=0)


def ao_variants(scene: RefScene, prim, ctri, ct, samples, words, radius):
    """The AO ray of every (item, candidate, facing side): prim is the
    items' primary rays, (ctri, ct) their candidates [N, C]; returns the
    rays flattened over [N, C, 2] and the cost of taking the undecided
    facing side."""
    n, c = ctri.shape
    reps = c * 2
    o, d = _expand(prim[0], reps), _expand(prim[1], reps)
    tri = ctri.repeat_interleave(2, dim=1).reshape(-1)
    t = ct.repeat_interleave(2, dim=1).reshape(-1).to(scene.dtype)
    t = torch.where(tri >= 0, t, torch.zeros_like(t))
    normal = scene.normal(tri)
    _, facing = raygen.facing_normal(normal, d)
    decided = facing > 0
    side = torch.arange(n * reps, device=scene.device) % 2 == 1
    flip = torch.where(side, ~decided, decided)
    rays = raygen.ao_rays(o, d, t, normal, tri >= 0, np.repeat(samples, reps),
                          np.repeat(words, reps), radius, scene.dtype, flip=flip)
    side_cost = torch.where(side, facing.abs(), torch.zeros_like(facing))
    return rays, side_cost


# ---------------------------------------------------------------------------
# Trace cells
# ---------------------------------------------------------------------------

def judge_trace(scene: RefScene, cams, mix: dict, items: dict, answers: dict, ao_seed: int,
                radius: float) -> dict:
    """``ray_gap`` and ``hit_gap`` per item.  ``items``: pose, slot and
    sample (-1 for a primary ray) per item; ``answers``: the judged side's
    ray (origin, dirn, tmin, tmax) and hit (tri, t) for it."""
    w, h = mix["width"], mix["height"]
    i2p = raygen.morton_index_to_pixel(w, h)
    n = len(items["slot"])
    ray_gap = np.zeros(n)
    hit = np.zeros(n)
    ao = mix["ray_type"] == "ao"
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        prim = raygen.primary_rays(cams[p], w, h, i2p[items["slot"][sel]], scene.dtype,
                                   scene.device)
        theirs = tuple(_f(answers[k][sel], scene)
                       for k in ("origin", "dirn", "tmin", "tmax"))
        if not ao:
            ray_gap[sel] = _ray_distance(scene, prim, theirs).double().cpu().numpy()
        else:
            ray_gap[sel] = _ao_ray_gap(scene, prim, theirs, items["slot"][sel],
                                       items["sample"][sel], ao_seed, radius)
        hit[sel] = hit_gap(scene, theirs, answers["tri"][sel], answers["t"][sel], ao)
    return {"ray_gap": np.minimum(ray_gap, 1.0), "hit_gap": hit}


def _ao_ray_gap(scene, prim, theirs, slots, samples, ao_seed, radius) -> np.ndarray:
    """Gap of the judged AO rays from the nearest the reference could
    make from its candidate primary hits."""
    s = intersect.scan(scene.tris, *prim)
    ctri, ct, ccost = candidates(scene, s)
    words = raygen.rotation_word(ao_seed, slots)
    rays, side_cost = ao_variants(scene, prim, ctri, ct, samples, words, radius)
    n = len(slots)
    reps = rays[0].shape[0] // n
    dist = _ray_distance(scene, rays, tuple(_expand(x, reps) for x in theirs))
    cost = ccost.repeat_interleave(2, dim=1).reshape(-1)
    total = torch.maximum(torch.maximum(dist, side_cost), cost).reshape(n, reps)
    return total.amin(1).clamp(max=1.0).double().cpu().numpy()


# ---------------------------------------------------------------------------
# Frame cells
# ---------------------------------------------------------------------------

def judge_frames(scene: RefScene, cams, mix: dict, items: dict, pixels: np.ndarray,
                 ao_seed: int, radius: float) -> dict:
    """``pixel_gap`` per item: ``items`` pose and pixel; ``pixels`` the
    judged side's RGBA value [N, 4] there."""
    w, h = mix["width"], mix["height"]
    i2p = raygen.morton_index_to_pixel(w, h)
    p2i = np.empty_like(i2p)
    p2i[i2p] = np.arange(i2p.size)
    n = len(items["pixel"])
    out = np.zeros(n)
    bg = torch.as_tensor(BG_COLOR, device=scene.device).double()
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        px = items["pixel"][sel]
        prim = raygen.primary_rays(cams[p], w, h, px, scene.dtype, scene.device)
        s = intersect.scan(scene.tris, *prim)
        ctri, ct, ccost = candidates(scene, s)
        value = torch.as_tensor(pixels[sel], device=scene.device).double()
        miss_dist = (value - bg).abs().amax(1)
        if mix["ray_type"] == "primary":
            shaded = torch.as_tensor(scene.shaded, device=scene.device).double()
            colors = shaded[ctri.clamp(min=0)]
            dist = (colors - value[:, None, :]).abs().amax(2)
            dist = torch.where(ctri >= 0, dist, miss_dist[:, None])
            gap = torch.maximum(dist, ccost.double()).amin(1)
            out[sel] = gap.clamp(max=1.0).cpu().numpy()
            continue
        out[sel] = _ao_pixel_gap(scene, prim, ctri, ct, ccost, value, miss_dist,
                                 p2i[px], ao_seed, radius, mix["samples"])
    return {"pixel_gap": out}


def _ao_pixel_gap(scene, prim, ctri, ct, ccost, value, miss_dist, slots, ao_seed, radius,
                  samples):
    n, c = ctri.shape
    s_count = int(samples)
    # The pixel's AO reading: k of s_count samples blocked gives gray 1 - k/s.
    grey = value[:, :3].mean(1)
    k_port = torch.clamp(torch.round((1.0 - grey) * s_count), 0, s_count)
    want = torch.cat([(1.0 - k_port / s_count)[:, None].expand(n, 3),
                      torch.ones((n, 1), dtype=value.dtype, device=value.device)], 1)
    color_dist = (value - want).abs().amax(1)
    best = torch.maximum(ccost[:, -1].double(), miss_dist)
    # Hit candidates worth a block of AO rays, on each facing side that is
    # nearly even.
    words = raygen.rotation_word(ao_seed, slots)
    rows, cols = torch.nonzero(ccost[:, :-1] < ccost.amin(1, keepdim=True) + PRUNE,
                               as_tuple=True)
    if rows.numel():
        sub = (prim[0][rows], prim[1][rows])
        tri = ctri[rows, cols]
        t = ct[rows, cols]
        normal = scene.normal(tri)
        _, facing = raygen.facing_normal(normal, sub[1])
        both = facing.abs() < FACING_EVEN
        r_idx = torch.cat([torch.arange(rows.numel(), device=rows.device),
                           torch.nonzero(both).reshape(-1)])
        flip = torch.cat([facing > 0, ~(facing[both] > 0)])
        cost = torch.cat([ccost[rows, cols], torch.maximum(ccost[rows, cols][both],
                                                          facing[both].abs())])
        m = r_idx.numel()
        rr = r_idx.repeat_interleave(s_count)
        j = np.tile(np.arange(s_count), m)
        w_rows = words[rows.cpu().numpy()][r_idx.cpu().numpy()]
        rays = raygen.ao_rays(sub[0][rr], sub[1][rr], t[rr].to(scene.dtype), normal[rr],
                              torch.ones_like(rr, dtype=torch.bool), j,
                              np.repeat(w_rows, s_count), radius, scene.dtype,
                              flip=flip.repeat_interleave(s_count))
        depth = intersect.scan(scene.tris, *rays).depth.reshape(m, s_count).double()
        item = rows[r_idx]
        k = k_port[item].long()
        order = torch.sort(depth, dim=1, descending=True).values
        pos = torch.arange(s_count, device=depth.device)[None, :]
        blocked = pos < k[:, None]
        g = torch.where(blocked, (-order).clamp(min=0), order.clamp(min=0)).amax(1)
        total = torch.maximum(torch.maximum(g, cost.double()), color_dist[item])
        best = best.scatter_reduce(0, item, total, reduce="amin")
    return torch.nan_to_num(best, nan=1.0).clamp(max=1.0).cpu().numpy()
