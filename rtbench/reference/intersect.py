"""Plain reference ray-triangle intersection: every ray against every
triangle, in blocks, with nothing built from the program.

A ray hits a triangle where the Moller-Trumbore solution (u, v, t) has
u, v, 1 - u - v >= 0 and tmin <= t <= tmax.  The judge needs to know how
surely, so the scan reports a graded "hit depth" per (ray, triangle):

    h = min(u, v, 1 - u - v, (t - tmin) / L, (tmax - t) / L)

with L the scene's extent: h > 0 is a hit with that much room on every
side, h < 0 a miss by that much.  The Moller-Trumbore products are written
as four small matrix products per block (the scalar triple products
expanded over the ray's moment o x d), so a block is a few kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Hits deeper than -LOOSE are kept as candidates of a closest hit.
LOOSE = 1e-3
CANDIDATES = 8


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tri_normals_f32(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Geometric normals in float32, the precision the scenes state:
    normalize(cross(v1 - v0, v2 - v0))."""
    p = positions
    e1 = p[indices[:, 1]] - p[indices[:, 0]]
    e2 = p[indices[:, 2]] - p[indices[:, 0]]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-30)).astype(np.float32)


class Triangles:
    """A scene's triangles as the coefficient rows of the four products."""

    def __init__(self, positions: np.ndarray, indices: np.ndarray, dtype, device):
        _no_tf32()
        v = torch.as_tensor(np.asarray(positions, np.float64)[np.asarray(indices)],
                            device=device).to(dtype)
        v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        n = torch.linalg.cross(e1, e2, dim=1)
        self.det = -n                                                   # det = d . (e2 x e1)
        self.u = torch.cat([e2, torch.linalg.cross(v0, e2, dim=1)], 1)   # [o x d, d]
        self.v = torch.cat([-e1, -torch.linalg.cross(v0, e1, dim=1)], 1)
        self.t = torch.cat([n, -(v0 * n).sum(1, keepdim=True)], 1)      # [o, 1]
        self.count = int(v.shape[0])
        self.dtype = dtype
        self.device = device
        self.extent = float(np.linalg.norm(positions.max(0).astype(np.float64)
                                           - positions.min(0).astype(np.float64)))


class Scan(NamedTuple):
    """Per ray: the deepest hit depth over all triangles (``depth``) and the
    CANDIDATES nearest triangles with h > -LOOSE, by t (``t``, ``tri``,
    ``h``; tri -1 and t inf where fewer)."""

    depth: torch.Tensor
    t: torch.Tensor
    tri: torch.Tensor
    h: torch.Tensor


def _rows(o, d):
    return (torch.cat([torch.linalg.cross(o, d, dim=1), d], 1),
            torch.cat([o, torch.ones_like(o[:, :1])], 1))


def _solve(tris: Triangles, x6, x4, d, tmin, tmax, sl):
    det = d @ tris.det[sl].T
    u = (x6 @ tris.u[sl].T) / det
    v = (x6 @ tris.v[sl].T) / det
    t = (x4 @ tris.t[sl].T) / det
    inv_l = 1.0 / tris.extent
    h = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    h = torch.minimum(h, (t - tmin[:, None]) * inv_l)
    h = torch.minimum(h, (tmax[:, None] - t) * inv_l)
    return t, torch.nan_to_num(h, nan=-np.inf, posinf=-np.inf)


def scan(tris: Triangles, o, d, tmin, tmax, ray_block: int = 1024,
         tri_block: int = 32768) -> Scan:
    """Every ray against every triangle (rays as [N, 3], [N] tensors)."""
    cast = [x.to(device=tris.device, dtype=tris.dtype) for x in (o, d, tmin, tmax)]
    n = cast[0].shape[0]
    k = CANDIDATES
    dev, dt = tris.device, tris.dtype
    depth = torch.full((n,), -np.inf, dtype=dt, device=dev)
    best_t = torch.full((n, k), np.inf, dtype=dt, device=dev)
    best_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    best_h = torch.full((n, k), -np.inf, dtype=dt, device=dev)
    for r0 in range(0, n, ray_block):
        rs = slice(r0, min(n, r0 + ray_block))
        o_, d_, lo, hi = (x[rs] for x in cast)
        x6, x4 = _rows(o_, d_)
        for t0 in range(0, tris.count, tri_block):
            sl = slice(t0, min(tris.count, t0 + tri_block))
            t, h = _solve(tris, x6, x4, d_, lo, hi, sl)
            depth[rs] = torch.maximum(depth[rs], h.amax(1))
            tt = torch.where(h > -LOOSE, t, torch.full_like(t, np.inf))
            kk = min(k, tt.shape[1])
            vals, idx = torch.topk(tt, kk, dim=1, largest=False)
            hh = torch.gather(h, 1, idx)
            all_t = torch.cat([best_t[rs], vals], 1)
            all_i = torch.cat([best_i[rs], idx + t0], 1)
            all_h = torch.cat([best_h[rs], hh], 1)
            vals, sel = torch.topk(all_t, k, dim=1, largest=False)
            best_t[rs] = vals
            best_i[rs] = torch.gather(all_i, 1, sel)
            best_h[rs] = torch.gather(all_h, 1, sel)
    best_i = torch.where(torch.isinf(best_t), torch.full_like(best_i, -1), best_i)
    return Scan(depth, best_t, best_i, best_h)


def eval_tris(tris: Triangles, o, d, tmin, tmax, tri):
    """(t, h) of each ray against its own triangle ``tri`` (>= 0)."""
    o, d, tmin, tmax = (x.to(device=tris.device, dtype=tris.dtype) for x in (o, d, tmin, tmax))
    tri = torch.as_tensor(tri, device=tris.device).long()
    x6, x4 = _rows(o, d)
    det = (d * tris.det[tri]).sum(1)
    u = (x6 * tris.u[tri]).sum(1) / det
    v = (x6 * tris.v[tri]).sum(1) / det
    t = (x4 * tris.t[tri]).sum(1) / det
    h = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    h = torch.minimum(h, (t - tmin) / tris.extent)
    h = torch.minimum(h, (tmax - t) / tris.extent)
    return t, torch.nan_to_num(h, nan=-np.inf, posinf=-np.inf)
