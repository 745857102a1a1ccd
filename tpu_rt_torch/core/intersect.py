"""Host-side intersection primitives (reference src/rt/Util.cc:34-127
Intersect::RayBox / RayTriangle / RayTriangleWoop), vectorized numpy.

Counterpart of ``tpu_rt.core.intersect``, the same numpy code; these mirror
the reference's CPU oracle math.  Note the documented sign
deviation: the reference's host RayTriangleWoop uses t = -Oz*ooDz while its
GPU kernel uses t = Oz*invDz with Oz negated in the fetch
(Util.cc:106-108 vs kepler_dynamic_fetch.cu:336-338); tpu_rt standardizes on
the GPU convention everywhere (SURVEY.md section 7 "hard parts").
"""

from __future__ import annotations

import numpy as np


def ray_box(box_lo, box_hi, origin, dirn, tmin, tmax):
    """Slab test.  Returns (hit mask, t_near, t_far) for [N] rays against a
    single box or [N,3] boxes (broadcasting)."""
    origin = np.asarray(origin, np.float32)
    dirn = np.asarray(dirn, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirn
        t0 = (np.asarray(box_lo, np.float32) - origin) * inv
        t1 = (np.asarray(box_hi, np.float32) - origin) * inv
    near = np.maximum(np.minimum(t0, t1).max(axis=-1), np.asarray(tmin, np.float32))
    far = np.minimum(np.maximum(t0, t1).min(axis=-1), np.asarray(tmax, np.float32))
    return far >= near, near, far


def ray_triangle(v0, v1, v2, origin, dirn, tmin, tmax):
    """Moller-Trumbore for [N] rays against [N] triangles elementwise.
    Returns (hit mask, t, u, v)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    origin = np.asarray(origin, np.float32)
    dirn = np.asarray(dirn, np.float32)
    pvec = np.cross(dirn, e2)
    det = np.einsum("...k,...k->...", e1, pvec)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
        tvec = origin - v0
        u = np.einsum("...k,...k->...", tvec, pvec) * inv_det
        qvec = np.cross(tvec, e1)
        v = np.einsum("...k,...k->...", dirn, qvec) * inv_det
        t = np.einsum("...k,...k->...", e2, qvec) * inv_det
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin) & (t < tmax)
    return hit, t, u, v


def ray_triangle_woop(woop_row, origin, dirn, tmin, tmax):
    """Woop unit-triangle test with the GPU kernel's convention
    (kepler_dynamic_fetch.cu:334-370).  woop_row: [...,12]
    (woopZ[4], woopU[4], woopV[4]).  Returns (hit, t, u, v)."""
    w = np.asarray(woop_row, np.float32)
    origin = np.asarray(origin, np.float32)
    dirn = np.asarray(dirn, np.float32)
    wz, wzw = w[..., 0:3], w[..., 3]
    wx, wxw = w[..., 4:7], w[..., 7]
    wy, wyw = w[..., 8:11], w[..., 11]
    oz = wzw - np.einsum("...k,...k->...", origin, wz)
    dz = np.einsum("...k,...k->...", dirn, wz)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = oz / dz
        u = wxw + np.einsum("...k,...k->...", origin, wx) + t * np.einsum("...k,...k->...", dirn, wx)
        v = wyw + np.einsum("...k,...k->...", origin, wy) + t * np.einsum("...k,...k->...", dirn, wy)
    hit = (t > tmin) & (t < tmax) & (u >= 0) & (v >= 0) & (u + v <= 1)
    return hit, t, u, v
