"""Plain reference ray generation: primary rays through pixels, and AO rays
around a hit, in any floating dtype (float64 for the reference, bfloat16
for the control).

The semantics are the reference renderer's (src/rt/ray/RayGenKernels.cu,
Renderer.cc:126-129, PixelTable.cc) as the benchmark's configurations
state them; nothing here reads the program's code or its derived data.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
# Hit points are pulled back this far along the incoming ray (f32).
BACKTRACK = float(np.float32(1.0e-4))


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

def nscreen_to_world(cam: dict, width: int, height: int) -> np.ndarray:
    """Normalized screen (x, y, 0, 1) to a world point: the inverse of
    fitToView((-1,-1),(2,2),(w,h)) @ perspective @ world_to_camera, the
    matrix formed in float32 as the reference renderer forms it
    (Renderer.cc:126-129, CameraControls.cc:263-270, Math.cc:66-92) and
    inverted in float64."""
    f32 = np.float32
    pos = np.asarray(cam["position"], f32)
    back = -np.asarray(cam["forward"], f32)
    back = back / np.linalg.norm(back)
    right = np.cross(np.asarray(cam["up"], f32), back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    up = up / np.linalg.norm(up)
    rot = np.stack([right, up, back], axis=1).astype(f32)
    w2c = np.eye(4, dtype=f32)
    w2c[:3, :3] = rot.T
    w2c[:3, 3] = -(rot.T @ pos)
    near, far = cam["near"], cam["far"]
    f = 1.0 / np.tan(f32(cam["fov"]) * np.pi / 360.0)
    d = 1.0 / (near - far)
    proj = np.zeros((4, 4), f32)
    proj[0, 0] = proj[1, 1] = f
    proj[2, 2] = (near + far) * d
    proj[2, 3] = 2.0 * near * far * d
    proj[3, 2] = -1.0
    m = f32(min(width / 2.0, height / 2.0))
    fit = np.diag(np.array([2.0 / width * m, 2.0 / height * m, 1.0, 1.0], f32))
    return np.linalg.inv((fit @ (proj @ w2c).astype(f32)).astype(f32).astype(np.float64))


def morton_index_to_pixel(width: int, height: int) -> np.ndarray:
    """Primary ray i targets pixel ``index_to_pixel[i]``: 8x8 blocks in
    Morton order, pixels bit-swizzled within a block, then the bottom
    stripe column-major and the right stripe row-major (PixelTable.cc)."""
    out = []
    bw, bh = width & ~7, height & ~7
    w8, h8 = bw >> 3, bh >> 3
    if w8 > 0 and h8 > 0:
        side = 1
        while side < max(w8, h8):
            side *= 2
        i = np.arange(side * side, dtype=np.int64)

        def even_bits(v):
            r = np.zeros_like(v)
            for b in range(32):
                r |= ((v >> (2 * b)) & 1) << b
            return r

        tx, ty = even_bits(i), even_bits(i >> 1)
        keep = (tx < w8) & (ty < h8)
        tx, ty = tx[keep], ty[keep]
        inner = np.arange(64)
        ix = (inner & 1) | ((inner >> 1) & 2) | ((inner >> 2) & 4)
        iy = ((inner >> 1) & 1) | ((inner >> 2) & 2) | ((inner >> 3) & 4)
        out.append(((ty[:, None] * 8 + iy) * width + tx[:, None] * 8 + ix).ravel())
    if bh < height and bw > 0:
        px, py = np.meshgrid(np.arange(bw), np.arange(bh, height), indexing="ij")
        out.append((py * width + px).ravel())
    if bw < width:
        py, px = np.meshgrid(np.arange(height), np.arange(bw, width), indexing="ij")
        out.append((py * width + px).ravel())
    return np.concatenate(out).astype(np.int64)


def primary_rays(cam: dict, width: int, height: int, pixels, dtype, device):
    """(origin, dirn, tmin, tmax) of the primary rays through ``pixels``, in
    ``dtype``.  They are made in the precision the configurations state,
    float32 (bfloat16 for the control): the float32 matrix applied to the
    pixel center, the unprojected point less the eye, normalized."""
    work = torch.float32 if dtype == torch.float64 else dtype
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    m = torch.as_tensor(nscreen_to_world(cam, width, height).astype(np.float32),
                        device=device).to(work)
    sx = 2.0 * ((pixels % width).to(work) + 0.5) / width - 1.0
    sy = 2.0 * ((pixels // width).to(work) + 0.5) / height - 1.0
    world = m[:, 0] * sx[:, None] + m[:, 1] * sy[:, None] + m[:, 3]
    o = torch.as_tensor(np.asarray(cam["position"], np.float32), device=device).to(work)
    d = world[:, :3] / world[:, 3:4] - o
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    n = pixels.shape[0]
    return (o.expand(n, 3).to(dtype), d.to(dtype), torch.zeros(n, dtype=dtype, device=device),
            torch.full((n,), float(np.float32(cam["far"])), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# AO rays
# ---------------------------------------------------------------------------

def _mix(a, b, c):
    a = (a - b - c) & U32; a ^= c >> 13
    b = (b - c - a) & U32; b ^= (a << 8) & U32
    c = (c - a - b) & U32; c ^= b >> 13
    a = (a - b - c) & U32; a ^= c >> 12
    b = (b - c - a) & U32; b ^= (a << 16) & U32
    c = (c - a - b) & U32; c ^= b >> 5
    a = (a - b - c) & U32; a ^= c >> 3
    b = (b - c - a) & U32; b ^= (a << 10) & U32
    c = (c - a - b) & U32; c ^= b >> 15
    return a, b, c


def rotation_word(seed: int, slots: np.ndarray) -> np.ndarray:
    """The per-ray random word: the third word of two Jenkins mixes of
    (seed + primary slot, golden, golden), as int64 holding a uint32."""
    a = (slots.astype(np.int64) + (int(seed) & U32)) & U32
    b = np.full(a.shape, GOLDEN, np.int64)
    c = b.copy()
    return _mix(*_mix(a, b, c))[2]


def halton(j: np.ndarray, base: int) -> np.ndarray:
    """Radical inverse of j + 1 in ``base`` (float64)."""
    v = j.astype(np.int64) + 1
    out = np.zeros(v.shape)
    f = 1.0 / base
    while np.any(v > 0):
        out += (v % base) * f
        v //= base
        f /= base
    return out


def facing_normal(normal, dirn):
    """The normal flipped to face against ``dirn``, and the dot product
    that decided it."""
    facing = (normal * dirn).sum(dim=1)
    return torch.where((facing > 0)[:, None], -normal, normal), facing


def ao_rays(origin, dirn, t, normal, valid, samples, word, radius, dtype, flip=None):
    """AO rays of sample index ``samples`` around hits at ``t`` along
    (origin, dirn) on triangles of ``normal``; ``valid`` False gives a
    degenerate ray (tmax = -1).  ``word`` is ``rotation_word``.  ``flip``
    (bool per ray) overrides the facing decision.  Cosine-weighted
    hemisphere directions from Halton (2, 3), rotated by the word's angle
    about the normal (RayGenKernels.cu:117-227)."""
    dev = origin.device
    org = origin + dirn * torch.clamp(t - BACKTRACK, min=0.0)[:, None]
    n, _ = facing_normal(normal, dirn)
    if flip is not None:
        n = torch.where(flip[:, None], -normal, normal)
    na = n.abs()
    nm = na.amax(dim=1)
    zero = torch.zeros_like(nm)
    nx, ny, nz = n.unbind(1)
    perp = torch.where((nm == na[:, 2])[:, None], torch.stack([zero, nz, -ny], 1),
                       torch.where((nm == na[:, 0])[:, None], torch.stack([-nz, zero, nx], 1),
                                   torch.stack([ny, -nx, zero], 1)))
    perp = perp / torch.linalg.vector_norm(perp, dim=1, keepdim=True)
    biperp = torch.linalg.cross(n, perp, dim=1)
    angle = torch.as_tensor(2.0 * np.pi * word.astype(np.float64) / 2.0**32, device=dev).to(dtype)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    t0 = perp * ca + biperp * sa
    t1 = -perp * sa + biperp * ca
    hx = torch.as_tensor(halton(samples, 2), device=dev).to(dtype)
    hy = torch.as_tensor(halton(samples, 3), device=dev).to(dtype)
    sr = torch.sqrt(hx)
    x = sr * torch.cos(2.0 * np.pi * hy)
    y = sr * torch.sin(2.0 * np.pi * hy)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    d = x[:, None] * t0 + y[:, None] * t1 + z[:, None] * n
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    r = float(np.float32(radius))
    tmax = torch.where(valid, torch.full_like(t, r), torch.full_like(t, -1.0))
    return org, d, torch.zeros_like(t), tmax
