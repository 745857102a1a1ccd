"""Device ray generators (torch) — primary, AO / diffuse bounce, shadow.

Counterpart of ``tpu_rt.raygen.generators``, the vectorized re-designs of
the reference's raygen kernels (src/rt/ray/RayGenKernels.cu:79-293).  One
call is a handful of elementwise torch ops over the whole batch on the
device of its inputs; the ID<->slot arrays are returned alongside.

``gen_ao_rays`` on a CUDA device is one launch of a hand-written kernel
(``csrc/raygen_ao.cu``, ``ao_kernel.py``); on the CPU it runs its plain
version ``gen_ao_rays_plain``, the ops below, which the tests hold to
``tpu_rt`` and the kernel to.

Seeding is explicit (the reference's RayGen.cc:106 uses rand()): the caller
passes a uint32 seed.  Torch has no uint32 shifts, ``%`` or ``//`` on every
device, so the Jenkins mix and the Halton digit loops run in int64 holding
values in [0, 2^32): every subtraction and left shift is masked back to 32
bits, and right shifts of those non-negative values are logical.  The hash
words and Halton points are then bit-equal to ``tpu_rt``'s; the directions
agree within a few ulps, since torch's cos, sin and sqrt may round
differently from XLA's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rt_torch.core.math import hammersley, sobol2d
from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.raygen import ao_kernel

TWO_PI = float(np.float32(2.0 * np.pi))
GOLDEN = 0x9E3779B9
U32 = 0xFFFFFFFF
INV_2_32 = 2.0 ** -32


def gen_primary_rays(
    index_to_pixel: torch.Tensor,    # [W*H] i32
    origin: torch.Tensor,            # [3] f32
    nscreen_to_world: torch.Tensor,  # [4,4] f32
    width: int,
    height: int,
    max_dist: float,
):
    """Primary rays in Morton-swizzled pixel order (rayGenPrimaryKernel,
    RayGenKernels.cu:79-113).  Returns (Rays, slot_to_id, id_to_slot), all
    on the device of ``index_to_pixel``."""
    dev = index_to_pixel.device
    n = width * height
    f32 = torch.float32
    task = torch.arange(n, dtype=torch.int32, device=dev)
    pixel = index_to_pixel.to(torch.int32)

    px = (pixel % width).to(f32)
    py = (pixel // width).to(f32)
    sx = 2.0 * (px + 0.5) / width - 1.0
    sy = 2.0 * (py + 0.5) / height - 1.0

    # Transform (sx, sy, 0, 1) by the 4x4 with explicit f32 per-element
    # math, never a matmul (which could run in TF32 on the card): the
    # perspective inverse has heavy cancellation in w.
    m = nscreen_to_world.to(device=dev, dtype=f32)
    world = m[None, :, 0] * sx[:, None] + m[None, :, 1] * sy[:, None] + m[None, :, 3]  # [n,4]
    world_pos = world[:, :3] / world[:, 3:4]
    d = world_pos - origin.to(device=dev, dtype=f32)[None, :]
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)

    rays = Rays(
        origin=origin.to(device=dev, dtype=f32).expand(n, 3).contiguous(),
        dirn=d.contiguous(),
        tmin=torch.zeros((n,), dtype=f32, device=dev),
        tmax=torch.full((n,), float(max_dist), dtype=f32, device=dev),
    )
    slot_to_id = pixel
    id_to_slot = torch.zeros((n,), dtype=torch.int32, device=dev).scatter_(0, pixel.long(), task)
    return rays, slot_to_id, id_to_slot


# ---------------------------------------------------------------------------
# uint32 hashing and low-discrepancy sequences in int64
# ---------------------------------------------------------------------------

def _jenkins_mix(a, b, c):
    """The 96-bit Jenkins mixer (RayGenKernels.cu:40-47) on int64 tensors
    holding uint32 values; returns the same."""
    a = (a - b) & U32; a = (a - c) & U32; a = a ^ (c >> 13)
    b = (b - c) & U32; b = (b - a) & U32; b = b ^ ((a << 8) & U32)
    c = (c - a) & U32; c = (c - b) & U32; c = c ^ (b >> 13)
    a = (a - b) & U32; a = (a - c) & U32; a = a ^ (c >> 12)
    b = (b - c) & U32; b = (b - a) & U32; b = b ^ ((a << 16) & U32)
    c = (c - a) & U32; c = (c - b) & U32; c = c ^ (b >> 5)
    a = (a - b) & U32; a = (a - c) & U32; a = a ^ (c >> 3)
    b = (b - c) & U32; b = (b - a) & U32; b = b ^ ((a << 10) & U32)
    c = (c - a) & U32; c = (c - b) & U32; c = c ^ (b >> 15)
    return a, b, c


def _hash_words(seed: int, task_offset: int, r: int, dev):
    """Two Jenkins mixes of (seed + task, golden, golden) for tasks
    task_offset .. task_offset + r - 1: the per-ray random words."""
    task = (torch.arange(r, dtype=torch.int64, device=dev) + (int(task_offset) & U32)) & U32
    a = (task + (int(seed) & U32)) & U32
    b = torch.full((r,), GOLDEN, dtype=torch.int64, device=dev)
    c = b.clone()
    a, b, c = _jenkins_mix(a, b, c)
    return _jenkins_mix(a, b, c)


def _u32_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 value (in int64) -> f32 in [0, 1): round to f32, times 2^-32."""
    return x.to(torch.float32) * INV_2_32


def _halton2(i: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse of i+1 (bit reversal, RayGenKernels.cu:180-205)."""
    v = (i.to(torch.int64) + 1) & U32
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    v = ((v >> 16) | (v << 16)) & U32
    return _u32_to_unit(v)


def _halton3(i: torch.Tensor, iters: int = 21) -> torch.Tensor:
    """Base-3 radical inverse of i+1 (RayGenKernels.cu:207-215); 3^21 > 2^32."""
    hc = (i.to(torch.int64) + 1) & U32
    y = torch.zeros(hc.shape, dtype=torch.float32, device=hc.device)
    yadd = torch.ones(hc.shape, dtype=torch.float32, device=hc.device)
    third = float(np.float32(1.0 / 3.0))
    for _ in range(iters):
        yadd = yadd * third
        y = y + (hc % 3).to(torch.float32) * yadd
        hc = hc // 3
    return y


def _backtrack(in_origin, in_dirn, in_t):
    """Hit points pulled back by epsilon along the incoming ray."""
    eps = float(np.float32(1.0e-4))
    back = torch.maximum(in_t - eps, torch.zeros_like(in_t))
    return in_origin + in_dirn * back[:, None]


def _expand(origin: torch.Tensor, num_samples: int) -> torch.Tensor:
    r = origin.shape[0]
    return origin[:, None, :].expand(r, num_samples, 3).reshape(r * num_samples, 3)


# ---------------------------------------------------------------------------
# Secondary generators
# ---------------------------------------------------------------------------

def gen_ao_rays(
    in_origin: torch.Tensor,   # [R,3] input ray origins
    in_dirn: torch.Tensor,     # [R,3] input ray directions
    in_t: torch.Tensor,        # [R] hit t
    in_tri: torch.Tensor,      # [R] hit tri id (-1 miss)
    tri_normal: torch.Tensor,  # [T,3] scene triangle normals
    num_samples: int,
    max_dist: float,
    seed: int,                 # uint32
    task_offset: int = 0,
):
    """AO / diffuse-bounce rays (rayGenAOKernel, RayGenKernels.cu:117-227):
    ``gen_ao_rays_plain``'s results.  Inputs on a CUDA device take one
    launch of ``csrc/raygen_ao.cu`` (``ao_kernel.KERNEL``, which counts it);
    inputs on the CPU take ``gen_ao_rays_plain``."""
    dev = in_origin.device
    if dev.type != "cuda":
        return gen_ao_rays_plain(in_origin, in_dirn, in_t, in_tri, tri_normal, num_samples,
                                 max_dist, seed, task_offset)
    return ao_kernel.KERNEL(in_origin, in_dirn, in_t, in_tri,
                            tri_normal.to(device=dev, dtype=torch.float32), num_samples,
                            max_dist, seed, task_offset)


def gen_ao_rays_plain(
    in_origin: torch.Tensor,   # [R,3] input ray origins
    in_dirn: torch.Tensor,     # [R,3] input ray directions
    in_t: torch.Tensor,        # [R] hit t
    in_tri: torch.Tensor,      # [R] hit tri id (-1 miss)
    tri_normal: torch.Tensor,  # [T,3] scene triangle normals
    num_samples: int,
    max_dist: float,
    seed: int,                 # uint32
    task_offset: int = 0,
):
    """AO / diffuse-bounce rays (rayGenAOKernel, RayGenKernels.cu:117-227).

    For each input hit: backtrack epsilon along the ray, build a tangent
    frame around the (front-facing) normal with a per-ray random rotation
    (2x jenkinsMix of seed + task_offset + i), then emit num_samples
    cosine-weighted hemisphere directions from the Halton 2/3 sequence.
    Misses emit degenerate rays (tmax = -1).  Returns (Rays [R*S],
    slot_to_id, id_to_slot), both identity (RayGenKernels.cu:224-225), on
    the device of ``in_origin``.
    """
    dev = in_origin.device
    f32 = torch.float32
    r = in_origin.shape[0]
    origin = _backtrack(in_origin, in_dirn, in_t)

    tri_normal = tri_normal.to(device=dev, dtype=f32)
    if tri_normal.shape[0] == 0:
        # Empty scene: every input missed; pad so the gather stays well-formed.
        tri_normal = torch.zeros((1, 3), dtype=f32, device=dev)
    valid = in_tri >= 0
    tri_c = in_tri.long().clamp(0, tri_normal.shape[0] - 1)
    default = torch.tensor([[1.0, 0.0, 0.0]], dtype=f32, device=dev)
    normal = torch.where(valid[:, None], tri_normal[tri_c], default)
    # Flip back-facing normals toward the incoming ray.
    p = normal * in_dirn
    facing = (p[:, 0] + p[:, 1]) + p[:, 2]
    normal = torch.where((facing > 0.0)[:, None], -normal, normal)

    # Perpendicular construction (RayGenKernels.cu:152-161): default assumes
    # y largest; the z test comes first, then x.
    na = normal.abs()
    nm = na.amax(dim=1)
    zero = torch.zeros((r,), dtype=f32, device=dev)
    nx, ny, nz = normal.unbind(1)
    perp_y = torch.stack([ny, -nx, zero], dim=1)
    perp_z = torch.stack([zero, nz, -ny], dim=1)
    perp_x = torch.stack([-nz, zero, nx], dim=1)
    perp = torch.where((nm == na[:, 2])[:, None], perp_z,
                       torch.where((nm == na[:, 0])[:, None], perp_x, perp_y))
    perp = perp / torch.linalg.vector_norm(perp, dim=1, keepdim=True)
    biperp = torch.linalg.cross(normal, perp, dim=1)

    _, _, c = _hash_words(seed, task_offset, r, dev)
    # (2 pi * float(c)) * 2^-32, in the reference's order.
    angle = (TWO_PI * c.to(f32)) * INV_2_32
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    t0 = perp * ca + biperp * sa
    t1 = -perp * sa + biperp * ca

    # Samples: Halton base-2 (x) / base-3 (y) -> cosine hemisphere.
    i = torch.arange(num_samples, dtype=torch.int64, device=dev)
    hx = _halton2(i)  # [S]
    hy = _halton3(i)
    sangle = TWO_PI * hy
    sr = torch.sqrt(hx)
    x = sr * torch.cos(sangle)
    y = sr * torch.sin(sangle)
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))

    # [R,S,3] = x*t0 + y*t1 + z*normal
    d = (x[None, :, None] * t0[:, None, :]
         + y[None, :, None] * t1[:, None, :]
         + z[None, :, None] * normal[:, None, :])
    d = d / torch.linalg.vector_norm(d, dim=2, keepdim=True)

    out_tmax = torch.where(valid, torch.tensor(float(np.float32(max_dist)), dtype=f32, device=dev),
                           torch.tensor(-1.0, dtype=f32, device=dev))
    n_out = r * num_samples
    rays = Rays(
        origin=_expand(origin, num_samples),
        dirn=d.reshape(n_out, 3).contiguous(),
        tmin=torch.zeros((n_out,), dtype=f32, device=dev),
        tmax=out_tmax[:, None].expand(r, num_samples).reshape(n_out),
    )
    ids = torch.arange(n_out, dtype=torch.int32, device=dev)
    return rays, ids, ids


def gen_shadow_rays(
    in_origin: torch.Tensor,
    in_dirn: torch.Tensor,
    in_t: torch.Tensor,
    in_tri: torch.Tensor,
    num_samples: int,
    light_position,               # [3]
    light_radius: float,
    seed: int,
    task_offset: int = 0,
):
    """Area-light shadow rays (the reference's dormant rayGenShadowKernel,
    RayGenKernels.cu:231-293): Sobol 2D x Hammersley with a per-ray
    Cranley-Patterson random offset toward a spherical light."""
    dev = in_origin.device
    f32 = torch.float32
    r = in_origin.shape[0]
    origin = _backtrack(in_origin, in_dirn, in_t)
    valid = in_tri >= 0

    a, b, c = _hash_words(seed, task_offset, r, dev)
    offset = torch.stack([_u32_to_unit(a), _u32_to_unit(b), _u32_to_unit(c)], dim=1)

    # Sobol 2D (reference variant) + Hammersley, host-precomputed per sample.
    s = np.arange(num_samples)
    pos = np.concatenate([sobol2d(s), hammersley(s, num_samples)[:, None]], axis=1)
    pos = torch.as_tensor(pos.astype(np.float32), device=dev)  # [S,3]

    p = pos[None, :, :] + offset[:, None, :]  # [R,S,3]
    p = torch.where(p >= 1.0, p - 1.0, p)
    p = p * 2.0 - 1.0

    light = torch.as_tensor(np.asarray(light_position, np.float32), device=dev)
    target = light[None, None, :] + float(np.float32(light_radius)) * p
    d = target - origin[:, None, :]
    dist = torch.linalg.vector_norm(d, dim=2)
    dn = d / dist[..., None]

    n_out = r * num_samples
    tmax = torch.where(valid[:, None], dist, torch.tensor(-1.0, dtype=f32, device=dev))
    rays = Rays(
        origin=_expand(origin, num_samples),
        dirn=dn.reshape(n_out, 3).contiguous(),
        tmin=torch.zeros((n_out,), dtype=f32, device=dev),
        tmax=tmax.reshape(n_out).contiguous(),
    )
    ids = torch.arange(n_out, dtype=torch.int32, device=dev)
    return rays, ids, ids
