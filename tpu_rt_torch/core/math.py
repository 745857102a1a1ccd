"""Host (numpy) math + hashing utilities.

Counterpart of the numpy paths of ``tpu_rt.core.math``, bit-for-bit:

- Jenkins mix / hashBits      (reference src/framework/base/Hash.hh:195-200)
- Halton 2 / 3                (RayGenKernels.cu:190-215; the device raygen has
                              its own)
- Sobol 2D + Hammersley       (RayGenKernels.cu:49-75, the shadow path)
- ABGR8 color pack / unpack   (src/framework/base/Math.cc:34-52)
- float<->bits                (Math.hh floatToBits/bitsToFloat)
- 192-bit ray Morton keys     (RayBufferKernels.cu:66-179), the host oracle
                              of the device sort (rays/buffer.py)
- the Morton pixel swizzle    (src/rt/ray/PixelTable.cc:70-161)
"""

from __future__ import annotations

import numpy as np

GOLDEN = np.uint32(0x9E3779B9)


# ---------------------------------------------------------------------------
# float <-> bits
# ---------------------------------------------------------------------------

def float_to_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def bits_to_float(b) -> np.ndarray:
    return np.asarray(b, np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# Jenkins hashing
# ---------------------------------------------------------------------------

def jenkins_mix(a, b, c):
    """The 96-bit Jenkins mixer. Inputs/outputs are uint32 arrays."""
    u32 = lambda x: np.asarray(x).astype(np.uint32)
    a, b, c = u32(a), u32(b), u32(c)
    with np.errstate(over="ignore"):
        a = u32(a - b); a = u32(a - c); a = a ^ (c >> 13)
        b = u32(b - c); b = u32(b - a); b = b ^ (a << 8)
        c = u32(c - a); c = u32(c - b); c = c ^ (b >> 13)
        a = u32(a - b); a = u32(a - c); a = a ^ (c >> 12)
        b = u32(b - c); b = u32(b - a); b = b ^ (a << 16)
        c = u32(c - a); c = u32(c - b); c = c ^ (b >> 5)
        a = u32(a - b); a = u32(a - c); a = a ^ (c >> 3)
        b = u32(b - c); b = u32(b - a); b = b ^ (a << 10)
        c = u32(c - a); c = u32(c - b); c = c ^ (b >> 15)
    return a, b, c


def hash_bits(*vals) -> int:
    """Combine uint32 values into one hash, Jenkins style (host scalar).

    Used for BVH cache keys, mirroring the discipline of the reference's
    hashBits (src/framework/base/Hash.hh:195-196).
    """
    h = np.uint32(len(vals))
    a = b = GOLDEN
    vs = [np.uint32(v & 0xFFFFFFFF) for v in vals]
    # Mix three at a time like the reference's overloads do.
    i = 0
    with np.errstate(over="ignore"):
        while i < len(vs):
            chunk = vs[i : i + 3] + [np.uint32(0)] * max(0, 3 - len(vs[i:]))
            a = np.uint32(a + chunk[0])
            b = np.uint32(b + chunk[1])
            h = np.uint32(h + chunk[2])
            a, b, h = jenkins_mix(a, b, h)
            a, b, h = np.uint32(a), np.uint32(b), np.uint32(h)
            i += 3
    return int(h)


def hash_buffer(arr) -> int:
    """Hash raw array contents (host).  Cache-key building block."""
    data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    # Pad to a multiple of 4 bytes, fold as uint32 stream.
    pad = (-data.size) % 4
    if pad:
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
    words = data.view(np.uint32)
    with np.errstate(over="ignore"):
        # Tree-reduce with position-dependent mixing for order sensitivity.
        idx = np.arange(words.size, dtype=np.uint32)
        a, b, c = jenkins_mix(words, idx, np.full(words.size, GOLDEN, np.uint32))
        h = np.uint32(words.size)
        for part in (a, b, c):
            h = np.uint32(h * np.uint32(16777619) + np.uint32(part.sum(dtype=np.uint64) & 0xFFFFFFFF))
    return int(h)


# ---------------------------------------------------------------------------
# Low-discrepancy points (host; the shadow generator uploads Sobol's)
# ---------------------------------------------------------------------------

def halton2(i):
    """Base-2 radical inverse of i+1 (matches RayGenKernels.cu:190-205 which
    feeds sample index i as i+1), in float64; exact for any uint32 index.
    ``tpu_rt``'s ``halton2(i, xp=np)``; the device raygen has its own."""
    i = np.asarray(i, np.uint32) + 1
    # Bit-reverse the 32-bit word, then scale by 2^-32.
    v = i
    v = ((v >> 1) & np.uint32(0x55555555)) | ((v & np.uint32(0x55555555)) << 1)
    v = ((v >> 2) & np.uint32(0x33333333)) | ((v & np.uint32(0x33333333)) << 2)
    v = ((v >> 4) & np.uint32(0x0F0F0F0F)) | ((v & np.uint32(0x0F0F0F0F)) << 4)
    v = ((v >> 8) & np.uint32(0x00FF00FF)) | ((v & np.uint32(0x00FF00FF)) << 8)
    v = (v >> 16) | (v << 16)
    return v.astype(np.float64) * (2.0 ** -32)


def halton3(i, iters: int = 21):
    """Base-3 radical inverse of i+1 (RayGenKernels.cu:207-215), in f32.

    3^21 > 2^32 so 21 digit iterations cover any uint32 index.
    ``tpu_rt``'s ``halton3(i, xp=np)``."""
    hc = np.asarray(i, np.uint32) + 1
    y = np.zeros(hc.shape, np.float32)
    yadd = np.ones(hc.shape, np.float32)
    third = np.float32(1.0 / 3.0)
    for _ in range(iters):
        yadd = yadd * third
        y = y + (hc % 3).astype(np.float32) * yadd
        hc = hc // 3
    return y


def sobol2d(i):
    """First two Sobol dimensions of index i (RayGenKernels.cu:54-75)."""
    i = np.asarray(i, np.uint64)
    scalar = i.ndim == 0
    i = np.atleast_1d(i)
    r1 = np.zeros(i.shape, np.uint32)
    r2 = np.zeros(i.shape, np.uint32)
    v1 = np.full(i.shape, np.uint32(1) << 31, np.uint32)
    v2 = np.full(i.shape, np.uint32(3) << 30, np.uint32)
    rem = i.copy()
    with np.errstate(over="ignore"):
        for _ in range(32):
            take = (rem & 1).astype(bool)
            r1 = np.where(take, r1 ^ v1, r1)
            r2 = np.where(take, r2 ^ (v2 << 1), r2)
            v1 = v1 | (v1 >> 1)
            v2 = v2 ^ (v2 >> 1)
            rem >>= 1
    out = np.stack([r1 * (1.0 / 2**32), r2 * (1.0 / 2**32)], axis=-1).astype(np.float32)
    return out[0] if scalar else out


def hammersley(i, num):
    return (np.asarray(i, np.float32) + 0.5) / np.float32(num)


# ---------------------------------------------------------------------------
# ABGR8 colors — bit-exact with Vec4f::toABGR (Math.cc:45-52)
# ---------------------------------------------------------------------------

def to_abgr(rgba: np.ndarray) -> np.ndarray:
    """Pack [...,4] float RGBA into uint32 ABGR with the reference's exact
    fixed-point rounding: channel = ((floor(clamp(c)*2^56)*255 >> 55)+1)>>1."""
    c = np.clip(np.asarray(rgba, np.float64), 0.0, 1.0)
    fixed = (c * np.float64(2.0**56)).astype(np.uint64)
    with np.errstate(over="ignore"):
        ch = ((((fixed * np.uint64(255)) >> np.uint64(55)) + np.uint64(1)) >> np.uint64(1)).astype(np.uint32)
    return (ch[..., 0] | (ch[..., 1] << 8) | (ch[..., 2] << 16) | (ch[..., 3] << 24)).astype(np.uint32)


def from_abgr(abgr):
    """Unpack uint32 ABGR into [...,4] f32 RGBA (Math.cc:34-42)."""
    a = np.asarray(abgr).astype(np.uint32)
    s = np.float32(1.0 / 255.0)
    return np.stack(
        [
            (a & 0xFF).astype(np.float32) * s,
            ((a >> 8) & 0xFF).astype(np.float32) * s,
            ((a >> 16) & 0xFF).astype(np.float32) * s,
            (a >> 24).astype(np.float32) * s,
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# 192-bit ray Morton keys (coherence sort)
# ---------------------------------------------------------------------------

def ray_morton_keys(origin: np.ndarray, dirn: np.ndarray, aabb_lo, aabb_hi) -> np.ndarray:
    """Per-ray 192-bit Morton keys as [N, 6] uint32, matching the stride-6
    interleave of genMortonKeysKernel (RayBufferKernels.cu:66-179):

    6 quantized streams — origin xyz at 24 bits (scaled into the batch AABB),
    direction xyz at 21 bits (normalized to [0,1]) — bit j of stream d lands
    at global bit position j*6 + d of the 192-bit key.

    Keys compare most-significant-word-last (hash[5] down to hash[0],
    reference RayBuffer.cc:237-249); sort with np.lexsort(keys.T).
    """
    origin = np.asarray(origin, np.float32)
    dirn = np.asarray(dirn, np.float32)
    lo = np.asarray(aabb_lo, np.float32)
    hi = np.asarray(aabb_hi, np.float32)
    extent = np.where(hi - lo > 0, hi - lo, 1.0)
    a = (origin - lo) / extent
    n = dirn / np.maximum(np.linalg.norm(dirn, axis=-1, keepdims=True), 1e-30)
    b = (n + 1.0) * 0.5

    streams = np.empty((origin.shape[0], 6), np.uint32)
    with np.errstate(over="ignore", invalid="ignore"):
        streams[:, 0] = (a[:, 0].astype(np.float64) * 256.0 * 65536.0).astype(np.int64).astype(np.uint32)
        streams[:, 1] = (a[:, 1].astype(np.float64) * 256.0 * 65536.0).astype(np.int64).astype(np.uint32)
        streams[:, 2] = (a[:, 2].astype(np.float64) * 256.0 * 65536.0).astype(np.int64).astype(np.uint32)
        streams[:, 3] = (b[:, 0].astype(np.float64) * 32.0 * 65536.0).astype(np.int64).astype(np.uint32)
        streams[:, 4] = (b[:, 1].astype(np.float64) * 32.0 * 65536.0).astype(np.int64).astype(np.uint32)
        streams[:, 5] = (b[:, 2].astype(np.float64) * 32.0 * 65536.0).astype(np.int64).astype(np.uint32)

    keys = np.zeros((origin.shape[0], 6), np.uint32)
    for d in range(6):
        v = streams[:, d]
        for i in range(32):
            pos = d + i * 6
            if pos >= 192:
                break
            word, bit = pos >> 5, pos & 31
            keys[:, word] |= ((v >> np.uint32(i)) & np.uint32(1)) << np.uint32(bit)
    return keys


def morton_sort_order(origin: np.ndarray, dirn: np.ndarray) -> np.ndarray:
    """Permutation that sorts rays by their 192-bit Morton key (host)."""
    lo = origin.min(axis=0)
    hi = origin.max(axis=0)
    keys = ray_morton_keys(origin, dirn, lo, hi)
    # np.lexsort sorts by the LAST key first; reference compares hash[5]
    # first, so feed columns in order 0..5.
    return np.lexsort(tuple(keys[:, i] for i in range(6)))


# ---------------------------------------------------------------------------
# Pixel-space Morton swizzle (PixelTable equivalent)
# ---------------------------------------------------------------------------

def pixel_morton_luts(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """index->pixel and pixel->index LUTs with the reference's exact layout
    (src/rt/ray/PixelTable.cc:70-161): the image's 8x8-aligned bulk is split
    into 8x8 blocks visited in Morton order, pixels bit-swizzled within each
    block; the leftover bottom stripe then right stripe appended row-major.
    """
    n = width * height
    index_to_pixel = np.empty(n, np.int32)
    pixel_to_index = np.empty(n, np.int32)

    bw, bh = width & ~7, height & ~7
    w8, h8 = bw >> 3, bh >> 3
    idx = 0

    if w8 > 0 and h8 > 0:
        maxdim = max(w8, h8)
        maxdim_p2 = 1 << int(np.ceil(np.log2(maxdim))) if maxdim > 1 else 1
        count = maxdim_p2 * maxdim_p2
        i = np.arange(count, dtype=np.uint64)
        # De-interleave block Morton index into (tx, ty).
        def compact(v):
            v = v & np.uint64(0x5555555555555555)
            v = (v | (v >> np.uint64(1))) & np.uint64(0x3333333333333333)
            v = (v | (v >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
            v = (v | (v >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
            v = (v | (v >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
            v = (v | (v >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
            return v.astype(np.int64)

        tx = compact(i)
        ty = compact(i >> np.uint64(1))
        keep = (tx < w8) & (ty < h8)
        tx, ty = tx[keep], ty[keep]

        inner = np.arange(64)
        ix = ((inner & 1) >> 0) | ((inner & 4) >> 1) | ((inner & 16) >> 2)
        iy = ((inner & 2) >> 1) | ((inner & 8) >> 2) | ((inner & 32) >> 3)

        px = (tx[:, None] * 8 + ix[None, :]).ravel()
        py = (ty[:, None] * 8 + iy[None, :]).ravel()
        pos = (py * width + px).astype(np.int32)
        m = pos.size
        index_to_pixel[:m] = pos
        pixel_to_index[pos] = np.arange(m, dtype=np.int32)
        idx = m

    # Bottom stripe: px in [0,bw), py in [bh,height), column-major per ref.
    if bh < height and bw > 0:
        px, py = np.meshgrid(np.arange(bw), np.arange(bh, height), indexing="ij")
        pos = (py.ravel() * width + px.ravel()).astype(np.int32)
        index_to_pixel[idx : idx + pos.size] = pos
        pixel_to_index[pos] = np.arange(idx, idx + pos.size, dtype=np.int32)
        idx += pos.size

    # Right stripe + corner: py in [0,height), px in [bw,width), row-major.
    if bw < width:
        py, px = np.meshgrid(np.arange(height), np.arange(bw, width), indexing="ij")
        pos = (py.ravel() * width + px.ravel()).astype(np.int32)
        index_to_pixel[idx : idx + pos.size] = pos
        pixel_to_index[pos] = np.arange(idx, idx + pos.size, dtype=np.int32)
        idx += pos.size

    if idx != n:
        raise AssertionError((idx, n))
    return index_to_pixel, pixel_to_index


def normalize(v, axis=-1):
    n = np.sqrt(np.sum(v * v, axis=axis, keepdims=True))
    return v / n
