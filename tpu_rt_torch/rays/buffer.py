"""RayBuffer: a ray batch + its ID<->slot permutation, with device-side
Morton coherence sorting.

Counterpart of ``tpu_rt.rays.buffer`` (the reference's RayBuffer,
src/rt/ray/RayBuffer.hh:37-97; mortonSort, RayBuffer.cc:256-324): keys,
sorts and permutations run as torch ops on the rays' device, and every
permutation equals ``tpu_rt``'s on the same rays, the order of equal keys
included.

Two things keep the keys equal to ``tpu_rt``'s:

- ``tpu_rt`` runs without 64-bit types, so its ``astype(int64)`` is an XLA
  f32 -> int32 conversion: truncation toward zero, saturation at the int32
  range and NaN -> 0.  torch leaves out-of-range conversions to the
  hardware, so ``_int32_word`` clamps and maps NaN in float64 first (rows
  of a non-finite origin or direction reach it).
- The direction norm is ``torch.linalg.vector_norm``, which equals
  ``jnp.linalg.norm`` bit for bit on the CPU; ``sqrt(sum(d * d))`` does not.

Key words are uint32 values held in int64 (torch's uint32 lacks shifts and
bitwise ops on some backends).  ``jax.lax.sort(num_keys=k, is_stable=True)``
has no single torch call: ``_stable_lex_order`` runs one stable
``torch.sort`` per key word, least significant first, which gives the same
permutation.
"""

from __future__ import annotations

import torch

from tpu_rt_torch.core.types import Hits, Rays

# The live prefix is traced in multiples of this many rays (tpu_rt's
# kernel tile); the Renderer's rays_traced / rays_skipped follow it.
LIVE_PAD = 2048


def _batch_box(origin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Lower corner and extent (1 on a flat axis) of the finite origins."""
    valid = torch.isfinite(origin).all(dim=1, keepdim=True)
    lo = torch.where(valid, origin, torch.inf).amin(dim=0)
    hi = torch.where(valid, origin, -torch.inf).amax(dim=0)
    extent = torch.where(hi - lo > 0, hi - lo, torch.ones_like(lo))
    return lo, extent


def _int32_word(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 -> int32 conversion (truncate, saturate, NaN -> 0), then
    the int32's two's-complement word as a uint32, held in int64."""
    x = x.double().clamp(-2.0**31, 2.0**31 - 1)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return x.long() & 0xFFFFFFFF


def _interleave(streams: torch.Tensor, bits: int) -> torch.Tensor:
    """Key bit p = d + S i holds bit i of stream d (S = streams.shape[1]),
    for p < S * bits; returns the key's 32-bit words [N, ceil(S bits / 32)]
    as int64, word 0 least significant."""
    s = streams.shape[1]
    dev = streams.device
    p = torch.arange(s * bits, device=dev)
    n_words = -(-p.numel() // 32)
    out = []
    for w in range(n_words):
        pw = p[32 * w:32 * (w + 1)]
        bit = (streams[:, pw % s] >> (pw // s)) & 1
        out.append((bit << (pw - 32 * w)).sum(dim=1))
    return torch.stack(out, dim=1)


def ray_morton_keys_device(origin: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """[N, 6] Morton keys, one 32-bit word per int64 column, the stride-6
    interleave of genMortonKeysKernel (RayBufferKernels.cu:66-179): origin
    xyz quantized to 24 bits within the batch AABB of the finite origins,
    normalized direction xyz to 21 bits; bit j of stream d -> key bit
    j*6+d.  Word 5 is most significant."""
    if origin.shape[0] == 0:
        return torch.zeros((0, 6), dtype=torch.int64, device=origin.device)
    lo, extent = _batch_box(origin)
    a = (origin - lo) / extent
    n = dirn / torch.linalg.vector_norm(dirn, dim=1, keepdim=True).clamp_min(1e-30)
    b = (n + 1.0) * 0.5
    streams = _int32_word(torch.cat([a * 16777216.0, b * 2097152.0], dim=1))
    return _interleave(streams, 32)


def _stable_lex_order(keys: list[torch.Tensor]) -> torch.Tensor:
    """The permutation that sorts rows by ``keys`` (most significant first,
    each [N] int64, compared as integers), equal keys in index order: one
    stable sort per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def morton_sort_device(origin: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) sorting rays by 192-bit Morton key on their
    device.  Key words compare most-significant-first = hash[5]..hash[0]
    (reference compareMortonKey, RayBuffer.cc:237-249)."""
    keys = ray_morton_keys_device(origin, dirn)
    return _stable_lex_order([keys[:, 5 - k] for k in range(6)])


def morton_keys_coarse_device(origin: torch.Tensor) -> torch.Tensor:
    """[N] 30-bit origin Morton keys (int64): 10 bits per axis within the
    batch AABB of the finite origins, bit i of axis d -> key bit 3i+d."""
    if origin.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int64, device=origin.device)
    lo, extent = _batch_box(origin)
    q = (origin - lo) / extent * 1023.0
    # tpu_rt: .astype(int32).clip(0, 1023), NaN -> 0.
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q).clamp(0.0, 1023.0).long()
    return _interleave(q, 10)[:, 0]


def morton_sort_device_coarse(origin: torch.Tensor, dirn: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rays by a 30-bit origin Morton key — one sort key
    instead of six (``tpu_rt``'s reason: a packet's shared cursor sees only
    coarse grouping).  ``dirn`` is accepted for signature parity and
    unused."""
    return _stable_lex_order([morton_keys_coarse_device(origin)])


def sort_dead_last_device(rays: Rays) -> torch.Tensor:
    """Morton permutation with the degenerate flag (tmax < 0) as the most
    significant key: live rays first in Morton order, dead rays last (pair
    with ``trace_live_prefix``; the reference's dynamic ray fetch,
    kepler_dynamic_fetch.cu:48,398-401, done as compaction)."""
    keys = ray_morton_keys_device(rays.origin, rays.dirn)
    dead = (rays.tmax < 0).long()
    return _stable_lex_order([dead] + [keys[:, 5 - k] for k in range(6)])


def permute_rays(rays: Rays, order: torch.Tensor) -> Rays:
    return Rays(*(x[order] for x in rays))


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """int32 ``inv`` with ``inv[order[i]] = i``: a scatter of arange."""
    inv = torch.empty(order.shape, dtype=torch.int32, device=order.device)
    inv[order] = torch.arange(order.shape[0], dtype=torch.int32, device=order.device)
    return inv


def trace_live_prefix(trace_fn, rays: Rays, live: int, pad_to: int = LIVE_PAD) -> Hits:
    """Trace only the first ceil(live/pad_to)*pad_to rays of a
    dead-last-sorted batch; the dead suffix gets misses (tri = -1, t =
    tmax), exactly what the tracers return for tmax < 0 rays.

    trace_fn: rays -> Hits.  live: number of tmax >= 0 rays (a host int —
    the frame path knows it: primary hits x samples)."""
    n = rays.num
    m = min(n, -(-max(int(live), 0) // pad_to) * pad_to)
    if m >= n:
        return trace_fn(rays)
    h = trace_fn(Rays(*(x[:m] for x in rays)))
    fill = n - m
    dev = rays.origin.device
    zeros = torch.zeros((fill,), dtype=torch.float32, device=dev)
    return Hits(
        tri=torch.cat([h.tri, torch.full((fill,), -1, dtype=torch.int32, device=dev)]),
        t=torch.cat([h.t, rays.tmax[m:]]),
        u=torch.cat([h.u, zeros]),
        v=torch.cat([h.v, zeros]),
    )


class RayBuffer:
    """Handle bundling rays, results, and the ID<->slot maps (int32 tensors
    on the rays' device)."""

    def __init__(self, rays: Rays, slot_to_id=None, id_to_slot=None,
                 need_closest_hit: bool = True):
        dev = rays.origin.device
        ident = torch.arange(rays.num, dtype=torch.int32, device=dev)

        def as_map(x):
            return ident if x is None else torch.as_tensor(x, dtype=torch.int32, device=dev)

        self.rays = rays
        self.slot_to_id = as_map(slot_to_id)
        self.id_to_slot = as_map(id_to_slot)
        self.need_closest_hit = need_closest_hit
        self.hits: Hits | None = None

    @property
    def size(self) -> int:
        return self.rays.num

    def get_ray_for_id(self, ray_id: int):
        slot = int(self.id_to_slot[ray_id])
        r = self.rays
        return (r.origin[slot].cpu().numpy(), r.dirn[slot].cpu().numpy(),
                float(r.tmin[slot]), float(r.tmax[slot]))

    def get_result_for_id(self, ray_id: int):
        if self.hits is None:
            raise RuntimeError("no results: trace the buffer first")
        slot = int(self.id_to_slot[ray_id])
        return int(self.hits.tri[slot]), float(self.hits.t[slot])

    def morton_sort(self) -> None:
        """Reorder rays by Morton key, updating both permutation maps
        (reference semantics RayBuffer.cc:256-324)."""
        order = morton_sort_device(self.rays.origin, self.rays.dirn)
        self.rays = permute_rays(self.rays, order)
        self.slot_to_id = self.slot_to_id[order]
        self.id_to_slot = inverse_permutation(order)[self.id_to_slot.long()]
        self.hits = None  # results are slot-addressed; invalidated by reorder
