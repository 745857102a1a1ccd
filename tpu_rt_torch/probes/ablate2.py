"""Fixed-trip ablation of the binary traversal step on real tables.

Counterpart of ``tools/ablate2.py``, which timed ``tpu_rt``'s packet2 step
on a TPU v5e as its components were layered in.  The kernel is
``tpu_rt_torch/csrc/ablate2.cu``: a packet is the 32 rays of a warp
sharing one node cursor, and each warp holds ``K`` packets (a lane holds
one ray of each, in registers); what is per packet is held once per warp,
the stacks and queues in shared memory, and the table remainders divide by
invariant integers.  Levels (cumulative, see the source): 0 the loop, 1
the node record load, 2 the bounds held in registers, 3 the span math, 4
the votes and ordering bit, 5 the stack and queue, 6 the Woop row load, 7
``U`` Woop tests, 8 the hit writes, 9 the while loop.

The functions take any row-major [n, 16] node table and [m, 16] Woop row
table (on the card bunny's ``FlatBVH`` records and ``woop_rows``; the tests
pass ``pack_tables2``'s tables transposed to rows) and rays [N, 8] f32
(origin, direction, the accumulator's start, unused).  They return per ray
``acc + node`` [N] f32 and each packet's final node [N / tile] i32, as the
tool's kernel returns ``acc + node`` per lane.  The arithmetic is the
tool's: ``nd = node % n``, ``ti = (node * 7) % m``, rows ``ti + u`` wrapped
inside their aligned group of 128 rows, the Woop test with a true division
and the tool's accept rule, the ctx writes of level 8, and the loop of level
9 while any node of the group is below ``niter``; the stack, queue and ctx
start at zero.

The time per iteration is (t(5N) - t(N)) / 4N from CUDA events (median of
3), as ``tools/ablate2.py:210-216`` takes it.  ``ablate_plain`` computes
what the kernel computes in PyTorch ops (on the card its step replayed as
a CUDA graph), so ``run`` holds the output of every level's timed launch
at N against it, on every ray.  ``run`` also reports each level's
registers, resident blocks per SM and waves, as the card reports them
(``ProbeKernel.occupancy``).

Run on a card:  python -m tpu_rt_torch.probes.ablate2 [--rays N] [--niter N]
(prints what the tool prints and a JSON line; ``chip_smoke.py`` runs the
same ``run``).  On the CPU, ``ablate`` takes the plain version.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from tpu_rt_torch.probes import ProbeKernel, call_ms, iterate, same_bits, time_ms
from tpu_rt_torch.trace.common import woop_rows

LEVELS = tuple(range(10))
LEVEL_NAMES = ("empty loop", "node record load", "bounds in registers", "span math",
               "votes and ordering", "stack and queue", "Woop row load", "U Woop tests",
               "hit writes", "while loop")
FULL_LEVEL = 8                  # the full step's shape (the tool's :9)
K, U, NITER = 4, 3, 2000        # tools/ablate2.py defaults; the kernel's kK, kU
WARP = 32                       # rays of a packet on the card (the tool's TILE)
BLOCK = 128                     # threads per block of the kernel (kBlock)
GROUP = BLOCK * K               # rays of a block
SM_THREADS = 2048               # a Hopper SM's thread limit (full_card), not the kernel's
STACK_DEPTH = QUEUE_DEPTH = 64
ROLL = 128                      # the roll's aligned group of Woop rows
N_RAYS = 8192                   # the tool's K x TILE
REPEATS = 3
# f32 operations of one ray's full step (level 8): two span tests of 24 (6
# multiplies, 6 subtracts, 12 min / max), acc + c0min * 0 (2), the votes'
# compares (2), U Woop tests of 44 (Oz 6, Dz 5, the division, u 13, v 13,
# the accept rule 5, the select) and the hit write (compare, select).
STEP_OPS = 2 * 24 + 2 + 2 + U * 44 + 2
ROW_BYTES = 64                  # a node record or Woop row


class Ablate2Kernel(ProbeKernel):
    """Wrapper of ``ablate2.cu``: checks the arguments and launches a level
    (``ProbeKernel``: built at first use, launches counted per level)."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__("ablate2", LEVELS, [vp, ci, vp, ci, vp, ci, ci, vp, vp])

    def __call__(self, level: int, nodes: torch.Tensor, rows: torch.Tensor, rays: torch.Tensor,
                 niter: int):
        if level not in LEVELS:
            raise ValueError(f"{self.name}: level must be in 0..9, got {level}")
        for what, x, width in (("nodes", nodes, 16), ("rows", rows, 16), ("rays", rays, 8)):
            if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != width \
                    or x.shape[0] < 1 or not x.is_contiguous():
                raise ValueError(f"{self.name}: {what} must be contiguous f32 [>= 1, {width}], "
                                 f"got {x.dtype} {tuple(x.shape)}")
        if any(x.data_ptr() % 16 for x in (nodes, rows, rays)):
            raise ValueError(f"{self.name}: nodes, rows and rays must start on 16 bytes")
        n = rays.shape[0]
        if n % GROUP or not 0 <= niter <= (2**31 - 1) // 7 - K:
            raise ValueError(f"{self.name}: need rays in blocks of {GROUP} and 0 <= niter < "
                             f"2^31 / 7; got {n}, {niter}")
        dev = rays.device
        if dev.type != "cuda" or nodes.device != dev or rows.device != dev:
            raise ValueError(f"{self.name} needs CUDA tensors on one device, got {nodes.device}, "
                             f"{rows.device}, {dev}")
        out = torch.empty((n,), dtype=torch.float32, device=dev)
        node = torch.empty((n // WARP,), dtype=torch.int32, device=dev)
        self.launch(level, dev, nodes.data_ptr(), nodes.shape[0], rows.data_ptr(),
                    rows.shape[0], rays.data_ptr(), n, niter, out.data_ptr(), node.data_ptr())
        return out, node


KERNEL = Ablate2Kernel()


def ablate(level: int, nodes: torch.Tensor, rows: torch.Tensor, rays: torch.Tensor, niter: int):
    """Per ray ``acc + node`` [N] f32 and each packet's final node [N / 32]
    i32 after ``niter`` iterations of ``level`` (K packets of a warp, U
    Woop rows): the kernel for CUDA tensors, the plain version for CPU
    ones."""
    if rays.device.type == "cpu":
        return ablate_plain(level, nodes, rows, rays, niter)
    return KERNEL(level, nodes, rows, rays, niter)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _span(b, lo, ctx):
    """near, far [G, k, tile] of the child whose bounds are b[..., lo]
    (x lo, hi, y lo, hi at lo .. lo + 3, z lo, hi at 8 + lo / 2 ..): the
    tool's ``span`` (:75-90)."""
    idirx, idiry, idirz, oodx, oody, oodz = ctx
    hit_t = ctx[0]
    zlo = 8 + lo // 2

    def c(j):
        return b[..., j:j + 1]

    tx0 = c(lo) * idirx - oodx
    tx1 = c(lo + 1) * idirx - oodx
    ty0 = c(lo + 2) * idiry - oody
    ty1 = c(lo + 3) * idiry - oody
    tz0 = c(zlo) * idirz - oodz
    tz1 = c(zlo + 1) * idirz - oodz
    zero = torch.zeros_like(tx0)
    near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                         torch.maximum(torch.minimum(tz0, tz1), zero))
    far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                        torch.minimum(torch.maximum(tz0, tz1), hit_t))
    return near, far


def ablate_plain(level: int, nodes: torch.Tensor, rows: torch.Tensor, rays: torch.Tensor,
                 niter: int, k: int = K, u: int = U, tile: int = WARP):
    """What ``ablate2.cu`` computes (and ``tools/ablate2.py``'s
    ``make_kernel(level)`` per lane), in PyTorch ops on the device of
    ``rays``: groups of ``k`` packets of ``tile`` rays, packet p of a group
    owning rays tile p .. tile (p + 1) - 1, its node starting at p.  Returns
    ``ablate``'s (out [N] f32, node [N / tile] i32)."""
    if level not in LEVELS:
        raise ValueError(f"level must be in 0..9, got {level}")
    dev = rays.device
    n = rays.shape[0]
    if n % (k * tile):
        raise ValueError(f"need rays in groups of k x tile = {k * tile}, got {n}")
    nodes, rows = nodes.to(dev), rows.to(dev)
    nodes_i, rows_i = nodes.view(torch.int32), rows.view(torch.int32)
    n_nodes, n_rows = nodes.shape[0], rows.shape[0]
    ray = rays.view(n // (k * tile), k, tile, 8)
    o = [ray[..., j] for j in range(3)]
    d = [ray[..., j] for j in range(3, 6)]
    acc = ray[..., 6].clone()                                     # [G, k, tile]
    g = acc.shape[0]
    node = torch.arange(k, device=dev).expand(g, k).clone()       # [G, k] int64
    stack = torch.zeros((g, k, STACK_DEPTH), dtype=torch.int32, device=dev)
    queue = torch.zeros((g, k, QUEUE_DEPTH), dtype=torch.int32, device=dev)
    # ctx: idir x, y, z, ood x, y, z; level 8 writes hit t into the first
    # and the hit count's int32 bits into the second, the rest stay 0.
    zero = torch.zeros_like(acc)

    def step(state):
        acc, node, stack, queue, ctx0, ctx1 = state
        ctx = (ctx0, ctx1, zero, zero, zero, zero)
        nxt = node + 1
        if level >= 1:
            nd = node % n_nodes
            b, bi = nodes[nd], nodes_i[nd].long()                 # [G, k, 16]
            link0, link1 = bi[..., 12], bi[..., 13]
            nxt = nxt + link0 % 3 - link0 % 3
        if level >= 3:
            c0min, c0max = _span(b, 0, ctx)
            c1min, c1max = _span(b, 4, ctx)
            acc = acc + c0min[..., 0:1] * 0.0
        if level >= 4:
            any0 = (c0max >= c0min).any(-1)
            any1 = (c1max >= c1min).any(-1)
            enc = bi[..., 14]
            swap = ((enc >> 2) ^ enc) & 1
            nxt = torch.where(any0 & any1 & (swap != 0), nxt, nxt + 0)
        if level >= 5:
            sp = (node % (STACK_DEPTH - 1))[..., None]
            cur = stack.gather(-1, sp)[..., 0]
            stack = stack.scatter(-1, sp, torch.where(any0, link0.int(), cur)[..., None])
            popped = stack.gather(-1, (sp - 1).clamp(0, STACK_DEPTH - 1))[..., 0]
            qw = (node % QUEUE_DEPTH)[..., None]
            cur = queue.gather(-1, qw)[..., 0]
            queue = queue.scatter(-1, qw, torch.where(any1, link1.int(), cur)[..., None])
            qr = queue.gather(-1, ((node + 1) % QUEUE_DEPTH)[..., None])[..., 0]
            pq = popped + qr                                       # int32, wraps
            nxt = nxt + pq % 3 - pq % 3
        if level >= 6:
            ti = (node * 7) % n_rows
            tw = rows_i[ti, 12].long()
            nxt = nxt + tw % 3 - tw % 3
        if level >= 7:
            group = ti - ti % ROLL
            width = (n_rows - group).clamp(max=ROLL)
            hh = acc
            for uu in range(u):
                w = rows[group + (ti - group + uu) % width]         # [G, k, 16]

                def c(j):
                    return w[..., j:j + 1]

                oz_t = c(3) - o[0] * c(0) - o[1] * c(1) - o[2] * c(2)
                dz_t = d[0] * c(0) + d[1] * c(1) + d[2] * c(2)
                t = oz_t / dz_t
                uu_ = (c(7) + o[0] * c(4) + o[1] * c(5) + o[2] * c(6)) \
                    + t * (d[0] * c(4) + d[1] * c(5) + d[2] * c(6))
                vv = (c(11) + o[0] * c(8) + o[1] * c(9) + o[2] * c(10)) \
                    + t * (d[0] * c(8) + d[1] * c(9) + d[2] * c(10))
                ok = (t > 0.0) & (uu_ >= 0.0) & (vv >= 0.0) & (uu_ + vv <= 1.0)
                hh = torch.where(ok, t, hh)
            acc = hh
        if level >= 8:
            htri = ctx1.view(torch.int32)
            ok2 = acc > 0.5
            ctx0 = torch.where(ok2, acc, ctx0)
            ctx1 = torch.where(ok2, htri + 1, htri).view(torch.float32)
        return acc, nxt, stack, queue, ctx0, ctx1

    state = (acc, node, stack, queue, zero.clone(), zero.clone())
    if level >= 9:
        state = iterate(step, state, until=lambda s: (s[1] < niter).any())
    else:
        state = iterate(step, state, niter)
    acc, node = state[0], state[1]
    out = acc + node.to(torch.float32)[..., None]
    return out.reshape(n), node.reshape(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

def walk_rows(n_rows: int, k: int, iters: int, u: int = U) -> np.ndarray:
    """The Woop rows [k, iters, u] that packet p's cursor reaches in its
    first ``iters`` iterations: rows ti + u of ti = 7 node mod m, wrapped
    as the kernel wraps them (level 7)."""
    node = np.arange(k)[:, None] + np.arange(iters)[None, :]
    ti = (node * 7) % n_rows
    group = ti - ti % ROLL
    width = np.minimum(ROLL, n_rows - group)
    return group[..., None] + ((ti - group)[..., None] + np.arange(u)) % width[..., None]


def probe_rays(rows: np.ndarray, scene, n: int, seed: int, k: int = K, tile: int = WARP,
               aim_iters: int = 64, device="cuda") -> torch.Tensor:
    """Rays [n, 8] f32 (numpy, from ``seed``) for the ablation: each ray
    aims at a point of a triangle its packet tests in its first
    ``aim_iters`` iterations (Woop rows ``rows`` [m, 16] of ``scene``), with
    barycentrics in [-0.2, 1.2] so that about half hit, from 0.05-0.5 of
    the scene's diagonal away; rows whose Woop matrix is singular (padding)
    give a random ray.  Slot 6, the accumulator's start, is 1 (the tool's
    rays are ones), slot 7 is 0."""
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(np.asarray(hi) - np.asarray(lo)))
    rng = np.random.default_rng(seed)
    rows = np.asarray(rows, np.float32)
    packet = (np.arange(n) // tile) % k
    visits = walk_rows(rows.shape[0], k, aim_iters)
    pick = visits[packet, rng.integers(0, aim_iters, n), rng.integers(0, U, n)]
    w = rows[pick].astype(np.float64)
    a = np.stack((w[:, 0:3], w[:, 4:7], w[:, 8:11]), 1)           # z, u, v rows
    bu, bv = rng.uniform(-0.2, 1.2, (2, n))
    rhs = np.stack((w[:, 3], bu - w[:, 7], bv - w[:, 11]), 1)
    ok = np.abs(np.linalg.det(a)) > 1e-12
    target = rng.normal(size=(n, 3))
    target[ok] = np.linalg.solve(a[ok], rhs[ok][..., None])[..., 0]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    origin = target - d * rng.uniform(0.05, 0.5, (n, 1)) * size
    out = np.zeros((n, 8), np.float32)
    out[:, 0:3], out[:, 3:6], out[:, 6] = origin, d, 1.0
    return torch.tensor(out, device=device)


def full_card(device="cuda") -> int:
    """A full card's rays at a fixed size, so that times compare across
    versions of the kernel: SM_THREADS threads (an SM's thread limit) on
    each SM, each holding K rays; 1,081,344 on 132 SMs.  The kernel keeps
    fewer threads on an SM than that (``KERNEL.occupancy``), so they run in
    ``waves``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * SM_THREADS * K


def waves(n_rays: int, occupancy: dict) -> float:
    """The launch's blocks over the card's resident blocks (``occupancy``:
    ``ProbeKernel.occupancy``)."""
    return n_rays / GROUP / (occupancy["blocks_per_sm"] * occupancy["sms"])


def run(flat, scene, device="cuda", n_rays: int | None = None, niter: int | None = None) -> dict:
    """Time every level at ``niter`` and 5 ``niter`` iterations (default
    NITER) on ``n_rays`` probe rays (default N_RAYS) over the node records
    and Woop rows of ``flat`` (``scene``'s BVH); then hold the output of
    each level's timed launch at ``niter`` against its plain version on the
    same rays, timing the plain version too.  Returns per level the ns per
    iteration of both, the kernel's step over the level below, the times,
    the check, and the level's ``occupancy`` and ``waves``; ``launches``
    are those of the timed runs."""
    n_rays = N_RAYS if n_rays is None else n_rays
    niter = NITER if niter is None else niter
    dev = torch.device(device)
    nodes = torch.tensor(np.ascontiguousarray(flat.nodes, np.float32), device=dev)
    rows_np = woop_rows(flat.tri_woop, flat.tri_index)
    rows = torch.tensor(rows_np, device=dev)
    rays = probe_rays(rows_np, scene, n_rays, 0, device=dev)
    KERNEL.reset_counts()
    res, outs, prev = {}, {}, 0.0
    for level in LEVELS:
        lo = []
        t_lo = time_ms(lambda: lo.append(ablate(level, nodes, rows, rays, niter)), REPEATS)
        t_hi = time_ms(lambda: ablate(level, nodes, rows, rays, 5 * niter), REPEATS)
        outs[level] = lo[-1]
        ns = (t_hi - t_lo) / (4 * niter) * 1e6
        res[level] = {"name": LEVEL_NAMES[level], "ns_per_iter": ns, "delta_ns": ns - prev,
                      "ms_lo": t_lo, "ms_hi": t_hi}
        occ = KERNEL.occupancy(level, dev)
        res[level].update({"occupancy": occ, "waves": waves(n_rays, occ)})
        prev = ns
    launches = dict(KERNEL.launches_by_form)
    for level in LEVELS:
        got, got_node = outs.pop(level)
        (want, want_node), plain_ms = call_ms(lambda: ablate_plain(level, nodes, rows, rays, niter))
        res[level].update({
            "plain_ns_per_iter": plain_ms / niter * 1e6,
            "check_rays": n_rays, "check_iters": niter,
            "bits_differ": int((~same_bits(got, want)).sum()),
            "max_abs_err": float(torch.nan_to_num(got - want).abs().max()),
            "node_differ": int((got_node != want_node).sum()),
        })
    return {"levels": res, "launches": launches, "n_rays": n_rays, "niter": niter, "k": K,
            "u": U, "tile": WARP, "n_nodes": nodes.shape[0], "n_rows": rows.shape[0]}


def check(res: dict) -> list[int]:
    """The levels whose output differs from the plain version's: every
    bit of acc + node (NaN as NaN) and every packet's node."""
    return [lv for lv, r in res["levels"].items() if r["bits_differ"] or r["node_differ"]]


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=N_RAYS, help="rays of a timed launch; 0: a "
                    "full card")
    ap.add_argument("--niter", type=int, default=NITER, help="the smaller trip count, N")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate2: no CUDA device (torch.cuda.is_available() is False)")
    from tpu_rt_torch.bvh import load_or_build_bvh
    from tpu_rt_torch.scene import Scene, procedural

    scene = Scene(procedural.scene_by_name("bunny"))
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    res = run(flat, scene, n_rays=args.rays or full_card(), niter=args.niter)
    print(f"ablate2 on {torch.cuda.get_device_name(0)}: {res['n_rays']} rays, "
          f"{res['n_nodes']} node records, {res['n_rows']} Woop rows")
    for level, r in res["levels"].items():
        occ = r["occupancy"]
        print(f"level {level}: {r['ns_per_iter']:9.1f} ns/iter  (+{r['delta_ns']:7.1f})  "
              f"{r['name']}; {occ['registers']} registers, {occ['blocks_per_sm']} blocks per "
              f"SM, {r['waves']:.2f} waves; plain {r['plain_ns_per_iter']:.1f} ns/iter; vs "
              f"plain on {r['check_rays']} rays x {r['check_iters']}: bits differ "
              f"{r['bits_differ']}, nodes differ {r['node_differ']}")
    print(f"\nconfig tile={res['tile']} K={res['k']} U={res['u']} niter={res['niter']}")
    print(json.dumps(res))
    bad = check(res)
    if bad:
        sys.exit(f"ablate2: levels differ from their plain versions: {bad}")


if __name__ == "__main__":
    main()
