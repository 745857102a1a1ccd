"""Fixed-trip ablation of the tensor-core leaf test on real Woop rows.

Counterpart of ``tools/mxu_ablate.py``, which timed ``tpu_rt``'s MXU
triangle unit piece by piece on a TPU v5e and found it slower than the
vector drain (``tpu_rt/trace/packet2.py:78-87``).  The kernel is
``tpu_rt_torch/csrc/mxu_ablate.cu``: every thread holds a ray, and each
iteration tests 8 Woop rows of bunny's SBVH against the warp's rays as a
fresh closest-hit query.  Variants (see the source): ``scalar`` (the
scalar kernels' f32 drain), ``full`` (the MXU form's leaf phase), ``noL``
(L from shared memory, built once), ``noM`` (no tensor-core products),
``epi0`` (the products summed, no epilogue).  ``tpu_rt``'s ``noT`` and
``noR`` time TPU relayouts that have no counterpart on the card.

The time per iteration is (t(hi) - t(lo)) / (hi - lo) over two trip counts,
as ``tools/mxu_ablate.py:211-217`` takes it, from CUDA events.  Each
variant returns deterministic per-ray accumulators (the sum of the winners'
t, and of tri + 1), which ``ablate_plain`` computes in PyTorch ops, so
``run`` checks every variant against it at a small trip count.

Run on a card:  python -m tpu_rt_torch.probes.mxu_ablate [--rays N]
[--hi H] [--lo L] (prints one line per variant and a JSON line;
``chip_smoke.py`` runs the same ``run``).  On the CPU, ``ablate`` takes the
plain version.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import numpy as np
import torch

from tpu_rt_torch.core.types import Rays, make_rays
from tpu_rt_torch.probes import ProbeKernel, time_ms
from tpu_rt_torch.trace.common import (
    MXU_LEAF,
    LeafBest,
    TraceState,
    drain_mxu_plain,
    drain_plain,
    woop_rows,
)

VARIANTS = ("scalar", "full", "noL", "noM", "epi0")
BLOCK = 128                      # threads per block of the kernel (kBlock)
N_RAYS = 1 << 18                 # rays of a timed launch: 2,048 blocks
NITER_HI, NITER_LO = 4000, 1000  # tools/mxu_ablate.py: NITER and NITER // 4
PLAIN_HI, PLAIN_LO = 4, 2         # trip counts of the plain version's timing
CHECK_RAYS, CHECK_ITERS = 512, 3
REPEATS = 3


class MxuAblateKernel(ProbeKernel):
    """Wrapper of ``mxu_ablate.cu``: checks the arguments and launches a
    variant (``ProbeKernel``: built at first use, launches counted per
    variant)."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__("mxu_ablate", VARIANTS, [vp, ci, vp, vp, vp, vp, ci, ci, vp, vp])

    def __call__(self, variant: str, woop: torch.Tensor, rays: Rays, niter: int):
        dev = rays.origin.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got {dev}")
        n, r = rays.num, woop.shape[0]
        if n % BLOCK or r < MXU_LEAF or niter < 0:
            raise ValueError(f"{self.name}: need rays in blocks of {BLOCK}, >= {MXU_LEAF} Woop "
                             f"rows and niter >= 0; got {n}, {r}, {niter}")
        for x, shape in ((woop, (r, 16)), (rays.origin, (n, 3)), (rays.dirn, (n, 3)),
                         (rays.tmin, (n,)), (rays.tmax, (n,))):
            if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape \
                    or not x.is_contiguous():
                raise ValueError(f"{self.name}: need contiguous f32 {shape} on {dev}")
        acc_t = torch.empty((n,), dtype=torch.float32, device=dev)
        acc_tri = torch.empty((n,), dtype=torch.int32, device=dev)
        self.launch(variant, dev, woop.data_ptr(), r, rays.origin.data_ptr(),
                    rays.dirn.data_ptr(), rays.tmin.data_ptr(), rays.tmax.data_ptr(), n, niter,
                    acc_t.data_ptr(), acc_tri.data_ptr())
        return acc_t, acc_tri


KERNEL = MxuAblateKernel()


def ablate(variant: str, woop: torch.Tensor, rays: Rays, niter: int):
    """Per-ray accumulators (sum of the winners' t [n] f32, sum of tri + 1
    [n] i32) of ``niter`` iterations of ``variant``: the kernel for CUDA
    tensors, the plain version for CPU ones."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if rays.origin.device.type == "cpu":
        return ablate_plain(variant, woop, rays, niter)
    return KERNEL(variant, woop, rays, niter)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _leaf_a(w: torch.Tensor) -> torch.Tensor:
    """A elements [..., 6, 4] (f64) of Woop rows w [..., 16]: the rows of
    Oz, Dz, Ox, Dx, Oy, Dy (mxu_leaf.cuh ``leaf_a``)."""
    w = w.double()
    wz, wx, wy = w[..., 0:4], w[..., 4:8], w[..., 8:12]
    side = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=torch.float64, device=w.device)
    oz = torch.cat((-wz[..., :3], wz[..., 3:]), -1)
    return torch.stack((oz, wz * side, wx, wx * side, wy, wy * side), -2)


def _ray_b(rays: Rays) -> torch.Tensor:
    """B columns [n, 2, 4] (f64) of each ray: [o, 1] and [d, 0]."""
    o, d = rays.origin.double(), rays.dirn.double()
    return torch.stack((torch.cat((o, torch.ones_like(o[:, :1])), 1),
                        torch.cat((d, torch.zeros_like(d[:, :1])), 1)), 1)


def ablate_plain(variant: str, woop: torch.Tensor, rays: Rays, niter: int):
    """What ``mxu_ablate.cu`` computes, in PyTorch ops on the device of
    ``rays`` (n a multiple of 32): the per-ray accumulators of ``ablate``.
    ``noM`` and ``epi0`` read the mma fragments lane by lane (lane l holds
    A[l >> 2][l & 3], B[l & 3][l >> 2] and D[l >> 2][2 (l & 3) + i])."""
    dev = rays.origin.device
    n = rays.num
    woop = woop.to(dev)
    woop_i = woop.view(torch.int32)
    ray = torch.arange(n, device=dev)
    warp, lane = ray // 32, ray % 32
    span = woop.shape[0] - MXU_LEAF + 1
    m8 = torch.arange(MXU_LEAF, device=dev)
    count = torch.full((n,), MXU_LEAF, dtype=torch.int64, device=dev)
    b = _ray_b(rays)                                            # [n, 2, 4]
    acc_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    acc_tri = torch.zeros((n,), dtype=torch.int32, device=dev)
    acc_d = torch.zeros((n,), dtype=torch.float64, device=dev)
    kk, m_l = (lane % 8) // 2, lane // 4                        # a ray's D column; a lane's A row
    sign = 1.0 - 2.0 * (lane % 2).double()
    for i in range(niter):
        first = torch.zeros_like(ray) if variant == "noL" else (i * 7 + warp) % span
        if variant == "scalar":
            st = TraceState.start(rays)
            drain_plain(woop, woop_i, first, count, ray, rays, st, False)
        elif variant in ("full", "noL"):
            st = TraceState.start(rays)
            drain_mxu_plain(woop, woop_i, first, count, ray, rays, st, False)
        elif variant == "noM":
            # Ray c of a warp reads out[p][m][c], written by lane 4 m + kk
            # of tile c // 8 as float(A[p][m][kk] +- B[kk][8 (c // 8) + m]).
            rows = first[:, None] + m8                                  # [n, 8]
            col = kk[:, None, None, None]
            a = _leaf_a(woop[rows]).gather(3, col.expand(n, MXU_LEAF, 6, 1)).squeeze(3)
            src = warp[:, None] * 32 + (lane[:, None] // 8) * 8 + m8    # [n, 8] B's ray
            bsel = b[src].gather(3, col.expand(n, MXU_LEAF, 2, 1)).squeeze(3)     # [n, 8, 2]
            par = torch.arange(6, device=dev) % 2
            out = (a + sign[:, None, None] * bsel[:, :, par]).float()   # [n, 8, 6]
            best = LeafBest(n, dev)
            for m in range(MXU_LEAF):
                row = first + m
                best.offer(out[:, m].unbind(1), woop_i[row, 12], torch.ones_like(ray, dtype=bool),
                           rays.tmin, rays.tmax)
            st = TraceState.start(rays)
            take = best.t < st.t
            st.t[take] = best.t[take]
            st.tri[take] = best.tri[take]
        else:   # epi0: lane l adds D[p][l >> 2][8 j + 2 (l & 3) + i] over j, p, i
            rows = first[:, None] + m8
            a = _leaf_a(woop[rows])                                     # [n, 8, 6, 4]
            a_l = a[ray, m_l]                                           # [n, 6, 4] the lane's row
            for j in range(4):
                cols = warp * 32 + 8 * j + 2 * (lane % 4)
                for p in range(6):
                    d0 = (a_l[:, p] * b[cols, p % 2]).sum(1)
                    d1 = (a_l[:, p] * b[cols + 1, p % 2]).sum(1)
                    acc_d = acc_d + (d0 + d1)
            continue
        acc_t = acc_t + st.t
        acc_tri = acc_tri + st.tri + 1
    if variant == "epi0":
        return acc_d.float(), acc_tri
    return acc_t, acc_tri


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------

def probe_rays(scene, n: int, seed: int, device) -> Rays:
    """``n`` rays from around the scene at random points of its box (numpy,
    from ``seed``), tmin 0, tmax 4x the box diagonal."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return make_rays(origin, d, np.zeros(n, np.float32), np.full(n, 4 * size, np.float32),
                     device=device)


def run(flat, scene, device="cuda", n_rays: int | None = None, hi: int | None = None,
        lo: int | None = None) -> dict:
    """Time every variant at two trip counts on ``n_rays`` probe rays over
    ``flat``'s Woop rows, and the plain version of ``full`` at PLAIN_HI and
    PLAIN_LO, then check each variant against its plain version on
    CHECK_RAYS rays at CHECK_ITERS iterations.  Returns per variant the ns
    per iteration, the times, and the check; ``launches`` are those of the
    timed runs (the checks' are not counted).  ``n_rays``, ``hi`` and ``lo``
    default to N_RAYS, NITER_HI and NITER_LO."""
    n_rays = N_RAYS if n_rays is None else n_rays
    hi = NITER_HI if hi is None else hi
    lo = NITER_LO if lo is None else lo
    dev = torch.device(device)
    woop = torch.tensor(woop_rows(flat.tri_woop, flat.tri_index), device=dev)
    rays = probe_rays(scene, n_rays, 0, dev)
    KERNEL.reset_counts()
    res = {}
    for variant in VARIANTS:
        t_hi = time_ms(lambda: ablate(variant, woop, rays, hi), REPEATS)
        t_lo = time_ms(lambda: ablate(variant, woop, rays, lo), REPEATS)
        res[variant] = {"ns_per_iter": (t_hi - t_lo) / (hi - lo) * 1e6, "ms_hi": t_hi,
                        "ms_lo": t_lo}
    launches = dict(KERNEL.launches_by_form)
    # The plain version of `full` on the same rays, per iteration the same
    # way (its iterations are tens of PyTorch operations each).
    p_hi = time_ms(lambda: ablate_plain("full", woop, rays, PLAIN_HI), 1)
    p_lo = time_ms(lambda: ablate_plain("full", woop, rays, PLAIN_LO), 1)
    res["full"]["plain_ns_per_iter"] = (p_hi - p_lo) / (PLAIN_HI - PLAIN_LO) * 1e6
    small = Rays(*(x[:CHECK_RAYS].contiguous() for x in rays))
    small_cpu = Rays(*(x.cpu() for x in small))
    for variant in VARIANTS:
        got_t, got_i = ablate(variant, woop, small, CHECK_ITERS)
        t0 = time.perf_counter()
        want_t, want_i = ablate_plain(variant, woop.cpu(), small_cpu, CHECK_ITERS)
        plain_s = time.perf_counter() - t0
        got_t, got_i = got_t.cpu(), got_i.cpu()
        res[variant].update({
            "check_rays": CHECK_RAYS, "check_iters": CHECK_ITERS,
            "t_bits_differ": int((got_t.view(torch.int32) != want_t.view(torch.int32)).sum()),
            "max_abs_err": float((got_t - want_t).abs().max()),
            "max_rel_err": float(((got_t - want_t).abs() / want_t.abs().clamp(min=1e-30)).max()),
            "tri_differ": int((got_i != want_i).sum()), "plain_s": plain_s,
        })
    return {"variants": res, "launches": launches, "n_rays": n_rays, "n_rows": woop.shape[0],
            "niter": (hi, lo), "woop": woop, "rays": rays}


def check(res: dict, rtol: float = 1e-6) -> list[str]:
    """The variants whose accumulators differ from the plain version's:
    tri sums exactly, t sums beyond ``rtol``."""
    return [v for v, r in res["variants"].items()
            if r["tri_differ"] or not r["max_rel_err"] <= rtol]


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=N_RAYS, help="rays of a timed launch")
    ap.add_argument("--hi", type=int, default=NITER_HI, help="the larger trip count")
    ap.add_argument("--lo", type=int, default=NITER_LO, help="the smaller trip count")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mxu_ablate: no CUDA device (torch.cuda.is_available() is False)")
    from tpu_rt_torch.bvh import load_or_build_bvh
    from tpu_rt_torch.scene import Scene, procedural

    scene = Scene(procedural.scene_by_name("bunny"))
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    res = run(flat, scene, n_rays=args.rays, hi=args.hi, lo=args.lo)
    print(f"mxu_ablate on {torch.cuda.get_device_name(0)}: {res['n_rays']} rays, "
          f"{res['n_rows']} Woop rows, trip counts {res['niter']}")
    for variant, r in res["variants"].items():
        print(f"{variant:6s} {r['ns_per_iter']:10.1f} ns/iter (hi {r['ms_hi']:.4f} ms, lo "
              f"{r['ms_lo']:.4f} ms); vs plain on {r['check_rays']} rays x {r['check_iters']}: "
              f"t bits differ {r['t_bits_differ']}, max rel err {r['max_rel_err']:.3g}, tri "
              f"sums differ {r['tri_differ']}")
    print(json.dumps({k: v for k, v in res.items() if k not in ("woop", "rays")}))
    bad = check(res)
    if bad:
        sys.exit(f"mxu_ablate: variants differ from their plain versions: {bad}")


if __name__ == "__main__":
    main()
