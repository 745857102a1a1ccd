"""The 4-wide kernel against the binary kernel on the suite's workload.

Counterpart of the JAX package's ``tools/quad_probe.py`` (its accept / kill
experiment for the 4-wide BVH):

    python -m tpu_rt_torch.bench.quad_probe [scene ...] [--types primary,ao,diffuse]

Per scene: the binary tree and its ``choose_node_format(flat,
TABLE_BUDGET)`` decision, the 4-wide tree (``collapse4(flat, leaf_max)``)
with its residency (``quad_residency`` at ``TABLE_BUDGET``), the collapse
and upload seconds (``pack``), and the node and Woop table MB.  Per scene x
ray type (the suite camera at ``FRAME_W`` x ``FRAME_H``; secondary rays as
in ``bench_suite.bench_row``: a closest-hit pre-trace on the binary kernel,
``suite_ao_radius`` or ``camera.far``, Morton sort; the metric's rays are
the primary hits): each kernel's Mray/s (best of ``QP_REPEATS`` chains of
``QP_CHAIN`` traces after two warm chains, CUDA events around each chain,
``bench.chain_times``), its census (``bench_suite.census`` of one stats
trace: 32-ray warps and the sum of each warp's largest per-ray node + tri
tests, where ``tpu_rt`` counts Pallas grid-step iterations), and
``verify_subset`` of ``QP_VERIFY`` rays against ``trace_flat_scalar``; then
the ``packet4/packet2`` (4-wide / binary) Mray/s and iteration ratios.

Environment (``env``): QP_CHAIN (32), QP_REPEATS (3), QP_VERIFY (4096),
QP_LEAF (0: ``MAX_LEAF4``), and the 4-wide kernel's slot settings
(``trace_quad``'s ``u``, ``k`` and ``tile``, ``tpu_rt``'s ``trace_packet4``
arguments): QP_U4, a comma list of triangle units U to sweep, one 4-wide
row each (unset: one row of the default form, which tests one row at a
time); QP_K, the interleave K, and QP_TILE, the rays a block claims (unset
or 0: none).  The binary rows take none of them, as in the tool.  A value
the slot forms refuse (``common.check_schedule``) raises ValueError naming
its variable.  ``main``'s ``device="cpu"`` and ``width`` / ``height`` serve
the tests.
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from tpu_rt_torch.bench.bench import chain_times
from tpu_rt_torch.bench.bench_suite import census
from tpu_rt_torch.bench.workload import FRAME_H, FRAME_W, suite_ao_radius, suite_camera
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.bvh.collapse import MAX_LEAF4, collapse4
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import morton_sort_device, permute_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import (TABLE_BUDGET, choose_node_format, trace_flat, trace_flat_scalar,
                                trace_quad, upload_flat, upload_quad)
from tpu_rt_torch.trace.common import check_schedule
from tpu_rt_torch.trace.tables import QUAD_NODE_BYTES, WOOP_ROW_BYTES, quad_residency


def _ints(var: str, text: str) -> list[int]:
    try:
        return [int(x) for x in text.split(",")]
    except ValueError:
        raise ValueError(f"{var}={text!r}: need a comma list of ints") from None


def settings(env) -> dict:
    """The tool's settings from ``env``: ``u4`` the U sweep ([None] when
    QP_U4 is unset), ``k`` and ``tile`` (None when unset or 0).  A value the
    slot forms refuse raises ValueError naming its variable."""
    u4 = _ints("QP_U4", env["QP_U4"]) if "QP_U4" in env else [None]
    k = _ints("QP_K", env.get("QP_K", "0"))[0] or None
    tile = _ints("QP_TILE", env.get("QP_TILE", "0"))[0] or None
    for var, kw in (("QP_K", {"k": k}), ("QP_TILE", {"tile": tile}),
                    *(("QP_U4", {"u": u}) for u in u4)):
        try:
            check_schedule(**kw)
        except ValueError as e:
            raise ValueError(f"{var}={env.get(var)!r}: {e}") from None
    return {"chain": int(env.get("QP_CHAIN", 32)), "repeats": int(env.get("QP_REPEATS", 3)),
            "verify": int(env.get("QP_VERIFY", 4096)),
            "leaf_max": int(env.get("QP_LEAF", 0)) or MAX_LEAF4, "u4": u4, "k": k, "tile": tile}


def verify_subset(flat, rays, hits, any_hit: bool, n: int) -> int:
    """Rays of ``n`` evenly spaced (``linspace``) whose ``hits`` disagree
    with ``trace_flat_scalar``: for any hit, hit / miss; for closest hit,
    neither the same id, nor a t tie (rtol 2e-4, atol 1e-5), nor an edge
    graze of the oracle's hit (margin < 1e-3)."""
    num = rays.origin.shape[0]
    idx = np.linspace(0, num - 1, min(n, num)).astype(np.int64)
    o, d, tn, tx = (x.cpu().numpy()[idx] for x in rays)
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tn, tx, any_hit=any_hit)
    got = hits.tri.cpu().numpy()[idx]
    if any_hit:
        bad = int(np.sum((got >= 0) != (s_id >= 0)))
    else:
        exact = got == s_id
        tie = ~exact & np.isclose(hits.t.cpu().numpy()[idx], s_t, rtol=2e-4, atol=1e-5)
        margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
        graze = ~exact & ~tie & (s_id >= 0) & (margin < 1e-3)
        bad = int(np.sum(~exact & ~tie & ~graze))
    if bad:
        print(f"    *** VERIFY FAILED: {bad}/{idx.size} rays wrong ***", flush=True)
    return bad


def bench_kernel(label, trace_fn, rays, num_metric, flat, any_hit, s, device) -> dict:
    """One kernel on ``rays``: ``trace_fn(rays, with_stats=False)``
    timed, its census, its hit count and its verification; prints the
    tool's line."""
    trace = functools.partial(trace_fn, rays)
    chain_times(trace, s["chain"], 2, device)   # warm
    best = min(chain_times(trace, s["chain"], s["repeats"], device))
    h, stats = trace_fn(rays, with_stats=True)
    groups, iters = census(stats)
    mrays = num_metric / best / 1e6
    print(f"  {label:28s}: {mrays:8.2f} Mray/s  best {best*1e3:8.3f} ms  "
          f"iters {iters:8d} groups {groups:4d}", flush=True)
    bad = verify_subset(flat, rays, h, any_hit, s["verify"])
    return {"label": label, "mrays": mrays, "best_s": best, "iters": iters, "groups": groups,
            "bad": bad, "rays": rays.origin.shape[0], "rays_metric": num_metric,
            "hits": int((h.tri >= 0).sum())}


def main(argv=None, env=None, device="cuda", cache_dir: str | None = "bvhcache", *,
         width: int = FRAME_W, height: int = FRAME_H) -> list[dict]:
    """The tool's run: prints its lines and returns one row per scene x ray
    type x kernel, one 4-wide row per U of the sweep (the 4-wide rows carry
    the ratios and their ``u``, ``k`` and ``tile``)."""
    env = os.environ if env is None else env
    s = settings(env)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="*", help="default: bunny sponza knob dragon")
    ap.add_argument("--types", default="primary", help="comma list (default primary)")
    args = ap.parse_args(argv)
    scenes = args.scenes or ["bunny", "sponza", "knob", "dragon"]
    types = args.types.split(",")
    device = torch.device(device)

    out = []
    for name in scenes:
        scene = Scene(procedural.scene_by_name(name))
        flat, _ = load_or_build_bvh(scene, cache_dir=cache_dir)
        t0 = time.time()
        quad = collapse4(flat, leaf_max=s["leaf_max"])
        tcol = time.time() - t0
        res2, bf16 = choose_node_format(flat, TABLE_BUDGET)
        n4b = quad.num_nodes * QUAD_NODE_BYTES
        w4b = max(quad.num_refs, 1) * WOOP_ROW_BYTES
        res4 = quad_residency(n4b, w4b, TABLE_BUDGET)
        t0 = time.time()
        tab4 = upload_quad(quad, device, residency=res4)
        tab2 = upload_flat(flat, device, residency=res2, bf16_nodes=bf16)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tpack = time.time() - t0
        print(f"\n{name}: binary {flat.nodes.shape[0]} nodes/"
              f"{flat.tri_woop.shape[0]} refs [{res2}"
              f"{'-bf16' if bf16 else ''}] -> quad {quad.num_nodes} nodes/"
              f"{quad.num_refs} refs [{res4}] "
              f"(collapse {tcol:.1f}s pack {tpack:.1f}s; "
              f"nodes {n4b/1e6:.1f}MB woop {w4b/1e6:.1f}MB)", flush=True)

        camera = suite_camera(name, scene)
        prim, _, _ = RayGen().primary(camera, width, height, device=device)
        ph = None
        for rt in types:
            any_hit = rt == "ao"
            if rt == "primary":
                rays, num = prim, prim.num
            else:
                if ph is None:
                    ph = trace_flat(tab2, prim)
                live = int((ph.tri >= 0).sum())
                max_dist = (suite_ao_radius(name, scene) if rt == "ao"
                            else float(camera.far))
                rays, _, _ = gen_ao_rays(prim.origin, prim.dirn, ph.t, ph.tri,
                                         torch.as_tensor(scene.tri_normal, device=device), 1,
                                         max_dist, 0)
                rays = permute_rays(rays, morton_sort_device(rays.origin, rays.dirn))
                num = live
            print(f" {name} {rt} (metric rays {num}):", flush=True)

            def t2(r, with_stats=False):
                return trace_flat(tab2, r, any_hit, with_stats=with_stats)

            r2 = bench_kernel(f"flat_trace [{res2}" + ("-bf16" if bf16 else "") + "]",
                              t2, rays, num, flat, any_hit, s, device)
            out.append({"scene": name, "ray_type": rt, "kernel": "flat_trace", **r2})
            for u4 in s["u4"]:
                def t4(r, with_stats=False, u4=u4):
                    return trace_quad(tab4, r, any_hit, with_stats=with_stats, u=u4, k=s["k"],
                                      tile=s["tile"])

                r4 = bench_kernel(f"quad_trace [{res4}]" + (f" U={u4}" if u4 else "")
                                  + (f" K={s['k']}" if s["k"] else "")
                                  + (f" t={s['tile']}" if s["tile"] else ""),
                                  t4, rays, num, flat, any_hit, s, device)
                m2, i2, m4, i4 = r2["mrays"], r2["iters"], r4["mrays"], r4["iters"]
                print(f"    -> packet4/packet2 = {m4/m2:.3f}x "
                      f"(iters {i4}/{i2} = {i4/max(i2,1):.3f}x)", flush=True)
                r4.update({"vs_flat": m4 / m2, "iters_vs_flat": i4 / max(i2, 1), "u": u4,
                           "k": s["k"], "tile": s["tile"]})
                out.append({"scene": name, "ray_type": rt, "kernel": "quad_trace", **r4})
    return out


if __name__ == "__main__":
    main()
