"""One sharded differentiable train step on tiny shapes, held to the
unsharded step.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: every rank builds the same small blob scene (200
triangles) and 64 rays per rank, takes one ``grad_step_sharded`` on its
block, and holds the loss and gradients, which every rank holds whole, to
the unsharded step on all rays at the same tolerances (loss rtol 1e-5,
gradients rtol 1e-4 / atol 1e-7).

Run on every rank of a group:

    torchrun --nproc_per_node=N -m tpu_rt_torch.dist.dryrun [--backend gloo] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_rt_torch.bvh import build_sbvh, flatten_bvh
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.diff.shading import render_image_diff
from tpu_rt_torch.diff.train import _deterministic
from tpu_rt_torch.dist.multihost import init_multihost
from tpu_rt_torch.dist.sharding import (grad_step_sharded, make_ray_mesh, replicate_bvh,
                                        shard_rays, shard_rows)
from tpu_rt_torch.scene import Scene, procedural


def small_problem(num_tris: int = 600, num_rays: int = 1024, seed: int = 7, device="cuda"):
    """(scene, host FlatBVH, rays on ``device``): a blob and rays from around
    it toward points inside its box, as the JAX package's ``_small_problem``."""
    scene = Scene(procedural.make_blob(num_tris, seed=seed))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(num_rays, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (num_rays, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(origin, d, np.zeros(num_rays), np.full(num_rays, 4 * size), device=device)
    return scene, flat, rays


def dryrun_multichip(mesh=None) -> dict:
    """One sharded step over ``mesh`` (default ``make_ray_mesh()``), held to
    the unsharded step on this rank; raises AssertionError where they
    differ.  Returns the loss and the gradients' norms."""
    mesh = make_ray_mesh() if mesh is None else mesh
    num_rays = 64 * mesh.size
    scene, flat, rays = small_problem(num_tris=200, num_rays=num_rays, device=mesh.device)
    dflat = replicate_bvh(flat, mesh)
    vtx, tvi, mat = (torch.as_tensor(x, device=mesh.device)
                     for x in (scene.vtx_pos, scene.tri_vtx_index, scene.tri_material))
    rng = np.random.default_rng(0)
    target = torch.as_tensor(rng.uniform(0, 1, (num_rays, 3)).astype(np.float32),
                             device=mesh.device)

    loss, g_vtx, g_mat = grad_step_sharded(mesh, dflat, shard_rays(rays, mesh), vtx, tvi, mat,
                                           shard_rows(target, mesh))
    got = [x.detach().cpu().numpy() for x in (loss, g_vtx, g_mat)]
    if not all(np.isfinite(x).all() for x in got):
        raise AssertionError("non-finite sharded loss or gradients")

    # The strong check: the summed data-parallel step reproduces the
    # unsharded gradients, not merely finite ones.
    vp, m = vtx.clone().requires_grad_(True), mat.clone().requires_grad_(True)
    loss_1 = torch.mean((render_image_diff(dflat, rays, vp, tvi, m) - target) ** 2)
    with _deterministic():
        loss_1.backward()
    want = [x.detach().cpu().numpy() for x in (loss_1, vp.grad, m.grad)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-7)
    return {"n_devices": mesh.size, "loss": float(got[0]),
            "g_vtx_norm": float(np.linalg.norm(got[1])),
            "g_mat_norm": float(np.linalg.norm(got[2]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl with CUDA)")
    ap.add_argument("--device", default="cuda", help="the ranks' device (default: cuda)")
    args = ap.parse_args()
    init_multihost(backend=args.backend)
    try:
        out = dryrun_multichip(make_ray_mesh(args.device))
        print(f"dryrun_multichip({out['n_devices']}): loss={out['loss']:.6f} "
              f"|g_vtx|={out['g_vtx_norm']:.6f} |g_mat|={out['g_mat_norm']:.6f} "
              "sharded == unsharded gradients OK", flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
