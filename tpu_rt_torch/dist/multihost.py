"""Process-group initialization + scaling-efficiency measurement.

Counterpart of ``tpu_rt.dist.multihost``, on ``torch.distributed``:

- every rank calls ``init_multihost()``, which joins the process group from
  its arguments or from the rendezvous variables ``torchrun`` sets
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``); with none of them it is a no-op, a world of 1;
- ``make_ray_mesh()`` (``dist.sharding``) then spans every rank; rays are
  data-parallel over the ranks, so the only traffic is the step's three
  gradient and loss sums.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from tpu_rt_torch.core.types import Rays
from tpu_rt_torch.dist.sharding import (RayMesh, make_ray_mesh, replicate_bvh, shard_rays,
                                        trace_sharded)
from tpu_rt_torch.trace.wavefront import trace_wavefront


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None,
                   init_method: str | None = None) -> int:
    """Join the process group (idempotent); returns the world size.

    coordinator_address: "host:port" of rank 0 (default ``MASTER_ADDR`` and
    ``MASTER_PORT``); init_method: any ``init_process_group`` URL in its
    place (a ``file://`` store avoids port races between test runs);
    num_processes / process_id: default ``WORLD_SIZE`` / ``RANK``.
    backend: "nccl" (default where CUDA is available; rank r then takes
    ``cuda:LOCAL_RANK``) or "gloo" (the CPU, or ranks that share a card).
    With no address, no init_method and at most one process it is a no-op
    returning 1, so callers can invoke it unconditionally."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and init_method is None and num_processes in (None, 1):
        return 1
    if num_processes is None or process_id is None:
        raise ValueError("init_multihost needs num_processes and process_id (or WORLD_SIZE "
                         "and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    bound = {}
    if backend == "nccl":
        # The rank's card, bound to the group: NCCL's barriers and
        # communicators then need no guess of the rank-to-card mapping.
        card = torch.device("cuda", int(env.get("LOCAL_RANK", process_id)))
        torch.cuda.set_device(card)
        bound["device_id"] = card
    dist.init_process_group(backend, init_method=init_method or f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **bound)
    return dist.get_world_size()


def _fence(mesh) -> None:
    """Every rank's work done: the device drained, then a barrier."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def measure_scaling(flat, rays: Rays, routing=None, tables=None,
                    any_hit: bool = False, repeats: int = 3,
                    warmup: int = 1, mode: str = "weak", mesh=None) -> dict:
    """Rays/s of rank 0 alone against every rank; returns {"n_devices",
    "rate_1_rays_per_s", "rate_n_rays_per_s", "per_device_rate_n",
    "efficiency"} where efficiency = (rate_n / n) / rate_1, the same on
    every rank.  Every rank of ``mesh`` (default ``make_ray_mesh()``) calls
    it.

    rays: the PER-RANK batch in "weak" mode (every rank traces this batch),
    or the GLOBAL batch in "strong" mode (fixed total work split across the
    ranks; per-rank fixed overheads then count against efficiency), which
    also reports ``rate_1_small_rays_per_s`` (rank 0 alone on a 1/n batch)
    and ``mechanism_efficiency`` = (rate_n / n) / rate_1_small.

    rate_1 is rank 0 alone on a one-rank subgroup while the others wait at a
    barrier; rate_n is every rank on its block between barriers.  Each
    window is fenced by ``torch.cuda.synchronize()`` and a barrier; rank 0's
    rates reach the others in one broadcast after the timed windows."""
    if mode not in ("weak", "strong"):
        raise ValueError(f"mode {mode!r}: 'weak' or 'strong'")
    if (routing is None) != (tables is None):
        raise ValueError("pass the (routing, tables) pair from make_routing_tracer together, "
                         "or neither")
    mesh = make_ray_mesh() if mesh is None else mesh
    n = mesh.size
    if routing is None:
        routing, tables = trace_wavefront, replicate_bvh(flat, mesh)
    # Rank 0 alone runs on a one-rank subgroup, which every rank creates.
    root = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    solo = mesh if n == 1 else RayMesh(dist.new_group([root]), 1, 0, mesh.device)

    def rate(m: RayMesh, batch: Rays) -> float:
        if mode == "weak":
            k = m.size
            sub = batch if k == 1 else Rays(*(torch.cat([x] * k) for x in batch))
            take = batch.num * k
        else:
            take = (batch.num // m.size) * m.size
            sub = Rays(*(x[:take] for x in batch))
        local = shard_rays(sub, m)

        def once():
            trace_sharded(None, local, m, any_hit=any_hit, routing=routing, tables=tables)

        for _ in range(warmup):
            once()
        best = float("inf")
        for _ in range(repeats):
            _fence(m)
            t0 = time.perf_counter()
            once()
            _fence(m)
            best = min(best, time.perf_counter() - t0)
        return take / best

    def alone(batch: Rays) -> float:
        # The other ranks wait for rank 0 at a barrier.
        r = rate(solo, batch) if mesh.rank == 0 else 0.0
        if n > 1:
            dist.barrier(group=mesh.group)
        return r

    rate_1 = alone(rays)
    rates = [rate_1, rate(mesh, rays) if n > 1 else rate_1]
    if mode == "strong" and n > 1:
        rates.append(alone(Rays(*(x[:max(1, x.shape[0] // n)] for x in rays))))
    agreed = torch.tensor(rates, dtype=torch.float64, device=mesh.device)
    if mesh.group is not None:
        dist.broadcast(agreed, src=root, group=mesh.group)
    rate_1, rate_n, *small = agreed.tolist()
    out = {
        "n_devices": n,
        "rate_1_rays_per_s": rate_1,
        "rate_n_rays_per_s": rate_n,
        "per_device_rate_n": rate_n / n,
        "efficiency": (rate_n / n) / rate_1 if rate_1 > 0 else float("nan"),
    }
    if small:
        # Strong-mode loss = (a) each rank traces a 1/n-size batch, which
        # amortizes fixed per-call cost worse, + (b) what the sharding
        # itself costs.  rate_1_small isolates (a); mechanism_efficiency
        # isolates (b).
        out["rate_1_small_rays_per_s"] = small[0]
        out["mechanism_efficiency"] = (rate_n / n) / small[0] if small[0] > 0 else float("nan")
    return out
