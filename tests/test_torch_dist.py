"""The port's sharded ray path (tpu_rt_torch.dist) on a gloo world of 4 CPU
processes, against tpu_rt.dist on conftest's 8-device mesh, on
tests/test_dist.py's inputs (blob 500, seed 50, 2,048 rays).

The world is this file run as a script, once per rank (``python
tests/test_torch_dist.py RANK WORLD STORE INPUTS OUT``): each rank joins
over a ``file://`` store, reads the scene, BVH and rays the test wrote,
runs every case on its block and writes its rank-local results.  The
script imports only torch and tpu_rt_torch; JAX and tpu_rt are imported by
the pytest process alone, inside the fixtures.  A rank that fails or
outlives its timeout fails the tests.

Tolerances are test_dist.py's: the wavefront's hits tri equal and t rtol
1e-6, the kernels' t rtol 1e-5 (a multiply by 1 / Dz where the wavefront
divides); the render rtol 1e-6 / atol 1e-7; the loss rtol 1e-5 and the
gradients rtol 1e-4 / atol 1e-7 (sums over ranks of local sums); a routed
step against the default one rtol 1e-6 / atol 1e-8.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_rt_torch.core.types import FlatBVH, make_rays, pad_rays
from tpu_rt_torch.dist import (collective_audit, grad_step_sharded, init_multihost,
                               make_ray_mesh, measure_scaling, render_diff_sharded,
                               shard_rays, trace_sharded)
from tpu_rt_torch.dist.dryrun import dryrun_multichip
from tpu_rt_torch.dist.sharding import _count_collectives, replicate_bvh, shard_rows
from tpu_rt_torch.trace import make_routing_tracer

WORLD = 4
N_ODD = 1001
ROUTES = ("packet", "packet4")
TARGET_SEED = 1  # test_dist.py's grad step target
SCALING_RAYS = 512
WORKER_TIMEOUT = 150


def _inputs(path):
    z = np.load(path)
    flat = FlatBVH(z["nodes"], z["tri_woop"], z["tri_index"], z["leaf_counts"])
    rays = make_rays(z["origin"], z["dirn"], z["tmin"], z["tmax"], device="cpu")
    geom = tuple(torch.as_tensor(z[k]) for k in ("vtx_pos", "tri_vtx_index", "tri_material"))
    return z, flat, rays, geom


def _rank_main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """One rank of the world: every case on its block, results to OUT."""
    torch.set_num_threads(1)
    assert init_multihost(num_processes=world, process_id=rank, backend="gloo",
                          init_method=f"file://{store}") == world
    mesh = make_ray_mesh("cpu")
    z, flat, rays, (vtx, tvi, mat) = _inputs(inputs)
    dflat = replicate_bvh(flat, mesh)
    srays = shard_rays(rays, mesh)
    res, meta = {}, {"rank": mesh.rank, "size": mesh.size}

    def put(name, *xs):
        for i, x in enumerate(xs):
            res[f"{name}/{i}"] = x.detach().numpy()

    put("shard", *srays)
    put("replica", *dflat)
    put("trace", *trace_sharded(dflat, srays, mesh)[:2])
    padded, n = pad_rays(type(rays)(*(x[:N_ODD] for x in rays)), mesh.size)
    meta["padded"] = [n, padded.num]
    put("padded", trace_sharded(dflat, shard_rays(padded, mesh), mesh).tri)
    put("render", render_diff_sharded(mesh, dflat, srays, vtx, tvi, mat))
    target = shard_rows(z["target"], mesh)
    put("grad", *grad_step_sharded(mesh, dflat, srays, vtx, tvi, mat, target))
    meta["audit"] = {"xla": collective_audit(mesh, dflat, srays, vtx, tvi, mat, target)}
    for route in ROUTES:
        # Every rank fills one shared cache directory at once.
        fn, kind, tables = make_routing_tracer(flat, route, device="cpu",
                                               cache_dir=os.path.join(out, "cache"))
        meta[f"kind_{route}"] = kind
        put(f"trace_{route}", *trace_sharded(None, srays, mesh, routing=fn, tables=tables)[:2])
        put(f"grad_{route}", *grad_step_sharded(mesh, dflat, srays, vtx, tvi, mat, target,
                                                 routing=fn, tables=tables))
        meta["audit"][route] = collective_audit(mesh, dflat, srays, vtx, tvi, mat, target,
                                                routing=fn, tables=tables)
    # Rates need no size here: the CPU's say nothing of the card's.
    few = type(rays)(*(x[:SCALING_RAYS] for x in rays))
    meta["scaling"] = {mode: measure_scaling(dflat, few, repeats=1, warmup=0, mode=mode,
                                             mesh=mesh) for mode in ("weak", "strong")}
    meta["dryrun"] = dryrun_multichip(mesh)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    torch.distributed.destroy_process_group()


def _setup_arrays():
    """tests/test_dist.py's setup: tpu_rt's scene, host FlatBVH and rays."""
    from tpu_rt.bvh import build_sbvh, flatten_bvh
    from tpu_rt.scene import Scene, procedural

    scene = Scene(procedural.make_blob(500, seed=50))
    flat = flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos)
    rng = np.random.default_rng(0)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    n = 2048
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    arrays = {"nodes": flat.nodes, "tri_woop": flat.tri_woop, "tri_index": flat.tri_index,
              "leaf_counts": flat.leaf_counts, "origin": origin, "dirn": d.astype(np.float32),
              "tmin": np.zeros(n, np.float32), "tmax": np.full(n, 4 * size, np.float32),
              "vtx_pos": scene.vtx_pos, "tri_vtx_index": scene.tri_vtx_index,
              "tri_material": scene.tri_material}
    arrays["target"] = np.random.default_rng(TARGET_SEED).uniform(0, 1, (n, 3)).astype(np.float32)
    return {k: np.asarray(v) for k, v in arrays.items()}


def _reference(a):
    """tpu_rt.dist's results on the 8-device mesh, and the single-device
    trace and grad step, as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_rt.core.types import FlatBVH as TFlat
    from tpu_rt.core.types import make_rays as t_make_rays
    from tpu_rt.diff.shading import render_image_diff
    from tpu_rt.dist import grad_step_sharded as t_grad, make_ray_mesh as t_mesh
    from tpu_rt.dist import render_diff_sharded as t_render, shard_rays as t_shard
    from tpu_rt.dist import trace_sharded as t_trace
    from tpu_rt.dist.sharding import replicate_bvh as t_replicate
    from tpu_rt.trace import device_bvh, trace_wavefront

    mesh = t_mesh()
    assert mesh.devices.size == 8, "conftest must provide 8 CPU devices"
    flat = device_bvh(TFlat(a["nodes"], a["tri_woop"], a["tri_index"], a["leaf_counts"]))
    rays = t_make_rays(a["origin"], a["dirn"], a["tmin"], a["tmax"])
    vtx, tvi, mat = (jnp.asarray(a[k]) for k in ("vtx_pos", "tri_vtx_index", "tri_material"))
    rep, srays = t_replicate(flat, mesh), t_shard(rays, mesh)
    target = jnp.asarray(a["target"])
    sh_target = jax.device_put(target, NamedSharding(mesh, P("rays", None)))

    def single_loss(vp, m):
        return jnp.mean((render_image_diff(flat, rays, vp, tvi, m) - target) ** 2)

    hits = t_trace(rep, srays, mesh)
    odd = jax.tree_util.tree_map(lambda x: x[:N_ODD], rays)
    loss_1, (g_vtx_1, g_mat_1) = jax.value_and_grad(single_loss, argnums=(0, 1))(vtx, mat)
    out = {
        "trace": (hits.tri, hits.t),
        "single_trace": trace_wavefront(flat, rays)[:2],
        "odd": trace_wavefront(flat, odd).tri,
        "render": t_render(mesh, rep, srays, vtx, tvi, mat),
        "grad_sharded": t_grad(mesh, rep, srays, vtx, tvi, mat, sh_target),
        "grad_single": (loss_1, g_vtx_1, g_mat_1),
    }
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of WORLD ranks, started once: (inputs, results by rank,
    tpu_rt's reference, the world's directory).  tpu_rt's reference runs while the ranks do."""
    d = tmp_path_factory.mktemp("dist")
    arrays = _setup_arrays()
    inputs = str(d / "inputs.npz")
    np.savez(inputs, **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD), str(d / "store"),
         inputs, str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for r in range(WORLD)]
    try:
        ref = _reference(arrays)
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {len(outs)} of the gloo world timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, o) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        pytest.fail("gloo world rank failed:\n" + "\n----\n".join(f"rank {r}:\n{o}" for r, o in bad))
    ranks = [(dict(np.load(d / f"rank{r}.npz")), json.loads((d / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    return arrays, ranks, ref, d


def gathered(ranks, name, i=0):
    """The global array of a rank-local result: the blocks in rank order."""
    return np.concatenate([res[f"{name}/{i}"] for res, _ in ranks])


def same_on_every_rank(ranks, name, n):
    for i in range(n):
        for res, _ in ranks[1:]:
            np.testing.assert_array_equal(res[f"{name}/{i}"], ranks[0][0][f"{name}/{i}"])


def test_shards_partition_the_batch(world):
    a, ranks, _, _ = world
    assert [(m["rank"], m["size"]) for _, m in ranks] == [(r, WORLD) for r in range(WORLD)]
    for i, k in enumerate(("origin", "dirn", "tmin", "tmax")):
        np.testing.assert_array_equal(gathered(ranks, "shard", i), a[k])
    # Every rank holds the whole BVH, bit for bit.
    for res, _ in ranks:
        for i, k in enumerate(("nodes", "tri_woop", "tri_index", "leaf_counts")):
            assert res[f"replica/{i}"].tobytes() == a[k].tobytes()


def test_ranks_share_one_cache(world):
    """The four ranks wrote the quad collapse to one cache directory at
    once: one whole entry, no temporary file left."""
    _, _, _, d = world
    files = os.listdir(d / "cache")
    assert len(files) == 1 and files[0].startswith("q") and files[0].endswith(".npz"), files
    np.load(d / "cache" / files[0])["nodes"]


def test_trace_sharded_matches_tpu_rt(world):
    _, ranks, ref, _ = world
    np.testing.assert_array_equal(gathered(ranks, "trace", 0), ref["trace"][0])
    np.testing.assert_allclose(gathered(ranks, "trace", 1), ref["trace"][1], rtol=1e-6)


def test_pad_rays_for_mesh(world):
    _, ranks, ref, _ = world
    n, padded = ranks[0][1]["padded"]
    assert n == N_ODD and padded % WORLD == 0 and padded > N_ODD
    tri = gathered(ranks, "padded")
    assert tri.shape == (padded,)
    np.testing.assert_array_equal(tri[:N_ODD], ref["odd"])
    assert np.all(tri[N_ODD:] == -1)  # padding rays are degenerate: they miss


def test_render_diff_sharded_matches_tpu_rt(world):
    _, ranks, ref, _ = world
    np.testing.assert_allclose(gathered(ranks, "render"), ref["render"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("against", ["grad_sharded", "grad_single"])
def test_grad_step_sharded_matches_tpu_rt(world, against):
    """Against tpu_rt's grad_step_sharded on the mesh, and against
    jax.value_and_grad of the single-device mean loss."""
    _, ranks, ref, _ = world
    same_on_every_rank(ranks, "grad", 3)
    res = ranks[0][0]
    loss, g_vtx, g_mat = ref[against]
    np.testing.assert_allclose(res["grad/0"], loss, rtol=1e-5)
    np.testing.assert_allclose(res["grad/1"], g_vtx, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(res["grad/2"], g_mat, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("route", ROUTES)
def test_trace_sharded_kernel_routing(world, route):
    """The traversal kernels' plain versions as each rank's routing tracer
    match the wavefront, as test_dist.py's Pallas kernels do."""
    _, ranks, ref, _ = world
    assert ranks[0][1][f"kind_{route}"] == ("flat" if route == "packet" else "quad") + "-plain"
    np.testing.assert_array_equal(gathered(ranks, f"trace_{route}", 0), ref["single_trace"][0])
    np.testing.assert_allclose(gathered(ranks, f"trace_{route}", 1), ref["single_trace"][1],
                               rtol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_grad_step_sharded_kernel_routing_matches(world, route):
    """Routing is discrete, so a routed step equals the default one."""
    _, ranks, _, _ = world
    same_on_every_rank(ranks, f"grad_{route}", 3)
    for res, _ in ranks:
        for i in range(3):
            np.testing.assert_allclose(res[f"grad_{route}/{i}"], res[f"grad/{i}"],
                                       rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("route", ("xla",) + ROUTES)
def test_collective_audit(world, route):
    """No collective in the forward trace; exactly the three sums in the
    grad step, on every rank."""
    _, ranks, _, _ = world
    for _, meta in ranks:
        assert meta["audit"][route] == {"n_devices": WORLD, "forward": {},
                                        "grad_step": {"all_reduce": 3}}, meta["audit"]


@pytest.mark.parametrize("mode", ["weak", "strong"])
def test_measure_scaling(world, mode):
    """Rates positive and finite (timing quality is not asserted on the
    CPU), and agreed: the same on every rank."""
    _, ranks, _, _ = world
    out = ranks[0][1]["scaling"][mode]
    keys = {"n_devices", "rate_1_rays_per_s", "rate_n_rays_per_s", "per_device_rate_n",
            "efficiency"}
    if mode == "strong":
        keys |= {"rate_1_small_rays_per_s", "mechanism_efficiency"}
    assert set(out) == keys and out["n_devices"] == WORLD
    assert all(np.isfinite(v) and v > 0 for v in out.values()), out
    assert all(m["scaling"][mode] == out for _, m in ranks)


def test_dryrun_multichip(world):
    _, ranks, _, _ = world
    runs = [m["dryrun"] for _, m in ranks]
    assert runs[0]["n_devices"] == WORLD and np.isfinite(runs[0]["loss"])
    assert all(r == runs[0] for r in runs)


def test_count_collectives_names():
    """Every c10d op counts, under tpu_rt's StableHLO name where it has one
    and under its own otherwise; backend spans and other ops do not."""
    names = ["c10d::allreduce_", "gloo:all_reduce", "c10d::_allgather_base_", "aten::add",
             "c10d::allreduce_", "c10d::broadcast_", "c10d::barrier", "c10d::alltoall_base_"]
    assert _count_collectives(names) == {"all_reduce": 2, "all_gather": 1,
                                         "collective_broadcast": 1, "barrier": 1,
                                         "all_to_all": 1}


def test_init_multihost_without_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_multihost() == 1
    assert not torch.distributed.is_initialized()


def test_world_of_one_in_process(world):
    """No process group: the same functions in this process, a world of 1,
    against tpu_rt's single-device trace and step; nothing is reduced."""
    a, _, ref, _ = world
    assert not torch.distributed.is_initialized()
    mesh = make_ray_mesh("cpu")
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    flat = replicate_bvh(FlatBVH(a["nodes"], a["tri_woop"], a["tri_index"], a["leaf_counts"]),
                         mesh)
    rays = shard_rays(make_rays(a["origin"], a["dirn"], a["tmin"], a["tmax"], device="cpu"), mesh)
    vtx, tvi, mat = (torch.as_tensor(a[k]) for k in ("vtx_pos", "tri_vtx_index", "tri_material"))
    hits = trace_sharded(flat, rays, mesh)
    np.testing.assert_array_equal(hits.tri.numpy(), ref["single_trace"][0])
    np.testing.assert_allclose(hits.t.numpy(), ref["single_trace"][1], rtol=1e-6)
    target = shard_rows(a["target"], mesh)
    got = [x.numpy() for x in grad_step_sharded(mesh, flat, rays, vtx, tvi, mat, target)]
    loss, g_vtx, g_mat = ref["grad_single"]
    np.testing.assert_allclose(got[0], loss, rtol=1e-5)
    np.testing.assert_allclose(got[1], g_vtx, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got[2], g_mat, rtol=1e-4, atol=1e-7)
    audit = collective_audit(mesh, flat, rays, vtx, tvi, mat, target)
    assert audit == {"n_devices": 1, "forward": {}, "grad_step": {}}


def test_sharding_refuses_what_it_cannot_place(world):
    a, _, _, _ = world
    mesh = make_ray_mesh("cpu")._replace(size=3)
    rays = make_rays(a["origin"], a["dirn"], a["tmin"], a["tmax"], device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3"):
        shard_rays(rays, mesh)
    one = make_ray_mesh("cpu")._replace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="the mesh traces on meta"):
        trace_sharded(None, rays, one)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
