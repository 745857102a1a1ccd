"""The port's design tools (``tpu_rt_torch.bench.packet_stats``,
``treelet_sim``, ``iter_probe``, ``ao_probe``, ``quad_probe``) against the
JAX package's ``tools/``: the host simulators bit for bit on identical
inputs, the ray generation, orders, prefixes and paddings, the oracle
verification's count, ``quad_probe``'s U / K / tile settings and what they
refuse, each ``main`` on knob at a small frame with the kernels' plain
versions, and ``quad_probe``'s and ``ao_probe``'s hit counts against the
JAX tools' (their Pallas kernels in interpret mode) on the same rays."""

import functools
import importlib
import sys
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rt import raygen as t_raygen
from tpu_rt.bvh import load_or_build_bvh as t_load_or_build_bvh
from tpu_rt.core.types import Rays as TRays
from tpu_rt.rays import buffer as t_buffer
from tpu_rt.scene import Scene as TScene
from tpu_rt.scene import procedural as t_proc

from tpu_rt_torch.bench import ao_probe, iter_probe, packet_stats, quad_probe, treelet_sim
from tpu_rt_torch.bench.bench_suite import census
from tpu_rt_torch.bench.workload import suite_ao_radius, suite_camera
from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.core.types import Hits, Rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.raygen.generators import gen_ao_rays
from tpu_rt_torch.rays.buffer import sort_dead_last_device
from tpu_rt_torch.scene import Camera, Scene, procedural
from tpu_rt_torch.trace import (device_bvh, trace_flat, trace_flat_scalar, trace_quad,
                                trace_wavefront, upload_flat, upload_quad)
from tpu_rt_torch.bvh.collapse import collapse4

SCENE = "knob"
EPS32 = np.finfo(np.float32).eps
# tools/ao_probe.py's schedules, in its order.
AO_SCHEDULES = ["unsorted", "natural", "compact", "spread", "uns-t512k4", "uns-t512k8",
                "uns-t1024k4", "uns-t1024k8", "uns-c2", "cmp-t512k8", "cmp-c2"]


def _tool(name, monkeypatch):
    """``tools/<name>.py`` imported with ``sys.argv`` holding only its name
    (``ao_probe`` and ``iter_probe`` parse it at import)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    return importlib.import_module(f"tools.{name}")


@pytest.fixture(scope="module")
def flats():
    """(tpu_rt's, the port's) FlatBVH of knob, built without a cache."""
    t_flat, _ = t_load_or_build_bvh(TScene(t_proc.scene_by_name(SCENE)), cache_dir=None)
    p_flat, _ = load_or_build_bvh(Scene(procedural.scene_by_name(SCENE)), cache_dir=None)
    for a, b in zip(t_flat, p_flat):
        assert np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))
    return t_flat, p_flat


@pytest.fixture(scope="module")
def ao_rays(flats):
    """Knob's 1-sample AO rays of a 128x64 Camera.for_bbox frame on the
    CPU, as host arrays (the misses' rays dead)."""
    _, flat = flats
    scene = Scene(procedural.scene_by_name(SCENE))
    lo, hi = scene.bbox()
    rays, _, _ = RayGen().primary(Camera.for_bbox(lo, hi), 128, 64, device="cpu")
    ph = trace_flat(upload_flat(flat, "cpu"), rays)
    arays, _, _ = gen_ao_rays(rays.origin, rays.dirn, ph.t, ph.tri,
                              torch.as_tensor(scene.tri_normal), 1,
                              0.1 * float(np.linalg.norm(hi - lo)), 0)
    return [x.numpy() for x in arays]


def _t_rays(arrays) -> TRays:
    return TRays(*(jnp.asarray(x) for x in arrays))


def _p_rays(arrays) -> Rays:
    return Rays(*(torch.as_tensor(x) for x in arrays))


class _SizedRayGen(t_raygen.RayGen):
    """tpu_rt's RayGen at a fixed frame (its tools hard-code 1024x768)."""

    size = (64, 32)

    def primary(self, camera, width, height):
        return super().primary(camera, *self.size)


# ---------------------------------------------------------------------------
# packet_stats
# ---------------------------------------------------------------------------

def test_simulate_packet_and_links_bit_equal(flats, tmp_path, monkeypatch, capsys):
    # Every packet of a 128x64 frame at tiles 256 and 1024: the JAX tool's
    # own inputs to simulate_packet, recorded, give the same counts through
    # the port's copy, and the port's rays and packed links are the tool's.
    t_ps = _tool("packet_stats", monkeypatch)
    calls = []
    orig = t_ps.simulate_packet

    def record(*args):
        calls.append((args, orig(*args)))
        return calls[-1][1]

    monkeypatch.setattr(t_ps, "simulate_packet", record)
    monkeypatch.setattr(_SizedRayGen, "size", (128, 64))
    monkeypatch.setattr(t_raygen, "RayGen", _SizedRayGen)
    monkeypatch.setattr(sys, "argv", ["packet_stats.py", SCENE, "256", "1024"])
    monkeypatch.setenv("PS_MAX_PACKETS", "1000")
    monkeypatch.chdir(tmp_path)
    t_ps.main()
    assert len(calls) == 32 + 8

    _, flat = flats
    links = packet_stats.packed_links(flat)
    assert links.dtype == np.int32 and (links[:, :2] < 0).any()
    lo, hi = Scene(procedural.scene_by_name(SCENE)).bbox()
    rays = RayGen().primary(Camera.for_bbox(lo, hi), 128, 64, device="cpu")[0]
    o, d, tmin, tmax = (x.numpy() for x in rays)
    starts = [256 * i for i in range(32)] + [1024 * i for i in range(8)]
    for (args, want), s0 in zip(calls, starts):
        rows, t_links, woop, t_o, t_d, t_tmin, t_tmax = args
        assert np.array_equal(t_links, links)
        assert np.array_equal(rows.view(np.int32), np.asarray(flat.nodes).view(np.int32))
        n = t_o.shape[0]
        for a, b in ((t_o, o), (t_d, d), (t_tmin, tmin), (t_tmax, tmax)):
            assert np.array_equal(a.view(np.int32), b[s0:s0 + n].view(np.int32))
        assert packet_stats.simulate_packet(*args) == want
        assert packet_stats.simulate_packet(rows, links, woop, o[s0:s0 + n], d[s0:s0 + n],
                                            tmin[s0:s0 + n], tmax[s0:s0 + n]) == want


@pytest.mark.parametrize("tool", ["packet_stats", "treelet_sim"])
def test_host_mains_print_tpu_rt_numbers(tool, flats, tmp_path, monkeypatch, capsys):
    # A 64x32 primary frame (bit-equal rays), tile 256, 4 packets.
    t_mod = _tool(tool, monkeypatch)
    env = {"PS_MAX_PACKETS": "4", "TS_WH": "64x32", "TS_TILE": "256", "TS_MAX_PACKETS": "4"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = [SCENE, "256"] if tool == "packet_stats" else [SCENE, "primary", "16", "64"]
    monkeypatch.setattr(t_raygen, "RayGen", _SizedRayGen)
    monkeypatch.setattr(sys, "argv", [f"{tool}.py"] + argv)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    t_mod.main()
    want = capsys.readouterr().out
    if tool == "packet_stats":
        rows = packet_stats.main(argv, env, device="cpu", cache_dir=None, width=64, height=32)
    else:
        rows = treelet_sim.main(argv, env, device="cpu", cache_dir=None)
    got = capsys.readouterr().out
    assert got == want and len(want.splitlines()) == len(rows) + 1
    assert rows[0]["scene"] == SCENE and rows[0]["rays"] == 2048


# ---------------------------------------------------------------------------
# treelet_sim
# ---------------------------------------------------------------------------

def test_treelet_cut_and_links_equal(flats, monkeypatch):
    t_ts = _tool("treelet_sim", monkeypatch)
    t_flat, flat = flats
    links = treelet_sim.leaf_encode_links(flat)
    t_links = t_ts.leaf_encode_links(t_flat)
    assert links.dtype == t_links.dtype == np.int64 and np.array_equal(links, t_links)
    assert np.array_equal(treelet_sim.subtree_sizes(links), t_ts.subtree_sizes(t_links))
    for T in (1, 16, 64, 1000, 10**6):
        in_t, portals = treelet_sim.build_cut(links, T)
        t_in, t_portals = t_ts.build_cut(t_links, T)
        assert np.array_equal(in_t, t_in) and portals == t_portals
        assert in_t.sum() == min(T, int((links[:, :2] >= 0).sum()) + 1)


def _stepper_equal(got, want):
    (ht, htri, cnt, pairs), (w_ht, w_htri, w_cnt, w_pairs) = got, want
    assert np.array_equal(ht.view(np.int32), w_ht.view(np.int32))
    assert np.array_equal(htri, w_htri) and tuple(cnt) == tuple(w_cnt)
    assert len(pairs) == len(w_pairs)
    for (idx, portal), (w_idx, w_portal) in zip(pairs, w_pairs):
        assert portal == w_portal and np.array_equal(idx, w_idx)


@pytest.mark.parametrize("case", ["single-closest", "single-any", "A16-any", "A64-closest",
                                  "B-any", "B-closest"])
def test_stepper_bit_equal(case, flats, ao_rays, monkeypatch):
    t_ts = _tool("treelet_sim", monkeypatch)
    _, flat = flats
    rows, woop = np.asarray(flat.nodes), np.asarray(flat.tri_woop)
    links = treelet_sim.leaf_encode_links(flat)
    any_hit = case.endswith("any")
    if any_hit:
        o, d, tmin, tmax = (x[:2048] for x in ao_rays)
    else:
        lo, hi = Scene(procedural.scene_by_name(SCENE)).bbox()
        rays = RayGen().primary(Camera.for_bbox(lo, hi), 64, 32, device="cpu")[0]
        o, d, tmin, tmax = (x.numpy() for x in rays)
    T = {"single": None, "A16": 16, "A64": 64, "B": 64}[case.split("-")[0]]
    in_t = None if T is None else treelet_sim.build_cut(links, T)[0]
    args = (rows, links, woop, in_t)
    got = treelet_sim.Stepper(*args).run(o, d, tmin, tmax, any_hit=any_hit)
    want = t_ts.Stepper(*args).run(o, d, tmin, tmax, any_hit=any_hit)
    _stepper_equal(got, want)
    assert got[2][0] > 0 and (not any_hit or (got[1] >= 0).any())
    if T is not None:
        assert got[3] and got[2][3] == len(got[3])
    if case.startswith("B"):
        # Phase B from the portal that most rays reached, from phase A's t.
        idx, portal = max(got[3], key=lambda p: p[0].size)
        kw = dict(start=portal, any_hit=any_hit, hit_t0=got[0][idx],
                  hit_tri0=np.full(idx.size, -1, np.int64))
        sub = (o[idx], d[idx], tmin[idx], tmax[idx])
        b = treelet_sim.Stepper(rows, links, woop).run(*sub, **kw)
        _stepper_equal(b, t_ts.Stepper(rows, links, woop).run(*sub, **kw))
        assert b[2][0] > 0 and not b[3]


def test_gen_rays_equal_tpu_rt(flats, tmp_path, monkeypatch):
    t_ts = _tool("treelet_sim", monkeypatch)
    monkeypatch.chdir(tmp_path)
    want = t_ts.gen_rays(SCENE, "primary", 64, 32)
    got = treelet_sim.gen_rays(SCENE, "primary", 64, 32, device="cpu", cache_dir=None)
    assert got[5] is want[5] is False
    for a, b in zip(got[1:5], want[1:5]):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    # AO rays, both unsorted: the rays to the raygen tolerances
    # (tests/test_torch_raygen.py), and the same Morton order on identical
    # rays.
    t_sort, p_sort = t_buffer.morton_sort_device, treelet_sim.morton_sort_device
    monkeypatch.setattr(t_buffer, "morton_sort_device", lambda o, d: jnp.arange(o.shape[0]))
    monkeypatch.setattr(treelet_sim, "morton_sort_device", lambda o, d: torch.arange(o.shape[0]))
    want = t_ts.gen_rays(SCENE, "ao", 64, 32)
    got = treelet_sim.gen_rays(SCENE, "ao", 64, 32, device="cpu", cache_dir=None)
    assert got[5] is True and want[5] is True
    order = p_sort(torch.as_tensor(want[1]), torch.as_tensor(want[2])).numpy()
    assert np.array_equal(order, np.asarray(t_sort(jnp.asarray(want[1]), jnp.asarray(want[2]))))
    assert not np.array_equal(order, np.arange(order.size))
    # Origins within one rounding of |o| + |d back| (back = t - 1e-4), the
    # FMA contraction of tpu_rt's raygen on the CPU.
    flat, p_o, p_d, p_tmin, p_tmax, _ = treelet_sim.gen_rays(SCENE, "primary", 64, 32,
                                                             device="cpu", cache_dir=None)
    t = trace_wavefront(device_bvh(flat, "cpu"), _p_rays([p_o, p_d, p_tmin, p_tmax])).t.numpy()
    back = np.maximum(t - np.float32(1e-4), np.float32(0.0))
    tol = (np.abs(p_o) + np.abs(p_d * back[:, None])) * EPS32
    assert np.all(np.abs(got[1] - want[1]) <= tol)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=4 * EPS32)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    assert (got[4] < 0).any() and (got[4] > 0).any()


# ---------------------------------------------------------------------------
# iter_probe and ao_probe: orders, prefixes, paddings
# ---------------------------------------------------------------------------

def test_iter_probe_orders_and_padding_equal(ao_rays, monkeypatch):
    t_ip = _tool("iter_probe", monkeypatch)
    assert iter_probe.TILE * iter_probe.K == t_ip.TILE * t_ip.K == 4096
    t_r, p_r = _t_rays(ao_rays), _p_rays(ao_rays)
    for p_fn, t_fn in ((iter_probe.sort_dir_octant, t_ip.sort_dir_octant),
                       (sort_dead_last_device, t_ip.sort_dead_last)):
        got, want = p_fn(p_r).numpy(), np.asarray(t_fn(t_r))
        assert np.array_equal(got, want) and not np.array_equal(got, np.arange(got.size))
    for n, block in ((8192, 4096), (5000, 4096), (100, 64)):
        sub = [x[:n] for x in ao_rays]
        got = iter_probe.pad_to_block(_p_rays(sub), block)
        want = t_ip.pad_to_block(_t_rays(sub), block)
        assert got.num == want.origin.shape[0] == -(-n // block) * block
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))
    idx = np.array([5, 0, 77, 3])
    for a, b in zip(iter_probe.take(p_r, torch.as_tensor(idx)), t_ip.take(t_r, jnp.asarray(idx))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_ao_probe_schedules_equal_tpu_rt(ao_rays, monkeypatch):
    # The compact prefix and the spread order: the JAX tool's main
    # (ao_probe.py:240-247) on the same rays.
    t_ao = _tool("ao_probe", monkeypatch)
    tile = t_ao.TILE
    t_r, p_r = _t_rays(ao_rays), _p_rays(ao_rays)
    n, live = p_r.num, int((p_r.tmax >= 0).sum())
    assert 0 < live < n and n // tile == 4
    dl = t_ao.take(t_r, t_ao.sort_dead_last(t_r))
    m = min(n, -(-live // tile) * tile)
    want = {"natural": t_ao.take(t_r, t_buffer.morton_sort_device(t_r.origin, t_r.dirn)),
            "compact": TRays(*(x[:m] for x in dl)),
            "spread": t_ao.take(dl, jnp.asarray(np.argsort(np.arange(n) % (n // tile),
                                                           kind="stable"), jnp.int32)),
            "unsorted": t_r}
    got = ao_probe.schedules(p_r, live, tile)
    assert list(got) == AO_SCHEDULES
    assert got["compact"][0].num == m < n and m % tile == 0
    assert got["cmp-c2"][0] is got["compact"][0] is got["cmp-t512k8"][0]
    assert got["uns-c2"] == (p_r, {"cursors": 2})
    # The tool's tile / interleave schedules (ao_probe.py:251-256), as
    # trace_flat's tile and k.
    for t_ in (512, 1024):
        for k_ in (4, 8):
            assert got[f"uns-t{t_}k{k_}"] == (p_r, {"tile": t_, "k": k_})
    assert got["cmp-t512k8"][1] == {"tile": 512, "k": 8}
    for name, w in want.items():
        rays, kw = got[name]
        assert kw == {}
        for a, b in zip(rays, w):
            assert np.array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32)), name


# ---------------------------------------------------------------------------
# quad_probe: the oracle verification and the refused knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("any_hit", [False, True])
def test_verify_subset_equals_bench_kernel(any_hit, flats, ao_rays, monkeypatch):
    t_qp = _tool("quad_probe", monkeypatch)
    monkeypatch.setattr(t_qp, "CHAIN", 1)
    monkeypatch.setattr(t_qp, "REPEATS", 1)
    t_flat, flat = flats
    if any_hit:
        arrays = ao_rays
    else:
        lo, hi = Scene(procedural.scene_by_name(SCENE)).bbox()
        arrays = [x.numpy() for x in RayGen().primary(Camera.for_bbox(lo, hi), 64, 32,
                                                      device="cpu")[0]]
    rays = _p_rays(arrays)
    hits = trace_flat(upload_flat(flat, "cpu"), rays, any_hit)
    tri, t = hits.tri.numpy().copy(), hits.t.numpy().copy()
    # Some ids made wrong: hits moved to another triangle (t too) or to a
    # miss, and misses given a hit.
    hit = np.flatnonzero(tri >= 0)
    miss = np.flatnonzero(tri < 0)
    tri[hit[::97]] = (tri[hit[::97]] + 1) % flat.tri_index.max()
    t[hit[::97]] *= 1.5
    tri[hit[5::89]] = -1
    tri[miss[::53]] = 7
    n = 1500
    if not any_hit:
        # Wrong ids on the oracle's edge hits too: grazes (margin < 1e-3)
        # are excused, those just beyond are not.
        sub = np.linspace(0, rays.num - 1, n).astype(np.int64)
        s_id, _, s_u, s_v = trace_flat_scalar(flat, *(x[sub] for x in arrays))
        margin = np.minimum(np.minimum(s_u, s_v), 1.0 - s_u - s_v)
        edge = sub[(s_id >= 0) & (margin < 1e-2)]
        assert edge.size and ((margin >= 1e-3) & (margin < 1e-2) & (s_id >= 0)).any()
        tri[edge] = (tri[edge] + 1) % flat.tri_index.max()
        t[edge] *= 1.5
    StubHits = namedtuple("StubHits", "tri t")

    def stub(r, count_iters=False):
        h = StubHits(tri, t)
        return (h, np.zeros(4, np.int32)) if count_iters else h

    monkeypatch.setattr(t_qp, "VERIFY", n)
    _, _, want = t_qp.bench_kernel("stub", stub, TRays(*arrays), 1, t_flat, any_hit)
    got = quad_probe.verify_subset(flat, rays, Hits(torch.as_tensor(tri), torch.as_tensor(t),
                                                    hits.u, hits.v), any_hit, n)
    assert got == want > 0
    assert quad_probe.verify_subset(flat, rays, hits, any_hit, n) == 0


# Values of each knob that the slot forms refuse (common.check_schedule).
QP_BAD = {"QP_U4": ("0", "33", "3,x", "4,40"), "QP_K": ("3", "16", "-2"),
          "QP_TILE": ("100", "-128", "64")}


@pytest.mark.parametrize("var,value", [("QP_U4", "3,4,6,8"), ("QP_U4", "8"), ("QP_K", "4"),
                                       ("QP_TILE", "1024")])
def test_quad_probe_refuses_pallas_knobs(var, value):
    # The tool's knobs are the 4-wide kernel's slot settings: the value
    # given is taken (tools/quad_probe.py:41-43), and one that the slot
    # forms refuse raises ValueError naming its variable.
    s = quad_probe.settings({var: value})
    key = {"QP_U4": "u4", "QP_K": "k", "QP_TILE": "tile"}[var]
    assert s[key] == ([int(x) for x in value.split(",")] if var == "QP_U4" else int(value))
    for bad in QP_BAD[var]:
        with pytest.raises(ValueError, match=var):
            quad_probe.settings({var: bad})
    with pytest.raises(ValueError, match=var):
        quad_probe.main([SCENE], {var: QP_BAD[var][0]}, device="cpu", cache_dir=None)
    s = quad_probe.settings({"QP_K": "0", "QP_TILE": "0"})
    assert s == {"chain": 32, "repeats": 3, "verify": 4096, "leaf_max": 16, "u4": [None],
                 "k": None, "tile": None}


# ---------------------------------------------------------------------------
# Each tool's main on the CPU, at a small frame
# ---------------------------------------------------------------------------

def _census_of(flat, rays, quad=False):
    if quad:
        return census(trace_quad(upload_quad(collapse4(flat), "cpu"), rays, with_stats=True)[1])
    return census(trace_flat(upload_flat(flat, "cpu"), rays, with_stats=True)[1])


def test_iter_probe_main_rows(flats):
    _, flat = flats
    rows = iter_probe.main([SCENE, "primary", "ao", "--subsets"], {}, device="cpu",
                           cache_dir=None, width=64, height=32)
    assert [r["name"] for r in rows] == ["primary", "ao-suite", "ao-diroct", "ao-plane",
                                         "ao-blob"]
    for r in rows:
        assert r["groups"] == -(-r["rays"] // 32) and r["iters"] > 0 and r["wall_s"] > 0
        assert r["max"] <= r["iters"] and r["mean"] == pytest.approx(r["iters"] / r["groups"])
    # The subsets are padded to TILE * K and hold the live rays of each
    # surface; together every live ray of the batch.
    assert rows[3]["rays"] == rows[4]["rays"] == 4096
    assert rows[3]["live"] + rows[4]["live"] == rows[1]["live"] == rows[2]["live"]
    scene = Scene(procedural.scene_by_name(SCENE))
    rays = RayGen().primary(suite_camera(SCENE, scene), 64, 32, device="cpu")[0]
    assert (rows[0]["groups"], rows[0]["iters"]) == _census_of(flat, rays)


def test_quad_probe_main_rows(flats):
    _, flat = flats
    rows = quad_probe.main([SCENE, "--types=primary,ao"],
                           {"QP_CHAIN": "1", "QP_REPEATS": "1", "QP_VERIFY": "512"},
                           device="cpu", cache_dir=None, width=64, height=32)
    assert [(r["ray_type"], r["kernel"]) for r in rows] == [
        ("primary", "flat_trace"), ("primary", "quad_trace"), ("ao", "flat_trace"),
        ("ao", "quad_trace")]
    for r in rows:
        assert r["bad"] == 0 and r["mrays"] > 0 and r["groups"] == -(-r["rays"] // 32) == 64
    assert rows[1]["vs_flat"] == pytest.approx(rows[1]["mrays"] / rows[0]["mrays"])
    assert rows[2]["rays_metric"] < 2048 == rows[0]["rays_metric"]
    scene = Scene(procedural.scene_by_name(SCENE))
    rays = RayGen().primary(suite_camera(SCENE, scene), 64, 32, device="cpu")[0]
    assert (rows[0]["groups"], rows[0]["iters"]) == _census_of(flat, rays)
    assert (rows[1]["groups"], rows[1]["iters"]) == _census_of(flat, rays, quad=True)


def test_ao_probe_main_rows():
    rows = ao_probe.main([SCENE], {"TPU_RT_TILE2": "256"}, device="cpu", cache_dir=None,
                         width=64, height=32)
    assert [r["name"] for r in rows] == AO_SCHEDULES
    # Every schedule finds the same occluded rays; compact traces only the
    # live prefix, padded to the tile.
    assert len({r["hits"] for r in rows}) == 1 and rows[0]["hits"] > 0
    live = rows[0]["live"]
    for r in rows:
        want = -(-live // 256) * 256 if r["name"].startswith(("compact", "cmp")) else 2048
        assert r["rays_traced"] == want and r["best_s"] > 0


def test_host_tools_main_rows():
    ps = packet_stats.main([SCENE, "512", "1024"], {"PS_MAX_PACKETS": "2"}, device="cpu",
                           cache_dir=None, width=64, height=32)
    assert [(r["tile"], r["packets"]) for r in ps] == [(512, 2), (1024, 2)]
    assert all(r["total_serial"] == r["node_visits"] + r["leaf_tri_steps"] for r in ps)
    ts = treelet_sim.main([SCENE, "ao", "32"], {"TS_WH": "64x32", "TS_TILE": "512",
                                                "TS_MAX_PACKETS": "2"},
                          device="cpu", cache_dir=None)
    assert [r["T"] for r in ts] == [None, 32] and ts[1]["portals"] >= 1
    assert ts[0]["steps_per_ray"] > 0 and ts[1]["steps_per_ray"] > 0


# ---------------------------------------------------------------------------
# quad_probe's and ao_probe's hit counts against the JAX tools'
# ---------------------------------------------------------------------------

def _port_ao_rays(flat, camera, width, height, max_dist):
    """The port's unsorted 1-sample AO rays of a frame, as its tools make
    them (a closest-hit trace of the primary rays on the binary tables)."""
    scene = Scene(procedural.scene_by_name(SCENE))
    rays = RayGen().primary(camera, width, height, device="cpu")[0]
    ph = trace_flat(upload_flat(flat, "cpu"), rays)
    return gen_ao_rays(rays.origin, rays.dirn, ph.t, ph.tri, torch.as_tensor(scene.tri_normal),
                       1, max_dist, 0)[0]


def _jax_rays_of(port_rays):
    """A stand-in for the JAX tools' ``gen_ao_rays`` that returns the port's
    rays, so that both tools trace the same rays."""
    rays = _t_rays([x.numpy() for x in port_rays])
    return lambda *args, **kw: (rays, None, None)


def test_ao_probe_hits_equal_tpu_rt_tool(flats, tmp_path, monkeypatch, capsys):
    # Both tools on knob's AO rays of a 128x64 frame (4 tiles of 2,048 rays):
    # every schedule, the tile / interleave ones included, finds the JAX
    # tool's hit count (its Pallas kernel in interpret mode; any hit holds
    # hit vs miss, tests/test_torch_flat_trace.py).
    t_ao = _tool("ao_probe", monkeypatch)
    _, flat = flats
    scene = Scene(procedural.scene_by_name(SCENE))
    lo, hi = scene.bbox()
    arays = _port_ao_rays(flat, Camera.for_bbox(lo, hi), 128, 64,
                          0.1 * float(np.linalg.norm(hi - lo)))
    monkeypatch.setattr(_SizedRayGen, "size", (128, 64))
    monkeypatch.setattr(t_ao, "RayGen", _SizedRayGen)
    monkeypatch.setattr(t_ao, "gen_ao_rays", _jax_rays_of(arays))
    monkeypatch.setattr(t_ao, "trace_packet2", functools.partial(t_ao.trace_packet2,
                                                                 interpret=True))
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    t_ao.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " hits " in ln]
    want = {ln.split(":")[0].strip(): int(ln.split(" hits ")[1].split()[0]) for ln in lines}
    assert list(want) == AO_SCHEDULES
    monkeypatch.setattr(ao_probe, "gen_ao_rays", lambda *a, **k: (arays, None, None))
    rows = ao_probe.main([SCENE], {}, device="cpu", cache_dir=None, width=128, height=64)
    assert {r["name"]: r["hits"] for r in rows} == want
    assert len(set(want.values())) == 1 and rows[0]["hits"] > 0
    by = {r["name"]: r for r in rows}
    assert (by["uns-t1024k8"]["tile"], by["uns-t1024k8"]["k"]) == (1024, 8)


def test_quad_probe_slot_settings_hits_equal_tpu_rt_tool(flats, tmp_path, monkeypatch):
    # QP_U4="3,4", QP_K="2", QP_TILE="512" on knob, primary and AO rays at
    # 64x32: one 4-wide row per U after the binary row, as the JAX tool
    # prints them, each with the JAX tool's hit count on the same rays
    # (its Pallas kernels in interpret mode with the same settings); every
    # row verified against the oracle.
    t_qp = _tool("quad_probe", monkeypatch)
    _, flat = flats
    scene = Scene(procedural.scene_by_name(SCENE))
    camera = suite_camera(SCENE, scene)
    arays = _port_ao_rays(flat, camera, 64, 32, suite_ao_radius(SCENE, scene))
    for name, value in (("U4_SWEEP", [3, 4]), ("K4", 2), ("TILE4", 512), ("CHAIN", 1),
                        ("REPEATS", 1), ("VERIFY", 256)):
        monkeypatch.setattr(t_qp, name, value)
    monkeypatch.setattr(t_qp, "RayGen", _SizedRayGen)
    monkeypatch.setattr(t_qp, "gen_ao_rays", _jax_rays_of(arays))
    want = []
    for fn in ("trace_packet2", "trace_packet4"):
        orig = functools.partial(getattr(t_qp, fn), interpret=True)

        def record(*args, orig=orig, **kw):
            out = orig(*args, **kw)
            if kw.get("count_iters"):
                want.append((kw.get("u"), int(np.sum(np.asarray(out[0].tri) >= 0))))
            return out

        monkeypatch.setattr(t_qp, fn, record)
    import tpu_rt.bench.workload as t_workload

    monkeypatch.setattr(t_workload, "FRAME_W", 64)
    monkeypatch.setattr(t_workload, "FRAME_H", 32)
    monkeypatch.setattr(sys, "argv", ["quad_probe.py", SCENE, "--types=primary,ao"])
    monkeypatch.chdir(tmp_path)
    t_qp.main()
    monkeypatch.setattr(quad_probe, "gen_ao_rays", lambda *a, **k: (arays, None, None))
    rows = quad_probe.main([SCENE, "--types=primary,ao"],
                           {"QP_U4": "3,4", "QP_K": "2", "QP_TILE": "512", "QP_CHAIN": "1",
                            "QP_REPEATS": "1", "QP_VERIFY": "256"},
                           device="cpu", cache_dir=None, width=64, height=32)
    assert [(r["ray_type"], r["kernel"], r.get("u")) for r in rows] == [
        (rt, kernel, u) for rt in ("primary", "ao")
        for kernel, u in (("flat_trace", None), ("quad_trace", 3), ("quad_trace", 4))]
    assert [(r.get("u"), r["hits"]) for r in rows] == want
    assert all(r["bad"] == 0 for r in rows) and rows[0]["hits"] > 0 and rows[3]["hits"] > 0
    assert all((r["k"], r["tile"]) == (2, 512) for r in rows if r["kernel"] == "quad_trace")
