"""The binary tracer's tensor-core leaf test (tpu_rt's MXU triangle unit) in
its plain version, on tables tpu_rt built: against tpu_rt's
``trace_packet2(mxu=True)`` (interpret mode) and the oracle with
test_pallas.py's tolerances; the tie rule and u, v on a hand-built leaf;
what refuses it; Renderer frames with ``mxu`` and ``cursors``; and the
plain versions of the ablation probe against a lane-by-lane reading of the
kernel."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.core.types import make_rays as t_make_rays
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace import trace_flat_scalar
from tpu_rt.trace.packet2 import trace_packet2

from tpu_rt_torch.bench.workload import suite_ao_radius, suite_camera
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.probes import mxu_ablate
from tpu_rt_torch.renderer import Renderer, RendererParams
from tpu_rt_torch.scene import Scene as PScene
from tpu_rt_torch.scene import procedural as p_proc
from tpu_rt_torch.trace import make_routing_tracer
from tpu_rt_torch.trace import trace_flat_scalar as p_trace_flat_scalar
from tpu_rt_torch.trace.common import woop_rows
from tpu_rt_torch.trace.flat_kernel import trace_flat, trace_flat_plain, upload_flat

SCENES = {
    "blob": lambda: procedural.make_blob(700, seed=80),
    "interior": lambda: procedural.make_interior(900, seed=81),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def setup(request):
    scene = Scene(SCENES[request.param]())
    flat, _ = load_or_build_bvh(scene, cache_dir=None)
    return scene, flat, upload_flat(flat, "cpu", "vmem", False)


def _rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    short = slice(n // 2, n)
    origin[short] = rng.uniform(lo, hi, (n - n // 2, 3)).astype(np.float32)
    tmax[short] = np.float32(0.15 * size)
    tmax[::9] = -1.0
    return origin, d, np.zeros(n, np.float32), tmax


def _agree(got_tri, got_t, want_tri, want_t):
    """test_pallas.py's rule for the MXU unit: more than 0.999 of the ids
    equal, t to rtol 1e-4, atol 1e-5 where they agree on a hit."""
    agree = got_tri == want_tri
    assert agree.mean() > 0.999, agree.mean()
    hit = agree & (want_tri >= 0)
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cursors", [1, 2])
def test_mxu_matches_packet2_mxu_and_the_oracle(setup, cursors):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 2 * 512 + 99, seed=7)
    want = trace_packet2(flat, t_make_rays(o, d, tmin, tmax), interpret=True, tile=512, k=2,
                         mxu=True, c=cursors)
    got, counts = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"),
                                   want_uv=True, with_stats=True, mxu=True, cursors=cursors)
    tri, t = got.tri.numpy(), got.t.numpy()
    _agree(tri, t, np.asarray(want.tri), np.asarray(want.t))
    s_id, s_t, s_u, s_v = trace_flat_scalar(flat, o, d, tmin, tmax)
    _agree(tri, t, s_id, s_t)
    both = (tri == s_id) & (s_id >= 0)
    # u = Ox + t Dx cancels: an error of t's order times |Dx| (no tolerance
    # of tpu_rt's covers u, v of the MXU unit).
    np.testing.assert_allclose(got.u.numpy()[both], s_u[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[both], s_v[both], rtol=0, atol=1e-4)
    # A whole leaf per test: at least the scalar drain's triangle tests.
    _, scalar = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"),
                                 with_stats=True, cursors=cursors)
    assert int(counts["tri_tests"].sum()) >= int(scalar["tri_tests"].sum())


def test_mxu_any_hit_matches_the_oracle(setup):
    scene, flat, tables = setup
    o, d, tmin, tmax = _rays(scene, 1200, seed=8)
    got = trace_flat_plain(tables, make_rays(o, d, tmin, tmax, device="cpu"), any_hit=True,
                           mxu=True, cursors=3)
    s_id, _, _, _ = trace_flat_scalar(flat, o, d, tmin, tmax, any_hit=True)
    assert np.mean((got.tri.numpy() >= 0) == (s_id >= 0)) > 0.999


def _one_leaf(ids):
    """A FlatBVH of one inner node over one leaf of Woop rows in the plane
    z = 0 whose t along -z is the same to the bit: even rows give u = x,
    v = y, odd rows u = y, v = x.  The other child is an empty leaf."""
    wz = [0.0, 0.0, 1.0, 0.0]
    rows = np.array([wz + ([1, 0, 0, 0] + [0, 1, 0, 0] if i % 2 == 0 else
                           [0, 1, 0, 0] + [1, 0, 0, 0]) for i in range(len(ids))], np.float32)
    node = np.zeros((1, 16), np.float32)
    node[0, :12] = [-1, 2, -1, 2, 10, 11, 10, 11, -1, 2, 10, 11]
    node[0, 12:14] = np.array([~0, ~len(ids)], np.int32).view(np.float32)
    counts = np.ones(len(ids) + 1, np.int32)
    counts[0], counts[-1] = len(ids), 0
    return SimpleNamespace(nodes=node, tri_woop=rows, tri_index=np.array(ids, np.int32),
                           leaf_counts=counts)


@pytest.mark.parametrize("ids", [(5, 9), (9, 5)])
def test_mxu_ties_go_to_the_largest_id_with_its_u_v(ids):
    flat = _one_leaf(ids)
    tables = upload_flat(flat, "cpu", "vmem", False)
    o = np.array([[0.2, 0.3, 1.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0]], np.float32)
    rays = make_rays(o, d, np.zeros(1, np.float32), np.full(1, 10.0, np.float32), device="cpu")
    mxu = trace_flat(tables, rays, want_uv=True, mxu=True)
    scalar = trace_flat(tables, rays, want_uv=True)
    oracle = p_trace_flat_scalar(flat, o, d, np.zeros(1, np.float32), np.full(1, 10.0, np.float32))
    assert float(mxu.t[0]) == float(scalar.t[0]) == 1.0
    # The scalar drain keeps the first row tested (a strict <), as the
    # oracle; the MXU unit's leaf winner is the largest id (packet2.py
    # :836-862), with u, v of that same row.
    assert int(scalar.tri[0]) == oracle[0][0] == ids[0]
    assert (float(scalar.u[0]), float(scalar.v[0])) == (np.float32(0.2), np.float32(0.3))
    assert int(mxu.tri[0]) == 9
    want_uv = (0.2, 0.3) if ids[0] == 9 else (0.3, 0.2)
    assert (float(mxu.u[0]), float(mxu.v[0])) == tuple(np.float32(want_uv))


def test_mxu_refuses_wide_leaves_and_quad_routes(setup):
    wide = _one_leaf(tuple(range(9)))
    tables = upload_flat(wide, "cpu", "vmem", False)
    assert tables.max_leaf == 9
    rays = make_rays(np.array([[0.2, 0.3, 1.0]], np.float32), np.array([[0, 0, -1]], np.float32),
                     np.zeros(1, np.float32), np.full(1, 10.0, np.float32), device="cpu")
    assert int(trace_flat(tables, rays).tri[0]) == 0     # the scalar drain takes any leaf
    with pytest.raises(ValueError, match="at most 8"):
        trace_flat(tables, rays, mxu=True)
    with pytest.raises(ValueError, match="at most 8"):
        make_routing_tracer(wide, "packet", "cpu", mxu=True)
    _, flat, _ = setup
    for prefer in ("packet4", "auto", "pallas", "xla"):
        with pytest.raises(ValueError, match="mxu"):
            make_routing_tracer(flat, prefer, "cpu", mxu=True)
    with pytest.raises(ValueError, match="mxu"):
        Renderer(8, 6, RendererParams(tracer="auto", mxu=True, device="cpu"))
    fn, kind, t = make_routing_tracer(flat, "packet", "cpu", mxu=True, cursors=2)
    assert kind == "flat-plain-mxu-c2" and t.max_leaf <= 8


# Frames at 64x48 with the triangle-phase options, against the default
# route's, disputed pixels adjudicated by the oracle.
W, H = 64, 48
OPTIONS = {"mxu": {"mxu": True}, "c2": {"cursors": 2}, "mxu-c3": {"mxu": True, "cursors": 3}}


@pytest.fixture(scope="module")
def blob():
    scene = PScene(p_proc.make_blob(700, seed=80))
    return scene, suite_camera("bunny", scene), suite_ao_radius("bunny", scene)


def _frame(blob, ray_type, **kw):
    scene, camera, radius = blob
    r = Renderer(W, H, RendererParams(ray_type=ray_type, num_samples=4, ao_radius=radius,
                                      max_batch=4096, cache_dir=None, device="cpu",
                                      tracer="packet", **kw))
    r.set_scene(scene)
    stats = r.render_frame(camera)
    return r, stats, r.update_result()


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_primary_frame_with_the_triangle_phase_options(blob, option):
    base, _, base_img = _frame(blob, "primary")
    r, stats, img = _frame(blob, "primary", **OPTIONS[option])
    kind = "flat-plain" + ("-mxu" if "mxu" in option else "") + (
        f"-c{OPTIONS[option]['cursors']}" if "cursors" in OPTIONS[option] else "")
    assert stats["tracer"] == kind
    # Per-pixel ids of both frames; where they differ, the option's hit
    # against the oracle's: an exact tie (t within fp noise) or an edge
    # graze, else wrong.
    slot = r.primary.id_to_slot.numpy()
    tri, base_tri = r.primary.hits.tri.numpy()[slot], base.primary.hits.tri.numpy()[slot]
    differ = tri != base_tri
    same = ~differ
    np.testing.assert_array_equal(img.reshape(-1, 4)[same], base_img.reshape(-1, 4)[same])
    ids = np.nonzero(differ)[0]
    if ids.size:
        rays = r.primary.rays
        s = slot[ids]
        s_id, s_t, s_u, s_v = p_trace_flat_scalar(r.flat, *(x.numpy()[s] for x in rays))
        t = r.primary.hits.t.numpy()[s]
        tie = np.isclose(t, s_t, rtol=2e-4, atol=1e-5)
        graze = (s_id >= 0) & (np.minimum(np.minimum(s_u, s_v), 1 - s_u - s_v) < 1e-3)
        assert (tie | graze).all(), ids[~(tie | graze)]
    assert differ.sum() <= 3
    if "mxu" not in option:
        np.testing.assert_array_equal(r.primary.hits.t.numpy(), base.primary.hits.t.numpy())


@pytest.mark.parametrize("option", ["mxu", "c2"])
def test_ao_frame_with_the_triangle_phase_options(blob, option):
    base, base_stats, base_img = _frame(blob, "ao")
    r, stats, img = _frame(blob, "ao", **OPTIONS[option])
    assert stats["batches"] == base_stats["batches"] == 3
    got, want = r.frame_sample_tri().numpy() >= 0, base.frame_sample_tri().numpy() >= 0
    # Hit / miss per sample; the MXU unit may flip a sample that grazes an
    # edge (its primary hit may move too).
    assert np.mean(got == want) > 0.999
    if option == "c2":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(img, base_img)


# The probe's plain versions against a lane-by-lane reading of
# mxu_ablate.cu: the scalar drain row by row in numpy f32, and the mma
# fragments of noM and epi0 lane by lane.

@pytest.fixture(scope="module")
def probe():
    scene = PScene(p_proc.make_blob(700, seed=80))
    from tpu_rt_torch.bvh import load_or_build_bvh as p_load

    flat, _ = p_load(scene, cache_dir=None)
    woop = torch.tensor(woop_rows(flat.tri_woop, flat.tri_index))
    rays = mxu_ablate.probe_rays(scene, 64, 3, "cpu")
    return flat, woop, rays


def _lane_products(a, b_o, b_d, j, lane, mode):
    """(row, column, value) pairs lane ``lane`` writes for tile ``j``:
    D[l >> 2][8 j + 2 (l & 3) + i] of each product p."""
    m, k = lane >> 2, lane & 3
    out = []
    for p in range(6):
        b = (b_d if p % 2 else b_o)[k][8 * j + m]
        if mode == "mma":
            col = 8 * j + 2 * k
            out += [(p, m, col, sum(a[p][m][kk] * (b_d if p % 2 else b_o)[kk][col]
                                    for kk in range(4))),
                    (p, m, col + 1, sum(a[p][m][kk] * (b_d if p % 2 else b_o)[kk][col + 1]
                                        for kk in range(4)))]
        else:
            out += [(p, m, 8 * j + 2 * k, a[p][m][k] + b), (p, m, 8 * j + 2 * k + 1, a[p][m][k] - b)]
    return out


def _woop_tuv(row, o, d, mxu):
    """t, u, v of one Woop row along one ray in f32: the scalar drain's ops
    in the oracle's order, or (``mxu``) each dot product in f64 rounded
    once, t = Oz / Dz."""
    o0, o1, o2 = o
    d0, d1, d2 = d
    if not mxu:
        oz = row[3] - o0 * row[0] - o1 * row[1] - o2 * row[2]
        dz = d0 * row[0] + d1 * row[1] + d2 * row[2]
        t = oz * (np.float32(1) / dz)
        ox = row[7] + o0 * row[4] + o1 * row[5] + o2 * row[6]
        dx = d0 * row[4] + d1 * row[5] + d2 * row[6]
        oy = row[11] + o0 * row[8] + o1 * row[9] + o2 * row[10]
        dy = d0 * row[8] + d1 * row[9] + d2 * row[10]
        return t, ox + t * dx, oy + t * dy
    r64, o64, d64 = row.astype(np.float64), o.astype(np.float64), d.astype(np.float64)
    oz, dz = np.float32(r64[3] - o64 @ r64[0:3]), np.float32(d64 @ r64[0:3])
    ox, dx = np.float32(r64[7] + o64 @ r64[4:7]), np.float32(d64 @ r64[4:7])
    oy, dy = np.float32(r64[11] + o64 @ r64[8:11]), np.float32(d64 @ r64[8:11])
    t = oz / dz
    return t, ox + t * dx, oy + t * dy


def _warp_inputs(woop, rays, first, w):
    rows = woop[first:first + 8].double().numpy()
    a = np.zeros((6, 8, 4))
    for m in range(8):
        wz, wx, wy = rows[m, 0:4], rows[m, 4:8], rows[m, 8:12]
        a[:, m] = [[-wz[0], -wz[1], -wz[2], wz[3]], [wz[0], wz[1], wz[2], 0],
                   list(wx), [wx[0], wx[1], wx[2], 0], list(wy), [wy[0], wy[1], wy[2], 0]]
    o = rays.origin[32 * w:32 * w + 32].double().numpy()
    dd = rays.dirn[32 * w:32 * w + 32].double().numpy()
    b_o = np.concatenate((o, np.ones((32, 1))), 1).T
    b_d = np.concatenate((dd, np.zeros((32, 1))), 1).T
    return a, b_o, b_d


@pytest.mark.parametrize("variant", mxu_ablate.VARIANTS)
def test_probe_plain_versions(probe, variant):
    flat, woop, rays = probe
    niter = 2
    acc_t, acc_tri = mxu_ablate.ablate(variant, woop, rays, niter)
    assert acc_t.shape == acc_tri.shape == (64,) and torch.isfinite(acc_t).all()
    w_np = woop.numpy()
    span = woop.shape[0] - 7
    want_t = np.zeros(64, np.float32)
    want_tri = np.zeros(64, np.int64)
    want_d = np.zeros(64)
    for w in range(2):
        for i in range(niter):
            first = 0 if variant == "noL" else (7 * i + w) % span
            if variant in ("scalar", "full", "noL"):
                # Each ray's closest hit among the 8 rows (the oracle's
                # Woop test in f32 for the scalar drain).
                for lane in range(32):
                    r = 32 * w + lane
                    o, d = rays.origin[r].numpy(), rays.dirn[r].numpy()
                    best_t, best_id = rays.tmax[r].numpy(), -1
                    for m in range(8):
                        row = w_np[first + m]
                        t, u, v = _woop_tuv(row, o, d, variant != "scalar")
                        tid = int(row[12:13].view(np.int32)[0])
                        ok = t > 0 and t < rays.tmax[r].numpy() and u >= 0 and v >= 0 \
                            and u + v <= 1
                        if ok and (t < best_t or (variant != "scalar" and t == best_t
                                                  and tid > best_id)):
                            best_t, best_id = t, tid
                    want_t[r] += np.float32(best_t)
                    want_tri[r] += best_id + 1
                continue
            a, b_o, b_d = _warp_inputs(woop, rays, first, w)
            if variant == "epi0":
                for lane in range(32):
                    for j in range(4):
                        vals = [x[3] for x in _lane_products(a, b_o, b_d, j, lane, "mma")]
                        for p in range(6):
                            want_d[32 * w + lane] += vals[2 * p] + vals[2 * p + 1]
                continue
            out = np.zeros((6, 8, 32), np.float32)
            for lane in range(32):
                for j in range(4):
                    for p, m, col, val in _lane_products(a, b_o, b_d, j, lane, "noM"):
                        out[p, m, col] = np.float32(val)
            for lane in range(32):
                r = 32 * w + lane
                best_t, best_id = np.float32(np.inf), -1
                for m in range(8):
                    with np.errstate(divide="ignore", invalid="ignore"):
                        t = out[0, m, lane] / out[1, m, lane]
                        u = out[2, m, lane] + t * out[3, m, lane]
                        v = out[4, m, lane] + t * out[5, m, lane]
                    tid = int(w_np[first + m, 12:13].view(np.int32)[0])
                    if t > 0 and t < rays.tmax[r].numpy() and u >= 0 and v >= 0 and u + v <= 1 \
                            and (t < best_t or (t == best_t and tid > best_id)):
                        best_t, best_id = t, tid
                take = best_t < rays.tmax[r].numpy()
                want_t[r] += best_t if take else rays.tmax[r].numpy()
                want_tri[r] += best_id + 1 if take else 0
    if variant == "epi0":
        np.testing.assert_allclose(acc_t.numpy(), want_d.astype(np.float32), rtol=1e-6)
        assert (acc_tri.numpy() == 0).all()
    else:
        np.testing.assert_allclose(acc_t.numpy(), want_t, rtol=1e-6)
        np.testing.assert_array_equal(acc_tri.numpy(), want_tri)
