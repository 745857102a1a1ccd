"""The port's table formats and placement policy against tpu_rt's: the
directed bf16 rounding, the bf16 node record, choose_node_format, the
residency rules and quad_policy (tune cache included) at tpu_rt's own
budget, the routed kinds with each override, the default budget, the rows
the plain versions record as read, and the card default of every entry
point."""

import inspect
import json
import os
import warnings

import numpy as np
import pytest
import torch

import tpu_rt.trace.packet2 as t_packet2
from tpu_rt.bvh import load_or_build_bvh
from tpu_rt.scene import Scene
from tpu_rt.scene import procedural
from tpu_rt.trace import make_routing_tracer as t_make_routing_tracer
from tpu_rt.trace import quad_policy as t_quad_policy

from tpu_rt_torch.bvh.collapse import collapse4
from tpu_rt_torch.core.types import Rays, make_rays
from tpu_rt_torch.raygen import RayGen
from tpu_rt_torch.renderer import RendererParams
from tpu_rt_torch.trace import flat_kernel, make_routing_tracer, quad_kernel
from tpu_rt_torch.trace.flat_kernel import decode_bf16_nodes, upload_flat
from tpu_rt_torch.trace.quad_kernel import upload_quad
from tpu_rt_torch.trace.tables import (
    RESIDENCIES,
    TABLE_BUDGET,
    VMEM_TABLE_BUDGET,
    _bf16_round_dir,
    _residency_flags,
    _tune_path,
    choose_node_format,
    pack_bf16_nodes,
    quad_policy,
    quad_residency,
    tables2_fit_vmem,
    tables2_residency,
)
from tpu_rt_torch.trace.wavefront import device_bvh


@pytest.fixture(scope="module")
def flat():
    scene = Scene(procedural.make_blob(700, seed=80))
    return load_or_build_bvh(scene, cache_dir=None)[0]


def _pallas_inputs():
    # tests/test_pallas.py test_bf16_round_dir_conservative's inputs.
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-20, 20, 4096),
        np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-40, -1e-40], np.float32),
    ])


def _widen(u16):
    return (np.asarray(u16, np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_bf16_round_dir_bit_equal(up):
    x = _pallas_inputs()
    got = _bf16_round_dir(x, up=up)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, t_packet2._bf16_round_dir(x, up=up))
    w = _widen(got)
    assert np.all(w >= x) if up else np.all(w <= x)


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_bf16_round_dir_nan_and_inf(up):
    bits = np.array([0x7F800001, 0xFF800001, 0x7FC00000, 0x7F801234, 0x7FFFFFFF, 0xFFC00000,
                     0x7F800000, 0xFF800000], np.uint32)
    x = bits.view(np.float32)
    got = _bf16_round_dir(x, up=up)
    nan = np.isnan(x)
    # A NaN stays NaN, sign kept; tpu_rt's truncation turns a NaN whose
    # payload lies in the low 16 bits into an infinity.
    assert np.all(np.isnan(_widen(got[nan])))
    np.testing.assert_array_equal(got[nan] >> 15, (bits[nan] >> 31).astype(np.uint16))
    assert np.isinf(_widen(t_packet2._bf16_round_dir(x[:1], up=up))).all()
    # Infinities are exact, as in tpu_rt.
    np.testing.assert_array_equal(got[~nan], t_packet2._bf16_round_dir(x[~nan], up=up))
    np.testing.assert_array_equal(_widen(got[~nan]), x[~nan])


def test_bf16_record_contains_f32_bounds(flat):
    nodes = np.asarray(flat.nodes, np.float32)
    rec = pack_bf16_nodes(nodes)
    assert rec.dtype == np.int32 and rec.shape == (nodes.shape[0], 8)
    dec = decode_bf16_nodes(torch.from_numpy(rec)).numpy()
    assert dec.shape == (nodes.shape[0], 16) and dec.dtype == np.float32
    # Lower bounds rounded down, upper bounds up; links verbatim.
    assert np.all(dec[:, 0:12:2] <= nodes[:, 0:12:2])
    assert np.all(dec[:, 1:12:2] >= nodes[:, 1:12:2])
    np.testing.assert_array_equal(rec[:, 6:8], nodes[:, 12:14].view(np.int32))
    np.testing.assert_array_equal(dec[:, 12:14].view(np.int32), nodes[:, 12:14].view(np.int32))
    assert not dec[:, 14:].any()
    # The bound words are pack_tables2's bf16 words (its layout transposed
    # into 128-lane blocks; its link words carry the hint bits instead).
    t_nodes = t_packet2.pack_tables2(flat, bf16_nodes=True)[0]
    t_rows = t_nodes.transpose(0, 2, 1).reshape(-1, 8)[:nodes.shape[0]]
    np.testing.assert_array_equal(rec[:, :6], t_rows[:, :6])


def _budgets(flat):
    """Budgets around every threshold of the binary and quad rules."""
    n = flat.nodes.shape[0]
    w = flat.tri_woop.shape[0] * 64
    edges = [n * 32, n * 64, n * 32 + w, n * 64 + w]
    return sorted({max(b + d, 0) for b in edges for d in (-1, 0, 1)} | {0, 1 << 40})


def test_binary_policy_equals_tpu_rt(flat, monkeypatch):
    seen = set()
    for budget in _budgets(flat):
        monkeypatch.setattr(t_packet2, "VMEM_TABLE_BUDGET", budget)
        got = choose_node_format(flat, budget)
        assert got == t_packet2.choose_node_format(flat), budget
        assert tables2_fit_vmem(flat, budget) == t_packet2.tables2_fit_vmem(flat)
        for bf16 in (False, True):
            assert (tables2_residency(flat, bf16, budget)
                    == t_packet2.tables2_residency(flat, bf16_nodes=bf16))
        seen.add(got)
    assert seen == {("vmem", False), ("vmem", True), ("mixed", False), ("mixed", True),
                    ("hbm", False)}
    for res in RESIDENCIES + (False, True):
        assert _residency_flags(res) == t_packet2._residency_flags(res)


def test_quad_policy_and_tune_cache_equal_tpu_rt(flat, monkeypatch, tmp_path):
    from tpu_rt.trace import _tune_path as t_tune_path

    n64 = flat.nodes.shape[0] * 64
    for budget in (n64 - 1, n64, VMEM_TABLE_BUDGET):
        monkeypatch.setattr(t_packet2, "VMEM_TABLE_BUDGET", budget)
        assert quad_policy(flat, None, budget) == t_quad_policy(flat) == (
            32 if budget < n64 else 16)
    cache = str(tmp_path)
    path, t_path = _tune_path(flat, cache), t_tune_path(flat, cache)
    assert path is not None and _tune_path(flat, None) is None
    assert os.path.dirname(path) == os.path.dirname(t_path) and path != t_path
    # A width tpu_rt's tool recorded routes tpu_rt, never the port.
    with open(t_path, "w") as f:
        f.write('{"leaf_max": 8}')
    assert t_quad_policy(flat, cache) == 8
    assert quad_policy(flat, cache, n64) == 16 and quad_policy(flat, cache, n64 - 1) == 32
    # The port's own file wins in the port, and tpu_rt does not read it.
    os.remove(t_path)
    with open(path, "w") as f:
        f.write('{"leaf_max": 8}')
    assert quad_policy(flat, cache, n64) == 8
    monkeypatch.setattr(t_packet2, "VMEM_TABLE_BUDGET", n64 - 1)
    assert t_quad_policy(flat, cache) == 32
    # A corrupt file, or one without leaf_max, gives the static rule in both
    # packages, silently.
    for text in ("not json", '{"width": 8}'):
        for p in (path, t_path):
            with open(p, "w") as f:
                f.write(text)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert quad_policy(flat, cache, n64 - 1) == t_quad_policy(flat, cache) == 32
    os.remove(t_path)
    # Out of range, or not an int: a warning naming the file and the value,
    # and the static rule.
    for bad in (0, 128, "x", 8.0, True):
        with open(path, "w") as f:
            json.dump({"leaf_max": bad}, f)
        with pytest.warns(RuntimeWarning, match=f"{os.path.basename(path)}.*{bad!r}"):
            assert quad_policy(flat, cache, n64 - 1) == 32
    for good in (1, 127):
        with open(path, "w") as f:
            json.dump({"leaf_max": good}, f)
        assert quad_policy(flat, cache, n64) == good


def test_routed_kinds_equal_tpu_rt(flat, monkeypatch):
    # tpu_rt's make_routing_tracer at a patched VMEM_TABLE_BUDGET, and the
    # port's at the same budget_bytes.  Both binary rules count the same
    # bytes, so the binary kinds agree at every budget; the quad rule is fed
    # tpu_rt's padded table sizes for equality, and the port's own tables
    # (unpadded) decide its kind.
    suffix = {"vmem": "", "mixed": "-mixed", "hbm": "-hbm"}
    for budget in _budgets(flat):
        monkeypatch.setattr(t_packet2, "VMEM_TABLE_BUDGET", budget)
        _, t_kind, _ = t_make_routing_tracer(flat, prefer="packet", interpret=True)
        _, kind, tables = make_routing_tracer(flat, prefer="packet", device="cpu",
                                              budget_bytes=budget)
        assert kind == "flat-plain" + t_kind[len("packet"):], budget
        res, bf16 = choose_node_format(flat, budget)
        assert (tables.residency, tables.bf16_nodes) == (res, bf16)
        assert kind == f"flat-plain{suffix[res]}" + ("-bf16" if bf16 else "")
        _, t_kind4, t_tables4 = t_make_routing_tracer(flat, prefer="packet4", interpret=True)
        t_bytes = [int(x.size) * 4 for x in t_tables4]
        assert t_kind4 == "packet4-" + quad_residency(*t_bytes, budget)
        _, kind4, tables4 = make_routing_tracer(flat, prefer="packet4", device="cpu",
                                                budget_bytes=budget)
        res4 = quad_residency(tables4.nodes.numel() * 4, tables4.woop.numel() * 4, budget)
        assert tables4.residency == res4 and kind4 == f"quad-plain{suffix[res4]}"


def test_routing_overrides_on_the_cpu(flat):
    kinds = set()
    for res in RESIDENCIES:
        for bf16 in (False, True):
            fn, kind, tables = make_routing_tracer(flat, prefer="packet", device="cpu",
                                                   residency=res, bf16_nodes=bf16)
            want = "flat-plain" + ("" if res == "vmem" else f"-{res}") + ("-bf16" if bf16 else "")
            assert kind == want and tables.residency == res and tables.bf16_nodes == bf16
            assert tables.nodes.shape[1] == (8 if bf16 else 16)
            assert tables.nodes.dtype == (torch.int32 if bf16 else torch.float32)
            kinds.add(kind)
        for prefer in ("auto", "packet4", "pallas"):
            _, kind, tables = make_routing_tracer(flat, prefer=prefer, device="cpu", residency=res)
            assert kind == "quad-plain" + ("" if res == "vmem" else f"-{res}")
            assert tables.residency == res
    assert len(kinds) == 6
    # A forced format takes its residency from the policy; a forced
    # residency its format.
    small = flat.nodes.shape[0] * 32
    _, kind, t = make_routing_tracer(flat, prefer="packet", device="cpu", bf16_nodes=True,
                                     budget_bytes=small)
    assert kind == "flat-plain-mixed-bf16" and (t.residency, t.bf16_nodes) == ("mixed", True)
    _, kind, t = make_routing_tracer(flat, prefer="packet", device="cpu", residency="hbm",
                                     budget_bytes=small)
    assert kind == "flat-plain-hbm-bf16"
    assert upload_flat(flat, "cpu").residency == "vmem"
    with pytest.raises(ValueError, match="residency"):
        upload_flat(flat, "cpu", residency="l2")
    # The leaf width follows the budget: 32 once the binary f32 node table
    # exceeds it.
    _, _, q16 = make_routing_tracer(flat, prefer="packet4", device="cpu")
    _, _, q32 = make_routing_tracer(flat, prefer="packet4", device="cpu",
                                    budget_bytes=flat.nodes.shape[0] * 64 - 1)
    assert q32.nodes.shape[0] < q16.nodes.shape[0] and q32.residency == "mixed"


def test_default_budget_routes_every_scene_to_vmem_f32(flat):
    # One default for every device: no budget, so vmem f32 tables and
    # 16-wide leaves however large the scene; tpu_rt's decisions need its
    # VMEM_TABLE_BUDGET passed.
    assert TABLE_BUDGET > 1 << 60
    assert choose_node_format(flat, TABLE_BUDGET) == ("vmem", False)
    assert quad_policy(flat, None, TABLE_BUDGET) == 16
    t = upload_flat(flat, "cpu")
    assert (t.residency, t.bf16_nodes) == ("vmem", False)
    assert upload_quad(collapse4(flat), "cpu").residency == "vmem"
    for prefer, want in (("packet", "flat-plain"), ("auto", "quad-plain"),
                         ("packet4", "quad-plain"), ("pallas", "quad-plain")):
        _, kind, tables = make_routing_tracer(flat, prefer=prefer, device="cpu")
        assert kind == want and tables.residency == "vmem", prefer
    _, _, q = make_routing_tracer(flat, prefer="packet4", device="cpu")
    assert q.nodes.shape[0] == collapse4(flat, leaf_max=16).nodes.shape[0]


def _visit_rays(flat, n, seed):
    # From around the root's box (cols: _LO / _HI of flat_kernel) at it.
    rng = np.random.default_rng(seed)
    nodes = np.asarray(flat.nodes, np.float32)
    lo = np.array([min(nodes[0, 0], nodes[0, 4]), min(nodes[0, 2], nodes[0, 6]),
                   min(nodes[0, 8], nodes[0, 10])], np.float32)
    hi = np.array([max(nodes[0, 1], nodes[0, 5]), max(nodes[0, 3], nodes[0, 7]),
                   max(nodes[0, 9], nodes[0, 11])], np.float32)
    size = float(np.linalg.norm(hi - lo))
    o = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    d = rng.uniform(lo, hi, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    tmax[::5] = -1.0
    return make_rays(o, d, np.zeros(n, np.float32), tmax, device="cpu")


@pytest.mark.parametrize("tree", ["binary f32", "binary bf16", "quad"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_records_the_rows_it_reads(flat, tree, any_hit):
    # A ray reads a node row once per node test and a Woop row once per
    # triangle test (no row twice: the leaves' row ranges are disjoint), so
    # for one ray the rows marked equal its counters; a batch marks the
    # union of its rays' rows, and the results do not change.
    if tree == "quad":
        tables, plain = upload_quad(collapse4(flat), "cpu"), quad_kernel.trace_quad_plain
    else:
        tables = upload_flat(flat, "cpu", "vmem", tree == "binary bf16")
        plain = flat_kernel.trace_flat_plain
    rays = _visit_rays(flat, 48, seed=5)
    want, cnt = plain(tables, rays, any_hit, True, True)
    seen = {}
    got, cnt2 = plain(tables, rays, any_hit, True, True, visited=seen)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert all(torch.equal(cnt[k], cnt2[k]) for k in cnt)
    names = {"nodes", "woop"} | ({"leaf_counts"} if tree != "quad" else set())
    assert set(seen) == names
    assert seen["nodes"].shape[0] == tables.nodes.shape[0]
    assert seen["woop"].shape[0] == tables.woop.shape[0]
    union = {k: torch.zeros_like(v) for k, v in seen.items()}
    for i in range(rays.num):
        one = {}
        plain(tables, Rays(*(x[i:i + 1] for x in rays)), any_hit, False, True, visited=one)
        assert int(one["nodes"].sum()) == int(cnt["node_tests"][i])
        assert int(one["woop"].sum()) == int(cnt["tri_tests"][i])
        for k in union:
            union[k] |= one[k]
    for k in union:
        assert torch.equal(union[k], seen[k]), k
    assert bool(seen["nodes"][0]) and int(seen["woop"].sum()) > 0


def test_entry_points_default_to_the_card(flat):
    defaults = {
        "make_routing_tracer": inspect.signature(make_routing_tracer).parameters["device"].default,
        "RayGen.primary": inspect.signature(RayGen.primary).parameters["device"].default,
        "device_bvh": inspect.signature(device_bvh).parameters["device"].default,
        "make_rays": inspect.signature(make_rays).parameters["device"].default,
        "RendererParams": RendererParams().device,
    }
    assert set(defaults.values()) == {"cuda"}, defaults
    if not torch.cuda.is_available():
        # Without a card the default raises, as torch does; nothing falls
        # back to the CPU.
        with pytest.raises((AssertionError, RuntimeError)):
            make_rays(np.zeros((1, 3)), np.ones((1, 3)), [0.0], [1.0])
        with pytest.raises((AssertionError, RuntimeError)):
            device_bvh(flat)


def test_wrappers_refuse_cpu_tensors_in_every_layout(flat):
    rays = make_rays(np.zeros((4, 3)), np.ones((4, 3)), np.zeros(4), np.ones(4), device="cpu")
    for res in RESIDENCIES:
        for bf16 in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                flat_kernel.KERNEL(upload_flat(flat, "cpu", res, bf16), rays)
        with pytest.raises(ValueError, match="CUDA"):
            quad_kernel.KERNEL(upload_quad(collapse4(flat), "cpu", res), rays, any_hit=True)
