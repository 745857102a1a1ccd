"""The traversal kernels' CUDA sources, run on the CPU: ``csrc/quad_trace.cu``,
``quad_trace_c.cu``, ``flat_trace.cu``, ``flat_trace_c.cu``,
``flat_trace_mxu.cu`` and the probe ``mxu_ablate.cu`` built with g++
against ``tests/cuda_emulation/cuda_runtime.h`` (every lane of a warp a
thread, the warp intrinsics and the FP64 mma barriers of the warp), and
launched through their C ABI with the wrappers' ctypes ``argtypes``.  Every
form (closest and any hit, uv, counters, postponed leaves, the tensor-core
leaf test at 1-4 cursors, f32 and bf16 nodes, the residencies) of the
persistent kernels, their shared-memory stack and the first versions, give
the plain PyTorch version's hits and counters bit for bit, on rays from
outside and inside two scenes, at ray counts that fill warps and that do
not; the launch shape is ``persistent_grid``'s and ``shared_stack_bytes``'
(``MXU_SMEM`` for the tensor-core form).  Every variant of the probe gives
its plain version's accumulators bit for bit.  The card runs the same
checks at full size in ``chip_smoke.py``."""

import ctypes
import os
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.bvh.collapse import collapse4
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import common
from tpu_rt_torch.trace.common import DESIGNS, persistent_grid, shared_stack_bytes
from tpu_rt_torch.probes import mxu_ablate
from tpu_rt_torch.trace.flat_kernel import (
    MXU_SMEM,
    FlatMxuKernel,
    FlatTraceKernel,
    trace_flat_plain,
    upload_flat,
)
from tpu_rt_torch.trace.quad_kernel import QuadTraceKernel, trace_quad_plain, upload_quad
from tpu_rt_torch.trace.tables import _residency_flags

HERE = os.path.dirname(os.path.abspath(__file__))
LIBS = ("quad_trace", "quad_trace_c", "flat_trace", "flat_trace_c", "flat_trace_mxu",
        "mxu_ablate")
SMS, PER_SM = 2, 2      # what the emulated launches see
SCENES = {"blob": lambda: procedural.make_blob(700, seed=80),
          "interior": lambda: procedural.make_interior(900, seed=81)}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{library: ctypes library}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels for the host")
    out_dir = tmp_path_factory.mktemp("cuda_emulation")
    procs = {}
    # The card's build's -D flags (the stack size).
    defines = [f for f in common.NVCC_FLAGS if f.startswith("-D")]
    for lib in LIBS:
        so = os.path.join(out_dir, f"lib{lib}.so")
        cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
               "-I", os.path.join(HERE, "cuda_emulation"), *defines,
               "-x", "c++", os.path.join(common.CSRC, f"{lib}.cu"),
               "-x", "c++", os.path.join(HERE, "cuda_emulation", "sim.cpp"), "-o", so]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), so)
    out = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"building {key} for the host failed:\n{log[-4000:]}"
        out[key] = ctypes.CDLL(so)
        out[key].sim_config(SMS, PER_SM)
    return out


def _rays(scene, n, seed):
    """Rays from around the scene at it (the first 8 straight down, one
    with -0.0), and short AO-like rays from inside it in the second half;
    tmax = -1 on every 7th."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:8] = np.array([0.0, -0.0, -1.0], np.float32)
    tmax = np.full(n, 4 * size, np.float32)
    inside = slice(n // 2, n)
    origin[inside] = rng.uniform(lo, hi, (n - n // 2, 3)).astype(np.float32)
    tmax[inside] = np.float32(0.15 * size)
    tmax[::7] = -1.0
    return make_rays(origin, d, np.zeros(n, np.float32), tmax, device="cpu")


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        scene = Scene(SCENES[name]())
        flat, _ = load_or_build_bvh(scene, cache_dir=None)
        _SCENES[name] = (scene, flat, collapse4(flat))
    return _SCENES[name]


def _tables(name, kernel, residency="vmem", bf16=False):
    """(tables, table arguments of the C ABI, stack need, wrapper); kernel
    "quad", "flat" or "mxu" (the binary tables, the tensor-core library)."""
    _, flat, quad = _scene(name)
    if kernel == "quad":
        t = upload_quad(quad, "cpu", residency)
        return (t, [t.nodes.data_ptr(), t.nodes.shape[0], t.woop.data_ptr()], 3 * t.depth,
                QuadTraceKernel())
    t = upload_flat(flat, "cpu", residency, bf16)
    return (t, [t.nodes.data_ptr(), t.nodes.shape[0], int(bf16), t.woop.data_ptr(),
                t.leaf_counts.data_ptr(), t.leaf_counts.shape[0]], t.depth,
            FlatMxuKernel() if kernel == "mxu" else FlatTraceKernel())


def _lib(kernel, cursors):
    """The library of a kernel kind and cursor count."""
    if kernel == "mxu":
        return "flat_trace_mxu"
    return f"{kernel}_trace" + ("_c" if cursors > 1 else "")


def _launch(lib, wrapper, name, table_args, need, rays, any_hit, uv, stats, cursors, design,
            residency):
    """One launch through the C ABI; returns (error, outputs, shape, counter)."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = wrapper.argtypes
    fn.restype = ctypes.c_int
    n = rays.origin.shape[0]
    tri = torch.full((n,), 12345, dtype=torch.int32)
    t = torch.full((n,), 7.0)
    u, v = torch.full((n,), 9.0), torch.full((n,), 9.0)
    nt, tt = torch.full((n,), -5, dtype=torch.int32), torch.full((n,), -5, dtype=torch.int32)
    counter = torch.full((1,), 77, dtype=torch.int32)
    shape = (ctypes.c_int * 4)(-1, -1, -1, -1)
    sn, st = _residency_flags(residency)
    err = fn(*table_args, rays.origin.data_ptr(), rays.dirn.data_ptr(), rays.tmin.data_ptr(),
             rays.tmax.data_ptr(), tri.data_ptr(), t.data_ptr(),
             u.data_ptr() if uv else None, v.data_ptr() if uv else None,
             nt.data_ptr() if stats else None, tt.data_ptr() if stats else None, n, cursors,
             int(any_hit), int(uv), int(stats), int(sn), int(st), 0, 0, DESIGNS[design], need,
             counter.data_ptr(), ctypes.addressof(shape), None)
    return err, (tri, t, u, v, nt, tt), list(shape), int(counter[0])


_PLAIN = {}


def _plain(name, kernel, tables, rays, any_hit, cursors, key):
    if key not in _PLAIN:
        if kernel == "quad":
            _PLAIN[key] = trace_quad_plain(tables, rays, any_hit, True, True, cursors=cursors)
        else:
            _PLAIN[key] = trace_flat_plain(tables, rays, any_hit, True, True, cursors=cursors,
                                           mxu=kernel == "mxu")
    return _PLAIN[key]


def _bits(x):
    return x.view(torch.int32)


CASES = []
for _kernel in ("quad", "flat"):
    for _any in (False, True):
        for _design in ("persistent", "first", "shared_stack"):
            CASES.append((_kernel, 1, _any, False, False, _design, "vmem", False))
        for _uv, _stats in ((True, False), (False, True), (True, True)):
            CASES.append((_kernel, 1, _any, _uv, _stats, "persistent", "vmem", False))
        for _c in (2, 3, 4):
            CASES.append((_kernel, _c, _any, False, False, "persistent", "vmem", False))
            CASES.append((_kernel, _c, _any, True, True, "persistent", "vmem", False))
    CASES.append((_kernel, 1, True, True, True, "persistent", "hbm", False))
    CASES.append((_kernel, 2, False, False, True, "persistent", "mixed", False))
for _any in (False, True):
    CASES.append(("flat", 1, _any, False, False, "persistent", "vmem", True))
    CASES.append(("flat", 3, _any, True, True, "persistent", "hbm", True))
# The tensor-core form: both designs, every form at 1 cursor, frame and
# full forms at 2-4, and the other node format and residencies.
for _any in (False, True):
    for _design in ("persistent", "first"):
        CASES.append(("mxu", 1, _any, False, False, _design, "vmem", False))
    for _uv, _stats in ((True, False), (False, True), (True, True)):
        CASES.append(("mxu", 1, _any, _uv, _stats, "persistent", "vmem", False))
    for _c in (2, 3, 4):
        CASES.append(("mxu", _c, _any, False, False, "persistent", "vmem", False))
        CASES.append(("mxu", _c, _any, True, True, "persistent", "vmem", False))
    CASES.append(("mxu", 1, _any, False, False, "persistent", "vmem", True))
    CASES.append(("mxu", 2, _any, True, True, "persistent", "mixed", False))
    CASES.append(("mxu", 3, _any, False, True, "persistent", "hbm", False))
    CASES.append(("mxu", 4, _any, True, True, "persistent", "hbm", True))
    CASES.append(("mxu", 1, _any, True, False, "persistent", "mixed", True))


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("kernel, cursors, any_hit, uv, stats, design, residency, bf16", CASES)
def test_kernel_equals_plain(libs, scene, kernel, cursors, any_hit, uv, stats, design,
                             residency, bf16):
    tables, targs, need, wrapper = _tables(scene, kernel, residency, bf16)
    rays = _rays(_scene(scene)[0], 700, 3)
    lib = _lib(kernel, cursors)
    err, got, shape, counter = _launch(libs[lib], wrapper, lib, targs, need, rays, any_hit, uv,
                                       stats, cursors, design, residency)
    assert err == 0
    want, want_cnt = _plain(scene, kernel, tables, rays, any_hit, cursors,
                            (scene, kernel, residency, bf16, any_hit, cursors))
    tri, t, u, v, nt, tt = got
    assert torch.equal(tri, want.tri)
    assert torch.equal(_bits(t), _bits(want.t))
    if uv:
        assert torch.equal(_bits(u), _bits(want.u)) and torch.equal(_bits(v), _bits(want.v))
    if stats:
        assert torch.equal(nt, want_cnt["node_tests"])
        assert torch.equal(tt, want_cnt["tri_tests"])
    n = rays.origin.shape[0]
    smem = MXU_SMEM[design] if kernel == "mxu" else (
        shared_stack_bytes(need) if design == "shared_stack" else 0)
    if design == "first":
        assert shape == [-(-n // 128), 0, smem, SMS]
    else:
        assert shape == [persistent_grid(n, SMS, PER_SM), PER_SM, smem, SMS]
        # The pool was zeroed by the launch and handed out past n.
        assert counter >= n


@pytest.mark.parametrize("kernel", ["flat", "mxu"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 300])
def test_partial_warps_and_pool(libs, n, kernel):
    # Fewer rays than a warp, or than the grid's lanes: every ray is traced
    # once, by whichever warp takes it.
    tables, targs, need, wrapper = _tables("interior", kernel)
    rays = _rays(_scene("interior")[0], max(n, 1), 11)
    if n == 0:
        rays = make_rays(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0),
                         device="cpu")
    lib = _lib(kernel, 1)
    for any_hit in (False, True):
        err, got, shape, _ = _launch(libs[lib], wrapper, lib, targs, need, rays, any_hit, False,
                                     False, 1, "persistent", "vmem")
        assert err == 0
        if n == 0:
            assert shape == [-1, -1, -1, -1]   # nothing launched
            continue
        want = trace_flat_plain(tables, rays, any_hit, mxu=kernel == "mxu")
        assert torch.equal(got[0], want.tri) and torch.equal(_bits(got[1]), _bits(want.t))
        assert shape[0] == persistent_grid(n, SMS, PER_SM)


def _tie_leaf(ids):
    """A FlatBVH of one inner node over one leaf of Woop rows in the plane
    z = 0, whose t along -z is the same to the bit for every row: even rows
    give u = x, v = y, odd rows u = y, v = x.  The other child is an empty
    leaf."""
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


@pytest.mark.parametrize("ids", [(5, 9), (9, 5), (3, 9, 9, 1, 7, 9, 2, 8),
                                 (9, 9, 3, 1, 7, 2, 8, 5), (9, 1, 2, 9, 3, 4, 5, 6),
                                 (9, 1, 2, 3, 4, 9, 5, 6)])
@pytest.mark.parametrize("design", ["persistent", "first"])
def test_mxu_tie_rule(libs, ids, design):
    # Every candidate of the leaf ties in t on every ray: the winner is the
    # largest id, and of equal ids the first row, with that row's u, v.
    flat = _tie_leaf(ids)
    tables = upload_flat(flat, "cpu", "vmem", False)
    rng = np.random.default_rng(len(ids))
    n = 77
    origin = np.concatenate((rng.uniform(0.0, 0.5, (n, 2)), np.ones((n, 1))), 1)
    rays = make_rays(origin.astype(np.float32), np.tile(np.float32([0, 0, -1]), (n, 1)),
                     np.zeros(n, np.float32), np.full(n, 10.0, np.float32), device="cpu")
    targs = [tables.nodes.data_ptr(), 1, 0, tables.woop.data_ptr(),
             tables.leaf_counts.data_ptr(), tables.leaf_counts.shape[0]]
    uv = design == "persistent"
    err, got, _, _ = _launch(libs["flat_trace_mxu"], FlatMxuKernel(), "flat_trace_mxu", targs,
                             tables.depth, rays, False, uv, False, 1, design, "vmem")
    assert err == 0
    want = trace_flat_plain(tables, rays, want_uv=True, mxu=True)
    assert (want.tri == max(ids)).all() and (want.t == 1.0).all()
    assert torch.equal(got[0], want.tri) and torch.equal(_bits(got[1]), _bits(want.t))
    if uv:
        assert torch.equal(_bits(got[2]), _bits(want.u)) and torch.equal(_bits(got[3]),
                                                                          _bits(want.v))
        # The first row of the largest id: u = x on an even row, u = y on an odd one.
        first = ids.index(max(ids))
        assert torch.equal(want.u, rays.origin[:, first % 2])


@pytest.mark.parametrize("kernel", ["quad", "mxu"])
def test_refusals(libs, kernel):
    tables, targs, need, wrapper = _tables("blob", kernel)
    rays = _rays(_scene("blob")[0], 64, 5)
    name = _lib(kernel, 1)
    lib = libs[name]
    # A first version (and, in quad_trace, a shared-memory stack) exists for
    # the vmem f32 frame forms at cursors = 1 only.
    for design in ("first", "shared_stack"):
        for uv, stats, residency in ((True, False, "vmem"), (False, True, "vmem"),
                                     (False, False, "hbm")):
            err, *_ = _launch(lib, wrapper, name, targs, need, rays, False, uv, stats, 1,
                              design, residency)
            assert err != 0
        if kernel == "quad":
            err, *_ = _launch(libs["quad_trace_c"], wrapper, "quad_trace_c", targs, need, rays,
                              False, False, False, 2, design, "vmem")
        else:
            err, *_ = _launch(lib, wrapper, name, targs, need, rays, False, False, False, 2,
                              design, "vmem")
        assert err != 0
    if kernel == "mxu":
        # No shared-memory stack, and no first version of the bf16 forms.
        for design, bf16 in (("shared_stack", False), ("first", True)):
            t, targs_b, _, _ = _tables("blob", kernel, "vmem", bf16)
            err, *_ = _launch(lib, wrapper, name, targs_b, need, rays, False, False, False, 1,
                              design, "vmem")
            assert err != 0
        # Cursors outside 1..kMaxCursors.
        for cursors in (0, common.MAX_CURSORS + 1):
            err, *_ = _launch(lib, wrapper, name, targs, need, rays, False, False, False,
                              cursors, "persistent", "vmem")
            assert err != 0
    # A stack need the local stack cannot hold.
    err, *_ = _launch(lib, wrapper, name, targs, common.STACK_SIZE + 1, rays, False,
                      False, False, 1, "persistent", "vmem")
    assert err != 0


@pytest.mark.parametrize("variant", mxu_ablate.VARIANTS)
def test_probe_variants_equal_plain(libs, variant):
    # mxu_ablate.cu through its C ABI at a small trip count: each variant's
    # accumulators equal ablate_plain's bit for bit (two blocks, on the
    # first scene's Woop rows).
    scene, flat, _ = _scene("blob")
    woop = torch.tensor(common.woop_rows(flat.tri_woop, flat.tri_index))
    rays = mxu_ablate.probe_rays(scene, 256, 4, "cpu")
    niter = 3
    fn = libs["mxu_ablate"].mxu_ablate_launch
    fn.argtypes = [ctypes.c_int, *mxu_ablate.KERNEL.argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    acc_t = torch.full((256,), 7.0)
    acc_tri = torch.full((256,), -5, dtype=torch.int32)
    err = fn(mxu_ablate.VARIANTS.index(variant), woop.data_ptr(), woop.shape[0],
             rays.origin.data_ptr(), rays.dirn.data_ptr(), rays.tmin.data_ptr(),
             rays.tmax.data_ptr(), 256, niter, acc_t.data_ptr(), acc_tri.data_ptr(), None)
    assert err == 0
    want_t, want_tri = mxu_ablate.ablate_plain(variant, woop, rays, niter)
    assert torch.equal(_bits(acc_t), _bits(want_t))
    assert torch.equal(acc_tri, want_tri)
    # A ray count off the block, or fewer than 8 rows, is refused.
    assert fn(1, woop.data_ptr(), 7, rays.origin.data_ptr(), rays.dirn.data_ptr(),
              rays.tmin.data_ptr(), rays.tmax.data_ptr(), 256, niter, acc_t.data_ptr(),
              acc_tri.data_ptr(), None) != 0
    assert fn(1, woop.data_ptr(), woop.shape[0], rays.origin.data_ptr(), rays.dirn.data_ptr(),
              rays.tmin.data_ptr(), rays.tmax.data_ptr(), 200, niter, acc_t.data_ptr(),
              acc_tri.data_ptr(), None) != 0
