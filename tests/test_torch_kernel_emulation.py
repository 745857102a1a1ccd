"""The traversal kernels' CUDA sources, run on the CPU: ``csrc/quad_trace.cu``,
``quad_trace_c.cu``, ``flat_trace.cu``, ``flat_trace_c.cu``,
``flat_trace_mxu.cu``, the slot libraries ``quad_trace_k{1,2,4,8}.cu`` and
``flat_trace_k{1,2,4,8}.cu`` and the probes ``mxu_ablate.cu``, ``ablate2.cu`` and
``mosaic_probe3.cu`` built with g++ against
``tests/cuda_emulation/cuda_runtime.h`` (every lane of a warp a thread, the
warp intrinsics and the FP64 mma barriers of the warp, ``__syncthreads`` a
barrier of the block, shared memory host memory the block's threads share),
and launched through their C ABI with the wrappers' ctypes ``argtypes``.  Every
form (closest and any hit, uv, counters, postponed leaves, the tensor-core
leaf test at 1-4 cursors, f32 and bf16 nodes, the residencies) of the
persistent kernels, and the slot forms at K = 1, 2, 4, 8 rays a thread, U =
1, 3, 16 Woop rows at once (32 on a 32-wide quad tree) and block pools of
128 and 512 rays, give the plain PyTorch version's hits and counters bit
for bit, on rays from outside and inside two scenes, at ray counts that
fill warps and that do not; the launch shape is ``persistent_grid``'s (at
K rays a thread), with ``MXU_SMEM`` of dynamic shared memory for the
tensor-core form and none for the others.  Every variant of the probe gives
its plain version's accumulators bit for bit, and so does every level of
``ablate2`` (on node tables of 1-129 records and Woop tables whose last
group of 128 rows holds 1 or 2) and every mode of ``mosaic_probe3``.  The
invariant-integer remainder of ``csrc/int_div.cuh`` equals ``%`` on
divisors 1 to 2^24 (``cuda_emulation/int_div_check.cpp``).  The AO ray
generator ``csrc/raygen_ao.cu`` gives ``gen_ao_rays_plain``'s ids, tmin and
tmax bit for bit, its origins and directions within the tolerances of
``tests/test_torch_raygen.py``, and its rotation words and Halton points bit
for bit, at 1 and 8 samples, seeds whose sum with the task wraps past 2^32,
batches that fill a block and that do not, no input and an empty scene.
The coarse sort's kernels ``csrc/morton_coarse.cu`` give
``morton_keys_coarse_device``'s keys and ``sort_batch_coarse``'s rays and
maps on the CPU bit for bit.
The card runs the same checks at full size in ``chip_smoke.py``."""

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
from tpu_rt_torch.core.types import Rays, make_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import common
from tpu_rt_torch.trace.common import BLOCK, persistent_grid
from tpu_rt_torch.probes import ablate2, mosaic_probe3, mxu_ablate
from tpu_rt_torch.raygen import ao_kernel
from tpu_rt_torch.raygen.generators import _halton2, _halton3, _hash_words, gen_ao_rays_plain
from tpu_rt_torch.rays import buffer, sort_kernel
from tpu_rt_torch.trace.flat_kernel import (
    MXU_SMEM,
    FlatMxuKernel,
    FlatTraceKernel,
    trace_flat_plain,
    upload_flat,
)
from tpu_rt_torch.trace.quad_kernel import QuadTraceKernel, trace_quad_plain, upload_quad
from tpu_rt_torch.trace.tables import _residency_flags
from test_torch_buffer import ray_batch

HERE = os.path.dirname(os.path.abspath(__file__))
LIBS = ("quad_trace", "quad_trace_c", "flat_trace", "flat_trace_c", "flat_trace_mxu",
        *(f"{t}_trace_k{k}" for t in ("quad", "flat") for k in common.SLOTS),
        "mxu_ablate", "ablate2", "mosaic_probe3")
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
        _SCENES[name] = (scene, flat, collapse4(flat), collapse4(flat, leaf_max=32))
    return _SCENES[name]


def _spec(kernel):
    """(tree, K, U, tile) of a kernel spec: "quad", "flat", "mxu" (the
    binary tables, the tensor-core library), or a slot library's, such as
    "flat_k4_u16_t128" (K = 4, U = 16, a block pool of 128 rays) or
    "quad32_k1_u32" (the 32-wide quad tree)."""
    tree, *rest = kernel.split("_")
    opts = {part[0]: int(part[1:]) for part in rest}
    return tree, opts.get("k"), opts.get("u"), opts.get("t")


def _tables(name, kernel, residency="vmem", bf16=False):
    """(tables, table arguments of the C ABI, wrapper) of a kernel spec
    (``_spec``)."""
    _, flat, quad, quad32 = _scene(name)
    tree, k, _, _ = _spec(kernel)
    if tree.startswith("quad"):
        t = upload_quad(quad32 if tree == "quad32" else quad, "cpu", residency)
        return (t, [t.nodes.data_ptr(), t.nodes.shape[0], t.woop.data_ptr()],
                QuadTraceKernel(f"quad_trace_k{k}", slots=k) if k else QuadTraceKernel())
    t = upload_flat(flat, "cpu", residency, bf16)
    wrapper = (FlatMxuKernel() if kernel == "mxu" else
               FlatTraceKernel(f"flat_trace_k{k}", slots=k) if k else FlatTraceKernel())
    return (t, [t.nodes.data_ptr(), t.nodes.shape[0], int(bf16), t.woop.data_ptr(),
                t.leaf_counts.data_ptr(), t.leaf_counts.shape[0]], wrapper)


def _lib(kernel, cursors):
    """The library of a kernel spec and cursor count."""
    if kernel == "mxu":
        return "flat_trace_mxu"
    tree, k, _, _ = _spec(kernel)
    if k:
        return f"{tree[:4]}_trace_k{k}"
    return f"{kernel}_trace" + ("_c" if cursors > 1 else "")


def _launch(lib, wrapper, name, table_args, rays, any_hit, uv, stats, cursors, residency,
            units=None, tile=None):
    """One launch through the C ABI (a slot library's with U = ``units``
    and S = ``tile``, None as the wrapper passes it); returns (error,
    outputs, shape, counter)."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = wrapper.argtypes
    fn.restype = ctypes.c_int
    n = rays.origin.shape[0]
    tri = torch.full((n,), 12345, dtype=torch.int32)
    t = torch.full((n,), 7.0)
    u, v = torch.full((n,), 9.0), torch.full((n,), 9.0)
    nt, tt, sk = (torch.full((n,), -5, dtype=torch.int32) for _ in range(3))
    counter = torch.full((1,), 77, dtype=torch.int32)
    shape = (ctypes.c_int * 4)(-1, -1, -1, -1)
    sn, st = _residency_flags(residency)
    schedule = [1 if units is None else units, tile or 0] if wrapper.slots else []
    err = fn(*schedule, *table_args, rays.origin.data_ptr(), rays.dirn.data_ptr(),
             rays.tmin.data_ptr(), rays.tmax.data_ptr(), tri.data_ptr(), t.data_ptr(),
             u.data_ptr() if uv else None, v.data_ptr() if uv else None,
             *(x.data_ptr() if stats else None for x in (nt, tt, sk)), n, cursors,
             int(any_hit), int(uv), int(stats), int(sn), int(st), 0, 0, counter.data_ptr(),
             ctypes.addressof(shape), None)
    return err, (tri, t, u, v, nt, tt, sk), list(shape), int(counter[0])


_PLAIN = {}


def _plain(name, kernel, tables, rays, any_hit, cursors, key):
    if key not in _PLAIN:
        if kernel.startswith("quad"):
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
        for _uv, _stats in ((False, False), (True, False), (False, True), (True, True)):
            CASES.append((_kernel, 1, _any, _uv, _stats, "vmem", False))
        for _c in (2, 3, 4):
            CASES.append((_kernel, _c, _any, False, False, "vmem", False))
            CASES.append((_kernel, _c, _any, True, True, "vmem", False))
    CASES.append((_kernel, 1, True, True, True, "hbm", False))
    CASES.append((_kernel, 2, False, False, True, "mixed", False))
for _any in (False, True):
    CASES.append(("flat", 1, _any, False, False, "vmem", True))
    CASES.append(("flat", 3, _any, True, True, "hbm", True))
# The frame forms of the forced large-scene layouts (chip_smoke.py phase
# 18): the quad tree, binary f32 and binary bf16 in mixed and hbm.
for _kernel, _bf16 in (("quad", False), ("flat", False), ("flat", True)):
    for _residency in ("mixed", "hbm"):
        for _any in (False, True):
            CASES.append((_kernel, 1, _any, False, False, _residency, _bf16))
# The tensor-core form: every form at 1 cursor, frame and full forms at 2-4,
# and the other node format and residencies.
for _any in (False, True):
    for _uv, _stats in ((False, False), (True, False), (False, True), (True, True)):
        CASES.append(("mxu", 1, _any, _uv, _stats, "vmem", False))
    for _c in (2, 3, 4):
        CASES.append(("mxu", _c, _any, False, False, "vmem", False))
        CASES.append(("mxu", _c, _any, True, True, "vmem", False))
    CASES.append(("mxu", 1, _any, False, False, "vmem", True))
    CASES.append(("mxu", 2, _any, True, True, "mixed", False))
    CASES.append(("mxu", 3, _any, False, True, "hbm", False))
    CASES.append(("mxu", 4, _any, True, True, "hbm", True))
    CASES.append(("mxu", 1, _any, True, False, "mixed", True))
# The slot forms (one library per K; the spec names K, U and the block's
# pool, _spec): every K on the frame forms and with uv and counters, U 1, 3
# and 16 at K = 1 (32 on the 32-wide quad tree), pools of 128 and 512 rays,
# both of them with K > 1, the other residencies and bf16 nodes.
for _kernel in ("quad", "flat"):
    for _k in common.SLOTS:
        for _any in (False, True):
            CASES.append((f"{_kernel}_k{_k}", 1, _any, False, False, "vmem", False))
            CASES.append((f"{_kernel}_k{_k}", 1, _any, True, True, "vmem", False))
    for _any in (False, True):
        for _u in (1, 3, 16):
            CASES.append((f"{_kernel}_k1_u{_u}", 1, _any, False, True, "vmem", False))
        for _t in (128, 512):
            CASES.append((f"{_kernel}_k1_t{_t}", 1, _any, False, True, "vmem", False))
        CASES.append((f"{_kernel}_k2_u3_t512", 1, _any, True, True, "mixed", False))
        CASES.append((f"{_kernel}_k8_u16_t128", 1, _any, False, True, "hbm", False))
for _any in (False, True):
    CASES.append(("quad32_k1_u32", 1, _any, True, True, "vmem", False))
    CASES.append(("quad32_k4_u16_t512", 1, _any, False, True, "mixed", False))
    CASES.append(("flat_k2", 1, _any, False, False, "vmem", True))
    CASES.append(("flat_k4_u3_t512", 1, _any, True, True, "hbm", True))
    CASES.append(("flat_k8_t128", 1, _any, False, True, "mixed", True))


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("kernel, cursors, any_hit, uv, stats, residency, bf16", CASES)
def test_kernel_equals_plain(libs, scene, kernel, cursors, any_hit, uv, stats, residency, bf16):
    tables, targs, wrapper = _tables(scene, kernel, residency, bf16)
    rays = _rays(_scene(scene)[0], 700, 3)
    lib = _lib(kernel, cursors)
    tree, k, units, tile = _spec(kernel)
    err, got, shape, counter = _launch(libs[lib], wrapper, lib, targs, rays, any_hit, uv, stats,
                                       cursors, residency, units, tile)
    assert err == 0
    # The slot forms' plain version is the default forms' (cursors = 1).
    want, want_cnt = _plain(scene, tree, tables, rays, any_hit, cursors,
                            (scene, tree, residency, bf16, any_hit, cursors))
    tri, t, u, v, nt, tt, sk = got
    assert torch.equal(tri, want.tri)
    assert torch.equal(_bits(t), _bits(want.t))
    if uv:
        assert torch.equal(_bits(u), _bits(want.u)) and torch.equal(_bits(v), _bits(want.v))
    if stats:
        assert torch.equal(nt, want_cnt["node_tests"])
        assert torch.equal(tt, want_cnt["tri_tests"])
        assert torch.equal(sk, want_cnt["stack"])
    n = rays.origin.shape[0]
    smem = MXU_SMEM if kernel == "mxu" else 0
    assert shape == [persistent_grid(n, SMS, PER_SM, BLOCK * (k or 1)), PER_SM, smem, SMS]
    # The pool was zeroed by the launch and handed out past n (a block pool
    # claims whole tiles).
    assert counter >= n and counter % (tile or 1) == 0


@pytest.mark.parametrize("kernel", ["flat", "mxu", "flat_k4_t128", "quad_k8_u3_t512",
                                    "quad_k2_t128"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 300])
def test_partial_warps_and_pool(libs, n, kernel):
    # Fewer rays than a warp, or than the grid's lanes (or than a block
    # pool's tile, or a last tile only in part filled): every ray is traced
    # once, by whichever warp takes it.
    tables, targs, wrapper = _tables("interior", kernel)
    rays = _rays(_scene("interior")[0], max(n, 1), 11)
    if n == 0:
        rays = make_rays(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0),
                         device="cpu")
    lib = _lib(kernel, 1)
    tree, k, units, tile = _spec(kernel)
    for any_hit in (False, True):
        err, got, shape, _ = _launch(libs[lib], wrapper, lib, targs, rays, any_hit, False, False,
                                     1, "vmem", units, tile)
        assert err == 0
        if n == 0:
            assert shape == [-1, -1, -1, -1]   # nothing launched
            continue
        if tree == "quad":
            want = trace_quad_plain(tables, rays, any_hit)
        else:
            want = trace_flat_plain(tables, rays, any_hit, mxu=kernel == "mxu")
        assert torch.equal(got[0], want.tri) and torch.equal(_bits(got[1]), _bits(want.t))
        assert shape[0] == persistent_grid(n, SMS, PER_SM, BLOCK * (k or 1))


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
@pytest.mark.parametrize("cursors", [1, 2])
def test_mxu_tie_rule(libs, ids, cursors):
    # Every candidate of the leaf ties in t on every ray: the winner is the
    # largest id, and of equal ids the first row, with that row's u, v.  At
    # 2 cursors the ray holds the leaf until its stack is empty.
    flat = _tie_leaf(ids)
    tables = upload_flat(flat, "cpu", "vmem", False)
    rng = np.random.default_rng(len(ids))
    n = 77
    origin = np.concatenate((rng.uniform(0.0, 0.5, (n, 2)), np.ones((n, 1))), 1)
    rays = make_rays(origin.astype(np.float32), np.tile(np.float32([0, 0, -1]), (n, 1)),
                     np.zeros(n, np.float32), np.full(n, 10.0, np.float32), device="cpu")
    targs = [tables.nodes.data_ptr(), 1, 0, tables.woop.data_ptr(),
             tables.leaf_counts.data_ptr(), tables.leaf_counts.shape[0]]
    err, got, _, _ = _launch(libs["flat_trace_mxu"], FlatMxuKernel(), "flat_trace_mxu", targs,
                             rays, False, True, False, cursors, "vmem")
    assert err == 0
    want = trace_flat_plain(tables, rays, want_uv=True, mxu=True, cursors=cursors)
    assert (want.tri == max(ids)).all() and (want.t == 1.0).all()
    assert torch.equal(got[0], want.tri) and torch.equal(_bits(got[1]), _bits(want.t))
    assert torch.equal(_bits(got[2]), _bits(want.u)) and torch.equal(_bits(got[3]),
                                                                      _bits(want.v))
    # The first row of the largest id: u = x on an even row, u = y on an odd one.
    first = ids.index(max(ids))
    assert torch.equal(want.u, rays.origin[:, first % 2])


@pytest.mark.parametrize("kernel", ["quad", "mxu", "quad_k2", "flat_k4"])
def test_refusals(libs, kernel):
    tables, targs, wrapper = _tables("blob", kernel)
    rays = _rays(_scene("blob")[0], 64, 5)
    name = _lib(kernel, 1)
    lib = libs[name]
    if wrapper.slots:
        # The slot forms: at cursors = 1, U in 1..kMaxUnits, a tile a
        # multiple of the block (or 0).
        def slot_launch(cursors=1, units=1, tile=0):
            return _launch(lib, wrapper, name, targs, rays, False, False, False, cursors, "vmem",
                           units, tile)[0]

        assert slot_launch() == 0 and slot_launch(units=32, tile=256) == 0
        for bad in ({"cursors": 2}, {"cursors": 0}, {"units": 0},
                    {"units": common.MAX_UNITS + 1}, {"tile": 100}, {"tile": -128}):
            assert slot_launch(**bad) != 0, bad
        return
    # Cursors outside the library's range: 1 for quad_trace, 1..kMaxCursors
    # for the tensor-core form.
    for cursors in (0, wrapper.cursors[1] + 1):
        err, *_ = _launch(lib, wrapper, name, targs, rays, False, False, False, cursors, "vmem")
        assert err != 0


@pytest.mark.parametrize("variant", mxu_ablate.VARIANTS)
def test_probe_variants_equal_plain(libs, variant):
    # mxu_ablate.cu through its C ABI at a small trip count: each variant's
    # accumulators equal ablate_plain's bit for bit (two blocks, on the
    # first scene's Woop rows).
    scene, flat, *_ = _scene("blob")
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


def _probe_fn(lib, wrapper):
    fn = getattr(lib, f"{wrapper.name}_launch")
    fn.argtypes = [ctypes.c_int, *wrapper.argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _occupancy_fn(lib, wrapper):
    fn = getattr(lib, f"{wrapper.name}_occupancy")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ablate2(libs, level, nodes, rows, rays, niter):
    """One launch of ablate2.cu; returns (error, out, node)."""
    n = rays.shape[0]
    out = torch.full((n,), 7.0)
    node = torch.full((n // ablate2.WARP,), -5, dtype=torch.int32)
    err = _probe_fn(libs["ablate2"], ablate2.KERNEL)(
        level, nodes.data_ptr(), nodes.shape[0], rows.data_ptr(), rows.shape[0],
        rays.data_ptr(), n, niter, out.data_ptr(), node.data_ptr(), None)
    return err, out, node


def _ablate2_tables(n_nodes=None, n_rows=None):
    """The first scene's node records and Woop rows, cut to the first
    ``n_nodes`` / ``n_rows``, and 2 blocks of probe rays aimed at them."""
    scene, flat, *_ = _scene("blob")
    nodes = np.ascontiguousarray(flat.nodes, np.float32)[:n_nodes]
    rows = common.woop_rows(flat.tri_woop, flat.tri_index)[:n_rows]
    rays = ablate2.probe_rays(rows, scene, 2 * ablate2.GROUP, 4, device="cpu")
    return torch.tensor(nodes), torch.tensor(np.ascontiguousarray(rows)), rays


def _same(got, want):
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("level", ablate2.LEVELS)
def test_ablate2_levels_equal_plain(libs, level):
    # Every level through the C ABI on two blocks: acc + node of every ray
    # and every packet's node equal ablate_plain's bit for bit.
    nodes, rows, rays = _ablate2_tables()
    err, out, node = _ablate2(libs, level, nodes, rows, rays, 40)
    assert err == 0
    want, want_node = ablate2.ablate_plain(level, nodes, rows, rays, 40)
    assert _same(out, want) and torch.equal(node, want_node)


@pytest.mark.parametrize("n_nodes, n_rows", [(1, None), (2, None), (3, None), (127, None),
                                             (128, None), (129, None), (None, 1), (None, 2),
                                             (None, 129), (None, 130), (None, 257),
                                             (None, 258)])
def test_ablate2_table_edges(libs, n_nodes, n_rows):
    # The cursor's remainders by a run-time table size (node mod n, 7 node
    # mod m, the invariant-integer division) and the wrap of the U Woop rows
    # inside a last group of 1 or 2 rows, over enough iterations that every
    # record and row is reached: the full step (8) and the while loop (9).
    nodes, rows, rays = _ablate2_tables(n_nodes, n_rows)
    niter = 300
    if n_rows:
        visits = ablate2.walk_rows(n_rows, ablate2.K, niter)
        assert (visits == n_rows - 1).any()
    for level in (8, 9):
        err, out, node = _ablate2(libs, level, nodes, rows, rays, niter)
        assert err == 0
        want, want_node = ablate2.ablate_plain(level, nodes, rows, rays, niter)
        assert _same(out, want) and torch.equal(node, want_node), level


def test_ablate2_refusals(libs):
    nodes, rows, rays = _ablate2_tables()
    fn = _probe_fn(libs["ablate2"], ablate2.KERNEL)
    out = torch.zeros(rays.shape[0])
    node = torch.zeros(rays.shape[0] // ablate2.WARP, dtype=torch.int32)

    def call(level=8, n_nodes=nodes.shape[0], n_rows=rows.shape[0], n=rays.shape[0], niter=2):
        return fn(level, nodes.data_ptr(), n_nodes, rows.data_ptr(), n_rows, rays.data_ptr(), n,
                  niter, out.data_ptr(), node.data_ptr(), None)

    assert call() == 0
    for bad in ({"level": 10}, {"level": -1}, {"n_nodes": 0}, {"n_rows": 0},
                {"n": ablate2.GROUP - ablate2.WARP}, {"niter": -1},
                {"niter": (2**31 - 1) // 7 - ablate2.K + 1}):
        assert call(**bad) != 0, bad
    # The occupancy query refuses a level that is not one.
    occupancy, res = _occupancy_fn(libs["ablate2"], ablate2.KERNEL), (ctypes.c_int * 4)()
    for bad in (-1, len(ablate2.LEVELS)):
        assert occupancy(bad, ctypes.addressof(res)) != 0, bad


@pytest.mark.parametrize("mode", mosaic_probe3.MODES)
def test_mosaic_probe3_modes_equal_plain(libs, mode):
    # Every mode through the C ABI on two packets, over more iterations than
    # the stack pointer's 60: the output and every row's node equal
    # probe_plain's bit for bit.
    tab, x = mosaic_probe3.probe_inputs(2, 11, device="cpu")
    iters = 70
    out = torch.full_like(x, 7.0)
    nodes = torch.full((2, mosaic_probe3.R), -5, dtype=torch.int32)
    fn = _probe_fn(libs["mosaic_probe3"], mosaic_probe3.KERNEL)
    err = fn(mosaic_probe3.MODES.index(mode), tab.data_ptr(), x.data_ptr(), 2, iters,
             out.data_ptr(), nodes.data_ptr(), None)
    assert err == 0
    want, want_nodes = mosaic_probe3.probe_plain(mode, tab, x, iters)
    assert _same(out, want) and torch.equal(nodes, want_nodes)
    # An unknown mode or no packet is refused.
    assert fn(len(mosaic_probe3.MODES), tab.data_ptr(), x.data_ptr(), 2, iters,
              out.data_ptr(), nodes.data_ptr(), None) != 0
    assert fn(0, tab.data_ptr(), x.data_ptr(), 0, iters, out.data_ptr(), nodes.data_ptr(),
              None) != 0
    # So is an unknown mode in the occupancy query.
    res = (ctypes.c_int * 4)()
    occupancy = _occupancy_fn(libs["mosaic_probe3"], mosaic_probe3.KERNEL)
    assert occupancy(len(mosaic_probe3.MODES), ctypes.addressof(res)) != 0


def test_invariant_divisor_equals_remainder(tmp_path):
    # int_div.cuh's multiplier-and-shift remainder against `%`: every
    # divisor 1 to 2^24, powers of two and large divisors, numerators up to
    # 2^31 - 1 at the edges (int_div_check.cpp).
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the check for the host")
    exe = str(tmp_path / "int_div_check")
    emu = os.path.join(HERE, "cuda_emulation")
    proc = subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", "-I", emu, "-I", common.CSRC,
                           os.path.join(emu, "int_div_check.cpp"), "-o", exe],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert int(run.stdout.split()[0]) > 300_000_000


# --- The AO ray generator (csrc/raygen_ao.cu) ----------------------------------
#
# Built with cuda_emulation/raygen_terms.cpp, which exports the kernel's
# rotation words and Halton points beside its C ABI.  Tolerances as in
# tests/test_torch_raygen.py: the host's cosf / sinf and the kernel's norm
# round otherwise than torch's in the last bits.
EPS32 = float(np.finfo(np.float32).eps)
SEED_NEAR_2_32 = 2**32 - 7


@pytest.fixture(scope="module")
def raygen_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernel for the host")
    so = str(tmp_path_factory.mktemp("raygen_emulation") / "libraygen_ao.so")
    emu = os.path.join(HERE, "cuda_emulation")
    defines = [f for f in common.NVCC_FLAGS if f.startswith("-D")]
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                           "-pthread", "-I", emu, "-I", common.CSRC, *defines,
                           os.path.join(emu, "raygen_terms.cpp"), os.path.join(emu, "sim.cpp"),
                           "-o", so], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    lib.sim_config(SMS, PER_SM)
    lib.raygen_ao_launch.argtypes = ao_kernel.ARGTYPES
    lib.raygen_ao_launch.restype = ctypes.c_int
    lib.raygen_ao_terms.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.raygen_ao_terms.restype = None
    return lib


def _ao_hits(n, num_tris, seed):
    """Input hits as tests/test_torch_raygen.py makes them: t around the
    backtrack epsilon, misses, and normals that take each perpendicular
    branch."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.0, 5.0, n).astype(np.float32)
    t[:5] = [0.0, 5e-5, 1e-4, 2e-4, 1.0][:n]
    tri = rng.integers(-1, num_tris, n).astype(np.int32)   # all -1 without triangles
    nrm = rng.normal(size=(num_tris, 3)).astype(np.float32)
    if num_tris >= 6:
        nrm[:6] = [[0, 0, 1], [1, 0, 0], [0, -1, 0], [0.6, 0.8, 0], [0, 0.6, -0.8], [1, 1, 1]]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return [torch.tensor(x) for x in (o, d, t, tri, nrm)]


def _raygen_launch(lib, hits, num_samples, max_dist, seed, offset):
    """One launch through the C ABI into outputs filled with markers;
    returns (error, Rays, ids)."""
    o, d, t, tri, nrm = hits
    n = o.shape[0] * num_samples
    rays = make_rays(np.full((n, 3), 7.0), np.full((n, 3), 7.0), np.full(n, 7.0),
                     np.full(n, 7.0), device="cpu")
    ids = torch.full((n,), -5, dtype=torch.int32)
    err = lib.raygen_ao_launch(o.data_ptr(), d.data_ptr(), t.data_ptr(), tri.data_ptr(),
                               nrm.data_ptr(), nrm.shape[0], o.shape[0], num_samples,
                               float(np.float32(max_dist)), seed & 0xFFFFFFFF,
                               offset & 0xFFFFFFFF, *(x.data_ptr() for x in rays),
                               ids.data_ptr(), None)
    return err, rays, ids


def _raygen_agrees(got, ids, hits, num_samples, max_dist, seed, offset):
    o, d, t, tri, nrm = hits
    want, w_ids, _ = gen_ao_rays_plain(o, d, t, tri, nrm, num_samples, max_dist, seed,
                                       task_offset=offset)
    assert torch.equal(ids, w_ids)
    assert torch.equal(_bits(got.tmin), _bits(want.tmin))
    assert torch.equal(_bits(got.tmax), _bits(want.tmax))
    back = torch.clamp_min(t - np.float32(1e-4), 0.0)
    scale = (o.abs() + (d * back[:, None]).abs()).repeat_interleave(num_samples, 0)
    assert ((got.origin - want.origin).abs() <= scale * EPS32).all()
    torch.testing.assert_close(got.dirn, want.dirn, rtol=0, atol=4 * EPS32)


@pytest.mark.parametrize("num_samples", [1, 8])
@pytest.mark.parametrize("seed,offset", [(0, 0), (SEED_NEAR_2_32, 4093)])
def test_raygen_ao_equals_plain(raygen_lib, num_samples, seed, offset):
    # Every output ray against gen_ao_rays_plain on 2,000 hits (seed +
    # offset + i wraps past 2^32 in the second case); the rotation words
    # and Halton points bit for bit.
    hits = _ao_hits(2000, 40, 7)
    err, got, ids = _raygen_launch(raygen_lib, hits, num_samples, 3.87, seed, offset)
    assert err == 0
    _raygen_agrees(got, ids, hits, num_samples, 3.87, seed, offset)
    r = hits[0].shape[0]
    word = torch.empty((r,), dtype=torch.int32)
    hx, hy = torch.empty((num_samples,)), torch.empty((num_samples,))
    raygen_ao_terms = raygen_lib.raygen_ao_terms
    raygen_ao_terms(seed & 0xFFFFFFFF, offset, r, num_samples, word.data_ptr(), hx.data_ptr(),
                    hy.data_ptr())
    _, _, c = _hash_words(seed, offset, r, "cpu")
    assert torch.equal(word.long() & 0xFFFFFFFF, c)
    j = torch.arange(num_samples)
    assert torch.equal(_bits(hx), _bits(_halton2(j))) and torch.equal(_bits(hy),
                                                                       _bits(_halton3(j)))


@pytest.mark.parametrize("r,num_samples,num_tris", [
    (256, 1, 40),    # one full block
    (257, 1, 40),    # a block and one ray
    (32, 8, 40),     # one full block of 8 samples
    (33, 8, 40),     # and 8 rays into the next
    (5, 3, 40),      # part of one block
    (100, 8, 0),     # an empty scene: every input missed
    (0, 8, 40),      # no input
])
def test_raygen_ao_shapes(raygen_lib, r, num_samples, num_tris):
    hits = _ao_hits(r, num_tris, 11)
    err, got, ids = _raygen_launch(raygen_lib, hits, num_samples, 0.5, 99, 12)
    assert err == 0
    _raygen_agrees(got, ids, hits, num_samples, 0.5, 99, 12)
    if num_tris == 0:
        assert (got.tmax == -1.0).all() and r > 0


def test_raygen_ao_refusals(raygen_lib):
    # No sample, a negative count, or more output rays than int32 holds.
    hits = _ao_hits(4, 40, 3)
    for r, s in ((4, 0), (-1, 8), (2**28, 8)):
        o, d, t, tri, nrm = hits
        err = raygen_lib.raygen_ao_launch(o.data_ptr(), d.data_ptr(), t.data_ptr(),
                                          tri.data_ptr(), nrm.data_ptr(), 40, r, s, 1.0, 0, 0,
                                          None, None, None, None, None, None)
        assert err != 0


# --- The coarse Morton sort (csrc/morton_coarse.cu) -----------------------------
#
# The box and key kernels against morton_keys_coarse_device's keys (as
# int32), the permutation kernels against sort_batch_coarse's CPU chain,
# around the CPU's stable torch.sort of the kernel's keys.  Cases: the batches
# of tests/test_torch_buffer.py, no finite origin, a flat axis, sizes that
# fill the key kernel's block (256) and the box kernel's (4,096) and that do
# not, no ray; maps the identity or a shuffle and its inverse.
BOX_RAYS = 256 * 16


def _morton_batch(case, n):
    if case in ("random", "special", "ties"):
        return ray_batch(case, n)
    rng = np.random.default_rng(n)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tmax = rng.uniform(-1, 1, n).astype(np.float32)
    if case == "no_finite":
        o[np.arange(n), rng.integers(0, 3, n)] = np.nan   # one coordinate a row
        o[::3, 0] = np.inf
    elif case == "flat_axis":
        # y flat on the finite rows; rows that a NaN x leaves out of the box
        # hold other y values.
        o[:, 1] = 2.5
        o[::7, 0] = np.nan
        o[::7, 1] = rng.uniform(0, 5, len(o[::7]))
    elif n > 1:
        # The box's corners in the last rays, past the first box block.
        o[-2], o[-1] = o.min(0) - 1.0, o.max(0) + 1.0
    return o, d, tmax


MORTON_CASES = [("random", 4000, True), ("special", 4000, True), ("ties", 4000, False),
                ("no_finite", 300, True), ("flat_axis", 1000, False),
                ("sizes", 256, False), ("sizes", 257, True), ("sizes", BOX_RAYS, False),
                ("sizes", BOX_RAYS + 1, True), ("sizes", 5, True), ("sizes", 1, False),
                ("sizes", 0, False)]


@pytest.fixture(scope="module")
def morton_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the kernels for the host")
    so = str(tmp_path_factory.mktemp("morton_emulation") / "libmorton_coarse.so")
    emu = os.path.join(HERE, "cuda_emulation")
    defines = [f for f in common.NVCC_FLAGS if f.startswith("-D")]
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                           "-pthread", "-I", emu, *defines,
                           "-x", "c++", os.path.join(common.CSRC, "morton_coarse.cu"),
                           "-x", "c++", os.path.join(emu, "sim.cpp"), "-o", so],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    lib.sim_config(SMS, PER_SM)
    lib.morton_coarse_keys.argtypes = sort_kernel.KEYS_ARGTYPES
    lib.morton_coarse_permute.argtypes = sort_kernel.PERMUTE_ARGTYPES
    lib.morton_coarse_keys.restype = lib.morton_coarse_permute.restype = ctypes.c_int
    return lib


def _from_ordered(words):
    w = words.astype(np.uint32)
    return np.where(w & 0x80000000, w & 0x7FFFFFFF, ~w).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case,n,shuffled", MORTON_CASES)
def test_morton_coarse_equals_plain(morton_lib, case, n, shuffled):
    o, d, tmax = _morton_batch(case, n)
    rays = make_rays(o, d, np.arange(n) * 0.5, tmax, device="cpu")
    s2i = np.random.default_rng(3).permutation(n) if shuffled else np.arange(n)
    s2i = torch.tensor(s2i, dtype=torch.int32)
    i2s = torch.empty_like(s2i)
    i2s[s2i.long()] = torch.arange(n, dtype=torch.int32)

    keys = torch.full((n,), -5, dtype=torch.int32)
    box = torch.zeros((6,), dtype=torch.int32)
    assert morton_lib.morton_coarse_keys(rays.origin.data_ptr(), n, box.data_ptr(),
                                         keys.data_ptr(), None) == 0
    assert torch.equal(keys, buffer.morton_keys_coarse_device(rays.origin).to(torch.int32))
    fin = np.isfinite(o).all(1)
    words = box.numpy().view(np.uint32)
    if n and fin.any():
        # The box's words: the finite rows' least and greatest coordinates.
        np.testing.assert_array_equal(_from_ordered(words[:3]), o[fin].min(0))
        np.testing.assert_array_equal(_from_ordered(~words[3:]), o[fin].max(0))
    elif n:
        assert (words == 0xFFFFFFFF).all()

    order = torch.sort(keys, stable=True).indices
    out = Rays(*(torch.full_like(x, 7.0) for x in rays))
    out_s2i, out_i2s, inv = (torch.full((n,), -5, dtype=torch.int32) for _ in range(3))
    assert morton_lib.morton_coarse_permute(
        order.data_ptr(), n, *(x.data_ptr() for x in rays), s2i.data_ptr(), i2s.data_ptr(),
        *(x.data_ptr() for x in out), out_s2i.data_ptr(), out_i2s.data_ptr(), inv.data_ptr(),
        None) == 0
    want, want_s2i, want_i2s = buffer.sort_batch_coarse(rays, s2i, i2s)
    for got_x, want_x in zip(out, want):
        assert torch.equal(_bits(got_x), _bits(want_x))
    assert torch.equal(out_s2i, want_s2i) and torch.equal(out_i2s, want_i2s)
    assert torch.equal(order, buffer.morton_sort_device_coarse(rays.origin, rays.dirn))
    if n == 0:
        # A negative count is refused.
        assert morton_lib.morton_coarse_keys(None, -1, None, None, None) != 0
