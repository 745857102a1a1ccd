"""The traversal kernels' CUDA sources, run on the CPU: ``csrc/quad_trace.cu``,
``quad_trace_c.cu``, ``flat_trace.cu`` and ``flat_trace_c.cu`` built with g++
against ``tests/cuda_emulation/cuda_runtime.h`` (every lane of a warp a
thread, the warp intrinsics barriers of the warp), and launched through
their C ABI with the wrappers' ctypes ``argtypes``.  Every form (closest and
any hit, uv, counters, postponed leaves, f32 and bf16 nodes) of the
persistent kernels, their shared-memory stack and the first versions, give
the plain PyTorch version's hits and counters bit for bit, on rays from
outside and inside two scenes, at ray counts that fill warps and that do
not; the launch shape is ``persistent_grid``'s and ``shared_stack_bytes``'.
The card runs the same checks at full size in ``chip_smoke.py``."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_rt_torch.bvh import load_or_build_bvh
from tpu_rt_torch.bvh.collapse import collapse4
from tpu_rt_torch.core.types import make_rays
from tpu_rt_torch.scene import Scene, procedural
from tpu_rt_torch.trace import common
from tpu_rt_torch.trace.common import DESIGNS, persistent_grid, shared_stack_bytes
from tpu_rt_torch.trace.flat_kernel import FlatTraceKernel, trace_flat_plain, upload_flat
from tpu_rt_torch.trace.quad_kernel import QuadTraceKernel, trace_quad_plain, upload_quad
from tpu_rt_torch.trace.tables import _residency_flags

HERE = os.path.dirname(os.path.abspath(__file__))
LIBS = ("quad_trace", "quad_trace_c", "flat_trace", "flat_trace_c")
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
    """(tables, table arguments of the C ABI, stack need, wrapper)."""
    _, flat, quad = _scene(name)
    if kernel == "quad":
        t = upload_quad(quad, "cpu", residency)
        return (t, [t.nodes.data_ptr(), t.nodes.shape[0], t.woop.data_ptr()], 3 * t.depth,
                QuadTraceKernel())
    t = upload_flat(flat, "cpu", residency, bf16)
    return (t, [t.nodes.data_ptr(), t.nodes.shape[0], int(bf16), t.woop.data_ptr(),
                t.leaf_counts.data_ptr(), t.leaf_counts.shape[0]], t.depth, FlatTraceKernel())


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
        plain = trace_quad_plain if kernel == "quad" else trace_flat_plain
        _PLAIN[key] = plain(tables, rays, any_hit, True, True, cursors=cursors)
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


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("kernel, cursors, any_hit, uv, stats, design, residency, bf16", CASES)
def test_kernel_equals_plain(libs, scene, kernel, cursors, any_hit, uv, stats, design,
                             residency, bf16):
    tables, targs, need, wrapper = _tables(scene, kernel, residency, bf16)
    rays = _rays(_scene(scene)[0], 700, 3)
    lib = f"{kernel}_trace" + ("_c" if cursors > 1 else "")
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
    if design == "first":
        assert shape == [-(-n // 128), 0, 0, SMS]
    else:
        assert shape == [persistent_grid(n, SMS, PER_SM), PER_SM,
                         shared_stack_bytes(need) if design == "shared_stack" else 0, SMS]
        # The pool was zeroed by the launch and handed out past n.
        assert counter >= n


@pytest.mark.parametrize("n", [0, 1, 31, 33, 300])
def test_partial_warps_and_pool(libs, n):
    # Fewer rays than a warp, or than the grid's lanes: every ray is traced
    # once, by whichever warp takes it.
    tables, targs, need, wrapper = _tables("interior", "flat")
    rays = _rays(_scene("interior")[0], max(n, 1), 11)
    if n == 0:
        rays = make_rays(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0),
                         device="cpu")
    for any_hit in (False, True):
        err, got, shape, _ = _launch(libs["flat_trace"], wrapper, "flat_trace", targs,
                                     need, rays, any_hit, False, False, 1, "persistent", "vmem")
        assert err == 0
        if n == 0:
            assert shape == [-1, -1, -1, -1]   # nothing launched
            continue
        want = trace_flat_plain(tables, rays, any_hit)
        assert torch.equal(got[0], want.tri) and torch.equal(_bits(got[1]), _bits(want.t))
        assert shape[0] == persistent_grid(n, SMS, PER_SM)


def test_refusals(libs):
    tables, targs, need, wrapper = _tables("blob", "quad")
    rays = _rays(_scene("blob")[0], 64, 5)
    lib = libs["quad_trace"]
    # A first version and a shared-memory stack exist for the vmem frame
    # forms at cursors = 1 only.
    for design in ("first", "shared_stack"):
        for uv, stats, residency in ((True, False, "vmem"), (False, True, "vmem"),
                                     (False, False, "hbm")):
            err, *_ = _launch(lib, wrapper, "quad_trace", targs, need, rays, False, uv, stats, 1,
                              design, residency)
            assert err != 0
        err, *_ = _launch(libs["quad_trace_c"], wrapper, "quad_trace_c", targs, need, rays,
                          False, False, False, 2, design, "vmem")
        assert err != 0
    # A stack need the local stack cannot hold.
    err, *_ = _launch(lib, wrapper, "quad_trace", targs, common.STACK_SIZE + 1, rays, False,
                      False, False, 1, "persistent", "vmem")
    assert err != 0
