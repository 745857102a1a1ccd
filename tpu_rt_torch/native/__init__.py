"""Native (C++) SBVH builder, loaded via ctypes.

Counterpart of ``tpu_rt.native``.  The C++ source ``sbvh.cc`` beside this
module is the port's own copy of ``tpu_rt/native/sbvh.cc`` (code
unchanged), so both packages build bit-identical trees
(``tests/test_torch_host.py``); the port reads no file of the JAX package.
It is compiled with g++ at first use into the port's git-ignored build
directory (``tpu_rt_torch._build``).  When g++ is missing or fails, callers
fall back to the numpy builder (``tpu_rt_torch.bvh.builder``), which is the
semantic definition.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from tpu_rt_torch._build import build_shared

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sbvh.cc")
_CMD = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def get_lib():
    """Load (compiling if needed) the native library, or None if
    unavailable — callers fall back to the numpy implementation."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            lib = ctypes.CDLL(build_shared("tpurt_native", [SRC], _CMD, timeout=300)[0])
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            _build_error = str(e)
            return None

        lib.sbvh_build.restype = ctypes.c_int
        lib.sbvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,          # tri_vtx, num_tris
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,        # vtx_pos, num_verts
            ctypes.c_float, ctypes.c_int, ctypes.c_int,          # alpha, min_leaf, max_leaf
            ctypes.c_float, ctypes.c_float,                      # tri_cost, node_cost
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # depths, bins
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
        ]
        lib.sbvh_free.restype = None
        lib.sbvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native builder built and loaded (``tpu_rt.native``'s
    ``native_available``)."""
    return get_lib() is not None


def build_error() -> str | None:
    return _build_error


def sbvh_build_native(tri_vtx_index, vtx_pos, platform, params):
    """Native SBVH build+flatten.  Returns (FlatBVH arrays dict, stats dict)
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None

    tri_vtx = np.ascontiguousarray(tri_vtx_index, np.int32)
    vtx = np.ascontiguousarray(vtx_pos, np.float32)
    num_tris = int(tri_vtx.shape[0])
    num_verts = int(vtx.shape[0])

    nodes_p = ctypes.POINTER(ctypes.c_float)()
    woop_p = ctypes.POINTER(ctypes.c_float)()
    tri_index_p = ctypes.POINTER(ctypes.c_int)()
    leaf_counts_p = ctypes.POINTER(ctypes.c_int)()
    n_nodes = ctypes.c_longlong()
    n_refs = ctypes.c_longlong()
    n_dup = ctypes.c_longlong()
    sah = ctypes.c_double()

    rc = lib.sbvh_build(
        tri_vtx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_tris,
        vtx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_verts,
        ctypes.c_float(params.split_alpha),
        platform.min_leaf_size, platform.max_leaf_size,
        ctypes.c_float(platform.sah_triangle_cost), ctypes.c_float(platform.sah_node_cost),
        params.max_depth, params.max_spatial_depth, params.num_spatial_bins,
        ctypes.byref(nodes_p), ctypes.byref(n_nodes),
        ctypes.byref(woop_p), ctypes.byref(n_refs),
        ctypes.byref(tri_index_p), ctypes.byref(leaf_counts_p),
        ctypes.byref(n_dup), ctypes.byref(sah),
    )
    if rc != 0:
        return None

    nn, nr = int(n_nodes.value), int(n_refs.value)
    try:
        nodes = np.ctypeslib.as_array(nodes_p, shape=(nn, 16)).copy()
        woop = np.ctypeslib.as_array(woop_p, shape=(max(nr, 1), 12))[:nr].copy()
        tri_index = np.ctypeslib.as_array(tri_index_p, shape=(max(nr, 1),))[:nr].copy()
        leaf_counts = np.ctypeslib.as_array(leaf_counts_p, shape=(nr + 1,)).copy()
    finally:
        for p in (nodes_p, woop_p, tri_index_p, leaf_counts_p):
            lib.sbvh_free(ctypes.cast(p, ctypes.c_void_p))

    arrays = {
        "nodes": nodes.astype(np.float32),
        "tri_woop": woop.astype(np.float32),
        "tri_index": tri_index.astype(np.int32),
        "leaf_counts": leaf_counts.astype(np.int32),
    }
    stats = {"num_duplicates": int(n_dup.value), "sah_cost": float(sah.value)}
    return arrays, stats
