"""Fixed directories inside the checkout (all under the git-ignored
``build/``), so that only a checkout's first run of a cell builds."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "rtbench")
BUILD = os.path.join(ROOT, "build", "rtbench")
MESH_DIR = os.path.join(BUILD, "meshes")
BVH_DIR = os.path.join(BUILD, "bvhcache")
TRACE_DIR = os.path.join(BUILD, "trace")
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": os.path.join(BUILD, "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(BUILD, "triton"),
}
