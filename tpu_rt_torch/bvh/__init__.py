from tpu_rt_torch.bvh.builder import BuildParams, BuildStats, Platform, build_sbvh
from tpu_rt_torch.bvh.flatten import flatten_bvh, woopify
from tpu_rt_torch.bvh.cache import bvh_cache_key, load_or_build_bvh, load_or_collapse_quad

__all__ = [
    "BuildParams",
    "BuildStats",
    "Platform",
    "build_sbvh",
    "flatten_bvh",
    "woopify",
    "bvh_cache_key",
    "load_or_build_bvh",
    "load_or_collapse_quad",
]
