"""Hash-keyed BVH build cache.

Equivalent of the reference's bvhcache/%08x.dat discipline
(src/rt/cuda/Renderer.cc:157-217, CudaBVH.cc:79-116): the key hashes the
scene content, the SAH platform, the build params, and the layout version;
the payload is the flattened arrays (npz) plus build stats, so a cache hit
skips SBVH construction entirely.
"""

from __future__ import annotations

import os
import numpy as np

from tpu_rt_torch.bvh.builder import BuildParams, BuildStats, Platform, build_sbvh
from tpu_rt_torch.bvh.flatten import flatten_bvh
from tpu_rt_torch.core.math import hash_bits
from tpu_rt_torch.core.types import FlatBVH

LAYOUT_VERSION = 2  # bump when the FlatBVH layout changes


def build_flat_bvh(scene, platform: Platform, params: BuildParams, backend: str = "auto"):
    """Build + flatten, choosing the native C++ or numpy builder."""
    if backend in ("auto", "native"):
        from tpu_rt_torch import native

        out = native.sbvh_build_native(scene.tri_vtx_index, scene.vtx_pos, platform, params)
        if out is not None:
            arrays, nstats = out
            flat = FlatBVH(
                nodes=arrays["nodes"],
                tri_woop=arrays["tri_woop"],
                tri_index=arrays["tri_index"],
                leaf_counts=arrays["leaf_counts"],
            )
            links = arrays["nodes"][:, 12:16].copy().view(np.int32)
            num_leaves = int((links[:, :2] < 0).sum())
            stats = BuildStats(
                sah_cost=nstats["sah_cost"],
                num_inner_nodes=int(arrays["nodes"].shape[0]),
                num_leaf_nodes=num_leaves,
                num_child_nodes=2 * int(arrays["nodes"].shape[0]),
                num_tris=int(arrays["tri_index"].shape[0]),
                num_duplicates=nstats["num_duplicates"],
            )
            return flat, stats
        if backend == "native":
            raise RuntimeError(f"native builder unavailable: {native.build_error()}")

    bvh = build_sbvh(scene, platform, params)
    flat = flatten_bvh(bvh, scene.tri_vtx_index, scene.vtx_pos)
    return flat, bvh.stats


def bvh_cache_key(scene, platform: Platform, params: BuildParams) -> int:
    return hash_bits(scene.hash(), platform.hash(), params.hash(), LAYOUT_VERSION)


def platform_from_env() -> Platform:
    """Default build platform, with env overrides for SAH retuning
    sweeps (negative result recorded in ARCHITECTURE.md):
    TPU_RT_SAH_NODE_COST / _TRI_COST /
    _MIN_LEAF / _MAX_LEAF.  The cache key includes the platform hash,
    so overridden builds never collide with the defaults."""
    p = Platform.gpu()
    nc = os.environ.get("TPU_RT_SAH_NODE_COST")
    tc = os.environ.get("TPU_RT_SAH_TRI_COST")
    mn = os.environ.get("TPU_RT_SAH_MIN_LEAF")
    mx = os.environ.get("TPU_RT_SAH_MAX_LEAF")
    if nc or tc or mn or mx:
        p = Platform(
            name=f"GPU-tuned-{nc or 1}-{tc or 1}-{mn or p.min_leaf_size}-{mx or p.max_leaf_size}",
            sah_node_cost=float(nc) if nc else p.sah_node_cost,
            sah_triangle_cost=float(tc) if tc else p.sah_triangle_cost,
            min_leaf_size=int(mn) if mn else p.min_leaf_size,
            max_leaf_size=int(mx) if mx else p.max_leaf_size,
        )
    return p


QUAD_LAYOUT_VERSION = 1  # bump when the QuadBVH layout changes


def _tmp_path(path: str) -> str:
    """A temporary file of this process's own for a cache entry: ranks that
    share a cache directory may build one entry at once, and each
    ``os.replace`` then installs a whole file."""
    return f"{path}.{os.getpid()}.tmp.npz"


def load_or_collapse_quad(flat: FlatBVH, leaf_max: int | None = None,
                          cache_dir: str | None = "bvhcache"):
    """Collapse the binary FlatBVH to a QuadBVH (bvh.collapse.collapse4),
    consulting/populating the cache.  Key = content hash of the binary
    arrays + leaf_max + layout version (same %08x.npz discipline as the
    binary cache; a quad entry is derived data, so it keys off the flat
    arrays themselves rather than the scene/platform/params triple —
    any upstream change reflects in the bytes)."""
    import hashlib

    from tpu_rt_torch.bvh.collapse import MAX_LEAF4, QuadBVH, collapse4

    if leaf_max is None:
        leaf_max = MAX_LEAF4
    path = None
    if cache_dir is not None:
        h = hashlib.blake2b(digest_size=8)
        h.update(np.ascontiguousarray(flat.nodes).tobytes())
        h.update(np.ascontiguousarray(flat.tri_index).tobytes())
        h.update(f"quad4:{leaf_max}:{QUAD_LAYOUT_VERSION}".encode())
        path = os.path.join(cache_dir, f"q{h.hexdigest()[:8]}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return QuadBVH(nodes=z["nodes"], tri_woop=z["tri_woop"],
                               tri_index=z["tri_index"])
    quad = collapse4(flat, leaf_max=leaf_max)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _tmp_path(path)
        np.savez_compressed(tmp, nodes=quad.nodes, tri_woop=quad.tri_woop,
                            tri_index=quad.tri_index)
        os.replace(tmp, path)
    return quad


def load_or_build_bvh(
    scene,
    platform: Platform | None = None,
    params: BuildParams | None = None,
    cache_dir: str | None = "bvhcache",
    backend: str = "auto",
) -> tuple[FlatBVH, BuildStats]:
    """Return (FlatBVH, BuildStats), consulting/populating the cache.

    backend: "auto" prefers the native C++ builder (tpu_rt_torch.native) and falls
    back to numpy; "native"/"numpy" force one (native raises if missing).
    """
    platform = platform or platform_from_env()
    if params is None:
        params = BuildParams()
        # Env override for the spatial-split alpha gate (mirrors the
        # reference --sbvh-alpha flag; TPU_RT_SBVH_ALPHA=1e9 disables
        # spatial splits — the hairball-class surrogate's dense
        # overlapping ribbons blow up split duplication 16x otherwise).
        alpha = os.environ.get("TPU_RT_SBVH_ALPHA")
        if alpha:
            params = BuildParams(split_alpha=float(alpha))

    path = None
    if cache_dir is not None:
        key = bvh_cache_key(scene, platform, params)
        path = os.path.join(cache_dir, f"{key:08x}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                flat = FlatBVH(
                    nodes=z["nodes"],
                    tri_woop=z["tri_woop"],
                    tri_index=z["tri_index"],
                    leaf_counts=z["leaf_counts"],
                )
                stats = BuildStats(
                    sah_cost=float(z["sah_cost"]),
                    num_inner_nodes=int(z["num_inner"]),
                    num_leaf_nodes=int(z["num_leaf"]),
                    num_child_nodes=int(z["num_child"]),
                    num_tris=int(z["num_tris"]),
                    num_duplicates=int(z["num_duplicates"]),
                )
            return flat, stats

    flat, stats = build_flat_bvh(scene, platform, params, backend=backend)

    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _tmp_path(path)
        np.savez_compressed(
            tmp,
            nodes=np.asarray(flat.nodes),
            tri_woop=np.asarray(flat.tri_woop),
            tri_index=np.asarray(flat.tri_index),
            leaf_counts=np.asarray(flat.leaf_counts),
            sah_cost=np.float64(stats.sah_cost),
            num_inner=np.int64(stats.num_inner_nodes),
            num_leaf=np.int64(stats.num_leaf_nodes),
            num_child=np.int64(stats.num_child_nodes),
            num_tris=np.int64(stats.num_tris),
            num_duplicates=np.int64(stats.num_duplicates),
        )
        os.replace(tmp, path)
    return flat, stats
