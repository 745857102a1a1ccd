"""Scene: flatten a multi-submesh Mesh into the five parallel triangle
buffers the tracer and shader consume (reference src/rt/Scene.cc:35-83),
vectorized in numpy.

Buffers:
- tri_vtx_index   [T,3] i32 — vertex indices per triangle
- tri_normal      [T,3] f32 — geometric normal (normalized cross product)
- tri_material_u32[T]  u32 — material diffuse as ABGR8
- tri_shaded_u32  [T]  u32 — diffuse precomputed against the fixed headlight
                  dir normalize(1,2,3): color * (dot(n, light)*0.5 + 0.5)
- vtx_pos         [V,3] f32

Also keeps float-typed material/shaded colors for the differentiable shading
path (the reference only has the quantized u32s), and a content hash used as
the BVH cache key (Scene.cc:93-101).
"""

from __future__ import annotations

import numpy as np

from tpu_rt_torch.core.math import hash_bits, hash_buffer, to_abgr
from tpu_rt_torch.scene.objio import Mesh


class Scene:
    LIGHT = np.array([1.0, 2.0, 3.0], np.float32) / np.float32(np.linalg.norm([1.0, 2.0, 3.0]))

    def __init__(self, mesh: Mesh):
        self.vtx_pos = np.ascontiguousarray(mesh.positions, dtype=np.float32)
        self.num_vertices = self.vtx_pos.shape[0]

        idx_parts = []
        color_parts = []
        for sub, mat in zip(mesh.submeshes, mesh.materials):
            sub = np.asarray(sub, np.int32).reshape(-1, 3)
            idx_parts.append(sub)
            color_parts.append(np.tile(np.asarray(mat.diffuse, np.float32), (sub.shape[0], 1)))
        if idx_parts:
            self.tri_vtx_index = np.ascontiguousarray(np.concatenate(idx_parts), dtype=np.int32)
            diffuse = np.concatenate(color_parts).astype(np.float32)  # [T,4]
        else:
            self.tri_vtx_index = np.zeros((0, 3), np.int32)
            diffuse = np.zeros((0, 4), np.float32)
        self.num_triangles = self.tri_vtx_index.shape[0]

        p = self.vtx_pos
        i = self.tri_vtx_index
        e1 = p[i[:, 1]] - p[i[:, 0]]
        e2 = p[i[:, 2]] - p[i[:, 0]]
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        self.tri_normal = (n / np.maximum(ln, 1e-30)).astype(np.float32)

        # Material color (float + quantized).
        self.tri_material = diffuse                      # [T,4] f32 RGBA
        self.tri_material_u32 = to_abgr(diffuse)         # [T] u32

        # Headlight-shaded color precompute (Scene.cc:37,80).
        lambert = (self.tri_normal @ self.LIGHT) * 0.5 + 0.5
        shaded = np.concatenate(
            [diffuse[:, :3] * lambert[:, None], np.ones((self.num_triangles, 1), np.float32)], axis=1
        ).astype(np.float32)
        self.tri_shaded = shaded                         # [T,4] f32 RGBA
        self.tri_shaded_u32 = to_abgr(shaded)            # [T] u32

    def bbox(self):
        if self.num_vertices == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return self.vtx_pos.min(axis=0), self.vtx_pos.max(axis=0)

    def hash(self) -> int:
        """Content hash keying the BVH cache (Scene.cc:93-101)."""
        return hash_bits(
            hash_buffer(self.tri_vtx_index),
            hash_buffer(self.tri_normal),
            hash_buffer(self.tri_material_u32),
            hash_buffer(self.tri_shaded_u32),
            hash_buffer(self.vtx_pos),
        )

    def triangles(self) -> np.ndarray:
        """[T,3,3] f32 vertex positions per triangle (convenience)."""
        return self.vtx_pos[self.tri_vtx_index]
