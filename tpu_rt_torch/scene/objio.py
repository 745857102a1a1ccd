"""Mesh and material containers (host, numpy).

Counterpart of the ``Mesh``/``Material`` half of ``tpu_rt.scene.objio``.
Wavefront OBJ/MTL import and export are not ported yet (ROADMAP.md); the
port's scenes come from ``tpu_rt_torch.scene.procedural``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    """Submesh material (reference Mesh.hh:82-98 Material)."""

    name: str = "default"
    diffuse: np.ndarray = field(default_factory=lambda: np.array([0.75, 0.75, 0.75, 1.0], np.float32))
    specular: np.ndarray = field(default_factory=lambda: np.array([0.5, 0.5, 0.5], np.float32))
    glossiness: float = 32.0
    displacement_coef: float = 0.0
    displacement_bias: float = 0.0
    textures: dict = field(default_factory=dict)  # kind -> filename


@dataclass
class Mesh:
    """Indexed triangle mesh with per-material submeshes.

    positions: [V,3] f32; normals/texcoords optional, same V.
    submeshes: list of ([T_i,3] int32 index arrays); materials parallel list.
    """

    positions: np.ndarray
    normals: np.ndarray | None
    texcoords: np.ndarray | None
    submeshes: list
    materials: list

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(sum(s.shape[0] for s in self.submeshes))

    def flat_indices(self) -> np.ndarray:
        if not self.submeshes:
            return np.zeros((0, 3), np.int32)
        return np.concatenate([s.reshape(-1, 3) for s in self.submeshes]).astype(np.int32)

    def bbox(self):
        lo = self.positions.min(axis=0)
        hi = self.positions.max(axis=0)
        return lo.astype(np.float32), hi.astype(np.float32)
