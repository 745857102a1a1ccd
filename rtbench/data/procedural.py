"""Frozen copies of the procedural stand-in scenes, in NumPy.

The benchmark's scenes are the reference suite's stand-ins at their
published triangle counts: ``make_interior`` (architectural interiors such
as Conference) and ``make_blob`` (scanned models such as the Stanford
Dragon).  These functions are copied from the port's
``tpu_rt_torch/scene/procedural.py`` and frozen here, so that a later change
to the port's generators cannot change the benchmark's scenes;
``rtbench/tests/test_rtbench_data.py`` holds them equal, bit for bit.

A generator returns a ``Mesh``: float32 positions [V, 3], one int32 index
array [T_i, 3] per submesh, and one RGBA float32 diffuse color per submesh.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_DIFFUSE = (0.75, 0.75, 0.75, 1.0)


@dataclass
class Mesh:
    positions: np.ndarray      # [V, 3] f32
    submeshes: list            # [T_i, 3] i32 each
    diffuse: list              # [4] f32 RGBA each, parallel to submeshes
    names: list                # material names, parallel to submeshes

    def flat_indices(self) -> np.ndarray:
        return np.concatenate([s.reshape(-1, 3) for s in self.submeshes]).astype(np.int32)

    def tri_diffuse(self) -> np.ndarray:
        """[T, 4] f32: each triangle's diffuse color."""
        return np.concatenate([np.tile(np.asarray(d, np.float32), (s.shape[0], 1))
                               for s, d in zip(self.submeshes, self.diffuse)])


def _mesh_from_tris(positions, indices, diffuse=None, names=None, splits=None) -> Mesh:
    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    if diffuse is None:
        return Mesh(positions, [indices], [np.array(DEFAULT_DIFFUSE, np.float32)], ["default"])
    submeshes = []
    start = 0
    for count in splits:
        submeshes.append(indices[start:start + count])
        start += count
    return Mesh(positions, submeshes, [np.asarray(d, np.float32) for d in diffuse], list(names))


def make_cube(center=(0, 0, 0), size=1.0) -> Mesh:
    c = np.asarray(center, np.float32)
    h = size * 0.5
    corners = np.array(
        [[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)], np.float32
    ) + c
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    idx = []
    for a, b, cc, d in faces:
        idx += [(a, b, cc), (a, cc, d)]
    return _mesh_from_tris(corners, np.asarray(idx, np.int32))


def make_sphere(n_lat: int = 16, n_lon: int = 32, radius: float = 1.0, center=(0, 0, 0)) -> Mesh:
    c = np.asarray(center, np.float32)
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    lat, lon = np.meshgrid(lats, lons, indexing="ij")
    pos = np.stack(
        [
            radius * np.sin(lat) * np.cos(lon),
            radius * np.cos(lat),
            radius * np.sin(lat) * np.sin(lon),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32) + c

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            cq, d = vid(i + 1, j), vid(i + 1, j + 1)
            if i > 0:
                idx.append((a, b, d))
            if i < n_lat - 1:
                idx.append((a, d, cq))
    return _mesh_from_tris(pos, np.asarray(idx, np.int32))


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    pos = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    idx = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int32,
    )
    return pos, idx


def _subdivide(pos, idx):
    """One loop of 1->4 triangle subdivision with midpoint welding."""
    edge_cache: dict = {}
    pos_list = list(pos)

    def midpoint(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        cached = edge_cache.get(key)
        if cached is not None:
            return cached
        m = (pos[a] + pos[b]) * 0.5
        pos_list.append(m)
        edge_cache[key] = len(pos_list) - 1
        return edge_cache[key]

    out = np.empty((idx.shape[0] * 4, 3), np.int64)
    for k, (a, b, c) in enumerate(idx):
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out[4 * k + 0] = (a, ab, ca)
        out[4 * k + 1] = (b, bc, ab)
        out[4 * k + 2] = (c, ca, bc)
        out[4 * k + 3] = (ab, bc, ca)
    return np.asarray(pos_list, np.float64), out


def _fbm3(p, seed: int, octaves: int = 5):
    rng = np.random.default_rng(seed)
    out = np.zeros(p.shape[0])
    amp = 1.0
    freq = 1.5
    for _ in range(octaves):
        d = rng.normal(size=(3, 3))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        q = p @ d.T * freq
        out += amp * (np.sin(q[:, 0] + ph[0]) * np.sin(q[:, 1] + ph[1]) * np.sin(q[:, 2] + ph[2]))
        amp *= 0.5
        freq *= 2.1
    return out


def make_blob(target_tris: int, seed: int = 1, roughness: float = 0.25,
              ground: bool = False) -> Mesh:
    """Displaced icosphere, a stand-in for scanned models (bunny, dragon),
    cut to exactly ``target_tris`` triangles."""
    blob_tris = target_tris - 2 if ground else target_tris
    pos, idx = _icosahedron()
    while idx.shape[0] < blob_tris:
        pos, idx = _subdivide(pos, idx)
    pos = pos / np.linalg.norm(pos, axis=1, keepdims=True)
    disp = _fbm3(pos, seed)
    pos = pos * (1.0 + roughness * disp[:, None] * 0.5)
    idx = idx[:blob_tris]
    used = np.unique(idx)
    remap = np.full(pos.shape[0], -1, np.int64)
    remap[used] = np.arange(used.size)
    pos, idx = pos[used], remap[idx]
    if not ground:
        return _mesh_from_tris(pos, idx, diffuse=[DEFAULT_DIFFUSE], names=["blob"],
                               splits=[idx.shape[0]])
    y0 = float(pos[:, 1].min())
    ext = float(np.abs(pos).max()) * 2.5
    quad = np.array([[-ext, y0, -ext], [ext, y0, -ext],
                     [ext, y0, ext], [-ext, y0, ext]], np.float32)
    v = pos.shape[0]
    gidx = np.array([[v, v + 1, v + 2], [v, v + 2, v + 3]], np.int64)
    return _mesh_from_tris(np.concatenate([pos, quad]), np.concatenate([idx, gidx]),
                           diffuse=[DEFAULT_DIFFUSE, (0.7, 0.7, 0.7, 1.0)],
                           names=["blob", "ground"], splits=[idx.shape[0], 2])


def make_interior(target_tris: int, seed: int = 2) -> Mesh:
    """Architectural interior stand-in (conference, sponza, sibenik): a box
    room with columns and clutter spheres, one material per part."""
    rng = np.random.default_rng(seed)
    parts = []

    def add(mesh: Mesh):
        parts.append((mesh.positions, mesh.flat_indices()))

    add(make_cube(center=(0, 0.5, 0), size=1.0))
    parts[-1] = (parts[-1][0] * np.array([20.0, 5.0, 10.0], np.float32), parts[-1][1])

    n_cols = 12
    for i in range(n_cols):
        x = -8.0 + 16.0 * (i % (n_cols // 2)) / (n_cols // 2 - 1)
        z = -3.0 if i < n_cols // 2 else 3.0
        col = make_sphere(6, 8, radius=0.5, center=(x, 2.0, z))
        sq = col.positions
        sq[:, 1] = sq[:, 1] * 4.0 - 4.0
        add(col)

    count = sum(p[1].shape[0] for p in parts)
    while count < target_tris:
        remaining = target_tris - count
        n_lat = int(np.clip(np.sqrt(remaining / 4), 3, 24))
        n_lon = 2 * n_lat
        center = rng.uniform([-9, 0.3, -4], [9, 4.5, 4])
        r = rng.uniform(0.15, 0.8)
        s = make_sphere(n_lat, n_lon, radius=r, center=center)
        add(s)
        count += s.flat_indices().shape[0]

    palette = [(0.8, 0.7, 0.6, 1.0), (0.6, 0.6, 0.8, 1.0), (0.7, 0.8, 0.6, 1.0),
               (0.9, 0.5, 0.4, 1.0)]
    all_pos, all_idx, splits = [], [], []
    voffset = 0
    for p, i in parts:
        all_pos.append(p)
        all_idx.append(i + voffset)
        splits.append(i.shape[0])
        voffset += p.shape[0]
    idx = np.concatenate(all_idx)[:target_tris]
    total = 0
    kept_splits, kept_diffuse, kept_names = [], [], []
    for k, s in enumerate(splits):
        take = min(s, idx.shape[0] - total)
        if take <= 0:
            break
        kept_splits.append(take)
        kept_diffuse.append(palette[k % len(palette)])
        kept_names.append(f"m{k % len(palette)}")
        total += take
    return _mesh_from_tris(np.concatenate(all_pos), idx, diffuse=kept_diffuse,
                           names=kept_names, splits=kept_splits)


GENERATORS = {"make_interior": make_interior, "make_blob": make_blob}
