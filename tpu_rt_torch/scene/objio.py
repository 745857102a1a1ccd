"""Wavefront OBJ + MTL import (host, numpy).

Counterpart of ``tpu_rt.scene.objio``, a copy held bit-equal to it: the same
arrays, and the same bytes in an exported file (``tests/test_torch_io.py``).

Behavioral parity with the reference importer
(src/framework/io/MeshWavefrontIO.cc:449-469 and helpers), re-implemented
vectorized where it matters:

- ``v``/``vn`` positions and normals; ``vt`` texcoords with the V flip
  (MeshWavefrontIO.cc:286-299).
- Faces of any arity triangulated as a fan (MeshWavefrontIO.cc:310-363);
  index forms ``p``, ``p/t``, ``p//n``, ``p/t/n``; negative (relative)
  indices.
- Vertex dedup on the (position, texcoord, normal) index triple
  (MeshWavefrontIO.cc:339-349).
- ``usemtl``/``mtllib`` split faces into one submesh per material
  (MeshWavefrontIO.cc:364-396); MTL ``Ka/Kd/Ks/d/Ns`` + texture map names
  parsed (MeshWavefrontIO.cc:131-243).
- Unknown-but-harmless directives ignored (MeshWavefrontIO.cc:398-430).
"""

from __future__ import annotations

import os
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

    def recompute_normals(self) -> None:
        """Area-weighted vertex normals (reference MeshBase::recomputeNormals,
        src/framework/3d/Mesh.cc:402)."""
        idx = self.flat_indices()
        p = self.positions
        fn = np.cross(p[idx[:, 1]] - p[idx[:, 0]], p[idx[:, 2]] - p[idx[:, 0]])
        acc = np.zeros_like(p)
        for k in range(3):
            np.add.at(acc, idx[:, k], fn)
        norms = np.linalg.norm(acc, axis=1, keepdims=True)
        self.normals = (acc / np.maximum(norms, 1e-30)).astype(np.float32)

    def _remap_vertices(self, remap: np.ndarray, keep: np.ndarray) -> None:
        """Apply a vertex remap + keep mask to all attributes and indices."""
        self.positions = np.ascontiguousarray(self.positions[keep])
        if self.normals is not None:
            self.normals = np.ascontiguousarray(self.normals[keep])
        if self.texcoords is not None:
            self.texcoords = np.ascontiguousarray(self.texcoords[keep])
        self.submeshes = [remap[s].astype(np.int32) for s in self.submeshes]

    def clean(self) -> None:
        """Remove degenerate triangles, empty submeshes, and unreferenced
        vertices (reference MeshBase::clean, src/framework/3d/Mesh.cc:460).
        Vectorized: mask instead of the reference's in-place compaction."""
        subs, mats = [], []
        for s, m in zip(self.submeshes, self.materials):
            s = s.reshape(-1, 3)
            ok = (s[:, 0] != s[:, 1]) & (s[:, 0] != s[:, 2]) & (s[:, 1] != s[:, 2])
            s = s[ok]
            if s.shape[0]:
                subs.append(np.ascontiguousarray(s.astype(np.int32)))
                mats.append(m)
        self.submeshes, self.materials = subs, mats
        used = np.zeros(self.num_vertices, bool)
        idx = self.flat_indices()
        used[idx.reshape(-1)] = True
        remap = np.cumsum(used, dtype=np.int64) - 1
        self._remap_vertices(remap, used)

    def collapse_vertices(self) -> None:
        """Collapse vertices whose full attribute tuples are identical
        (reference MeshBase::collapseVertices, Mesh.cc:538).  The reference
        hashes the raw vertex bytes; here np.unique over the stacked
        attribute rows plays that role."""
        cols = [self.positions]
        if self.normals is not None:
            cols.append(self.normals)
        if self.texcoords is not None:
            cols.append(self.texcoords)
        key = np.concatenate([c.reshape(self.num_vertices, -1) for c in cols],
                             axis=1)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        inverse = np.asarray(inverse).reshape(-1)
        # Keep first occurrences in original order (stable like the ref).
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        keep = np.zeros(self.num_vertices, bool)
        keep[first] = True
        remap = rank[inverse]
        self._remap_vertices(remap, keep)
        self.clean()

    def simplify(self, max_error: float) -> None:
        """Collapse short edges; no vertex drifts more than ``max_error``
        from its original position (reference MeshBase::simplify,
        Mesh.cc:643).  Idiomatic re-design: iterative rounds of
        independent-set shortest-edge collapses with area-weighted
        positions and accumulated drift tracking, instead of the
        reference's BinaryHeap + linked edge lists — same contract
        (bounded drift, degenerate faces cleaned afterwards)."""
        if self.num_vertices == 0:
            return
        v = self.num_vertices
        parent = np.arange(v)

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return int(i)

        pos = self.positions.astype(np.float32).copy()
        err = np.zeros(v, np.float32)   # accumulated drift bound per group
        for _ in range(16):             # rounds until no collapse applies
            idx = self.flat_indices()
            fa = np.fromiter((find(i) for i in idx.reshape(-1)),
                             np.int64, idx.size).reshape(-1, 3)
            p0, p1, p2 = pos[fa[:, 0]], pos[fa[:, 1]], pos[fa[:, 2]]
            area = np.maximum(
                np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1), 1e-8)
            w = np.zeros(v, np.float32)
            for k in range(3):
                np.add.at(w, fa[:, k], area.astype(np.float32))
            edges = np.concatenate([fa[:, [0, 1]], fa[:, [1, 2]],
                                    fa[:, [2, 0]]])
            edges = edges[edges[:, 0] != edges[:, 1]]
            if edges.shape[0] == 0:
                break
            edges = np.unique(np.sort(edges, axis=1), axis=0)
            elen = np.linalg.norm(pos[edges[:, 0]] - pos[edges[:, 1]],
                                  axis=1)
            order = np.argsort(elen, kind="stable")
            busy = np.zeros(v, bool)
            collapsed = 0
            for e in order:
                a, b = find(int(edges[e, 0])), find(int(edges[e, 1]))
                if a == b or busy[a] or busy[b]:
                    continue
                wa, wb = float(w[a]), float(w[b])
                tgt = (pos[a] * wa + pos[b] * wb) / max(wa + wb, 1e-30)
                # Triangle-inequality drift bound: every original vertex
                # in either group has drifted at most err + |move|.
                ea = err[a] + float(np.linalg.norm(tgt - pos[a]))
                eb = err[b] + float(np.linalg.norm(tgt - pos[b]))
                if max(ea, eb) > max_error:
                    continue
                busy[a] = busy[b] = True
                parent[b] = a
                pos[a] = tgt.astype(np.float32)
                err[a] = max(ea, eb)
                w[a] = wa + wb
                collapsed += 1
            if not collapsed:
                break
        roots = np.fromiter((find(i) for i in range(v)), np.int64, v)
        self.positions = pos[roots].astype(np.float32)
        self.submeshes = [roots[s].astype(np.int32) for s in self.submeshes]
        # positions now duplicated per original id; clean() drops
        # degenerates and unreferenced copies.
        self.clean()
        if self.normals is not None:
            self.recompute_normals()


_IGNORED_DIRECTIVES = {
    # Directives the reference silently skips (MeshWavefrontIO.cc:398-430).
    "vp", "deg", "bmat", "step", "cstype", "p", "l", "curv", "curv2", "surf",
    "parm", "trim", "hole", "scrv", "sp", "end", "con", "g", "s", "mg", "o",
    "bevel", "c_interp", "d_interp", "lod", "shadow_obj", "trace_obj",
    "ctech", "stech",
}

_MTL_TEXTURE_KEYS = {
    "map_kd": "diffuse", "map_ks": "specular", "map_d": "alpha",
    "map_bump": "displacement", "bump": "displacement", "disp": "displacement",
    "refl": "environment", "map_ka": "ambient", "map_ns": "glossiness",
}


def _parse_mtl(path: str, materials: dict) -> None:
    if not os.path.exists(path):
        return
    cur: Material | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            key = tokens[0].lower()
            try:
                if key == "newmtl":
                    name = tokens[1] if len(tokens) > 1 else ""
                    cur = materials.setdefault(name, Material(name=name))
                elif cur is None:
                    continue
                elif key == "kd":
                    vals = [float(v) for v in tokens[1:4]]
                    cur.diffuse = np.array(vals + [float(cur.diffuse[3])], np.float32)
                elif key == "ks":
                    cur.specular = np.array([float(v) for v in tokens[1:4]], np.float32)
                elif key == "d":
                    cur.diffuse = cur.diffuse.copy()
                    cur.diffuse[3] = float(tokens[1])
                elif key == "ns":
                    cur.glossiness = float(tokens[1])
                elif key in _MTL_TEXTURE_KEYS:
                    cur.textures[_MTL_TEXTURE_KEYS[key]] = " ".join(tokens[1:])
            except (ValueError, IndexError):
                continue  # reference tolerates malformed material rows


def _parse_index(token: str, counts: tuple[int, int, int]) -> tuple[int, int, int]:
    """Parse one face corner 'p', 'p/t', 'p//n', 'p/t/n' to 0-based
    (pos, tex, nrm) with -1 for absent; negative indices are relative."""
    parts = token.split("/")
    out = [-1, -1, -1]
    for i in range(min(3, len(parts))):
        s = parts[i]
        if not s:
            continue
        v = int(s)
        out[i] = v - 1 if v > 0 else counts[i] + v
    return out[0], out[1], out[2]


def import_wavefront_mesh(path: str, engine: str = "auto") -> Mesh:
    """Import an OBJ file.

    engine: "numpy" (vectorized token parse — the default path; a
    hairball-class 6.5M-tri file parses in seconds where the per-corner
    scalar loop takes minutes), "scalar" (the straightforward line loop,
    kept as the parity oracle), or "auto" (numpy with scalar fallback on
    malformed input).  Both produce IDENTICAL meshes: same vertex
    welding order (first occurrence), same submesh order (first usemtl
    use), same fan triangulation (tests/test_scene.py pins parity).
    """
    if engine in ("auto", "numpy"):
        try:
            return _import_wavefront_mesh_numpy(path)
        except (ValueError, IndexError) as e:
            # Only parse-shaped failures fall back to the scalar oracle
            # (genuine I/O faults and bugs propagate — a silent bare-
            # Exception fallback would mask them AND pay both the failed
            # vectorized pass and the minutes-long scalar pass).
            if engine == "numpy":
                raise
            import warnings

            warnings.warn(
                f"numpy OBJ importer failed on {path!r} ({e!r}); "
                "falling back to the scalar parser")
    return _import_wavefront_mesh_scalar(path)


def _parse_float_block(tokens: np.ndarray, marker_pos: np.ndarray,
                       counts: np.ndarray, k: int, pad: float = 0.0):
    """First k numeric fields after each marker as [rows, k] f32; rows
    with fewer than k fields are padded with `pad`."""
    rows = marker_pos.shape[0]
    if rows == 0:
        return np.zeros((0, k), np.float32)
    out = np.full((rows, k), pad, np.float32)
    for j in range(k):
        have = counts > j
        if not have.any():
            break
        out[have, j] = tokens[marker_pos[have] + 1 + j].astype(np.float64)
    return out


def _import_wavefront_mesh_numpy(path: str) -> Mesh:
    """Vectorized OBJ parse: one pass classifies lines, then each
    directive class is parsed as a flat numpy token array (reference
    importer behavior per MeshWavefrontIO.cc:449-469; see module doc)."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()

    v_lines: list = []
    v_ln: list = []
    vt_lines: list = []
    vt_ln: list = []
    vn_lines: list = []
    vn_ln: list = []
    f_lines: list = []
    f_ln: list = []
    ev_ln: list = [-1]
    ev_name: list = [""]
    materials: dict[str, Material] = {}
    for i, l in enumerate(lines):
        if len(l) < 2:
            continue
        c0, c1 = l[0], l[1]
        if c0 == "v":
            if c1 == " " or c1 == "\t":
                v_lines.append(l)
                v_ln.append(i)
            elif c1 == "t":
                vt_lines.append(l)
                vt_ln.append(i)
            elif c1 == "n":
                vn_lines.append(l)
                vn_ln.append(i)
        elif c0 == "f" and (c1 == " " or c1 == "\t"):
            f_lines.append(l)
            f_ln.append(i)
        elif c0 == "u" and l.startswith("usemtl"):
            t = l.split()
            ev_ln.append(i)
            ev_name.append(t[1] if len(t) > 1 else "")
        elif c0 == "m" and l.startswith("mtllib"):
            t = l.split()
            _parse_mtl(os.path.join(base_dir, " ".join(t[1:])), materials)

    def tok_block(block_lines, directive):
        """(tokens U-array, marker positions, per-line field counts)."""
        toks = np.asarray(" ".join(block_lines).split())
        if toks.size == 0:
            return toks, np.zeros(0, np.int64), np.zeros(0, np.int64)
        marks = np.flatnonzero(toks == directive)
        # Lines may hold stray repeats of the directive token only as
        # data (never for v/vt/vn/f numerics) — marker count must match.
        if marks.size != len(block_lines):
            raise ValueError("irregular OBJ block")
        counts = np.diff(np.append(marks, toks.size)) - 1
        return toks, marks, counts

    vtok, vmark, vcnt = tok_block(v_lines, "v")
    if (vcnt < 3).any():
        raise ValueError("short v line")
    positions = _parse_float_block(vtok, vmark, np.minimum(vcnt, 3), 3)
    ttok, tmark, tcnt = tok_block(vt_lines, "vt")
    texcoords = _parse_float_block(ttok, tmark, np.minimum(tcnt, 2), 2)
    texcoords[:, 1] = 1.0 - texcoords[:, 1]  # reference flips V (:293)
    ntok, nmark, ncnt = tok_block(vn_lines, "vn")
    if (ncnt < 3).any():
        raise ValueError("short vn line")
    normals = _parse_float_block(ntok, nmark, np.minimum(ncnt, 3), 3)

    ftok, fmark, fcnt = tok_block(f_lines, "f")
    fcnt = fcnt.copy()
    keep_f = fcnt >= 3  # legacy skips degenerate faces (<3 corners)
    # Corner tokens in file order, with their face id.
    corner_mask = np.ones(ftok.size, bool)
    corner_mask[fmark] = False
    face_of_tok = np.searchsorted(fmark, np.arange(ftok.size),
                                  side="right") - 1
    corners = ftok[corner_mask]
    face_of = face_of_tok[corner_mask]
    ok_c = keep_f[face_of]
    corners, face_of = corners[ok_c], face_of[ok_c]

    # Split 'p/t/n' forms (np.char: this numpy predates np.strings.partition).
    parts = np.char.partition(corners, "/")
    p_str, rest = parts[..., 0], parts[..., 2]
    parts2 = np.char.partition(rest, "/")
    t_str, n_str = parts2[..., 0], parts2[..., 2]

    def parse_idx(s, count_per_corner):
        missing = np.char.str_len(s) == 0
        raw = np.where(missing, "0", s).astype(np.int64)
        return np.where(missing, -1,
                        np.where(raw > 0, raw - 1, count_per_corner + raw))

    f_ln_arr = np.asarray(f_ln, np.int64)
    line_of_corner = f_ln_arr[face_of]
    vcnt_at = np.searchsorted(np.asarray(v_ln, np.int64), line_of_corner)
    tcnt_at = np.searchsorted(np.asarray(vt_ln, np.int64), line_of_corner)
    ncnt_at = np.searchsorted(np.asarray(vn_ln, np.int64), line_of_corner)
    pidx = parse_idx(p_str, vcnt_at)
    tidx = parse_idx(t_str, tcnt_at)
    nidx = parse_idx(n_str, ncnt_at)
    if pidx.size and (pidx.max() >= positions.shape[0] or pidx.min() < -1):
        raise ValueError("position index out of range")

    # Vertex welding on (p,t,n), first-occurrence order (legacy parity).
    order = np.lexsort((nidx, tidx, pidx))
    ps, ts, ns = pidx[order], tidx[order], nidx[order]
    new_grp = np.ones(order.size, bool)
    if order.size:
        new_grp[1:] = (ps[1:] != ps[:-1]) | (ts[1:] != ts[:-1]) | \
                      (ns[1:] != ns[:-1])
    gid_sorted = np.cumsum(new_grp) - 1
    gid = np.empty(order.size, np.int64)
    gid[order] = gid_sorted
    starts = np.flatnonzero(new_grp)
    first_occ = (np.minimum.reduceat(order, starts) if order.size
                 else np.zeros(0, np.int64))
    rank_order = np.argsort(first_occ, kind="stable")
    rank = np.empty_like(rank_order)
    rank[rank_order] = np.arange(rank_order.size)
    out_idx = rank[gid]  # per-corner output vertex id
    rep_corner = np.empty(rank_order.size, np.int64)  # group -> a corner
    rep_corner[out_idx] = np.arange(out_idx.size)
    rp, rt, rn = pidx[rep_corner], tidx[rep_corner], nidx[rep_corner]
    out_pos = positions[np.clip(rp, 0, max(positions.shape[0] - 1, 0))]
    out_pos[rp < 0] = 0.0
    valid_t = (rt >= 0) & (rt < texcoords.shape[0])
    out_tex = np.zeros((rt.size, 2), np.float32)
    out_tex[valid_t] = texcoords[rt[valid_t]]
    valid_n = (rn >= 0) & (rn < normals.shape[0])
    out_nrm = np.zeros((rn.size, 3), np.float32)
    out_nrm[valid_n] = normals[rn[valid_n]]
    any_tex = bool((tidx >= 0).any())
    any_nrm = bool((nidx >= 0).any())

    # Fan triangulation (vectorized ragged expansion).
    kept_faces = np.flatnonzero(keep_f)
    kcnt = fcnt[kept_faces]
    # First-corner offset of each kept face within `corners`.
    face_start = np.zeros(kept_faces.size, np.int64)
    if kept_faces.size:
        face_start[1:] = np.cumsum(kcnt)[:-1]
    ntri = kcnt - 2
    tri_face = np.repeat(np.arange(kept_faces.size), ntri)
    tri_start = np.zeros(kept_faces.size, np.int64)
    if kept_faces.size:
        tri_start[1:] = np.cumsum(ntri)[:-1]
    j = np.arange(tri_face.size) - tri_start[tri_face]
    base = face_start[tri_face]
    tris = np.stack([out_idx[base],
                     out_idx[base + j + 1],
                     out_idx[base + j + 2]], axis=1).astype(np.int32)

    # Material per face -> per tri; submeshes in first-use order.
    mtl_of_face = (np.searchsorted(np.asarray(ev_ln, np.int64),
                                   f_ln_arr[kept_faces], side="right") - 1)
    mtl_of_tri = mtl_of_face[tri_face]
    uniq, first = np.unique(mtl_of_tri, return_index=True)
    uniq_in_order = uniq[np.argsort(first, kind="stable")]
    submeshes, mats = [], []
    for m in uniq_in_order:
        name = ev_name[m]
        submeshes.append(np.ascontiguousarray(tris[mtl_of_tri == m]))
        mats.append(materials.get(name, Material(name=name or "default")))

    return Mesh(
        positions=np.ascontiguousarray(out_pos.astype(np.float32)),
        normals=(np.ascontiguousarray(out_nrm) if any_nrm else None),
        texcoords=(np.ascontiguousarray(out_tex) if any_tex else None),
        submeshes=submeshes,
        materials=mats,
    )


def _import_wavefront_mesh_scalar(path: str) -> Mesh:
    positions: list = []
    texcoords: list = []
    normals: list = []

    materials: dict[str, Material] = {}
    submesh_indices: dict[str, list] = {}
    current_mtl = ""

    # Output vertex welding: (p,t,n) triple -> output index.
    vertex_map: dict[tuple[int, int, int], int] = {}
    out_pos: list = []
    out_tex: list = []
    out_nrm: list = []
    any_tex = False
    any_nrm = False

    def corner(token: str) -> int:
        nonlocal any_tex, any_nrm
        key = _parse_index(token, (len(positions), len(texcoords), len(normals)))
        existing = vertex_map.get(key)
        if existing is not None:
            return existing
        p, t, n = key
        out_idx = len(out_pos)
        vertex_map[key] = out_idx
        out_pos.append(positions[p])
        out_tex.append(texcoords[t] if 0 <= t < len(texcoords) else (0.0, 0.0))
        out_nrm.append(normals[n] if 0 <= n < len(normals) else (0.0, 0.0, 0.0))
        if t >= 0:
            any_tex = True
        if n >= 0:
            any_nrm = True
        return out_idx

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            key = tokens[0]
            if key == "v":
                positions.append((float(tokens[1]), float(tokens[2]), float(tokens[3])))
            elif key == "vt":
                # Reference flips V (MeshWavefrontIO.cc:293).
                u = float(tokens[1])
                v = float(tokens[2]) if len(tokens) > 2 else 0.0
                texcoords.append((u, 1.0 - v))
            elif key == "vn":
                normals.append((float(tokens[1]), float(tokens[2]), float(tokens[3])))
            elif key == "f":
                if len(tokens) < 4:
                    continue
                idxs = [corner(t) for t in tokens[1:]]
                tris = submesh_indices.setdefault(current_mtl, [])
                for i in range(1, len(idxs) - 1):  # fan triangulation
                    tris.append((idxs[0], idxs[i], idxs[i + 1]))
            elif key == "usemtl":
                current_mtl = tokens[1] if len(tokens) > 1 else ""
            elif key == "mtllib":
                _parse_mtl(os.path.join(base_dir, " ".join(tokens[1:])), materials)
            elif key.lower() in _IGNORED_DIRECTIVES:
                continue
            # Anything else: skip silently (reference warns once; we tolerate).

    submeshes = []
    mats = []
    for name, tris in submesh_indices.items():
        if not tris:
            continue
        submeshes.append(np.asarray(tris, np.int32))
        mats.append(materials.get(name, Material(name=name or "default")))

    mesh = Mesh(
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(-1, 3) if any_nrm else None,
        texcoords=np.asarray(out_tex, np.float32).reshape(-1, 2) if any_tex else None,
        submeshes=submeshes,
        materials=mats,
    )
    return mesh


def export_wavefront_mesh(mesh: Mesh, path: str) -> None:
    """Minimal OBJ writer (round-trip testing + interchange)."""
    with open(path, "w") as f:
        f.write("# tpu_rt OBJ export\n")
        mtl_path = os.path.splitext(path)[0] + ".mtl"
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        for p in mesh.positions:
            f.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                f.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        has_n = mesh.normals is not None
        for sub, mat in zip(mesh.submeshes, mesh.materials):
            f.write(f"usemtl {mat.name}\n")
            for tri in sub:
                if has_n:
                    f.write("f " + " ".join(f"{i + 1}//{i + 1}" for i in tri) + "\n")
                else:
                    f.write("f " + " ".join(str(i + 1) for i in tri) + "\n")
    with open(mtl_path, "w") as f:
        for mat in mesh.materials:
            f.write(f"newmtl {mat.name}\n")
            f.write(f"Kd {mat.diffuse[0]:.6g} {mat.diffuse[1]:.6g} {mat.diffuse[2]:.6g}\n")
            f.write(f"Ks {mat.specular[0]:.6g} {mat.specular[1]:.6g} {mat.specular[2]:.6g}\n")
            f.write(f"Ns {mat.glossiness:.6g}\nd {mat.diffuse[3]:.6g}\n")
