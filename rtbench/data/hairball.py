"""The hairball stand-in, frozen, and its entries in the benchmark's tables.

``make_hairball`` is copied from the port's
``tpu_rt_torch/scene/procedural.py`` and frozen here (as
``rtbench/data/procedural.py`` freezes the other stand-ins), so that a later
change to the port's generator cannot change the benchmark's scene; it
gives the port's positions, indices, submesh and material byte for byte,
as a ``procedural.Mesh``.

Importing this module registers the scene where the benchmark looks a
scene up, each entry with ``setdefault`` so that no existing entry can
change: the generator in ``procedural.GENERATORS``, and the suite's
hairball framing in ``workload``: ``for_bbox`` (it is not an interior) at
the reference's decoded 73.7 deg, and the AO radius rule, the reference's
5 over its decoded extent of 9 (the port's ``tpu_rt_torch/bench/
workload.py`` values).  The driver that traces the hairball imports it.
"""

from __future__ import annotations

import numpy as np

from rtbench.data import procedural, workload


def make_hairball(target_tris: int, seed: int = 3) -> procedural.Mesh:
    """Incoherent-geometry stand-in for the hairball scene: thin curled
    triangle ribbons crammed into a ball.  Each strand wanders locally
    around a random center, and the ball's radius grows as n^(1/3), so the
    strand density does not depend on the count and an SBVH build at the
    reference's alpha (1e-5) stays bounded (about 40% duplication at 200K
    and 1M triangles)."""
    rng = np.random.default_rng(seed)
    segs_per_strand = 96
    tris_per_strand = segs_per_strand * 2
    n_strands = max(1, -(-target_tris // tris_per_strand))  # ceil, truncated below
    local_amp = 0.3
    # Constant strand density: ~1600 strands fit radius 1.2.
    ball_r = 1.2 * max(n_strands / 1050.0, 1.0) ** (1.0 / 3.0)

    pos_parts, idx_parts = [], []
    voffset = 0
    t = np.linspace(0, 1, segs_per_strand + 1)
    for _ in range(n_strands):
        center = rng.normal(size=3)
        center *= rng.uniform(0, ball_r) / max(np.linalg.norm(center), 1e-6)
        # Random smooth local space-curve: sum of a few random sinusoids.
        freqs = rng.uniform(1.0, 4.0, size=(3, 3))
        phases = rng.uniform(0, 2 * np.pi, size=(3, 3))
        amps = rng.dirichlet(np.ones(3), size=3) * rng.uniform(0.5, 1.0) * local_amp
        curve = np.tile(center, (segs_per_strand + 1, 1))
        for d in range(3):
            for k in range(3):
                curve[:, d] += amps[d, k] * np.sin(2 * np.pi * freqs[d, k] * t + phases[d, k])
        # Ribbon: offset along a random constant binormal.
        width = rng.uniform(0.004, 0.012)
        binormal = rng.normal(size=3)
        binormal = binormal / np.linalg.norm(binormal) * width
        left = curve - binormal
        right = curve + binormal
        pts = np.empty((2 * (segs_per_strand + 1), 3))
        pts[0::2] = left
        pts[1::2] = right
        tri = []
        for s in range(segs_per_strand):
            a, b, c, d = 2 * s, 2 * s + 1, 2 * s + 2, 2 * s + 3
            tri += [(a, b, c), (b, d, c)]
        pos_parts.append(pts)
        idx_parts.append(np.asarray(tri, np.int64) + voffset)
        voffset += pts.shape[0]

    pos = np.concatenate(pos_parts)
    idx = np.concatenate(idx_parts)[:target_tris]
    return procedural._mesh_from_tris(pos, idx, diffuse=[(0.7, 0.6, 0.3, 1.0)], names=["hair"],
                                      splits=[idx.shape[0]])


procedural.GENERATORS.setdefault("make_hairball", make_hairball)
workload.SCENE_FOV.setdefault("hairball", 73.7)
workload.REF_AO_RADIUS.setdefault("hairball", 5.0)
workload.REF_EXTENT_EST.setdefault("hairball", 9.0)
