"""The plain reference of the diffuse cells: the rays the reference
renderer's diffuse branch makes and the closest hits they need.

Renderer::nextBatch's diffuse branch (Renderer.cc:274-279) calls the AO
generator with maxDist = the camera's far and asks the tracer for the
closest hit.  So a diffuse ray is the AO ray of ``raygen.ao_rays``
(RayGenKernels.cu:117-227: the hit point backtracked along the primary
ray, the normal turned to face it, the Jenkins rotation word of the seed
and the primary slot, Halton (2, 3), the cosine hemisphere; tmax -1 behind
a primary miss) with the camera's far, in float32, as its tmax.

- ``judge_diffuse``: ``ray_gap`` as the AO cells' (``judge._ao_ray_gap``,
  the far as the radius: each primary hit the reference could accept is
  tried) and ``hit_gap`` judged as a closest hit (``judge.hit_gap`` with
  ``any_hit=False``: a nearer hit costs what the AO cells let pass).
- ``control_answers``: the control's AO rays with the far as the radius
  and their closest hits, in bfloat16 (``control.trace_answers``, whose
  answers are closest hits for every ray type), for ``calibrate.py``.

Departures from Renderer.cc:274-279 and RayGenKernels.cu:117-227: none
beyond the AO rays' (``raygen.py``).  The far is the configuration's
camera rule (3 x the scene's diagonal for an interior), not that of the
fork's camera signatures; a ray that leaves the scene is a miss either
way.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference import control, judge, raygen

RAY_KEYS = ("origin", "dirn", "tmin", "tmax")


def judge_diffuse(scene: judge.RefScene, cams, mix: dict, items: dict, answers: dict,
                  seed: int) -> dict:
    """``ray_gap`` and ``hit_gap`` per item.  ``items``: pose, slot (the
    primary ray) and sample per item; ``answers``: the judged side's ray
    (origin, dirn, tmin, tmax) and hit (tri, t) for it."""
    w, h = mix["width"], mix["height"]
    i2p = raygen.morton_index_to_pixel(w, h)
    n = len(items["slot"])
    ray_gap, hit = np.zeros(n), np.zeros(n)
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        slots = items["slot"][sel]
        prim = raygen.primary_rays(cams[p], w, h, i2p[slots], scene.dtype, scene.device)
        theirs = tuple(judge._f(answers[k][sel], scene) for k in RAY_KEYS)
        ray_gap[sel] = judge._ao_ray_gap(scene, prim, theirs, slots, items["sample"][sel], seed,
                                         cams[p]["far"])
        hit[sel] = judge.hit_gap(scene, theirs, answers["tri"][sel], answers["t"][sel],
                                 any_hit=False)
    return {"ray_gap": np.minimum(ray_gap, 1.0), "hit_gap": hit}


def control_answers(ref: judge.RefScene, cams, mix: dict, items: dict, seed: int) -> dict:
    """Rays and closest hits of the sampled diffuse items, in bfloat16."""
    ao = dict(mix, ray_type="ao")
    out = {}
    for p in np.unique(items["pose"]):
        sel = np.nonzero(items["pose"] == p)[0]
        got = control.trace_answers(ref, cams, ao, {k: v[sel] for k, v in items.items()}, seed,
                                    cams[p]["far"])
        for k, v in got.items():
            out.setdefault(k, np.zeros((len(items["pose"]),) + v.shape[1:], v.dtype))[sel] = v
    return out
