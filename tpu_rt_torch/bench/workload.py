"""Reference-calibrated suite workload: cameras, frame size and AO radii.

Counterpart of ``tpu_rt.bench.workload``, verbatim: the per-scene field of
view decoded from the reference's committed camera signatures (73.7 deg for
interiors and hairball, 46.8 deg for the object scenes), the framing of
each procedural stand-in, the committed 640x480 frame, and the AO radius
of each scene scaled from the reference's absolute radius to the
stand-in's extent (the same relative occlusion range).
"""

from __future__ import annotations

import numpy as np

# Reference absolute AO radii (grtcmdline.txt per-scene flags).
REF_AO_RADIUS = {
    "conference": 5.0, "fairy": 0.3, "sibenik": 5.0, "sanmiguel": 1.5,
    "sponza": 5.0, "knob": 5.0, "dragon": 5.0, "bunny": 5.0,
    "hairball": 5.0,
}

# Reference scene-extent estimates (units) from the decoded committed
# cameras (|position|, near/far): object scenes are ~2-3 units,
# interiors tens of units.
REF_EXTENT_EST = {
    "conference": 30.0, "fairy": 4.0, "sibenik": 20.0, "sanmiguel": 26.0,
    "sponza": 20.0, "knob": 2.2, "dragon": 1.6, "bunny": 3.0,
    "hairball": 9.0,
}

# Decoded per-scene camera fov (deg): 73.7 interiors/hairball, 46.8
# object scenes.
SCENE_FOV = {
    "conference": 73.7, "sibenik": 73.7, "sanmiguel": 73.7,
    "sponza": 73.7, "hairball": 73.7,
    "fairy": 46.8, "knob": 46.8, "dragon": 46.8, "bunny": 46.8,
}

# Reference committed frame (App.cc:53).
FRAME_W, FRAME_H = 640, 480


def scene_extent(scene) -> float:
    lo, hi = scene.bbox()
    return float(np.linalg.norm(hi - lo))


def suite_ao_radius(scene_name: str, scene, spec: str = "grt") -> float:
    """AO radius for a suite row.  spec: "grt" (default — the
    reference's absolute radius scaled to the surrogate's extent),
    "rel:<v>" (v x surrogate extent), or "abs:<v>"."""
    if spec == "grt":
        ref_r = REF_AO_RADIUS.get(scene_name, 5.0)
        ref_e = REF_EXTENT_EST.get(scene_name)
        if ref_e is None:
            return ref_r
        return ref_r * scene_extent(scene) / ref_e
    kind, val = spec.split(":")
    return float(val) * (scene_extent(scene) if kind == "rel" else 1.0)

# Interior surrogates (make_interior room shells): the reference
# cameras for these scenes sit INSIDE the architecture (decoded
# positions are within the room bounds), so nearly every primary ray
# hits — the round-3 suite framed them from OUTSIDE the shell, which
# left only ~25% of the frame on-scene and quartered every secondary
# row's metric numerator.
INTERIOR_SCENES = {"conference", "fairy", "sibenik", "sanmiguel", "sponza"}


def suite_camera(scene_name: str, scene):
    """Reference-framing camera for a suite scene: per-scene fov;
    interiors are framed from INSIDE the room (like every committed
    interior signature); the knob camera frames the OBJECT (blob bbox,
    plane visible below) from 25 deg elevation, like the committed Mori
    Knob signature — framing the whole ground plane makes the workload
    plane-dominated, which the reference's object-dominated IST
    percentages rule out."""
    from tpu_rt_torch.scene import Camera

    fov = SCENE_FOV.get(scene_name, 70.0)
    if scene_name == "knob":
        # Ground quad vertices are the last 4 (procedural.make_blob).
        pos = np.asarray(scene.vtx_pos)[:-4]
        return Camera.for_bbox(pos.min(0), pos.max(0), fov=fov,
                               elevation_deg=25.0)
    lo, hi = scene.bbox()
    if scene_name in INTERIOR_SCENES:
        lo3 = np.asarray(lo, np.float32)
        hi3 = np.asarray(hi, np.float32)
        center = (lo3 + hi3) * 0.5
        # Stand at 90% toward the -X wall at mid height, look down the
        # room's long axis (make_interior rooms are longest in X).
        position = np.array([lo3[0] + 0.1 * (hi3[0] - lo3[0]),
                             center[1], center[2]], np.float32)
        fwd = (center - position)
        fwd /= np.linalg.norm(fwd)
        size = float(np.linalg.norm(hi3 - lo3))
        return Camera(position=position, forward=fwd.astype(np.float32),
                      up=np.array([0.0, 1.0, 0.0], np.float32),
                      fov=fov, near=size * 0.005, far=size * 3.0)
    return Camera.for_bbox(lo, hi, fov=fov)
