"""Reference-calibrated suite cameras.

Counterpart of the camera half of ``tpu_rt.bench.workload``, verbatim: the
per-scene field of view decoded from the reference's committed camera
signatures (73.7 deg for interiors and hairball, 46.8 deg for the object
scenes) and the framing of each procedural stand-in.  The AO-radius
calibration is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

# Decoded per-scene camera fov (deg): 73.7 interiors/hairball, 46.8
# object scenes.
SCENE_FOV = {
    "conference": 73.7, "sibenik": 73.7, "sanmiguel": 73.7,
    "sponza": 73.7, "hairball": 73.7,
    "fairy": 46.8, "knob": 46.8, "dragon": 46.8, "bunny": 46.8,
}

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
