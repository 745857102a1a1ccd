"""Frozen copies of the suite's camera and AO-radius rules, and the camera
poses a run draws from its seed.

``suite_camera`` and ``suite_ao_radius`` are copied from the port's
``tpu_rt_torch/bench/workload.py`` (with ``Camera.for_bbox`` from
``tpu_rt_torch/scene/camera.py``) and frozen here; the tests hold them equal
to the port's.  A camera is a plain dict of float32 arrays and floats
(``position``, ``forward``, ``up``, ``fov``, ``near``, ``far``), which the
port receives as its own ``Camera`` and the reference reads as it is.
"""

from __future__ import annotations

import numpy as np

# Reference absolute AO radii and scene-extent estimates (grtcmdline.txt
# per-scene flags and the decoded committed cameras).
REF_AO_RADIUS = {"conference": 5.0, "dragon": 5.0}
REF_EXTENT_EST = {"conference": 30.0, "dragon": 1.6}
SCENE_FOV = {"conference": 73.7, "dragon": 46.8}
INTERIOR_SCENES = {"conference"}


def bbox(positions: np.ndarray):
    return positions.min(axis=0), positions.max(axis=0)


def scene_extent(positions: np.ndarray) -> float:
    lo, hi = bbox(positions)
    return float(np.linalg.norm(hi - lo))


def suite_ao_radius(scene_name: str, positions: np.ndarray) -> float:
    """The reference's absolute AO radius scaled to the stand-in's extent."""
    return REF_AO_RADIUS[scene_name] * scene_extent(positions) / REF_EXTENT_EST[scene_name]


def _camera(position, forward, up, fov, near, far) -> dict:
    return {"position": np.asarray(position, np.float32).reshape(3),
            "forward": np.asarray(forward, np.float32).reshape(3),
            "up": np.asarray(up, np.float32).reshape(3),
            "fov": float(fov), "near": float(near), "far": float(far)}


def for_bbox(lo, hi, fov: float) -> dict:
    """``Camera.for_bbox`` at elevation 0: stand back 0.75 x size on +Z."""
    lo = np.asarray(lo, np.float32).reshape(3)
    hi = np.asarray(hi, np.float32).reshape(3)
    center = (lo + hi) * 0.5
    size = float(np.linalg.norm(hi - lo))
    if size == 0.0:
        size = 1.0
    offset = np.array([0.0, np.sin(0.0), np.cos(0.0)], np.float32)
    position = center + offset * np.float32(size * 0.75)
    fwd = (center - position).astype(np.float32)
    fwd /= np.linalg.norm(fwd)
    return _camera(position, fwd, (0.0, 1.0, 0.0), fov, size * 0.0005, size * 1.5)


def suite_camera(scene_name: str, positions: np.ndarray) -> dict:
    """The suite's framing: interiors from inside the room at 10% of its
    length, looking down its long axis; objects by ``for_bbox``."""
    fov = SCENE_FOV[scene_name]
    lo, hi = bbox(positions)
    if scene_name in INTERIOR_SCENES:
        lo3 = np.asarray(lo, np.float32)
        hi3 = np.asarray(hi, np.float32)
        center = (lo3 + hi3) * 0.5
        position = np.array([lo3[0] + 0.1 * (hi3[0] - lo3[0]), center[1], center[2]],
                            np.float32)
        fwd = center - position
        fwd /= np.linalg.norm(fwd)
        size = float(np.linalg.norm(hi3 - lo3))
        return _camera(position, fwd.astype(np.float32), (0.0, 1.0, 0.0), fov,
                       size * 0.005, size * 3.0)
    return for_bbox(lo, hi, fov)


def _rot_y(v: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]])


def _pitch(v: np.ndarray, deg: float) -> np.ndarray:
    """Tilt a direction up or down by ``deg`` about its horizontal axis."""
    horiz = np.array([v[0], 0.0, v[2]])
    h = np.linalg.norm(horiz)
    el = np.arctan2(v[1], h) + np.deg2rad(deg)
    horiz = horiz / h if h > 0 else np.array([1.0, 0.0, 0.0])
    return horiz * np.cos(el) + np.array([0.0, 1.0, 0.0]) * np.sin(el)


def camera_poses(scene_name: str, positions: np.ndarray, poses: dict,
                 rng: np.random.Generator) -> list[dict]:
    """The run's camera poses, jittered by ``rng``.

    ``poses`` (the configuration's ``poses`` block) fixes the set:
    ``count`` poses spread ``spread_deg`` apart around the suite camera,
    turning it about the vertical axis (``"yaw"``: the camera turns where it
    stands) or orbiting it around the scene's center (``"orbit"``), in that
    order.  Every seed traces the same spread in the same order, so every
    seed does the same work (the order decides what the L2 cache holds from
    one pose to the next); the seed moves each pose by a small jitter
    (``jitter_deg`` of yaw and pitch, ``jitter_pos`` of the scene's
    extent), so that every seed traces other rays."""
    base = suite_camera(scene_name, positions)
    lo, hi = bbox(positions)
    center = (np.asarray(lo, np.float64) + np.asarray(hi, np.float64)) * 0.5
    size = scene_extent(positions)
    n = int(poses["count"])
    spread = float(poses["spread_deg"])
    angles = [(k - (n - 1) / 2.0) * spread for k in range(n)]
    out = []
    for ang in angles:
        pos = np.asarray(base["position"], np.float64)
        fwd = np.asarray(base["forward"], np.float64)
        if poses["mode"] == "orbit":
            pos = center + _rot_y(pos - center, ang)
            fwd = _rot_y(fwd, ang)
        elif poses["mode"] == "yaw":
            fwd = _rot_y(fwd, ang)
        else:
            raise ValueError(f"poses.mode {poses['mode']!r} is not 'yaw' or 'orbit'")
        jd = float(poses["jitter_deg"])
        fwd = _pitch(_rot_y(fwd, rng.uniform(-jd, jd)), rng.uniform(-jd, jd))
        pos = pos + rng.uniform(-1.0, 1.0, size=3) * float(poses["jitter_pos"]) * size
        fwd = fwd / np.linalg.norm(fwd)
        out.append(_camera(pos, fwd, base["up"], base["fov"], base["near"], base["far"]))
    return out
