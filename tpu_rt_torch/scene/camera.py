"""Pinhole camera with the reference's exact matrix conventions and the
base-64-ish camera *signature codec* so the reference repo's pinned cameras
(grtcmdline.txt) decode verbatim.

Conventions (reference src/framework/3d/CameraControls.cc and
src/framework/base/Math.cc):

- Right-handed view basis: camera looks down -Z; orientation columns are
  (right, up', back) with back = -normalize(forward) (CameraControls.cc:263-270).
- perspective(fov, near, far) maps z in [-near,-far] to NDC [-1,1]
  (Math.cc:79-92); fov is the full vertical field of view in degrees.
- world_to_clip = perspective @ world_to_camera (CameraControls.hh:96-97).
- Primary rays invert ``fit_to_view((-1,-1),(2,2),view) @ world_to_clip``
  (Renderer.cc:126-129) — an aspect-preserving letterbox of NDC.

Signature codec (CameraControls.cc:473-554): 6-bit symbols over the alphabet
'/'..':' (0-11), 'A'..'Z' (12-37), 'a'..'z' (38-63); floats as 6 symbols,
little-endian 6-bit chunks of the IEEE-754 bits; directions as a dominant-axis
face code plus two ratio floats.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from tpu_rt_torch.core.math import bits_to_float, float_to_bits


def _np3(v) -> np.ndarray:
    return np.asarray(v, np.float32).reshape(3)


def perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    f = 1.0 / np.tan(np.float32(fov_deg) * np.pi / 360.0)
    d = 1.0 / (near - far)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f
    m[1, 1] = f
    m[2, 2] = (near + far) * d
    m[2, 3] = 2.0 * near * far * d
    m[3, 2] = -1.0
    return m


def fit_to_view(pos, size, view_size) -> np.ndarray:
    """Reference Mat4f::fitToView (Math.cc:66-76): scale(2/viewSize) *
    scale(min(viewSize/size)) * translate(-pos - size/2)."""
    pos = np.asarray(pos, np.float32).reshape(2)
    size = np.asarray(size, np.float32).reshape(2)
    view = np.asarray(view_size, np.float32).reshape(2)
    s1 = np.diag(np.array([2.0 / view[0], 2.0 / view[1], 1.0, 1.0], np.float32))
    m = float((view / size).min())
    s2 = np.diag(np.array([m, m, 1.0, 1.0], np.float32))
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = -pos[0] - size[0] * 0.5
    t[1, 3] = -pos[1] - size[1] * 0.5
    return (s1 @ s2 @ t).astype(np.float32)


# ---------------------------------------------------------------------------
# Signature codec
# ---------------------------------------------------------------------------

def _encode_bits(v: int) -> str:
    assert 0 <= v < 64
    if v < 12:
        return chr(v + ord("/"))
    if v < 38:
        return chr(v - 12 + ord("A"))
    return chr(v - 38 + ord("a"))


def _decode_bits(src: str, pos: int) -> tuple[int, int]:
    c = src[pos]
    if "/" <= c <= ":":
        return ord(c) - ord("/"), pos + 1
    if "A" <= c <= "Z":
        return ord(c) - ord("A") + 12, pos + 1
    if "a" <= c <= "z":
        return ord(c) - ord("a") + 38, pos + 1
    raise ValueError(f"Camera signature: invalid character {c!r} at {pos}")


def _encode_float(v: float) -> str:
    bits = int(float_to_bits(np.float32(v)))
    return "".join(_encode_bits((bits >> i) & 0x3F) for i in range(0, 32, 6))


def _decode_float(src: str, pos: int) -> tuple[float, int]:
    bits = 0
    for i in range(0, 32, 6):
        v, pos = _decode_bits(src, pos)
        bits |= v << i
    return float(bits_to_float(np.uint32(bits & 0xFFFFFFFF))), pos


def _encode_direction(v: np.ndarray) -> str:
    a = np.abs(v)
    axis = 0 if a[0] >= max(a[1], a[2]) else (1 if a[1] >= a[2] else 2)
    if axis == 0:
        tuv = v
    elif axis == 1:
        tuv = np.array([v[1], v[2], v[0]], np.float32)
    else:
        tuv = np.array([v[2], v[0], v[1]], np.float32)
    face = axis | (0 if tuv[0] >= 0.0 else 4)
    if tuv[1] == 0.0 and tuv[2] == 0.0:
        return _encode_bits(face | 8)
    return (
        _encode_bits(face)
        + _encode_float(float(tuv[1] / abs(tuv[0])))
        + _encode_float(float(tuv[2] / abs(tuv[0])))
    )


def _decode_direction(src: str, pos: int) -> tuple[np.ndarray, int]:
    face, pos = _decode_bits(src, pos)
    x = 1.0 if (face & 4) == 0 else -1.0
    if (face & 8) == 0:
        y, pos = _decode_float(src, pos)
        z, pos = _decode_float(src, pos)
    else:
        y = z = 0.0
    tuv = np.array([x, y, z], np.float32)
    tuv = tuv / np.float32(np.sqrt(np.sum(tuv.astype(np.float32) ** 2)))
    k = face & 3
    if k == 0:
        out = tuv
    elif k == 1:
        out = np.array([tuv[2], tuv[0], tuv[1]], np.float32)
    else:
        out = np.array([tuv[1], tuv[2], tuv[0]], np.float32)
    return out, pos


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    forward: np.ndarray = field(default_factory=lambda: np.array([0, 0, -1], np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    fov: float = 70.0       # degrees, full vertical FOV
    near: float = 0.001
    far: float = 3.0
    speed: float = 0.2      # kept for signature round-trips
    keep_aligned: bool = False

    # -- orientation / matrices ---------------------------------------------

    def orientation(self) -> np.ndarray:
        """3x3 with columns (right, up', back) (CameraControls.cc:263-270)."""
        back = -_np3(self.forward)
        back = back / np.linalg.norm(back)
        right = np.cross(_np3(self.up), back)
        right = right / np.linalg.norm(right)
        up2 = np.cross(back, right)
        up2 = up2 / np.linalg.norm(up2)
        return np.stack([right, up2, back], axis=1).astype(np.float32)

    def camera_to_world(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.orientation()
        m[:3, 3] = _np3(self.position)
        return m

    def world_to_camera(self) -> np.ndarray:
        o = self.orientation()
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = o.T
        m[:3, 3] = -(o.T @ _np3(self.position))
        return m

    def world_to_clip(self) -> np.ndarray:
        return (perspective(self.fov, self.near, self.far) @ self.world_to_camera()).astype(np.float32)

    def nscreen_to_world(self, width: int, height: int) -> np.ndarray:
        """inv(fitToView((-1,-1),(2,2),(w,h)) @ world_to_clip) — the matrix the
        primary ray generator consumes (Renderer.cc:126-129)."""
        m = fit_to_view((-1.0, -1.0), (2.0, 2.0), (width, height)) @ self.world_to_clip()
        return np.linalg.inv(m.astype(np.float64)).astype(np.float32)

    # -- signature codec -----------------------------------------------------

    def encode_signature(self) -> str:
        sig = '"'
        p = _np3(self.position)
        sig += _encode_float(float(p[0]))
        sig += _encode_float(float(p[1]))
        sig += _encode_float(float(p[2]))
        sig += _encode_direction(_np3(self.forward))
        sig += _encode_direction(_np3(self.up))
        sig += _encode_float(self.speed)
        sig += _encode_float(self.fov)
        sig += _encode_float(self.near)
        sig += _encode_float(self.far)
        sig += _encode_bits(1 if self.keep_aligned else 0)
        sig += '",'
        return sig

    @classmethod
    def decode_signature(cls, sig: str) -> "Camera":
        s = sig.strip()
        pos = 0
        if pos < len(s) and s[pos] == '"':
            pos += 1
        px, pos = _decode_float(s, pos)
        py, pos = _decode_float(s, pos)
        pz, pos = _decode_float(s, pos)
        fwd, pos = _decode_direction(s, pos)
        up, pos = _decode_direction(s, pos)
        speed, pos = _decode_float(s, pos)
        fov, pos = _decode_float(s, pos)
        near, pos = _decode_float(s, pos)
        far, pos = _decode_float(s, pos)
        aligned, pos = _decode_bits(s, pos)
        rest = s[pos:].strip().rstrip(",").rstrip('"')
        if rest:
            raise ValueError(f"Camera signature: trailing garbage {rest!r}")
        return cls(
            position=np.array([px, py, pz], np.float32),
            forward=fwd,
            up=up,
            fov=fov,
            near=near,
            far=far,
            speed=speed,
            keep_aligned=bool(aligned),
        )

    # -- framing -------------------------------------------------------------

    @classmethod
    def for_bbox(cls, lo, hi, fov: float = 70.0,
                 elevation_deg: float = 0.0) -> "Camera":
        """Auto-frame a bounding box (CameraControls::initForMesh,
        CameraControls.cc:330-350): stand back 0.75*size on +Z, near/far
        proportional to scene size.

        elevation_deg raises the viewpoint above the horizon, looking
        down at the box center — the benchmark framing for
        object-on-ground-plane scenes (the reference's Mori Knob camera
        signature views the plane from above; a horizontal plane is
        invisible edge-on from the default +Z view)."""
        lo = _np3(lo)
        hi = _np3(hi)
        center = (lo + hi) * 0.5
        size = float(np.linalg.norm(hi - lo))
        if size == 0.0:
            size = 1.0
        e = float(np.deg2rad(elevation_deg))
        offset = np.array([0.0, np.sin(e), np.cos(e)], np.float32)
        position = center + offset * np.float32(size * 0.75)
        fwd = (center - position).astype(np.float32)
        fwd /= np.linalg.norm(fwd)
        return cls(
            position=position.astype(np.float32),
            forward=fwd,
            up=np.array([0.0, 1.0, 0.0], np.float32),
            fov=fov,
            near=size * 0.0005,
            far=size * 1.5,
            speed=size * 0.1,
        )

    def with_(self, **kw) -> "Camera":
        return replace(self, **kw)
