"""Pixel-format conversion and blitting (host, numpy).

Counterpart of ``tpu_rt.image``, a copy held bit-equal to it (numpy only;
``tests/test_torch_io.py``).

TPU-idiomatic replacement for the reference image library
(src/framework/gui/Image.hh:36-204, Image.cc): the reference models a
byte-level channel layout engine feeding OpenGL; here the canonical
store is a float32 RGBA [H, W, 4] numpy array (what the reconstruct
kernel emits) with vectorized converters for the packed formats the
reference defines (ImageFormat::ID, Image.hh:39-55).

Provided: Image with convert()/blit()/clear()/flip_y()/get/set pixel,
the packed formats R8_G8_B8, R8_G8_B8_A8, A8, XBGR_8888, ABGR_8888,
RGB_565, RGBA_5551, the float formats RGB_Vec3f / RGBA_Vec4f / A_F32,
and PPM/NPY file sinks (the headless display path; the reference's GL
window writes raw ABGR into a PBO, App.cc:124-132).
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = ["ImageFormat", "Image"]


class ImageFormat(enum.Enum):
    """Reference ImageFormat::ID (Image.hh:39-55)."""

    R8_G8_B8 = "R8_G8_B8"
    R8_G8_B8_A8 = "R8_G8_B8_A8"
    A8 = "A8"
    XBGR_8888 = "XBGR_8888"
    ABGR_8888 = "ABGR_8888"
    RGB_565 = "RGB_565"
    RGBA_5551 = "RGBA_5551"
    RGB_Vec3f = "RGB_Vec3f"
    RGBA_Vec4f = "RGBA_Vec4f"
    A_F32 = "A_F32"

    @property
    def bpp(self) -> int:
        """Bytes per pixel (reference StaticFormat.bpp)."""
        return {
            ImageFormat.R8_G8_B8: 3, ImageFormat.R8_G8_B8_A8: 4,
            ImageFormat.A8: 1, ImageFormat.XBGR_8888: 4,
            ImageFormat.ABGR_8888: 4, ImageFormat.RGB_565: 2,
            ImageFormat.RGBA_5551: 2, ImageFormat.RGB_Vec3f: 12,
            ImageFormat.RGBA_Vec4f: 16, ImageFormat.A_F32: 4,
        }[self]

    @property
    def has_alpha(self) -> bool:
        return self in (ImageFormat.R8_G8_B8_A8, ImageFormat.A8,
                        ImageFormat.ABGR_8888, ImageFormat.RGBA_5551,
                        ImageFormat.RGBA_Vec4f, ImageFormat.A_F32)


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _quant(x: np.ndarray, bits: int) -> np.ndarray:
    m = (1 << bits) - 1
    return (np.clip(x, 0.0, 1.0) * m + 0.5).astype(np.uint32)


class Image:
    """A float32 RGBA raster with reference-parity format export/import
    and clipped blits (Image::blit semantics)."""

    def __init__(self, width: int, height: int, data: np.ndarray | None = None):
        self.width = int(width)
        self.height = int(height)
        if data is None:
            data = np.zeros((self.height, self.width, 4), np.float32)
        data = np.asarray(data, np.float32)
        assert data.shape == (self.height, self.width, 4), data.shape
        self.data = data

    # -- constructors --------------------------------------------------

    @classmethod
    def from_rgba(cls, rgba: np.ndarray) -> "Image":
        rgba = np.asarray(rgba, np.float32)
        h, w = rgba.shape[:2]
        if rgba.shape[2] == 3:
            rgba = np.concatenate(
                [rgba, np.ones((h, w, 1), np.float32)], axis=2)
        return cls(w, h, rgba)

    @classmethod
    def from_format(cls, fmt: ImageFormat, packed: np.ndarray) -> "Image":
        """Decode a packed raster (reference Image::read path)."""
        f = ImageFormat(fmt)
        p = np.asarray(packed)
        if f == ImageFormat.RGBA_Vec4f:
            return cls.from_rgba(p)
        if f == ImageFormat.RGB_Vec3f:
            return cls.from_rgba(p[..., :3])
        if f == ImageFormat.A_F32:
            h, w = p.shape
            out = np.zeros((h, w, 4), np.float32)
            out[..., 3] = p
            return cls(w, h, out)
        if f == ImageFormat.A8:
            h, w = p.shape
            out = np.zeros((h, w, 4), np.float32)
            out[..., 3] = p.astype(np.float32) / 255.0
            return cls(w, h, out)
        if f == ImageFormat.R8_G8_B8:
            rgba = np.concatenate(
                [p.astype(np.float32) / 255.0,
                 np.ones((*p.shape[:2], 1), np.float32)], axis=2)
            return cls.from_rgba(rgba)
        if f == ImageFormat.R8_G8_B8_A8:
            return cls.from_rgba(p.astype(np.float32) / 255.0)
        if f in (ImageFormat.ABGR_8888, ImageFormat.XBGR_8888):
            u = p.astype(np.uint32)
            r = (u & 0xFF).astype(np.float32) / 255.0
            g = ((u >> 8) & 0xFF).astype(np.float32) / 255.0
            b = ((u >> 16) & 0xFF).astype(np.float32) / 255.0
            a = (((u >> 24) & 0xFF).astype(np.float32) / 255.0
                 if f == ImageFormat.ABGR_8888
                 else np.ones(p.shape, np.float32))
            return cls.from_rgba(np.stack([r, g, b, a], axis=-1))
        if f == ImageFormat.RGB_565:
            u = p.astype(np.uint32)
            r = ((u >> 11) & 31).astype(np.float32) / 31.0
            g = ((u >> 5) & 63).astype(np.float32) / 63.0
            b = (u & 31).astype(np.float32) / 31.0
            return cls.from_rgba(np.stack(
                [r, g, b, np.ones(p.shape, np.float32)], axis=-1))
        if f == ImageFormat.RGBA_5551:
            u = p.astype(np.uint32)
            r = ((u >> 11) & 31).astype(np.float32) / 31.0
            g = ((u >> 6) & 31).astype(np.float32) / 31.0
            b = ((u >> 1) & 31).astype(np.float32) / 31.0
            a = (u & 1).astype(np.float32)
            return cls.from_rgba(np.stack([r, g, b, a], axis=-1))
        raise ValueError(f)

    # -- format export -------------------------------------------------

    def convert(self, fmt: ImageFormat) -> np.ndarray:
        """Packed raster in `fmt` (reference format-conversion blit)."""
        f = ImageFormat(fmt)
        d = self.data
        if f == ImageFormat.RGBA_Vec4f:
            return d.copy()
        if f == ImageFormat.RGB_Vec3f:
            return d[..., :3].copy()
        if f == ImageFormat.A_F32:
            return d[..., 3].copy()
        if f == ImageFormat.A8:
            return _to_u8(d[..., 3])
        if f == ImageFormat.R8_G8_B8:
            return _to_u8(d[..., :3])
        if f == ImageFormat.R8_G8_B8_A8:
            return _to_u8(d)
        if f in (ImageFormat.ABGR_8888, ImageFormat.XBGR_8888):
            u = _to_u8(d).astype(np.uint32)
            a = (u[..., 3] if f == ImageFormat.ABGR_8888
                 else np.uint32(255))
            return (u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16)
                    | (a << 24)).astype(np.uint32)
        if f == ImageFormat.RGB_565:
            return ((_quant(d[..., 0], 5) << 11) | (_quant(d[..., 1], 6) << 5)
                    | _quant(d[..., 2], 5)).astype(np.uint16)
        if f == ImageFormat.RGBA_5551:
            return ((_quant(d[..., 0], 5) << 11) | (_quant(d[..., 1], 5) << 6)
                    | (_quant(d[..., 2], 5) << 1)
                    | _quant(d[..., 3], 1)).astype(np.uint16)
        raise ValueError(f)

    # -- raster ops ----------------------------------------------------

    def clear(self, color=(0.0, 0.0, 0.0, 1.0)) -> None:
        self.data[...] = np.asarray(color, np.float32)

    def get_pixel(self, x: int, y: int) -> np.ndarray:
        return self.data[y, x].copy()

    def set_pixel(self, x: int, y: int, color) -> None:
        self.data[y, x] = np.asarray(color, np.float32)

    def flip_y(self) -> "Image":
        """GL-convention vertical flip (the reference displays rasters
        bottom-up via glDrawPixels, App.cc:124-132)."""
        return Image(self.width, self.height, self.data[::-1].copy())

    def blit(self, src: "Image", dx: int = 0, dy: int = 0,
             sx: int = 0, sy: int = 0,
             w: int | None = None, h: int | None = None) -> None:
        """Copy a clipped rect of src into self (Image::blit semantics:
        out-of-bounds regions are silently clipped, never an error)."""
        w = src.width if w is None else int(w)
        h = src.height if h is None else int(h)
        # Clip against source.
        cx = max(sx, 0)
        cy = max(sy, 0)
        w -= cx - sx
        h -= cy - sy
        dx += cx - sx
        dy += cy - sy
        w = min(w, src.width - cx)
        h = min(h, src.height - cy)
        # Clip against destination.
        ox = max(dx, 0)
        oy = max(dy, 0)
        cx += ox - dx
        cy += oy - dy
        w -= ox - dx
        h -= oy - dy
        w = min(w, self.width - ox)
        h = min(h, self.height - oy)
        if w <= 0 or h <= 0:
            return
        self.data[oy:oy + h, ox:ox + w] = src.data[cy:cy + h, cx:cx + w]

    # -- file sinks (headless display path) ----------------------------

    def to_ppm(self, path: str) -> None:
        rgb = _to_u8(self.data[..., :3])
        with open(path, "wb") as f:
            f.write(f"P6\n{self.width} {self.height}\n255\n".encode())
            f.write(rgb.tobytes())

    @classmethod
    def from_ppm(cls, path: str) -> "Image":
        with open(path, "rb") as f:
            raw = f.read()
        # Header = magic, width, height, maxval as whitespace-separated
        # tokens, with `#` comment lines allowed anywhere in between; the
        # pixel block starts after the single whitespace byte that follows
        # maxval.
        pos, fields = 0, []
        while len(fields) < 4:
            if pos >= len(raw):
                raise ValueError("truncated PPM header")
            if raw[pos : pos + 1] == b"#":
                pos = raw.index(b"\n", pos) + 1
                continue
            if raw[pos : pos + 1].isspace():
                pos += 1
                continue
            end = pos
            while end < len(raw) and not raw[end : end + 1].isspace():
                end += 1
            fields.append(raw[pos:end])
            pos = end
        if fields[0] != b"P6":
            raise ValueError("only binary PPM (P6) supported")
        w, h, maxv = int(fields[1]), int(fields[2]), int(fields[3])
        if maxv > 255:
            raise ValueError(f"2-byte PPM samples unsupported (maxval {maxv})")
        pos += 1  # the single whitespace after maxval
        pix = np.frombuffer(raw, np.uint8, w * h * 3, offset=pos).reshape(h, w, 3)
        return cls.from_rgba(pix.astype(np.float32) / maxv)

    def to_npy(self, path: str) -> None:
        np.save(path, self.data)
