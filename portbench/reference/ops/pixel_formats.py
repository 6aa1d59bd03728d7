"""Pixel formats and plane handling.

Port of gyroflow src/core/stabilization/pixel_formats.rs: the dtype /
channel-count combos the per-plane render path uses (rendering/mod.rs:564-679),
the Rec.709 RGB->YUV conversion for per-plane backgrounds, and helpers to
split/merge planar YUV 4:2:0 frames for plane-at-a-time processing on TPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

KR = 0.2126  # Rec709 (pixel_formats.rs:30-34)
KB = 0.0722
KG = 1.0 - KR - KB
US = 1.0 / (2.0 - 2.0 * KB)
VS = 1.0 / (2.0 - 2.0 * KR)


def rgb_to_yuv(rgba: np.ndarray, is_limited: bool = False) -> np.ndarray:
    """pixel_formats.rs:23-48 (values normalized 0..1)."""
    v = np.asarray(rgba, dtype=np.float32)
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    a = v[..., 3] if v.shape[-1] > 3 else np.ones_like(r)
    y = np.clip(KR * r + KG * g + KB * b, 0.0, 1.0)
    u = np.clip((-KR * US) * r + (-KG * US) * g + ((1.0 - KB) * US) * b + 0.5, 0.0, 1.0)
    vv = np.clip(((1.0 - KR) * VS) * r + (-KG * VS) * g + (-KB * VS) * b + 0.5, 0.0, 1.0)
    a = np.clip(a, 0.0, 1.0)
    if is_limited:
        y = 16.0 / 255.0 + y * ((235.0 - 16.0) / 255.0)
        u = 16.0 / 255.0 + u * ((240.0 - 16.0) / 255.0)
        vv = 16.0 / 255.0 + vv * ((240.0 - 16.0) / 255.0)
    return np.stack([y, u, vv, a], axis=-1)


def yuv_to_rgb(yuva: np.ndarray, is_limited: bool = False) -> np.ndarray:
    """Inverse Rec.709 (for preview/export of processed planes)."""
    v = np.asarray(yuva, dtype=np.float32)
    y, u, w = v[..., 0].copy(), v[..., 1].copy(), v[..., 2].copy()
    if is_limited:
        y = (y - 16.0 / 255.0) / ((235.0 - 16.0) / 255.0)
        u = (u - 16.0 / 255.0) / ((240.0 - 16.0) / 255.0)
        w = (w - 16.0 / 255.0) / ((240.0 - 16.0) / 255.0)
    u = u - 0.5
    w = w - 0.5
    r = y + (2.0 - 2.0 * KR) * w
    b = y + (2.0 - 2.0 * KB) * u
    g = (y - KR * r - KB * b) / KG
    a = v[..., 3] if v.shape[-1] > 3 else np.ones_like(y)
    return np.clip(np.stack([r, g, b, a], axis=-1), 0.0, 1.0)


@dataclass(frozen=True)
class PixelFormat:
    """One entry of the reference's PixelType registry."""
    name: str
    channels: int
    dtype: np.dtype
    max_value: float
    is_yuv_plane: bool = False


# pixel_formats.rs:51-302 type registry
FORMATS: Dict[str, PixelFormat] = {
    "Luma8": PixelFormat("Luma8", 1, np.dtype(np.uint8), 255.0, True),
    "Luma16": PixelFormat("Luma16", 1, np.dtype(np.uint16), 65535.0, True),
    "RGB8": PixelFormat("RGB8", 3, np.dtype(np.uint8), 255.0),
    "RGBA8": PixelFormat("RGBA8", 4, np.dtype(np.uint8), 255.0),
    "BGRA8": PixelFormat("BGRA8", 4, np.dtype(np.uint8), 255.0),
    "RGB16": PixelFormat("RGB16", 3, np.dtype(np.uint16), 65535.0),
    "RGBA16": PixelFormat("RGBA16", 4, np.dtype(np.uint16), 65535.0),
    "AYUV16": PixelFormat("AYUV16", 4, np.dtype(np.uint16), 65535.0, True),
    "RGBAf": PixelFormat("RGBAf", 4, np.dtype(np.float32), 1.0),
    "RGBAf16": PixelFormat("RGBAf16", 4, np.dtype(np.float16), 1.0),
    "R32f": PixelFormat("R32f", 1, np.dtype(np.float32), 1.0, True),
    "UV8": PixelFormat("UV8", 2, np.dtype(np.uint8), 255.0, True),
    "UV16": PixelFormat("UV16", 2, np.dtype(np.uint16), 65535.0, True),
}


@dataclass
class Plane:
    """One plane ready for the remap kernel."""
    data: np.ndarray          # (H, W, C) f32
    fmt: PixelFormat
    plane_index: int
    scale: float = 1.0        # plane size / luma size


def plane_background(background_rgba01, fmt: PixelFormat, plane_index: int,
                     is_limited: bool) -> np.ndarray:
    """Per-plane background color (rendering/mod.rs:506-516): the RGBA user
    color converted to this plane's channels."""
    yuva = rgb_to_yuv(np.asarray(background_rgba01, np.float32), is_limited)
    if not fmt.is_yuv_plane:
        return np.asarray(background_rgba01, np.float32)[:fmt.channels]
    if fmt.channels == 1:
        return yuva[..., :1] if plane_index == 0 else yuva[..., 1 + plane_index - 1:2 + plane_index - 1]
    if fmt.channels == 2:      # UV plane
        return yuva[..., 1:3]
    if fmt.name == "AYUV16":
        return np.asarray([yuva[..., 3], yuva[..., 0], yuva[..., 1], yuva[..., 2]])
    return yuva[:fmt.channels]


def split_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 bit_depth: int = 8) -> List[Plane]:
    """Planar YUV420 -> per-plane f32 tensors (NV12/P010-style processing:
    rendering/mod.rs:564-679 builds one Stabilization per plane)."""
    maxv = float((1 << bit_depth) - 1)
    fmt_y = FORMATS["Luma8"] if bit_depth <= 8 else FORMATS["Luma16"]
    fmt_uv = FORMATS["UV8"] if bit_depth <= 8 else FORMATS["UV16"]
    uv = np.stack([u, v], axis=-1).astype(np.float32)
    return [
        Plane(y.astype(np.float32)[..., None], fmt_y, 0, 1.0),
        Plane(uv, fmt_uv, 1, u.shape[1] / y.shape[1]),
    ]


def merge_yuv420(planes: List[Plane], bit_depth: int = 8):
    y = planes[0].data[..., 0]
    uv = planes[1].data
    dtype = np.uint8 if bit_depth <= 8 else np.uint16
    maxv = (1 << bit_depth) - 1
    clip = lambda a: np.clip(a, 0, maxv).astype(dtype)
    return clip(y), clip(uv[..., 0]), clip(uv[..., 1])
