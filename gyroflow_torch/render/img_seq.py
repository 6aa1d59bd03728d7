"""PNG / TIFF image-sequence I/O (8- and 16-bit).

Reference: image sequences are first-class inputs/outputs — the PNG "codec"
(gyroflow src/rendering/mod.rs:82,307,346) and the image_sequence
decoder options (mod.rs:234-239); README.md "Supports image sequences
(PNG, OpenEXR, CinemaDNG)". The reference routes these through ffmpeg's
image2 demuxer; here cv2's PNG/TIFF codecs read/write the frames and the
kernel processes each frame as one interleaved (H, W, C) plane (the
RGB8/RGBA16 rows of pixel_formats.rs).

Input path forms: a directory, a glob ("shots/*.png"), a printf pattern
("frame_%04d.png"), or a single image file. Output: a printf pattern or
directory (frames named frame_%06d.png). YUV plane groups written to an
image sequence are converted Rec.709 YUV -> RGB on the host (the equivalent
of the reference's ffmpeg format conversion when encoding PNG from YUV).
"""
from __future__ import annotations

import glob as _glob
import os
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.pixel_formats import yuv_to_rgb
from .formats import RAW_FORMATS, RawFormat

IMG_SEQ_EXTS = (".png", ".tif", ".tiff", ".jpg", ".jpeg", ".bmp")

_FMT_BY_SHAPE = {
    (np.dtype(np.uint8), 1): RAW_FORMATS["gray"],
    (np.dtype(np.uint8), 3): RAW_FORMATS["rgb24"],
    (np.dtype(np.uint8), 4): RAW_FORMATS["rgba"],
    (np.dtype("<u2"), 1): RAW_FORMATS["gray16le"],
    (np.dtype("<u2"), 3): RAW_FORMATS["rgb48le"],
    (np.dtype("<u2"), 4): RAW_FORMATS["rgba64le"],
}


def expand_sequence(path: str, exts: Tuple[str, ...] = IMG_SEQ_EXTS) -> List[str]:
    """Resolve a dir / glob / printf pattern / single file into frame paths."""
    if os.path.isdir(path):
        files: List[str] = []
        for e in exts:
            files.extend(_glob.glob(os.path.join(path, "*" + e)))
        return sorted(files)
    if "*" in path or "?" in path:
        return sorted(_glob.glob(path))
    if re.search(r"%\d*d", path):
        files = []
        i = 0
        misses = 0
        while misses < 3:  # tolerate sequences starting at 0 or 1
            p = path % i
            if os.path.exists(p):
                files.append(p)
                misses = 0
            elif files:
                break
            else:
                misses += 1
            i += 1
        if not files:
            # arbitrary start number (image_sequence_start): glob the
            # pattern; numeric sort so frame 995 precedes 1000
            from ..utils.merge import natural_sorted
            files = natural_sorted(_glob.glob(re.sub(r"%\d*d", "*", path)))
        return files
    return [path]


def _imread(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot decode image: {path}")
    if img.ndim == 2:
        return img[..., None]
    if img.shape[-1] == 3:
        return img[..., ::-1]            # BGR -> RGB
    if img.shape[-1] == 4:
        return img[..., [2, 1, 0, 3]]    # BGRA -> RGBA
    return img


def _imwrite(path: str, img: np.ndarray):
    import cv2
    if img.shape[-1] == 1:
        bgr = img[..., 0]
    elif img.shape[-1] == 3:
        bgr = img[..., ::-1]
    else:
        bgr = img[..., [2, 1, 0, 3]]
    if not cv2.imwrite(path, np.ascontiguousarray(bgr)):
        raise IOError(f"cannot encode image: {path}")


class ImageSequenceReader:
    """Iterates (timestamp_us, [one interleaved (H, W, C) native-dtype plane])."""

    def __init__(self, path: str, fps: float = 30.0):
        self.files = expand_sequence(path)
        if not self.files:
            raise IOError(f"No image frames match: {path}")
        first = _imread(self.files[0])
        dt = np.dtype("<u2") if first.dtype == np.uint16 else np.dtype(first.dtype)
        key = (dt, first.shape[-1])
        if key not in _FMT_BY_SHAPE:
            raise IOError(f"unsupported image layout {first.dtype}x{first.shape[-1]}")
        self.fmt = _FMT_BY_SHAPE[key]
        self.height, self.width = first.shape[:2]
        self.fps = fps
        self.frame_count = len(self.files)
        self._index = 0
        self._first_cache: Optional[np.ndarray] = first

    @property
    def pix_fmt(self) -> str:
        return self.fmt.name

    @property
    def bit_depth(self) -> int:
        return self.fmt.bit_depth

    def seek_frame(self, frame: int):
        self._index = frame

    def __iter__(self) -> Iterator[Tuple[int, List[np.ndarray]]]:
        return self

    def __next__(self):
        if self._index >= len(self.files):
            raise StopIteration
        if self._index == 0 and self._first_cache is not None:
            img = self._first_cache
            self._first_cache = None
        else:
            img = _imread(self.files[self._index])
        ts_us = int(round(self._index * 1_000_000.0 / self.fps))
        self._index += 1
        return ts_us, [np.ascontiguousarray(img)]

    def close(self):
        self._first_cache = None


def yuv_groups_to_rgb01(planes: List[np.ndarray], src_fmt: RawFormat) -> np.ndarray:
    """Host-side YUV plane set -> interleaved RGB in 0..1 float (the ffmpeg
    format-conversion step the reference gets for free). Shared by the PNG
    and EXR sequence writers."""
    import cv2
    y = planes[0][..., 0].astype(np.float32)
    h, w = y.shape
    if len(planes) == 2 and planes[1].shape[-1] == 2:      # semi-planar
        u_s, v_s = planes[1][..., 0], planes[1][..., 1]
    else:
        u_s, v_s = planes[1][..., 0], planes[2][..., 0]
    u = cv2.resize(u_s.astype(np.float32), (w, h), interpolation=cv2.INTER_LINEAR)
    v = cv2.resize(v_s.astype(np.float32), (w, h), interpolation=cv2.INTER_LINEAR)
    maxv = src_fmt.max_value
    yuva = np.stack([y / maxv, u / maxv, v / maxv, np.ones_like(y)], axis=-1)
    return yuv_to_rgb(yuva, is_limited=True)[..., :3]


def multiplane_to_interleaved(planes: List[np.ndarray],
                              src_fmt: Optional[RawFormat]) -> np.ndarray:
    """Stack single-channel planes into (H, W, C), mapping ffmpeg's planar
    GBR(A) order back to RGB(A)."""
    chans = [np.asarray(p)[..., 0] for p in planes]
    if src_fmt is not None and src_fmt.name.startswith("gbr"):
        order = [2, 0, 1] + ([3] if len(chans) == 4 else [])
        chans = [chans[i] for i in order]
    return np.stack(chans, axis=-1)


def _yuv_groups_to_rgb(planes: List[np.ndarray], src_fmt: RawFormat) -> np.ndarray:
    rgb01 = yuv_groups_to_rgb01(planes, src_fmt)
    if src_fmt.bit_depth <= 8:
        return np.clip(np.rint(rgb01 * 255.0), 0, 255).astype(np.uint8)
    return np.clip(np.rint(rgb01 * 65535.0), 0, 65535).astype(np.uint16)


class ImageSequenceWriter:
    def __init__(self, path: str, width: int, height: int,
                 src_fmt: Optional[RawFormat] = None):
        ext = os.path.splitext(path)[1].lower()
        if ext not in IMG_SEQ_EXTS:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "frame_%06d.png")
        elif not re.search(r"%\d*d", path):
            base, e = os.path.splitext(path)
            path = base + "_%06d" + e
        self.pattern = path
        self.width = width
        self.height = height
        self.src_fmt = src_fmt
        # fmt drives renderer._ungroup_planes' cast: keep the source format
        # as the cast target (YUV groups are converted to RGB by the writer
        # itself; integer RGB/gray passes straight through)
        self.fmt = src_fmt
        self._index = 0

    def write_planes(self, planes: List[np.ndarray]):
        if len(planes) >= 2 and self.src_fmt is not None and self.src_fmt.is_yuv:
            img = _yuv_groups_to_rgb(planes, self.src_fmt)
        else:
            if len(planes) > 1:
                # planar RGB float / EXR channel planes: stack to interleaved
                # (GBR order mapped back to RGB)
                img = multiplane_to_interleaved(planes, self.src_fmt)
            else:
                img = np.asarray(planes[0])
            if img.dtype in (np.float32, np.float64):
                img = np.clip(np.rint(img * 65535.0), 0, 65535).astype(np.uint16)
            if self.fmt is None:
                self.fmt = _FMT_BY_SHAPE.get(
                    (np.dtype("<u2") if img.dtype == np.uint16
                     else np.dtype(img.dtype), img.shape[-1]))
        _imwrite(self.pattern % self._index, img)
        self._index += 1

    def write_rgb(self, rgb: np.ndarray):
        img = np.asarray(rgb)
        if img.dtype not in (np.uint8, np.uint16):
            img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        self.write_planes([img])

    def close(self):
        pass
