"""OpenEXR 32-bit float image-sequence I/O (eval config 4).

Reference: the float pipeline in pixel_formats.rs (RGBAf/R32f) and the
GBRPF32LE plane set (rendering/mod.rs:630-650); frame sequences are the
standard interchange for float footage. Frames flow through the kernel as one
(H, W, C) float32 plane with max_pixel_value = 1.0, so underwater refraction
and the full remap math run at full float precision (cpu_undistort.rs:143-152).

Input path forms: a directory, a glob ("shots/*.exr"), a printf pattern
("frame_%04d.exr"), or a single .exr file. Output: a printf pattern or a
directory (frames named frame_%06d.exr).
"""
from __future__ import annotations

import glob as _glob
import os
import re
from typing import Iterator, List, Tuple

import numpy as np

from ..utils.exr import read_exr, write_exr
from .formats import RawFormat

# kernel-facing formats (planes are single-channel like ffmpeg's planar float)
EXR_FORMATS = {
    1: RawFormat("exr_gray_f32", np.dtype("<f4"), 32, ((1, 1, 1),), True),
    3: RawFormat("exr_rgb_f32", np.dtype("<f4"), 32, ((1, 1, 1),) * 3, False),
    4: RawFormat("exr_rgba_f32", np.dtype("<f4"), 32, ((1, 1, 1),) * 4, False),
}


def _expand(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(_glob.glob(os.path.join(path, "*.exr")))
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


class EXRSequenceReader:
    """Iterates (timestamp_us, [plane arrays (H, W, 1) f32])."""

    def __init__(self, path: str, fps: float = 30.0):
        self.files = _expand(path)
        if not self.files:
            raise IOError(f"No EXR frames match: {path}")
        first = read_exr(self.files[0])
        self._chan_names = self._pick_channels(first)
        ref = first[self._chan_names[0]]
        self.height, self.width = ref.shape
        self.fps = fps
        self.frame_count = len(self.files)
        self.fmt = EXR_FORMATS[len(self._chan_names)]
        self._index = 0
        self._first_cache = first

    @staticmethod
    def _pick_channels(channels) -> List[str]:
        names = set(channels)
        for want in (["R", "G", "B", "A"], ["R", "G", "B"], ["Y"]):
            if all(n in names for n in want):
                return want
        return sorted(names)[:4]

    @property
    def pix_fmt(self) -> str:
        return self.fmt.name

    @property
    def bit_depth(self) -> int:
        return 32

    def seek_frame(self, frame: int):
        self._index = frame

    def __iter__(self) -> Iterator[Tuple[int, List[np.ndarray]]]:
        return self

    def __next__(self):
        if self._index >= len(self.files):
            raise StopIteration
        if self._index == 0 and self._first_cache is not None:
            chans = self._first_cache
            self._first_cache = None
        else:
            chans = read_exr(self.files[self._index])
        planes = [np.ascontiguousarray(chans[n])[..., None]
                  for n in self._chan_names]
        ts_us = int(round(self._index * 1_000_000.0 / self.fps))
        self._index += 1
        return ts_us, planes

    def close(self):
        self._first_cache = None


class EXRSequenceWriter:
    CHAN_NAMES = ["R", "G", "B", "A"]

    def __init__(self, path: str, width: int, height: int,
                 compression: str = "zip", src_fmt: RawFormat = None):
        if os.path.isdir(path) or (not re.search(r"%\d*d", path)
                                   and not path.lower().endswith(".exr")):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "frame_%06d.exr")
        elif not re.search(r"%\d*d", path):
            # single .exr name -> numbered siblings
            base, ext = os.path.splitext(path)
            path = base + "_%06d" + ext
        self.pattern = path
        self.width = width
        self.height = height
        self.compression = compression
        self.src_fmt = src_fmt
        # YUV sources convert to RGB floats here; keep the source format as
        # the renderer's cast target (like the PNG writer)
        self.fmt = src_fmt if src_fmt is not None and src_fmt.is_yuv else None
        self._index = 0

    def write_planes(self, planes: List[np.ndarray]):
        maxv = self.src_fmt.max_value if (self.src_fmt is not None and
                                          self.src_fmt.dtype != np.float32) \
            else 1.0
        if self.src_fmt is not None and self.src_fmt.is_yuv \
                and len(planes) >= 2:
            # subsampled YUV groups -> full-res RGB floats (the ffmpeg
            # conversion the reference gets before its EXR encoder)
            from .img_seq import yuv_groups_to_rgb01
            rgb = yuv_groups_to_rgb01(planes, self.src_fmt)
            planes = [rgb[..., i:i + 1] for i in range(3)]
            maxv = 1.0   # already normalized
        elif self.src_fmt is not None and self.src_fmt.name.startswith("gbr") \
                and len(planes) >= 3:
            order = [2, 0, 1] + ([3] if len(planes) == 4 else [])
            planes = [planes[i] for i in order]
        if self.fmt is None:
            self.fmt = EXR_FORMATS[len(planes)]
        names = ["Y"] if len(planes) == 1 else self.CHAN_NAMES[:len(planes)]
        chans = {n: np.asarray(p)[..., 0].astype(np.float32) / maxv
                 for n, p in zip(names, planes)}
        write_exr(self.pattern % self._index, chans, self.compression)
        self._index += 1

    def close(self):
        pass
