"""Video decode/encode behind the frame-tensor boundary.

The reference uses ffmpeg-next with GPU hwaccel (src/rendering/ffmpeg_*.rs);
on a TPU VM the boundary is host RAM -> HBM, so any CPU decoder works. This
uses OpenCV's FFMPEG backend (present in this image; the `av` package or an
ffmpeg subprocess slot in behind the same interface when available).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    frame_count: int
    duration_ms: float


def probe_video(path: str) -> VideoInfo:
    ext = os.path.splitext(path)[1].lower()
    from .img_seq import IMG_SEQ_EXTS
    if ext in (".y4m", ".exr", ".dng") or ext in IMG_SEQ_EXTS \
            or os.path.isdir(path) or "%" in path or "*" in path:
        # header-native probe (cv2 would force 8-bit or fail on sequences)
        if ext == ".y4m":
            from .y4m_io import Y4MReader
            r = Y4MReader(path)
        elif ext == ".dng":
            from .dng_seq import DNGSequenceReader
            r = DNGSequenceReader(path)
        else:
            from .dng_seq import DNGSequenceReader
            from .img_seq import ImageSequenceReader, expand_sequence
            if ext in IMG_SEQ_EXTS or (ext != ".exr" and expand_sequence(path)):
                r = ImageSequenceReader(path)
            elif ext != ".exr" and DNGSequenceReader._expand(path):
                r = DNGSequenceReader(path)
            else:
                from .exr_seq import EXRSequenceReader
                r = EXRSequenceReader(path)
        info = VideoInfo(r.width, r.height, r.fps, r.frame_count,
                         r.frame_count * 1000.0 / r.fps if r.fps else 0.0)
        r.close()
        return info
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"Cannot open video: {path}")
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return VideoInfo(w, h, fps, n, n * 1000.0 / fps if fps else 0.0)


class VideoReader:
    """Iterates (timestamp_us, rgb f32 HxWx3) frames."""

    def __init__(self, path: str):
        import cv2
        self.cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"Cannot open video: {path}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._index = 0

    def seek_frame(self, frame: int):
        self.cap.set(self.cv2.CAP_PROP_POS_FRAMES, frame)
        self._index = frame

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        return self

    def __next__(self):
        ok, bgr = self.cap.read()
        if not ok:
            raise StopIteration
        ts_us = int(round(self._index * 1_000_000.0 / self.fps))
        self._index += 1
        rgb = np.ascontiguousarray(bgr[:, :, ::-1])  # uint8; device converts
        return ts_us, rgb

    def close(self):
        self.cap.release()


class VideoWriter:
    def __init__(self, path: str, width: int, height: int, fps: float,
                 codec: str = "mp4v"):
        import cv2
        self.cv2 = cv2
        fourcc = cv2.VideoWriter_fourcc(*codec)
        self.writer = cv2.VideoWriter(path, fourcc, fps, (width, height))
        if not self.writer.isOpened():
            raise IOError(f"Cannot open video writer: {path}")
        self.path = path
        self.width = width
        self.height = height

    def write_rgb(self, rgb: np.ndarray):
        if rgb.shape[:2] != (self.height, self.width):
            # cv2.VideoWriter silently drops mismatched frames -> fail loudly
            raise ValueError(
                f"frame size {rgb.shape[1]}x{rgb.shape[0]} != writer size "
                f"{self.width}x{self.height} ({self.path})")
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb, 0, 255).astype(np.uint8)
        self.writer.write(np.ascontiguousarray(rgb[:, :, ::-1]))

    def close(self):
        self.writer.release()
