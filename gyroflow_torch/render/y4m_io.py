"""YUV4MPEG2 (.y4m) reader/writer — the pure-Python 10/12/16-bit video path.

The reference's 10-bit pipeline rides ffmpeg (rendering/ffmpeg_processor.rs:29);
y4m is the standard uncompressed interchange container every ffmpeg build
reads/writes (`ffmpeg -i in.mp4 -pix_fmt yuv420p10le out.y4m`), so this module
gives the framework a professional-depth end-to-end path with zero native
dependencies: header `YUV4MPEG2 W.. H.. F.. C420p10 ...`, then per frame a
`FRAME\\n` marker + planar little-endian samples.
"""
from __future__ import annotations

import os
from fractions import Fraction
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .formats import RAW_FORMATS, RawFormat, Y4M_TAGS


class Y4MReader:
    """Iterates (timestamp_us, planes) where planes is a list of (H,W,1)
    arrays in the container's native dtype."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            self.f.close()
            raise IOError(f"Not a YUV4MPEG2 file: {path}")
        self.width = self.height = 0
        num, den = 30, 1
        tag = "420jpeg"
        self.interlace = "p"
        self.extensions: List[str] = []
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = (int(v) for v in tok[1:].split(":"))
            elif tok[0] == "C":
                tag = tok[1:]
            elif tok[0] == "I":
                self.interlace = tok[1:]
            elif tok[0] == "X":
                self.extensions.append(tok[1:])
        if tag not in Y4M_TAGS:
            self.f.close()
            raise IOError(f"Unsupported y4m colorspace: C{tag}")
        self.fmt: RawFormat = Y4M_TAGS[tag]
        self.fps = num / den if den else 30.0
        self.fps_frac = (num, den)
        self._frame_bytes = self.fmt.frame_bytes(self.width, self.height)
        self._index = 0
        # frame count from file size (fixed-size frames + 6-byte FRAME marker)
        try:
            data = os.fstat(self.f.fileno()).st_size - self.f.tell()
            self.frame_count = max(data // (self._frame_bytes + 6), 0)
        except OSError:
            self.frame_count = 0

    @property
    def bit_depth(self) -> int:
        return self.fmt.bit_depth

    @property
    def pix_fmt(self) -> str:
        return self.fmt.name

    def seek_frame(self, frame: int):
        # fixed frame size (FRAME marker without parameters)
        self.f.seek(0)
        self.f.readline()
        self.f.seek((self._frame_bytes + 6) * frame, os.SEEK_CUR)
        self._index = frame

    def __iter__(self) -> Iterator[Tuple[int, List[np.ndarray]]]:
        return self

    def __next__(self):
        marker = self.f.readline()
        if not marker:
            raise StopIteration
        if not marker.startswith(b"FRAME"):
            raise IOError(f"Bad y4m frame marker: {marker[:20]!r}")
        buf = self.f.read(self._frame_bytes)
        if len(buf) < self._frame_bytes:
            raise StopIteration
        planes = self.fmt.unpack(buf, self.width, self.height)
        ts_us = int(round(self._index * 1_000_000.0 / self.fps))
        self._index += 1
        return ts_us, planes

    def close(self):
        self.f.close()


class Y4MWriter:
    def __init__(self, path: str, width: int, height: int, fps: float,
                 pix_fmt: str = "yuv420p10le",
                 fps_frac: Optional[Tuple[int, int]] = None):
        fmt = RAW_FORMATS.get(pix_fmt)
        if fmt is None or not fmt.y4m_tag:
            raise IOError(f"Pixel format not representable in y4m: {pix_fmt}")
        self.fmt = fmt
        self.width = width
        self.height = height
        self.path = path
        if fps_frac is None:
            fr = Fraction(fps).limit_denominator(65535)
            fps_frac = (fr.numerator, fr.denominator)
        self.f = open(path, "wb")
        self.f.write(f"YUV4MPEG2 W{width} H{height} "
                     f"F{fps_frac[0]}:{fps_frac[1]} Ip A1:1 "
                     f"C{fmt.y4m_tag}\n".encode("ascii"))

    def write_planes(self, planes: List[np.ndarray]):
        shapes = self.fmt.plane_shapes(self.width, self.height)
        if len(planes) != len(shapes):
            raise ValueError(f"expected {len(shapes)} planes, got {len(planes)}")
        for a, (ph, pw, ch) in zip(planes, shapes):
            if a.shape[:2] != (ph, pw):
                raise ValueError(f"plane shape {a.shape} != expected {(ph, pw)}")
        self.f.write(b"FRAME\n")
        self.fmt.write_to(self.f, planes)

    def close(self):
        self.f.close()
