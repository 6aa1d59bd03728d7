"""CinemaDNG image-sequence input (minimal DNG/TIFF-EP reader).

Reference: image sequences including CinemaDNG are first-class inputs
(gyroflow README.md "Supports image sequences (PNG, OpenEXR,
CinemaDNG)"; routed through ffmpeg's image2 demuxer + DNG decoder in
rendering/mod.rs:234-239). This module reads the DNG frames directly:
TIFF IFD walk, raw IFD selection, uncompressed CFA/linear-raw strips
(8/12-packed/16-bit), black/white-level normalization and a bilinear
demosaic to interleaved RGB48 for the kernel.

Scope: Compression=1 (uncompressed) DNGs — the layout cameras write for
"CinemaDNG uncompressed". Lossless-JPEG-compressed DNGs (Compression=7)
need that entropy codec and are rejected with a clear error.
"""
from __future__ import annotations

import glob as _glob
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .formats import RAW_FORMATS

# TIFF tags
T_NEW_SUBFILE = 254
T_WIDTH = 256
T_LENGTH = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_COUNTS = 279
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_COUNTS = 325
T_SUB_IFDS = 330
T_CFA_PATTERN = 33422
T_LINEARIZATION = 50712
T_BLACK_LEVEL = 50714
T_WHITE_LEVEL = 50717
T_ACTIVE_AREA = 50829

PHOTO_CFA = 32803
PHOTO_LINEAR = 34892

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


class DNGError(IOError, ValueError):
    """A file that is not a readable DNG. An IOError, as the reader's errors
    always were, and a ValueError, as a malformed value is."""


def _read_ifd(buf: bytes, off: int, endian: str) -> Tuple[dict, int]:
    # every count and offset is bounded by the buffer before it is unpacked:
    # a damaged 32-bit count would otherwise build a format string of up to
    # ~2.7 GB and leak struct.error
    if off + 2 > len(buf):
        raise DNGError(f"DNG IFD at {off} lies past the end of the file ({len(buf)} bytes)")
    n = struct.unpack_from(endian + "H", buf, off)[0]
    if off + 2 + n * 12 + 4 > len(buf):
        raise DNGError(f"DNG IFD at {off} with {n} entries runs past the end of the file")
    tags = {}
    for i in range(n):
        base = off + 2 + i * 12
        tag, typ, cnt = struct.unpack_from(endian + "HHI", buf, base)
        size = _TYPE_SIZE.get(typ, 1) * cnt
        if size <= 4:
            data_off = base + 8
        else:
            data_off = struct.unpack_from(endian + "I", buf, base + 8)[0]
        if data_off + size > len(buf):
            raise DNGError(f"DNG tag {tag}: {cnt} values at {data_off} run past the end of "
                           f"the file ({len(buf)} bytes)")
        fmt = _TYPE_FMT.get(typ)
        if fmt:
            vals = struct.unpack_from(endian + fmt * cnt, buf, data_off)
        elif typ == 5 or typ == 10:   # rationals
            raw = struct.unpack_from(endian + ("I" if typ == 5 else "i") * cnt * 2,
                                     buf, data_off)
            vals = tuple(raw[j] / max(raw[j + 1], 1) for j in range(0, 2 * cnt, 2))
        else:
            vals = (buf[data_off:data_off + size],)
        tags[tag] = vals
    nxt = struct.unpack_from(endian + "I", buf, off + 2 + n * 12)[0]
    return tags, nxt


def _ints(vals, name: str):
    """A tag's values, which must be integers (an offset, a count, a size)."""
    if not vals or not all(isinstance(v, int) for v in vals):
        raise DNGError(f"DNG {name} tag must hold integers, got {vals!r:.60}")
    return vals


def _numbers(vals, name: str):
    """A tag's values, which must be numbers (a level, an area)."""
    if not vals or not all(isinstance(v, (int, float)) and np.isfinite(v) for v in vals):
        raise DNGError(f"DNG {name} tag must hold finite numbers, got {vals!r:.60}")
    return vals


def _all_ifds(buf: bytes):
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        raise DNGError("not a TIFF/DNG file")
    if len(buf) < 8:
        raise DNGError("not a TIFF/DNG file: shorter than its header")
    magic, off = struct.unpack_from(endian + "HI", buf, 2)
    if magic != 42:
        raise DNGError("not a TIFF/DNG file")
    out = []
    seen = set()
    stack = [off]
    while stack:
        o = stack.pop()
        if not o or o in seen or o + 2 > len(buf):
            continue
        seen.add(o)
        tags, nxt = _read_ifd(buf, o, endian)
        out.append(tags)
        stack.append(nxt)
        for sub in tags.get(T_SUB_IFDS, ()):
            if isinstance(sub, int):
                stack.append(sub)
    return out, endian


def _unpack12(data: bytes, count: int) -> np.ndarray:
    """Big-endian 12-bit packed samples -> uint16 (DNG packs MSB-first)."""
    b = np.frombuffer(data, np.uint8)
    b = b[: (count + 1) // 2 * 3]
    b0, b1, b2 = b[0::3].astype(np.uint16), b[1::3].astype(np.uint16), \
        b[2::3].astype(np.uint16)
    first = (b0 << 4) | (b1 >> 4)
    second = ((b1 & 0x0F) << 8) | b2
    out = np.empty(first.size + second.size, np.uint16)
    out[0::2] = first
    out[1::2] = second
    return out[:count]


def _demosaic_bilinear(cfa: np.ndarray, pattern: bytes) -> np.ndarray:
    """(H, W) CFA -> (H, W, 3) float32, bilinear interpolation.

    Measured samples pass through untouched; missing sites take the
    distance-weighted mean of same-channel neighbors in the 3x3 ring."""
    h, w = cfa.shape
    out = np.zeros((h, w, 3), np.float32)
    k = np.array([[0.25, 0.5, 0.25], [0.5, 0.0, 0.5],
                  [0.25, 0.5, 0.25]], np.float32)
    for ch in range(3):
        mask = np.zeros((h, w), np.float32)
        # pattern bytes: 0=R 1=G 2=B row-major over the 2x2 tile
        for dy in range(2):
            for dx in range(2):
                if pattern[dy * 2 + dx] == ch:
                    mask[dy::2, dx::2] = 1.0
        val = cfa * mask
        pv = np.pad(val, 1, mode="edge")
        pm = np.pad(mask, 1, mode="edge")
        acc = np.zeros((h, w), np.float32)
        norm = np.zeros((h, w), np.float32)
        for ky in range(3):
            for kx in range(3):
                if k[ky, kx]:
                    acc += k[ky, kx] * pv[ky:ky + h, kx:kx + w]
                    norm += k[ky, kx] * pm[ky:ky + h, kx:kx + w]
        filled = acc / np.maximum(norm, 1e-9)
        out[..., ch] = np.where(mask > 0, cfa, filled)
    return out


class DNGSequenceReader:
    """Iterates (timestamp_us, [one (H, W, 3) uint16 RGB plane])."""

    def __init__(self, path: str, fps: float = 24.0):
        self.files = self._expand(path)
        if not self.files:
            raise IOError(f"No DNG frames match: {path}")
        self.fps = fps
        self.frame_count = len(self.files)
        first = self._decode(self.files[0])
        self.height, self.width = first.shape[:2]
        self.fmt = RAW_FORMATS["rgb48le"]
        self._index = 0
        self._first_cache: Optional[np.ndarray] = first

    @staticmethod
    def _expand(path: str) -> List[str]:
        if os.path.isdir(path):
            return sorted(_glob.glob(os.path.join(path, "*.dng")) +
                          _glob.glob(os.path.join(path, "*.DNG")))
        if "*" in path or "?" in path:
            return sorted(_glob.glob(path))
        import re
        if re.search(r"%\d*d", path):
            files, i, misses = [], 0, 0
            while misses < 3:
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
                # arbitrary start number: glob the pattern; numeric sort so
                # frame 995 precedes 1000
                from ..utils.merge import natural_sorted
                files = natural_sorted(_glob.glob(re.sub(r"%\d*d", "*", path)))
            return files
        return [path]

    @staticmethod
    def _raw_ifd(buf: bytes):
        ifds, endian = _all_ifds(buf)
        best = None
        for t in ifds:
            if T_WIDTH not in t or (T_STRIP_OFFSETS not in t
                                    and T_TILE_OFFSETS not in t):
                continue
            photo = t.get(T_PHOTOMETRIC, (0,))[0]
            subtype = t.get(T_NEW_SUBFILE, (0,))[0]
            if photo in (PHOTO_CFA, PHOTO_LINEAR) and subtype == 0:
                return t, endian
            if best is None:
                best = t
        if best is None:
            raise DNGError("no raw image IFD in DNG")
        return best, endian

    def _decode(self, path: str) -> np.ndarray:
        with open(path, "rb") as fh:
            buf = fh.read()
        t, endian = self._raw_ifd(buf)

        def req(tag, name):
            # a damaged IFD must surface as a clean DNGError, not a KeyError
            # or a TypeError (mutation fuzz findings)
            if tag not in t or not t[tag]:
                raise DNGError(f"DNG IFD missing required {name} tag")
            return _ints(t[tag], name)

        def opt(tag, name, default):
            return _ints(t.get(tag, (default,)), name)[0]

        w = req(T_WIDTH, "ImageWidth")[0]
        h = req(T_LENGTH, "ImageLength")[0]
        bits = opt(T_BITS, "BitsPerSample", 16)
        comp = opt(T_COMPRESSION, "Compression", 1)
        photo = opt(T_PHOTOMETRIC, "PhotometricInterpretation", PHOTO_CFA)
        spp = opt(T_SAMPLES_PER_PIXEL, "SamplesPerPixel", 1)
        if comp not in (1, 7):
            raise DNGError(f"unsupported DNG compression {comp} "
                           "(uncompressed and lossless-JPEG are supported)")

        def check_samples(n, what):
            # lossless JPEG spends at least one bit per sample: a size past
            # 8 samples per byte of the file is damage, not a picture
            if n <= 0 or n > 8 * len(buf):
                raise DNGError(f"DNG {what} of {n} samples does not fit a {len(buf)}-byte file")

        def unpack_raw(data: bytes, count: int) -> np.ndarray:
            if comp == 7:
                # lossless JPEG (SOF3) — the CinemaDNG entropy codec
                from ..native import ljpeg_decode
                dec = ljpeg_decode(bytes(data))
                return dec.reshape(dec.shape[0], -1)
            if bits == 16:
                return np.frombuffer(data, np.dtype(endian + "u2"),
                                     count=count)
            if bits == 8:
                return np.frombuffer(data, np.uint8,
                                     count=count).astype(np.uint16)
            if bits == 12:
                return _unpack12(data, count)
            raise DNGError(f"unsupported DNG bit depth {bits}")

        n = w * h * spp
        check_samples(n, f"{w}x{h}x{spp} image")
        if T_TILE_OFFSETS in t:
            # tiled layout (Adobe-written DNGs): place each tile into the
            # padded mosaic, then crop to the image size
            tw_ = req(T_TILE_WIDTH, "TileWidth")[0]
            th_ = req(T_TILE_LENGTH, "TileLength")[0]
            offs = req(T_TILE_OFFSETS, "TileOffsets")
            cnts = req(T_TILE_COUNTS, "TileByteCounts")
            check_samples(tw_ * th_ * spp, f"{tw_}x{th_}x{spp} tile")
            tiles_x = -(-w // tw_)
            canvas = np.zeros((-(-h // th_) * th_, tiles_x * tw_ * spp),
                              np.uint16)
            for idx, (o, c) in enumerate(zip(offs, cnts)):
                ty, tx = divmod(idx, tiles_x)
                vals = unpack_raw(buf[o:o + c], th_ * tw_ * spp)
                canvas[ty * th_:(ty + 1) * th_,
                       tx * tw_ * spp:(tx + 1) * tw_ * spp] = \
                    vals.reshape(th_, tw_ * spp)
            raw = canvas[:h, :w * spp].reshape(-1)
        else:
            offsets = req(T_STRIP_OFFSETS, "StripOffsets")
            counts = _ints(t.get(T_STRIP_COUNTS, (len(buf) - offsets[0],)),
                           "StripByteCounts")
            if comp == 7:
                parts = [unpack_raw(buf[o:o + c], 0)[:, :w * spp]
                         for o, c in zip(offsets, counts)]
                raw = np.concatenate(parts, axis=0).reshape(-1)[:n]
            else:
                data = b"".join(buf[o:o + c] for o, c in zip(offsets, counts))
                raw = unpack_raw(data, n)
        raw = raw.reshape(h, w, spp)
        # LinearizationTable (log/companded raws; DNG spec 1.4): stored
        # codes index the LUT before black/white normalization
        lin = t.get(T_LINEARIZATION)
        if lin:
            lin = _ints(lin, "LinearizationTable")
            if min(lin) < 0 or max(lin) > 0xFFFF:
                raise DNGError("DNG LinearizationTable holds values outside uint16")
            lut = np.asarray(lin, np.uint16)
            raw = lut[np.minimum(raw.astype(np.int64), len(lut) - 1)]
        # ActiveArea crop (top, left, bottom, right) drops masked borders
        aa = t.get(T_ACTIVE_AREA)
        if aa and len(aa) == 4:
            top, left, bottom, right = (int(v) for v in _numbers(aa, "ActiveArea"))
            if 0 <= top < bottom <= h and 0 <= left < right <= w:
                raw = raw[top:bottom, left:right]
                h, w = raw.shape[:2]
        black = float(np.mean(_numbers(t.get(T_BLACK_LEVEL, (0,)), "BlackLevel")))
        white = float(_numbers(t.get(T_WHITE_LEVEL, ((1 << bits) - 1,)), "WhiteLevel")[0])
        img = raw.astype(np.float32)
        img = (img - black) / max(white - black, 1.0)
        np.clip(img, 0.0, 1.0, out=img)
        if photo == PHOTO_CFA and spp == 1:
            pat = t.get(T_CFA_PATTERN, (b"\x00\x01\x01\x02",))
            if pat and isinstance(pat[0], (bytes, bytearray)):
                pat = pat[0]
            else:
                pat = bytes(_ints(pat, "CFAPattern")[:4])
            if len(pat) < 4:
                raise DNGError(f"DNG CFAPattern needs 4 entries, got {len(pat)}")
            rgb = _demosaic_bilinear(img[..., 0], bytes(pat[:4]))
        elif spp >= 3:
            rgb = img[..., :3]
        else:
            rgb = np.repeat(img, 3, axis=-1)
        return (rgb * 65535.0 + 0.5).astype(np.uint16)

    @property
    def pix_fmt(self) -> str:
        return self.fmt.name

    @property
    def bit_depth(self) -> int:
        return 16

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
            img = self._decode(self.files[self._index])
        ts_us = int(round(self._index * 1_000_000.0 / self.fps))
        self._index += 1
        return ts_us, [np.ascontiguousarray(img)]

    def close(self):
        self._first_cache = None
