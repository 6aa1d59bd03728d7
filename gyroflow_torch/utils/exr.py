"""OpenEXR 2.0 scanline codec (pure Python/numpy).

The reference writes ST-maps as EXR (stmap.rs:124-146 via the `exr` crate) and
its float pipeline consumes EXR sequences (pixel_formats.rs RGBAf/R32f;
rendering/mod.rs:630-650 GBRPF32LE). This image's OpenCV lacks OpenEXR
support, so this implements the interchange subset: single-part scanline
images, HALF/FLOAT/UINT channels, NO/ZIPS/ZIP compression (zlib with the
OpenEXR byte-reorder + delta predictor, ImfZip.cpp), increasing-Y line order.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional

import numpy as np

MAGIC = 20000630
VERSION = 2

# pixel type codes (ImfPixelType.h)
UINT, HALF, FLOAT = 0, 1, 2
_DTYPES = {UINT: np.dtype("<u4"), HALF: np.dtype("<f2"), FLOAT: np.dtype("<f4")}
_TYPE_OF = {np.dtype("<u4"): UINT, np.dtype("<f2"): HALF, np.dtype("<f4"): FLOAT}

# compression codes (ImfCompression.h) -> scanlines per chunk
_COMP_LINES = {0: 1, 1: 1, 2: 16}   # NONE, ZIPS, ZIP
_COMP_CODES = {"none": 0, "zips": 1, "zip": 2}


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data


def _predictor_encode(raw: bytes) -> bytes:
    """OpenEXR Zip pre-pass (ImfZip.cpp compress): REORDER the bytes into
    even/odd halves first, THEN delta-encode the reordered buffer."""
    a = np.frombuffer(raw, np.uint8)
    half = (len(a) + 1) // 2
    split = np.empty(len(a), np.int16)
    split[:half] = a[0::2]
    split[half:] = a[1::2]
    d = np.empty_like(split)
    d[0] = split[0]
    d[1:] = split[1:] - split[:-1] + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _predictor_decode(buf: bytes) -> bytes:
    """Inverse (ImfZip.cpp uncompress): un-delta first, then interleave the
    two halves back."""
    a = np.frombuffer(buf, np.uint8).astype(np.int64)
    a = a.copy()
    a[1:] -= 128
    split = (np.cumsum(a) & 0xFF).astype(np.uint8)
    half = (len(split) + 1) // 2
    out = np.empty(len(split), np.uint8)
    out[0::2] = split[:half]
    out[1::2] = split[half:]
    return out.tobytes()


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: str = "zip"):
    """channels: name -> (H, W) array. float32/float16/uint32 dtypes are
    written natively; everything else is converted to float32."""
    names = sorted(channels)  # EXR requires alphabetical channel order
    arrs = {}
    for n in names:
        a = np.asarray(channels[n])
        if a.dtype not in (np.dtype("<f4"), np.dtype("<f2"), np.dtype("<u4"),
                           np.dtype(">f4"), np.dtype(">f2"), np.dtype(">u4")):
            a = a.astype("<f4")
        arrs[n] = np.ascontiguousarray(a, a.dtype.newbyteorder("<"))
    h, w = next(iter(arrs.values())).shape
    for a in arrs.values():
        assert a.shape == (h, w)

    comp = _COMP_CODES[compression]
    lines_per_chunk = _COMP_LINES[comp]

    chan_data = b""
    for n in names:
        ptype = _TYPE_OF[arrs[n].dtype]
        chan_data += n.encode() + b"\x00" + struct.pack(
            "<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chan_data += b"\x00"

    header = b""
    header += _attr(b"channels", b"chlist", chan_data)
    header += _attr(b"compression", b"compression", bytes([comp]))
    header += _attr(b"dataWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += _attr(b"displayWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\x00")  # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", MAGIC, VERSION) + header

    chunks = []
    for y0 in range(0, h, lines_per_chunk):
        ny = min(lines_per_chunk, h - y0)
        raw = b"".join(arrs[n][y].tobytes() for y in range(y0, y0 + ny)
                       for n in names)
        if comp != 0:
            packed = zlib.compress(_predictor_encode(raw))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)

    n_chunks = len(chunks)
    first = len(preamble) + n_chunks * 8
    offsets = []
    pos = first
    for c in chunks:
        offsets.append(struct.pack("<Q", pos))
        pos += len(c)

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(b"".join(offsets))
        for c in chunks:
            f.write(c)


def read_exr(path: str, as_float32: bool = True) -> Dict[str, np.ndarray]:
    """Reads single-part scanline EXRs (NONE/ZIPS/ZIP compression,
    HALF/FLOAT/UINT channels). Returns name -> (H, W) arrays (float32 unless
    as_float32=False, which keeps native dtypes)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != MAGIC:
        raise IOError(f"not an EXR file: {path}")
    if version & 0x200:
        raise IOError("multi-part EXR not supported")
    pos = 8
    chans = []   # (name, ptype)
    dw = None
    comp = 0
    while data[pos] != 0:
        name_end = data.index(b"\x00", pos)
        name = data[pos:name_end].decode()
        pos = name_end + 1
        typ_end = data.index(b"\x00", pos)
        pos = typ_end + 1
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                ne = payload.index(b"\x00", p)
                cname = payload[p:ne].decode()
                ptype = struct.unpack_from("<i", payload, ne + 1)[0]
                chans.append((cname, ptype))
                p = ne + 1 + 16
        elif name == "dataWindow":
            dw = struct.unpack("<4i", payload)
        elif name == "compression":
            comp = payload[0]
        elif name == "lineOrder" and payload[0] != 0:
            raise IOError("only increasing-Y EXR supported")
    pos += 1
    if comp not in _COMP_LINES:
        raise IOError(f"unsupported EXR compression code {comp}")
    lines_per_chunk = _COMP_LINES[comp]
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    n_chunks = -(-h // lines_per_chunk)
    offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)

    line_bytes = sum(w * _DTYPES[pt].itemsize for _, pt in chans)
    out = {n: np.empty((h, w), _DTYPES[pt]) for n, pt in chans}
    # chunk data stores channels in header order (which EXR requires to be
    # alphabetical); trust the header rather than re-sorting
    sorted_chans = chans
    for off in offsets:
        y0, size = struct.unpack_from("<ii", data, off)
        buf = data[off + 8:off + 8 + size]
        ny = min(lines_per_chunk, h - y0)
        raw_len = line_bytes * ny
        if comp != 0 and size != raw_len:
            buf = _predictor_decode(zlib.decompress(buf))
        p = 0
        for y in range(y0, y0 + ny):
            for n, pt in sorted_chans:
                nb = w * _DTYPES[pt].itemsize
                out[n][y] = np.frombuffer(buf, _DTYPES[pt], w, p)
                p += nb
    if as_float32:
        out = {n: a.astype(np.float32) for n, a in out.items()}
    return out
