"""Lossless JPEG (ITU T.81 process 14, SOF3) — the CinemaDNG entropy codec.

DNG Compression=7 wraps each raw strip/tile in a lossless-JPEG stream
(Adobe DNG spec 1.4, "Compression"). The hot decode loop runs in C++
(native/gyroflow_native.cpp `ljpeg_decode`); this module holds the pure
Python fallback (bit-exact, slow) and an encoder used to build test
fixtures and for completeness.

Scope: single scan, 2-16 bit precision, predictors 1-7, point transform,
up to 4 interleaved 1x1-sampled components — the layout CinemaDNG cameras
write (BMPCC et al. use 2-component SOF3 rows).
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# encoder (predictor 1, one shared Huffman table built from the data)
# ---------------------------------------------------------------------------

def _category(v: np.ndarray) -> np.ndarray:
    """SSSS category of a difference value (number of magnitude bits)."""
    return np.where(v == 0, 0,
                    np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)


def _build_huffman(freq: np.ndarray) -> Tuple[dict, bytes, bytes]:
    """Canonical Huffman table for the present categories (0..16).

    Equal-length canonical codes: for n symbols use length L =
    ceil(log2(n)) + 1 (strictly incomplete, so no all-ones codeword —
    JPEG reserves it). Suboptimal compression, always spec-valid."""
    symbols = sorted(int(s) for s in np.nonzero(freq)[0]) or [0]
    n = len(symbols)
    L = max(int(np.ceil(np.log2(n))) + 1 if n > 1 else 2, 2)
    codes = {s: (i, L) for i, s in enumerate(symbols)}
    counts = [0] * 16
    counts[L - 1] = n
    return codes, bytes(counts), bytes(symbols)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)   # byte stuffing
                self.acc = 0
                self.nbits = 0

    def flush(self):
        if self.nbits:
            self.acc <<= (8 - self.nbits)
            self.acc |= (1 << (8 - self.nbits)) - 1   # pad with 1s
            self.out.append(self.acc)
            if self.acc == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.nbits = 0


def encode(img: np.ndarray, precision: int = 16, predictor: int = 1,
           point_transform: int = 0) -> bytes:
    """(H, W) or (H, W, C) uint16 -> lossless JPEG bytes (single scan).

    With point_transform > 0 the input is shifted right by Pt before
    prediction (T.81 H.1.2.1); decoders scale back up by 2^Pt, so the
    round-trip loses the low Pt bits."""
    a = np.asarray(img, np.int64) >> point_transform
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    # differences under the chosen predictor (vectorized per component)
    diffs = np.empty_like(a)
    default = 1 << (precision - 1 - point_transform)
    for c in range(nc):
        x = a[..., c]
        ra = np.roll(x, 1, axis=1)
        rb = np.roll(x, 1, axis=0)
        rc = np.roll(np.roll(x, 1, axis=0), 1, axis=1)
        if predictor == 1:
            pred = ra
        elif predictor == 2:
            pred = rb
        elif predictor == 3:
            pred = rc
        elif predictor == 4:
            pred = ra + rb - rc
        elif predictor == 5:
            pred = ra + ((rb - rc) >> 1)
        elif predictor == 6:
            pred = rb + ((ra - rc) >> 1)
        else:
            pred = (ra + rb) >> 1
        pred[0, 1:] = x[0, :-1]     # first line: Ra
        pred[1:, 0] = x[:-1, 0]     # first column: Rb
        pred[0, 0] = default
        diffs[..., c] = x - pred
    flat = diffs.reshape(-1)
    # 16-bit modular wrap keeps categories <= 16
    flat = ((flat + 32768) & 0xFFFF) - 32768
    cats = _category(flat)
    freq = np.bincount(np.minimum(cats, 16), minlength=17).astype(np.int64)
    codes, counts_b, syms_b = _build_huffman(freq)

    bw = _BitWriter()
    for d, t in zip(flat.tolist(), cats.tolist()):
        if t >= 16:
            code, ln = codes[16] if 16 in codes else codes[t]
            bw.put(code, ln)
            continue
        code, ln = codes[t]
        bw.put(code, ln)
        if t:
            v = d if d >= 0 else d + (1 << t) - 1
            bw.put(v, t)
    bw.flush()

    out = bytearray(b"\xff\xd8")                      # SOI
    sof = bytearray([precision])
    sof += struct.pack(">HH", h, w)
    sof.append(nc)
    for c in range(nc):
        sof += bytes([c, 0x11, 0])
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    dht = bytes([0x00]) + counts_b + syms_b
    out += b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
    sos = bytearray([nc])
    for c in range(nc):
        sos += bytes([c, 0x00])
    sos += bytes([predictor, 0, point_transform & 0x0F])
    out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    out += bw.out
    out += b"\xff\xd9"                                # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# pure-Python decoder (fallback for the native ljpeg_decode)
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get_bit(self) -> int:
        while self.nbits == 0:
            if self.pos >= len(self.d):
                raise EOFError("ljpeg: out of data")
            b = self.d[self.pos]
            if b == 0xFF:
                if self.pos + 1 < len(self.d) and self.d[self.pos + 1] == 0x00:
                    self.pos += 2
                else:
                    raise EOFError("ljpeg: marker in entropy data")
            else:
                self.pos += 1
            self.acc = b
            self.nbits = 8
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def get_bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.get_bit()
        return v


def _extend(v: int, t: int) -> int:
    if t == 0:
        return 0
    return v - ((1 << t) - 1) if v < (1 << (t - 1)) else v


def decode(data: bytes) -> np.ndarray:
    """Lossless JPEG bytes -> (H, W, C) uint16 (Python fallback)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    p = 2
    precision = height = width = ncomp = 0
    tables = {}
    comp_tbl = []
    predictor, pt = 1, 0
    scan_at = None
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            raise ValueError("bad marker")
        m = data[p + 1]
        p += 2
        if m in (0xD8, 0xD9) or 0xD0 <= m <= 0xD7:
            continue
        ln = struct.unpack_from(">H", data, p)[0]
        seg = data[p + 2:p + ln]
        if m == 0xC3:
            precision = seg[0]
            height, width = struct.unpack_from(">HH", seg, 1)
            ncomp = seg[5]
        elif m == 0xC4:
            off = 0
            while off + 17 <= len(seg):
                th = seg[off] & 0x0F
                counts = list(seg[off + 1:off + 17])
                nsym = sum(counts)
                syms = list(seg[off + 17:off + 17 + nsym])
                # build (code, length) -> symbol map
                table = {}
                code = 0
                k = 0
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        table[(length, code)] = syms[k]
                        code += 1
                        k += 1
                    code <<= 1
                tables[th] = table
                off += 17 + nsym
        elif m == 0xDA:
            ns = seg[0]
            comp_tbl = [(seg[1 + 2 * i + 1] >> 4) & 0x0F for i in range(ns)]
            predictor = seg[1 + 2 * ns]
            pt = seg[1 + 2 * ns + 2] & 0x0F
            scan_at = p + ln
            break
        p += ln
    if scan_at is None:
        raise ValueError("no SOS")
    br = _BitReader(data[scan_at:])

    def huff_decode(table) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | br.get_bit()
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("bad huffman code")

    out = np.zeros((height, width, ncomp), np.uint16)
    default = 1 << (precision - 1 - pt)
    for y in range(height):
        for x in range(width):
            for c in range(ncomp):
                t = huff_decode(tables[comp_tbl[c]])
                diff = 32768 if t == 16 else _extend(br.get_bits(t) if t else 0, t)
                if y == 0 and x == 0:
                    pred = default
                elif y == 0:
                    pred = int(out[0, x - 1, c])
                elif x == 0:
                    pred = int(out[y - 1, 0, c])
                else:
                    ra = int(out[y, x - 1, c])
                    rb = int(out[y - 1, x, c])
                    rc = int(out[y - 1, x - 1, c])
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                            5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1)}.get(predictor,
                                                          (ra + rb) >> 1)
                out[y, x, c] = (pred + diff) & 0xFFFF
    if pt:
        # T.81 point transform: prediction runs in the shifted-down domain;
        # reconstructed samples are scaled back up by 2^Pt on output (H.2.1).
        out = (out.astype(np.uint32) << pt).astype(np.uint16)
    return out
