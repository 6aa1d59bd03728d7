"""ArduPilot DataFlash log parser (.bin binary, .log text).

The reference supports ArduPilot logs via telemetry-parser (README.md:101).
The binary format is SELF-DESCRIBING, which makes a robust offline port
possible without vendor samples: every message starts with the two sync
bytes 0xA3 0x95 and a type byte; type 0x80 is FMT, whose fixed 86-byte body
declares another message type's layout — (Type u8, Length u8, Name char[4],
Format char[16], Columns char[64]) — using the documented format characters
(ArduPilot libraries/AP_Logger/README.md, public docs):

  b/B i8/u8, h/H i16/u16, i/I i32/u32, q/Q i64/u64, f float, d double,
  n char[4], N char[16], Z char[64], c/C i16/u16 * 0.01, e/E i32/u32 * 0.01,
  L i32 * 1e-7 (lat/lon), M u8 (flight mode)

Gyro comes from IMU messages (TimeUS, GyrX/Y/Z rad/s, AccX/Y/Z m/s^2) —
GYR/ACC messages (older firmwares) are consumed too. Only the first IMU
instance ("I"/"Id" column 0) is used when multiple IMUs log.

The .log text format is the same data as CSV lines ("FMT, 128, 89, FMT, ..."
then "IMU, 123456, 0.01, ..."), parsed against the FMT column names.

Units out: timestamps ms, gyro deg/s, accel m/s^2.
"""
from __future__ import annotations

import math
import struct
from typing import Callable, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

RAD2DEG = 180.0 / math.pi

_HEAD1, _HEAD2 = 0xA3, 0x95
_FMT_TYPE = 0x80

_SIZES = {"b": 1, "B": 1, "h": 2, "H": 2, "i": 4, "I": 4, "q": 8, "Q": 8,
          "f": 4, "d": 8, "n": 4, "N": 16, "Z": 64, "c": 2, "C": 2,
          "e": 4, "E": 4, "L": 4, "M": 1}
_STRUCT = {"b": "b", "B": "B", "h": "h", "H": "H", "i": "i", "I": "I",
           "q": "q", "Q": "Q", "f": "f", "d": "d", "n": "4s", "N": "16s",
           "Z": "64s", "c": "h", "C": "H", "e": "i", "E": "I", "L": "i",
           "M": "B"}
_SCALE = {"c": 0.01, "C": 0.01, "e": 0.01, "E": 0.01, "L": 1e-7}


class _Fmt:
    __slots__ = ("name", "length", "fmt_chars", "columns", "unpacker")

    def __init__(self, name, length, fmt_chars, columns):
        self.name = name
        self.length = length
        self.fmt_chars = fmt_chars
        self.columns = columns
        # unknown format chars raise KeyError -> the FMT is skipped upstream
        self.unpacker = struct.Struct("<" + "".join(
            _STRUCT[c] for c in fmt_chars))

    def decode(self, body: bytes):
        vals = list(self.unpacker.unpack_from(body))
        for i, c in enumerate(self.fmt_chars):
            s = _SCALE.get(c)
            if s is not None:
                vals[i] = vals[i] * s
            elif c in ("n", "N", "Z"):
                vals[i] = vals[i].split(b"\x00", 1)[0].decode("latin-1")
        return vals


def _extract_rows(msgs_by_name):
    """IMU (or GYR+ACC) rows -> (t_ms, gyro deg/s, accl m/s^2 or None)."""

    def first_instance(rows, cols):
        inst = next((c for c in ("I", "Id", "Instance") if c in cols), None)
        if inst is None:
            return rows
        k = cols.index(inst)
        return [r for r in rows if r[k] == 0 or r[k] == 0.0]

    if "IMU" in msgs_by_name:
        cols, rows = msgs_by_name["IMU"]
        need = ("TimeUS", "GyrX", "GyrY", "GyrZ")
        rows = first_instance(rows, cols) if rows else rows
        if all(c in cols for c in need) and rows:
            ix = {c: cols.index(c) for c in cols}
            t = np.asarray([r[ix["TimeUS"]] for r in rows], np.float64) * 1e-3
            gyr = np.asarray([[r[ix["GyrX"]], r[ix["GyrY"]], r[ix["GyrZ"]]]
                              for r in rows], np.float64) * RAD2DEG
            acc = None
            if all(c in cols for c in ("AccX", "AccY", "AccZ")):
                acc = np.asarray([[r[ix["AccX"]], r[ix["AccY"]], r[ix["AccZ"]]]
                                  for r in rows], np.float64)
            return t, gyr, acc
    if "GYR" in msgs_by_name:
        cols, rows = msgs_by_name["GYR"]
        rows = first_instance(rows, cols) if rows else rows
        if all(c in cols for c in ("TimeUS", "GyrX", "GyrY", "GyrZ")) and rows:
            ix = {c: cols.index(c) for c in cols}
            t = np.asarray([r[ix["TimeUS"]] for r in rows], np.float64) * 1e-3
            gyr = np.asarray([[r[ix["GyrX"]], r[ix["GyrY"]], r[ix["GyrZ"]]]
                              for r in rows], np.float64) * RAD2DEG
            # older firmwares log accel as separate ACC messages on their own
            # clock — interpolate onto the gyro timestamps
            acc = None
            if "ACC" in msgs_by_name:
                acols, arows = msgs_by_name["ACC"]
                arows = first_instance(arows, acols) if arows else arows
                if all(c in acols for c in ("TimeUS", "AccX", "AccY", "AccZ")) \
                        and arows:
                    ax = {c: acols.index(c) for c in acols}
                    at = np.asarray([r[ax["TimeUS"]] for r in arows],
                                    np.float64) * 1e-3
                    av = np.asarray([[r[ax["AccX"]], r[ax["AccY"]], r[ax["AccZ"]]]
                                     for r in arows], np.float64)
                    order = np.argsort(at, kind="stable")
                    at, av = at[order], av[order]
                    acc = np.stack([np.interp(t, at, av[:, k])
                                    for k in range(3)], axis=1)
            return t, gyr, acc
    raise ValueError("no IMU/GYR gyro messages in ArduPilot log")


def _build_metadata(t_ms, gyr, acc, progress_cb):
    t_ms = t_ms - t_ms[0]
    raw = []
    for i in range(len(t_ms)):
        raw.append(TimeIMU(timestamp_ms=float(t_ms[i]), gyro=gyr[i].copy(),
                           accl=acc[i].copy() if acc is not None else None,
                           magn=None))
        if progress_cb and (i & 0x3FF) == 0:
            progress_cb(i / max(len(t_ms), 1))
    md = FileMetadata()
    md.raw_imu = raw
    md.detected_source = "ArduPilot"
    if progress_cb:
        progress_cb(1.0)
    return md


def parse_ardupilot_bin(path: str,
                        progress_cb: Optional[Callable[[float], None]] = None
                        ) -> FileMetadata:
    from .mp4 import mapped
    # DataFlash logs are hundreds of MB to GBs: scan through a page-mapped
    # view rather than slurping (only the pages actually read are touched)
    with mapped(path) as data:
        return _parse_bin_view(data, path, progress_cb)


def _parse_bin_view(data, path, progress_cb):
    fmts = {}
    # FMT-declared record lengths for types whose payload we can't decode
    # (unknown format chars, e.g. 'a' = int16[32] in ISBH/ISBD batch-IMU
    # messages): the LENGTH still frames the stream — skipping by it avoids
    # byte-scan resyncs that can false-sync inside payload bytes and decode
    # garbage rows as known types
    lengths = {}
    wanted = ("IMU", "GYR", "ACC")
    msgs = {}
    pos = 0
    n = len(data)
    synced = False
    sync_pair = bytes((_HEAD1, _HEAD2))

    def _find(start):
        # both bytes and mmap objects implement .find
        return data.find(sync_pair, start)

    while pos + 3 <= n:
        if data[pos] != _HEAD1 or data[pos + 1] != _HEAD2:
            if not synced:
                pos += 1
                continue
            # lost sync mid-file: scan forward to the next header pair
            nxt = _find(pos + 1)
            if nxt < 0:
                break
            pos = nxt
            continue
        synced = True
        mtype = data[pos + 2]
        if mtype == _FMT_TYPE:
            if pos + 3 + 86 > n:
                break
            body = bytes(data[pos + 3:pos + 3 + 86])
            ftype, flen = body[0], body[1]
            name = body[2:6].split(b"\x00", 1)[0].decode("latin-1")
            fchars = body[6:22].split(b"\x00", 1)[0].decode("latin-1")
            cols = body[22:86].split(b"\x00", 1)[0].decode("latin-1")
            try:
                fmt = _Fmt(name, flen, fchars, cols.split(","))
            except (KeyError, struct.error):
                if flen >= 3:
                    lengths[ftype] = flen    # undecodable but still framed
                pos += 3 + 86
                continue
            # declared length must cover header + payload exactly
            if flen != 3 + sum(_SIZES.get(c, 0) for c in fchars):
                raise ValueError(
                    f"ArduPilot FMT length mismatch for {name}: declared "
                    f"{flen}, computed {3 + sum(_SIZES.get(c, 0) for c in fchars)}")
            fmts[ftype] = fmt
            if name in wanted:
                msgs.setdefault(name, (fmt.columns, []))
            pos += 3 + 86
            continue
        fmt = fmts.get(mtype)
        if fmt is None:
            flen = lengths.get(mtype)
            if flen is not None:
                if pos + flen > n:
                    break
                pos += flen                  # skip by declared length
                continue
            # unknown type before its FMT: cannot know its length — resync
            nxt = _find(pos + 2)
            if nxt < 0:
                break
            pos = nxt
            continue
        if pos + fmt.length > n:
            break
        if fmt.name in wanted:
            msgs[fmt.name][1].append(
                fmt.decode(bytes(data[pos + 3:pos + fmt.length])))
        pos += fmt.length
    if not fmts:
        raise ValueError(f"not an ArduPilot DataFlash log: {path!r}")
    t, g, a = _extract_rows(msgs)
    return _build_metadata(t, g, a, progress_cb)


def parse_ardupilot_log(path: str,
                        progress_cb: Optional[Callable[[float], None]] = None
                        ) -> FileMetadata:
    """Text .log: 'FMT, 128, 89, IMU, QffffffIIfBBHH, TimeUS,GyrX,...' then
    'IMU, 123, 0.01, ...' rows."""
    cols_by_name = {}
    msgs = {}
    wanted = ("IMU", "GYR", "ACC")
    saw_fmt = False
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",")]
            if len(parts) < 2:
                continue
            tag = parts[0]
            if tag == "FMT" and len(parts) >= 6:
                saw_fmt = True
                name = parts[3]
                cols_by_name[name] = parts[5:]
                if name in wanted:
                    msgs.setdefault(name, (parts[5:], []))
                continue
            if tag in wanted and tag in cols_by_name:
                try:
                    vals = [float(v) for v in parts[1:1 + len(cols_by_name[tag])]]
                except ValueError:
                    continue
                if len(vals) == len(cols_by_name[tag]):
                    msgs[tag][1].append(vals)
    if not saw_fmt:
        raise ValueError(f"not an ArduPilot text log: {path!r}")
    t, g, a = _extract_rows(msgs)
    return _build_metadata(t, g, a, progress_cb)
