"""Generic CSV gyro-log importer.

The reference's telemetry-parser crate accepts many vendor CSV dialects
(Runcam 5 Orange / Thumb, Hawkeye Firefly, XTU, iFlight GOCam, WitMotion
text export, phone apps like Sensor Logger / Sensor Record — reference
README.md:100-108). The files share one shape: a header row naming a time
column and gyro (optionally accel) columns, then numeric rows. Rather than
one brittle parser per vendor, this importer recognizes the known column
vocabularies and normalizes units:

- time: autodetected s/ms/us from the median sample delta;
- gyro: rad/s vs deg/s from the column label when it names a unit, else a
  magnitude heuristic (sustained |w| > 35 implies deg/s — 35 rad/s being
  an implausible 2000 deg/s);
- accel: g vs m/s^2 from the label, else from the median magnitude at rest
  (~1 vs ~9.8).

Options: {"gyro_unit": "deg"|"rad", "accel_unit": "g"|"ms2"} override the
heuristics (CLI --sync-params passthrough).

Output matches telemetry-parser's normalized IMU: timestamps ms, gyro deg/s,
accel m/s^2 (gyro_source/mod.rs:380 consumption contract).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

RAD2DEG = 180.0 / math.pi
G_TO_MS2 = 9.80665

# column vocabularies, checked in order (lowercase, unit suffixes stripped)
_TIME_NAMES = ("t", "time", "timestamp", "seconds_elapsed", "time_s",
               "timems", "time_ms", "chiptime", "datetime")
_GYRO_SETS = (
    ("gx", "gy", "gz"),
    ("rx", "ry", "rz"),
    ("gyrox", "gyroy", "gyroz"),
    ("gyro_x", "gyro_y", "gyro_z"),
    ("gyroadc[0]", "gyroadc[1]", "gyroadc[2]"),
    ("angularvelocityx", "angularvelocityy", "angularvelocityz"),
    ("wx", "wy", "wz"),
    ("omega_x", "omega_y", "omega_z"),
    ("x", "y", "z"),              # single-sensor exports (Sensor Logger)
)
_ACC_SETS = (
    ("ax", "ay", "az"),
    ("accx", "accy", "accz"),
    ("accelx", "accely", "accelz"),
    ("accel_x", "accel_y", "accel_z"),
    ("accsmooth[0]", "accsmooth[1]", "accsmooth[2]"),
    ("accelerationx", "accelerationy", "accelerationz"),
)

_UNIT_RE = re.compile(r"[\s(\[]+([^)\]]*)[)\]]?\s*$")


def _norm(name: str):
    """lowercase column key + the unit text inside (...)/[...] if present.

    Purely-numeric bracket suffixes are array indices, not units — keep them
    in the key so vocabularies like 'gyroadc[0]' can match."""
    name = name.strip().lower()
    m = _UNIT_RE.search(name)
    unit = ""
    if m and not m.group(1).strip().isdigit():
        unit = m.group(1).strip()
        name = name[:m.start()].strip()
    return name.replace(" ", "_"), unit


# chosen scale must land the median sample delta in a plausible gyro cadence
_SCALES = (("s", 1000.0), ("ms", 1.0), ("us", 1e-3), ("ns", 1e-6))


def _time_scale(t: np.ndarray, unit_label: str, col_name: str):
    """ms-per-unit factor for a time column, or None if no scale lands the
    cadence in a plausible range (0.05..1000 ms; preferring 0.05..50 ms =
    20 Hz..20 kHz when two scales both fit)."""
    ul = unit_label
    if "ms" in ul:
        return 1.0
    if ("us" in ul) or ("µs" in ul):
        return 1e-3
    if "ns" in ul:
        return 1e-6
    if ul in ("s", "sec", "secs", "seconds") or col_name == "seconds_elapsed":
        return 1000.0
    if len(t) < 2:
        return 1.0
    dt = float(np.median(np.diff(np.sort(t))))
    if dt <= 0:
        return None
    for lo, hi in ((0.05, 50.0), (0.05, 1000.0)):
        for _n, sc in _SCALES:
            if lo <= dt * sc <= hi:
                return sc
    return None


_DT_FORMATS = ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
               "%Y/%m/%d %H:%M:%S.%f", "%Y/%m/%d %H:%M:%S",
               "%H:%M:%S.%f", "%H:%M:%S")


def _datetime_col(cells):
    """Parse a wall-clock time column ('2024-01-01 10:00:00.000' — WitMotion
    text exports, phone apps) into seconds; None if no format fits."""
    import datetime as _dt
    for fmt in _DT_FORMATS:
        try:
            base = _dt.datetime.strptime(cells[0].strip(), fmt)
        except ValueError:
            continue
        out = np.empty(len(cells), np.float64)
        try:
            for i, c in enumerate(cells):
                d = _dt.datetime.strptime(c.strip(), fmt)
                out[i] = (d - base).total_seconds()
        except ValueError:
            return None
        # time-only formats wrap at midnight: unwrap a single wrap
        if fmt.startswith("%H"):
            out = np.where(out < out[0] - 1.0, out + 86400.0, out) - out[0]
        return out
    return None


def _float_col(cells):
    """Column of floats with NaN for unparseable cells."""
    out = np.empty(len(cells), np.float64)
    for i, c in enumerate(cells):
        try:
            out[i] = float(c)
        except ValueError:
            out[i] = np.nan
    return out


def parse_generic_csv(path: str,
                      options: Optional[dict] = None,
                      progress_cb: Optional[Callable[[float], None]] = None
                      ) -> FileMetadata:
    options = options or {}
    delim = None
    header_cols = None
    rows = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip().lstrip("﻿")
            if not line or line.startswith(("#", "//", ";")):
                continue
            if header_cols is None:
                for d in (",", ";", "\t"):
                    if d in line:
                        delim = d
                        break
                if delim is None:
                    raise ValueError(f"not a delimited log: {path!r}")
                header_cols = [_norm(c) for c in line.split(delim)]
                continue
            parts = line.split(delim)
            if len(parts) < len(header_cols):
                continue
            rows.append(parts[:len(header_cols)])
    if header_cols is None or not rows:
        raise ValueError(f"no data rows in {path!r}")

    names = [n for n, _u in header_cols]
    units = {n: u for n, u in header_cols}
    idx = {n: i for i, n in enumerate(names)}

    # Cells convert COLUMN-WISE and only the columns the import needs must be
    # numeric — vendor exports routinely carry datetime/text columns beside
    # the sensor data (WitMotion ChipTime, phone-app battery state, ...).
    col_cache = {}

    def col(i):
        if i not in col_cache:
            col_cache[i] = _float_col([r[i] for r in rows])
        return col_cache[i]

    # first time-name candidate with a usable scale: e.g. Sensor Logger has
    # BOTH a nanosecond-epoch `time` (f64 deltas may collapse to 0, or read
    # as an implausible cadence under the wrong scale) and `seconds_elapsed`
    # — prefer whichever yields a plausible sample cadence. Wall-clock
    # datetime columns parse via _datetime_col into seconds.
    t_col = scale = None
    t_vals = None
    for cand in (n for n in _TIME_NAMES if n in idx):
        tv = col(idx[cand])
        if np.isnan(tv).mean() > 0.02:
            cells = [r[idx[cand]] for r in rows]
            tv = _datetime_col(cells)
            if tv is None:
                continue
            sc = 1000.0                   # datetime deltas are seconds
        else:
            sc = _time_scale(tv[~np.isnan(tv)], units.get(cand, ""), cand)
        if sc is not None:
            t_col, scale, t_vals = cand, sc, tv
            break
    # bare x/y/z (last vocabulary entry) is the common single-sensor export
    # shape (Sensor Logger gyroscope file) — ambiguous alone, accepted
    g_cols = next((s for s in _GYRO_SETS if all(c in idx for c in s)), None)
    a_cols = next((s for s in _ACC_SETS if all(c in idx for c in s)), None)
    if t_col is None or g_cols is None:
        raise ValueError(
            f"{path!r}: no recognized time+gyro columns (saw {names[:12]})")

    gyro = np.stack([col(idx[c]) for c in g_cols], axis=1)
    accl = np.stack([col(idx[c]) for c in a_cols], axis=1) if a_cols else None

    # drop rows where any needed column failed to parse (footer text,
    # repeated headers, truncated tail lines)
    good = np.isfinite(t_vals) & np.all(np.isfinite(gyro), axis=1)
    if accl is not None:
        good &= np.all(np.isfinite(accl), axis=1)
    if not bool(good.any()):
        raise ValueError(f"no numeric data rows in {path!r}")
    t = t_vals[good]
    gyro = gyro[good]
    accl = accl[good] if accl is not None else None

    order = np.argsort(t, kind="stable")
    t = t[order]
    gyro = gyro[order]
    accl = accl[order] if accl is not None else None
    t_ms = t * scale
    t_ms -= t_ms[0]

    # explicit unit options OVERRIDE the label/magnitude heuristics (the
    # label wins only when no option is given — exporters mislabel)
    gu = units.get(g_cols[0], "")
    unit_opt = options.get("gyro_unit")
    if unit_opt == "rad":
        gyro = gyro * RAD2DEG
    elif unit_opt == "deg" or ("deg" in gu) or ("°" in gu) or ("dps" in gu):
        pass                               # already deg/s
    elif "rad" in gu:
        gyro = gyro * RAD2DEG
    else:
        # magnitude heuristic: sustained 35 rad/s = 2005 deg/s is implausible
        p99 = float(np.percentile(np.abs(gyro), 99)) if gyro.size else 0.0
        if p99 <= 35.0:
            gyro = gyro * RAD2DEG

    if accl is not None:
        au = units.get(a_cols[0], "")
        aopt = options.get("accel_unit")
        if aopt == "g":
            accl = accl * G_TO_MS2
        elif aopt == "ms2" or ("m/s" in au) or ("ms2" in au) or ("m/s2" in au) \
                or ("m/s^2" in au) or ("m/s²" in au):
            pass
        elif au == "g":
            accl = accl * G_TO_MS2
        else:
            med = float(np.median(np.linalg.norm(accl, axis=1))) if accl.size else 0.0
            if med < 4.0:                 # magnitude ~1 -> g units
                accl = accl * G_TO_MS2

    raw_imu = []
    for i in range(len(t_ms)):
        raw_imu.append(TimeIMU(
            timestamp_ms=float(t_ms[i]),
            gyro=gyro[i].copy(),
            accl=accl[i].copy() if accl is not None else None,
            magn=None,
        ))
        if progress_cb and (i & 0x3FF) == 0:
            progress_cb(i / max(len(t_ms), 1))

    md = FileMetadata()
    md.raw_imu = raw_imu
    md.frame_readout_time = None
    md.detected_source = "Generic CSV"
    if progress_cb:
        progress_cb(1.0)
    return md
