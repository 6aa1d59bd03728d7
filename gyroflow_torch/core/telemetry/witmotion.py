"""WitMotion IMU log parser (binary protocol, e.g. WT901SDCL .txt dumps).

The reference supports WitMotion logs via telemetry-parser (README.md:105).
The device protocol is public (WitMotion datasheets): a stream of 11-byte
frames `0x55, type, d0..d7, checksum`, checksum = low byte of the sum of the
first 10 bytes. Payloads are little-endian i16 triplets plus a fourth field:

  0x50 time:     YY MM DD hh mm ss msL msH
  0x51 accel:    ax ay az T      (value / 32768 * 16 g)
  0x52 gyro:     wx wy wz T      (value / 32768 * 2000 deg/s)
  0x53 angle:    roll pitch yaw version (/32768 * 180 deg)
  0x54 magnetic: hx hy hz T

Sample timestamps: the 0x50 time frame gives an absolute wall-clock anchor
with milliseconds; gyro frames between time frames are spaced evenly (the
recorder emits one 0x50 per output burst). When no time frames exist, the
configured output rate is estimated from the frame count ratio and samples
are laid out uniformly (options={"sample_rate": hz} overrides).

WitMotion CSV/text exports (columns like "AngularVelocityX(°/s)") are NOT
handled here — the generic CSV importer's vocabulary covers them.

Units out: timestamps ms, gyro deg/s, accel m/s^2.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

G_TO_MS2 = 9.80665


def looks_like_witmotion(path: str, probe: int = 4096) -> bool:
    """>= 4 valid checksummed frames in the first `probe` bytes."""
    with open(path, "rb") as f:
        data = f.read(probe)
    good = 0
    pos = 0
    while pos + 11 <= len(data):
        if data[pos] == 0x55 and 0x50 <= data[pos + 1] <= 0x5A \
                and (sum(data[pos:pos + 10]) & 0xFF) == data[pos + 10]:
            good += 1
            pos += 11
        else:
            pos += 1
    return good >= 4


def parse_witmotion(path: str,
                    options: Optional[dict] = None,
                    progress_cb: Optional[Callable[[float], None]] = None
                    ) -> FileMetadata:
    options = options or {}
    with open(path, "rb") as f:
        data = f.read()

    gyros = []          # (stream_ordinal, x, y, z) in arrival order
    accls = []          # (stream_ordinal, x, y, z)
    anchors = []        # (gyro_sample_index_of_next_sample, wall_ms)
    pos = 0
    n = len(data)
    nframes = 0
    while pos + 11 <= n:
        if data[pos] != 0x55:
            pos += 1
            continue
        typ = data[pos + 1]
        if not (0x50 <= typ <= 0x5A) or \
                (sum(data[pos:pos + 10]) & 0xFF) != data[pos + 10]:
            pos += 1
            continue
        payload = data[pos + 2:pos + 10]
        if typ == 0x50:
            yy, mo, dd, hh, mi, ss = payload[0:6]
            ms = struct.unpack_from("<H", payload, 6)[0]
            wall = (((hh * 60 + mi) * 60) + ss) * 1000.0 + ms
            # day rollover folds into the monotonic fix-up below
            anchors.append((len(gyros), wall + dd * 86400000.0))
        elif typ == 0x52:
            x, y, z, _t = struct.unpack_from("<hhhh", payload)
            gyros.append((nframes, x / 32768.0 * 2000.0,
                          y / 32768.0 * 2000.0, z / 32768.0 * 2000.0))
        elif typ == 0x51:
            x, y, z, _t = struct.unpack_from("<hhhh", payload)
            accls.append((nframes, x / 32768.0 * 16.0,
                          y / 32768.0 * 16.0, z / 32768.0 * 16.0))
        pos += 11
        nframes += 1
    if len(gyros) < 4:
        raise ValueError(f"no WitMotion gyro frames in {path!r}")

    ng = len(gyros)
    t_ms = None
    if len(anchors) >= 2:
        # piecewise-linear between time anchors (sample index -> wall ms)
        ai = np.asarray([a[0] for a in anchors], np.float64)
        aw = np.asarray([a[1] for a in anchors], np.float64)
        aw = np.maximum.accumulate(aw)          # guard clock glitches
        keep = np.concatenate(([True], np.diff(ai) > 0))
        ai, aw = ai[keep], aw[keep]
        if len(ai) >= 2:
            n_idx = np.arange(ng, dtype=np.float64)
            t_ms = np.interp(n_idx, ai, aw)
            # np.interp clamps outside [ai[0], ai[-1]]: extend the head and
            # tail bursts at the adjacent segment's sample spacing so the
            # samples after the LAST 0x50 anchor don't collapse onto one
            # duplicated timestamp
            s0 = (aw[1] - aw[0]) / (ai[1] - ai[0])
            s1 = (aw[-1] - aw[-2]) / (ai[-1] - ai[-2])
            head = n_idx < ai[0]
            tail = n_idx > ai[-1]
            t_ms[head] = aw[0] + (n_idx[head] - ai[0]) * s0
            t_ms[tail] = aw[-1] + (n_idx[tail] - ai[-1]) * s1
    if t_ms is None:
        rate = float(options.get("sample_rate", 0.0))
        if rate <= 0:
            rate = 100.0                        # datasheet default output rate
        t_ms = np.arange(ng, dtype=np.float64) * (1000.0 / rate)
    t_ms = t_ms - t_ms[0]

    gyro_arr = np.asarray(gyros, np.float64)
    g_ord, gyro_vals = gyro_arr[:, 0], gyro_arr[:, 1:]
    acc_arr = None
    if len(accls) >= ng * 0.5:                  # accel stream present
        # pair by STREAM ORDINAL, not bare list index: a single dropped /
        # checksum-failed frame mid-stream must not shift every later accel
        # onto the wrong gyro sample. Each burst emits 0x51 next to 0x52, so
        # nearest-ordinal interpolation recovers the pairing across gaps.
        a = np.asarray(accls, np.float64)
        a_ord, a_vals = a[:, 0], a[:, 1:] * G_TO_MS2
        acc_arr = np.stack([np.interp(g_ord, a_ord, a_vals[:, k])
                            for k in range(3)], axis=1)

    raw = []
    for i in range(ng):
        raw.append(TimeIMU(timestamp_ms=float(t_ms[i]),
                           gyro=gyro_vals[i].copy(),
                           accl=acc_arr[i].copy() if acc_arr is not None else None,
                           magn=None))
        if progress_cb and (i & 0x3FF) == 0:
            progress_cb(i / ng)
    md = FileMetadata()
    md.raw_imu = raw
    md.detected_source = "WitMotion"
    if progress_cb:
        progress_cb(1.0)
    return md
