"""Gyroflow .gcsv IMU log parser.

Format: https://docs.gyroflow.xyz/app/technical-details/gcsv-format —
header `GYROFLOW IMU LOG` (or `CAMERA IMU LOG`), `key,value` lines
(version/id/orientation/tscale/gscale/ascale/mscale/lensprofile/
frame_readout_time/...), then a `t,gx,gy,gz[,ax,ay,az[,mx,my,mz]]` table.

Units out (matching telemetry-parser's normalized IMU): timestamps ms,
gyro deg/s, accel m/s^2 (ascale yields g; x 9.80665), magnetometer raw*mscale.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

RAD2DEG = 180.0 / math.pi
G_TO_MS2 = 9.80665


def parse_gcsv(path: str, progress_cb: Optional[Callable[[float], None]] = None) -> FileMetadata:
    header = {}
    col_names = None
    data_rows = []
    with open(path, "r", errors="replace") as f:
        first = f.readline().strip()
        if "IMU LOG" not in first.upper() and "," not in first:
            raise ValueError(f"Not a gcsv file: {path!r} (header {first!r})")
        if "," in first and "IMU LOG" not in first.upper():
            # headerless variant starting directly with key,value
            parts = first.split(",", 1)
            header[parts[0].strip().lower()] = parts[1].strip() if len(parts) > 1 else ""
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if col_names is None:
                if parts[0].strip().lower() in ("t", "time", "timestamp"):
                    col_names = [p.strip().lower() for p in parts]
                    continue
                if len(parts) >= 2:
                    header[parts[0].strip().lower()] = ",".join(parts[1:]).strip()
                continue
            data_rows.append(parts)

    if col_names is None:
        raise ValueError(f"gcsv file has no data table: {path!r}")

    tscale = float(header.get("tscale", 0.001))
    gscale = float(header.get("gscale", 1.0))
    ascale = float(header.get("ascale", 1.0))
    mscale = float(header.get("mscale", 1.0))

    idx = {name: i for i, name in enumerate(col_names)}
    has_acc = all(k in idx for k in ("ax", "ay", "az"))
    has_mag = all(k in idx for k in ("mx", "my", "mz"))

    arr = np.asarray([[float(v) for v in row[:len(col_names)]] for row in data_rows
                      if len(row) >= len(col_names)], dtype=np.float64)
    if arr.size == 0:
        raise ValueError(f"gcsv file has no samples: {path!r}")

    t_ms = arr[:, idx["t"]] * tscale * 1000.0
    gyro = arr[:, [idx["gx"], idx["gy"], idx["gz"]]] * gscale * RAD2DEG
    accl = arr[:, [idx["ax"], idx["ay"], idx["az"]]] * ascale * G_TO_MS2 if has_acc else None
    magn = arr[:, [idx["mx"], idx["my"], idx["mz"]]] * mscale if has_mag else None

    raw_imu = []
    n = len(t_ms)
    for i in range(n):
        raw_imu.append(TimeIMU(
            timestamp_ms=float(t_ms[i]),
            gyro=gyro[i].copy(),
            accl=accl[i].copy() if accl is not None else None,
            magn=magn[i].copy() if magn is not None else None,
        ))
        if progress_cb and i % 4096 == 0:
            progress_cb(i / n)

    fm = FileMetadata()
    fm.raw_imu = raw_imu
    fm.imu_orientation = header.get("orientation") or None
    fm.detected_source = f"gcsv {header.get('id', '')}".strip()
    if "frame_readout_time" in header:
        try:
            fm.frame_readout_time = float(header["frame_readout_time"])
        except ValueError:
            pass
    fm.lens_profile = header.get("lensprofile") or None
    fm.additional_data = {k: v for k, v in header.items()}
    if progress_cb:
        progress_cb(1.0)
    return fm
