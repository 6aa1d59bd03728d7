"""Betaflight blackbox CSV parser (decoded logs).

Parses the CSV output of blackbox_decode (the reference handles raw .bbl via
telemetry-parser; decoded CSV is the portable interchange). Columns used:
``time (us)``, ``gyroADC[0..2]`` (deg/s), ``accSmooth[0..2]`` (raw / acc_1G).
"""
from __future__ import annotations

import csv
from typing import Callable, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

G_TO_MS2 = 9.80665


def parse_blackbox_csv(path: str, progress_cb: Optional[Callable[[float], None]] = None) -> FileMetadata:
    with open(path, "r", errors="replace") as f:
        header_meta = {}
        reader = csv.reader(f)
        cols = None
        rows = []
        for row in reader:
            if not row:
                continue
            if cols is None:
                if len(row) == 2 and not row[0].strip().startswith("loop"):
                    header_meta[row[0].strip().strip('"')] = row[1].strip().strip('"')
                    continue
                stripped = [c.strip().strip('"') for c in row]
                if any(c.startswith("time") for c in stripped):
                    cols = stripped
                    continue
                continue
            rows.append(row)

    if cols is None:
        raise ValueError(f"No column header found in blackbox csv: {path!r}")

    def find(name):
        for i, c in enumerate(cols):
            if c.startswith(name):
                return i
        return None

    ti = find("time")
    gi = [find(f"gyroADC[{k}]") for k in range(3)]
    ai = [find(f"accSmooth[{k}]") for k in range(3)]
    if ti is None or any(g is None for g in gi):
        raise ValueError(f"blackbox csv missing time/gyro columns: {path!r}")

    acc_1g = float(header_meta.get("acc_1G", 2048.0))

    raw_imu = []
    t0 = None
    n = len(rows)
    for i, row in enumerate(rows):
        try:
            t_us = float(row[ti])
            g = np.array([float(row[gi[0]]), float(row[gi[1]]), float(row[gi[2]])])
            a = None
            if all(x is not None for x in ai) and len(row) > max(ai):
                a = np.array([float(row[ai[0]]), float(row[ai[1]]), float(row[ai[2]])])
                a = a / acc_1g * G_TO_MS2
        except (ValueError, IndexError):
            continue
        if t0 is None:
            t0 = t_us
        raw_imu.append(TimeIMU(timestamp_ms=(t_us - t0) / 1000.0, gyro=g, accl=a))
        if progress_cb and i % 4096 == 0:
            progress_cb(i / n)

    fm = FileMetadata()
    fm.raw_imu = raw_imu
    fm.detected_source = "Betaflight blackbox"
    fm.additional_data = header_meta
    if progress_cb:
        progress_cb(1.0)
    return fm
