"""CAMM (Camera Motion Metadata) MP4 track parser.

Public spec: developers.google.com/streetview/publish/camm-spec — a `camm`
sample-format track whose samples are little-endian packets:
2 reserved bytes, u16 packet type, payload. Types used here:
  0: angle_axis (3×f32)        → orientation (converted to quaternion)
  2: gyro (3×f32, rad/s)
  3: accel (3×f32, m/s²)
Insta360/Android cameras export this; the reference reads it through the
external telemetry-parser crate (src/core/Cargo.toml:14).
"""
from __future__ import annotations

import math
import struct
from typing import List, Tuple

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU
from ..time_quat import TimeQuat


def parse_camm_samples(samples: List[Tuple[bytes, float]]) -> FileMetadata:
    """samples: (packet_bytes, time_s) per MP4 sample."""
    fm = FileMetadata()
    imu = {}
    q_t, q_v = [], []
    for data, t in samples:
        if len(data) < 4:
            continue
        typ = struct.unpack_from("<H", data, 2)[0]
        ms = t * 1000.0
        if typ == 2 and len(data) >= 16:
            g = np.asarray(struct.unpack_from("<3f", data, 4), np.float64)
            rec = imu.setdefault(round(ms, 6), TimeIMU(timestamp_ms=ms))
            rec.gyro = np.degrees(g)                  # TimeIMU stores deg/s
        elif typ == 3 and len(data) >= 16:
            a = np.asarray(struct.unpack_from("<3f", data, 4), np.float64)
            rec = imu.setdefault(round(ms, 6), TimeIMU(timestamp_ms=ms))
            rec.accl = a
        elif typ == 0 and len(data) >= 16:
            aa = np.asarray(struct.unpack_from("<3f", data, 4), np.float64)
            ang = float(np.linalg.norm(aa))
            if ang > 0:
                s = math.sin(ang / 2.0) / ang
                q_v.append([math.cos(ang / 2.0), aa[0] * s, aa[1] * s, aa[2] * s])
            else:
                q_v.append([1.0, 0.0, 0.0, 0.0])
            q_t.append(int(ms * 1000.0))
    fm.raw_imu = [imu[k] for k in sorted(imu)]
    if q_v:
        fm.quaternions = TimeQuat(np.asarray(q_t, np.int64), np.asarray(q_v))
    fm.detected_source = "CAMM"
    fm.has_accurate_timestamps = True
    return fm


def parse_camm_mp4(path: str, progress_cb=None) -> FileMetadata:
    from .mp4 import find_metadata_track, mapped
    with mapped(path) as buf:
        track = find_metadata_track(buf, b"camm")
        if track is None:
            from . import TelemetryError
            raise TelemetryError("no CAMM track in MP4")
        out = []
        samples = track.samples()
        for i, (off, size, t, _dur) in enumerate(samples):
            out.append((bytes(buf[off:off + size]), t))
            if progress_cb:
                progress_cb((i + 1) / max(len(samples), 1))
    return parse_camm_samples(out)
