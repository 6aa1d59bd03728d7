"""Camera-motion metadata export.

Port of gyroflow src/core/gyro_export.rs: field-selectable JSON of the
original/stabilized motion + zooming data (the CLI's --export-metadata).
"""
from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np

from ..core import quaternion as quat

DEFAULT_FIELDS = {
    "original": {"gyroscope": True, "accelerometer": True, "quaternion": True,
                 "euler_angles": True},
    "stabilized": {"quaternion": True, "euler_angles": True},
    "zooming": {"minimal_fovs": True, "fovs": True, "focal_length": True},
}


def export_camera_data(mgr, fields: Optional[dict] = None) -> str:
    fields = fields or DEFAULT_FIELDS
    gyro = mgr.gyro
    out = {"fps": mgr.params.fps, "vfr_fps": mgr.params.get_scaled_fps(),
           "frame_count": mgr.params.frame_count}

    f_org = fields.get("original") or {}
    if f_org:
        org = {}
        raw = gyro.get_raw_imu()
        if f_org.get("gyroscope") and raw:
            org["gyroscope"] = [[v.timestamp_ms] + (list(map(float, v.gyro)) if v.gyro is not None else [])
                                for v in raw]
        if f_org.get("accelerometer") and raw:
            org["accelerometer"] = [[v.timestamp_ms] + (list(map(float, v.accl)) if v.accl is not None else [])
                                    for v in raw]
        if f_org.get("quaternion") and len(gyro.quaternions):
            org["quaternion"] = {int(t): [float(x) for x in q]
                                 for t, q in zip(gyro.quaternions.timestamps_us,
                                                 gyro.quaternions.quats)}
        if f_org.get("euler_angles") and len(gyro.quaternions):
            r, p, y = quat.euler_angles(gyro.quaternions.quats)
            org["euler_angles"] = {int(t): [float(a), float(b), float(c)]
                                   for t, a, b, c in zip(gyro.quaternions.timestamps_us, r, p, y)}
        out["original"] = org

    f_st = fields.get("stabilized") or {}
    if f_st and len(gyro.smoothed_quaternions):
        st = {}
        if f_st.get("quaternion"):
            st["quaternion"] = {int(t): [float(x) for x in q]
                                for t, q in zip(gyro.smoothed_quaternions.timestamps_us,
                                                gyro.smoothed_quaternions.quats)}
        if f_st.get("euler_angles"):
            r, p, y = quat.euler_angles(gyro.smoothed_quaternions.quats)
            st["euler_angles"] = {int(t): [float(a), float(b), float(c)]
                                  for t, a, b, c in zip(gyro.smoothed_quaternions.timestamps_us, r, p, y)}
        out["stabilized"] = st

    f_z = fields.get("zooming") or {}
    if f_z:
        z = {}
        if f_z.get("fovs"):
            z["fovs"] = [float(f) for f in mgr.params.fovs]
        if f_z.get("minimal_fovs"):
            z["minimal_fovs"] = [float(f) for f in mgr.params.minimal_fovs]
        if f_z.get("focal_length"):
            z["focal_length"] = [None if f is None else float(f)
                                 for f in mgr.params.focal_lengths]
        out["zooming"] = z

    return json.dumps(out, indent=2)


def _np(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def export_parsed_metadata(mgr) -> str:
    """--export-metadata type 2 (render_queue.rs:965-969): the parsed
    FileMetadata serialized as JSON."""
    fm = mgr.gyro.file_metadata
    obj = {
        "imu_orientation": fm.imu_orientation,
        "detected_source": fm.detected_source,
        "frame_readout_time": fm.frame_readout_time,
        "frame_rate": fm.frame_rate,
        "has_accurate_timestamps": fm.has_accurate_timestamps,
        "raw_imu": [{"timestamp_ms": s.timestamp_ms,
                     "gyro": _np(s.gyro), "accl": _np(s.accl), "magn": _np(s.magn)}
                    for s in fm.raw_imu],
        "quaternions": {str(int(t)): q.tolist() for t, q in
                        zip(fm.quaternions.timestamps_us, fm.quaternions.quats)},
        "gravity_vectors": ({"ts": fm.gravity_vectors["ts"].tolist(),
                             "vec": fm.gravity_vectors["vec"].tolist()}
                            if fm.gravity_vectors else None),
        "image_orientations": ({str(int(t)): q.tolist() for t, q in
                                zip(fm.image_orientations.timestamps_us,
                                    fm.image_orientations.quats)}
                               if fm.image_orientations is not None else None),
        "lens_profile": fm.lens_profile,
        "lens_positions": {str(k): v for k, v in fm.lens_positions.items()},
        "digital_zoom": fm.digital_zoom,
        "per_frame_time_offsets": list(fm.per_frame_time_offsets),
        "additional_data": fm.additional_data,
    }
    return json.dumps(obj, indent=2, default=_np)


def export_full_metadata(mgr) -> str:
    """--export-metadata type 1 (gyro_export::export_full_metadata): full dump
    of everything parsed from the telemetry source + file/video info."""
    obj = {
        "file": mgr.input_file,
        "video": {"fps": mgr.params.fps, "frame_count": mgr.params.frame_count,
                  "duration_ms": mgr.params.duration_ms,
                  "size": list(mgr.params.size)},
        "metadata": json.loads(export_parsed_metadata(mgr)),
        "offsets": {str(k): v for k, v in mgr.gyro.offsets.items()},
        "integration_method": mgr.gyro.integration_method,
    }
    return json.dumps(obj, indent=2, default=_np)
