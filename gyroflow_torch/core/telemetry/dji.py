"""DJI timed-metadata (`djmd`) telemetry demuxer.

Reference boundary: the reference hands DJI Osmo Action / Avata MP4s to the
external telemetry-parser crate (gyro_source/mod.rs:372), whose dji module
reads the `djmd` timed-metadata track — "dvtm" protobuf messages, one per
video frame. Split the same honest way as telemetry.protobuf /
sony.SONY_USER_TAGS:

 * the protobuf WIRE walk (telemetry.protobuf.iter_fields) is spec-exact and
   self-describing — a malformed buffer raises, an unknown field is counted
   and skipped, never misparsed;
 * the FIELD-NUMBER registry below is PROJECT-DEFINED pending real DJI
   clips (the dvtm schema ships inside telemetry-parser, unavailable
   offline) and adjustable in one place.

Units follow telemetry-parser's DJI output: gyro rad/s, accel g, IMU
orientation remap applied by the caller via FileMetadata.imu_orientation.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU
from .protobuf import decode_message, encode_message

RAD2DEG = 180.0 / np.pi

# MP4 sample-description fourcc of the DJI timed-metadata track
SAMPLE_FORMAT = b"djmd"

# kind vocabulary shared with telemetry.protobuf.REGISTRY
DJI_REGISTRY: Dict[str, Dict[int, Tuple[str, str]]] = {
    "DjiSample": {
        1: ("ClipInfo", "message:DjiClipInfo"),
        2: ("Imu", "message:DjiImu"),            # repeated per sample
        3: ("FrameTimestamp", "double"),          # ms, video frame anchor
    },
    "DjiClipInfo": {
        1: ("ProductName", "string"),             # "DJI Osmo Action 4"
        2: ("FrameReadoutTime", "double"),        # ms, full frame
        3: ("ImuOrientation", "string"),
        4: ("SensorFps", "double"),
        5: ("LensInfo", "string"),
    },
    "DjiImu": {
        1: ("Timestamp", "double"),               # ms
        2: ("Gyro", "packed_double"),             # x, y, z rad/s
        3: ("Accel", "packed_double"),            # x, y, z g
    },
}
_DJI_REPEATED = {"DjiImu"}

G_TO_MS2 = 9.80665


def encode_dji_sample(tag_map: dict) -> bytes:
    """Fixture builder: one DjiSample message (tests + format docs)."""
    return encode_message(tag_map, "DjiSample", DJI_REGISTRY)


def has_dji_meta(path: str) -> bool:
    from .mp4 import find_metadata_track, mapped
    try:
        with mapped(path) as buf:
            return find_metadata_track(buf, SAMPLE_FORMAT) is not None
    except (OSError, ValueError):
        return False


def parse_dji_mp4(path: str, fps: float = 0.0, progress_cb=None) -> FileMetadata:
    """Parse the `djmd` track of a DJI MP4 into FileMetadata."""
    from .mp4 import find_metadata_track, mapped

    fm = FileMetadata()
    stats: dict = {}
    clip: dict = {}
    imu: Dict[float, TimeIMU] = {}
    with mapped(path) as buf:
        tr = find_metadata_track(buf, SAMPLE_FORMAT)
        if tr is None:
            raise ValueError(f"no DJI djmd track in {os.path.basename(path)}")
        samples = tr.samples()
        for i, (off, sz, _t, _d) in enumerate(samples):
            if off + sz > len(buf):
                raise ValueError("djmd sample extends past end of file")
            tm = decode_message(bytes(buf[off:off + sz]), "DjiSample", stats,
                                DJI_REGISTRY, _DJI_REPEATED)
            if "ClipInfo" in tm:
                clip.update(tm["ClipInfo"])
            for rec in tm.get("Imu", ()):
                g = rec.get("Gyro") or []
                a = rec.get("Accel") or []
                if "Timestamp" not in rec or len(g) < 3:
                    continue
                ms = float(rec["Timestamp"])
                if not np.isfinite(ms):
                    raise ValueError("non-finite djmd IMU timestamp")
                r = imu.setdefault(round(ms, 6), TimeIMU(timestamp_ms=ms))
                r.gyro = np.asarray(g[:3], np.float64) * RAD2DEG  # -> deg/s
                if len(a) >= 3:
                    r.accl = np.asarray(a[:3], np.float64) * G_TO_MS2
            if progress_cb and (i & 63) == 0:
                progress_cb(i / max(len(samples), 1))

    if not imu:
        raise ValueError(f"djmd track of {os.path.basename(path)} carries "
                         f"no IMU samples")
    fm.raw_imu = [imu[k] for k in sorted(imu)]
    product = (clip.get("ProductName") or "DJI").strip()
    fm.detected_source = product if product.startswith("DJI") \
        else f"DJI {product}"
    # telemetry-parser reports DJI action cams' IMU axes as (x, z, y)
    fm.imu_orientation = clip.get("ImuOrientation") or "xzy"
    if clip.get("FrameReadoutTime"):
        fm.frame_readout_time = float(clip["FrameReadoutTime"])
    if clip.get("LensInfo"):
        fm.additional_data["lens_info"] = clip["LensInfo"]
    else:
        fm.additional_data["lens_info"] = "wide"   # fixed-lens action cams
    fm.has_accurate_timestamps = True
    if stats.get("unknown_fields"):
        fm.additional_data["unknown_fields"] = stats["unknown_fields"]
    return fm
