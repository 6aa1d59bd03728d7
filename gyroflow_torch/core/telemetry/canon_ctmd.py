"""Canon CTMD (Canon Timed MetaData) track demuxer.

The reference consumes Canon telemetry through the external telemetry-parser
crate and applies per-camera quirks at gyro_source/mod.rs:491-499 via
canon.rs, which expects per-sample "tag maps". Canon MP4/XF-AVC/Cinema RAW
Light clips carry a timed-metadata track whose sample description fourcc is
`CTMD`; each sample is a sequence of records with the publicly documented
framing (exiftool's Canon::CTMD processing):

    [u32le total_size][u16le type][u16le reserved][payload ...]   repeated

Record types 5/7/9 wrap little-endian TLV sub-records:

    [u32le size][u16le tag][u16le reserved][data ...]             repeated

Documented types: 1 = timecode, 4 = frame info, 5 = focal/lens info,
7 = exposure info, 8/9 = vendor blocks. The specific TLV tag numbers for
lens distortion/IMU are NOT publicly standardized; the registry below
(CTMD_TAGS) is project-defined within the documented framing and isolated so
a real-clip calibration only has to adjust the numbers — unknown record
types and TLV tags are counted and skipped, never misparsed.

Output: FileMetadata with raw IMU plus `additional_data["tag_map"]` in the
schema telemetry/canon.py consumes ({"lens": {...}, "imager": {...}}), so
manager._apply_camera_quirks fires without pre-parsed metadata.
"""
from __future__ import annotations

import logging
import struct
from typing import Callable, Optional, Tuple

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

log = logging.getLogger(__name__)

REC_TIMECODE = 1
REC_FRAME_INFO = 4
REC_FOCAL = 5
REC_EXPOSURE = 7
REC_VENDOR_8 = 8
REC_VENDOR_9 = 9
_TLV_TYPES = (REC_FOCAL, REC_EXPOSURE, REC_VENDOR_8, REC_VENDOR_9)

# Project-defined TLV tag registry (see module docstring).
CTMD_TAGS = {
    "focal_length": 0x0001,        # f64 mm
    "pixel_focal_length": 0x0002,  # 2x f64 (fx, fy)
    "display_name": 0x0003,        # utf-8
    "distortion": 0x0004,          # 8x f64, canon order k1..k6 p1 p2
    "enabled_corrections": 0x0005,  # 4x u8
    "pixel_width": 0x0010,         # u32le
    "pixel_height": 0x0011,        # u32le
    "exposure_time": 0x0020,       # f64 ms
    "frame_readout_time": 0x0021,  # f64 ms
    "sample_rate": 0x0030,         # f64 Hz
    "imu_samples": 0x0031,         # N x 7 f64 LE: t_ms, gyro xyz deg/s, accl xyz
    "imu_orientation": 0x0032,     # ascii
    "camera_model": 0x0040,        # utf-8
}
_TAG_NAMES = {v: k for k, v in CTMD_TAGS.items()}


def has_canon_ctmd(path: str) -> bool:
    from .mp4 import find_metadata_track, mapped
    try:
        with mapped(path) as buf:
            return find_metadata_track(buf, b"CTMD") is not None
    except Exception:
        return False


def _iter_records(sample: bytes):
    pos = 0
    n = len(sample)
    while pos + 8 <= n:
        size, typ, _res = struct.unpack_from("<IHH", sample, pos)
        if size < 8 or pos + size > n:
            raise ValueError(f"CTMD record overruns sample (size={size})")
        yield typ, sample[pos + 8:pos + size]
        pos += size
    if pos != n:
        raise ValueError("trailing garbage after CTMD records")


def _iter_tlv(payload: bytes):
    pos = 0
    n = len(payload)
    while pos + 8 <= n:
        size, tag, _res = struct.unpack_from("<IHH", payload, pos)
        if size < 8 or pos + size > n:
            raise ValueError(f"CTMD TLV overruns record (size={size})")
        yield tag, payload[pos + 8:pos + size]
        pos += size
    if pos != n:
        raise ValueError("trailing garbage after CTMD TLVs")


def _f64s(v: bytes):
    if len(v) % 8:
        raise ValueError("CTMD f64 array length not a multiple of 8")
    return list(struct.unpack(f"<{len(v)//8}d", v))


def parse_ctmd_mp4(path: str, fps: float = 0.0, size=(0, 0),
                   progress_cb: Optional[Callable[[float], None]] = None
                   ) -> FileMetadata:
    """Demux the CTMD track into FileMetadata (+ tag_map for the manager's
    Canon quirks)."""
    from .mp4 import find_metadata_track, mapped

    with mapped(path) as buf:
        track = find_metadata_track(buf, b"CTMD")
        if track is None:
            raise ValueError(f"No CTMD track in {path}")
        # mmap slices are plain bytes copies of just the metadata samples
        payloads = [bytes(buf[off:off + sz])
                    for (off, sz, _ts, _dur) in track.samples()]

    md = FileMetadata()
    tag_map: dict = {}
    sample_rate = 0.0
    skipped = 0
    camera_model = ""
    imu_rows = []

    for si, payload in enumerate(payloads):
        for typ, body in _iter_records(payload):
            if typ not in _TLV_TYPES:
                if typ not in (REC_TIMECODE, REC_FRAME_INFO):
                    skipped += 1
                continue
            for tag, v in _iter_tlv(body):
                name = _TAG_NAMES.get(tag)
                if name is None:
                    skipped += 1
                    continue
                if name == "focal_length":
                    tag_map.setdefault("lens", {})["focal_length"] = _f64s(v)[0]
                elif name == "pixel_focal_length":
                    tag_map.setdefault("lens", {})["pixel_focal_length"] = _f64s(v)
                elif name == "display_name":
                    tag_map.setdefault("lens", {})["display_name"] = \
                        v.decode("utf-8", "replace")
                elif name == "distortion":
                    tag_map.setdefault("lens", {})["distortion"] = _f64s(v)
                elif name == "enabled_corrections":
                    tag_map.setdefault("lens", {})["enabled_corrections"] = list(v)
                elif name == "pixel_width":
                    tag_map.setdefault("imager", {})["pixel_width"] = \
                        struct.unpack("<I", v)[0]
                elif name == "pixel_height":
                    tag_map.setdefault("imager", {})["pixel_height"] = \
                        struct.unpack("<I", v)[0]
                elif name == "exposure_time":
                    tag_map.setdefault("imager", {})["exposure_time"] = _f64s(v)[0]
                elif name == "frame_readout_time":
                    md.frame_readout_time = _f64s(v)[0]
                elif name == "sample_rate":
                    sample_rate = _f64s(v)[0]
                elif name == "imu_orientation":
                    md.imu_orientation = v.decode("ascii", "replace")
                elif name == "camera_model":
                    camera_model = v.decode("utf-8", "replace")
                elif name == "imu_samples":
                    vals = _f64s(v)
                    if len(vals) % 7:
                        raise ValueError("CTMD IMU block not a multiple of 7")
                    imu_rows.extend(vals[i:i + 7]
                                    for i in range(0, len(vals), 7))
        if progress_cb:
            progress_cb((si + 1) / max(len(payloads), 1))

    if not imu_rows:
        raise ValueError(f"CTMD track in {path} carries no IMU samples")
    for r in imu_rows:
        md.raw_imu.append(TimeIMU(
            timestamp_ms=float(r[0]),
            gyro=np.asarray(r[1:4], np.float64),
            accl=np.asarray(r[4:7], np.float64)))
    md.detected_source = ("Canon " + camera_model).strip()
    md.frame_rate = fps or None
    md.additional_data["tag_map"] = tag_map
    md.additional_data["sample_rate"] = sample_rate or 1000.0
    if skipped:
        log.info("Canon CTMD: skipped %d unknown records/tags", skipped)
    return md


# ---------------------------------------------------------------------------
# fixture builder (spec-built, per VERDICT r2 #4)
# ---------------------------------------------------------------------------

def _record(typ: int, payload: bytes) -> bytes:
    return struct.pack("<IHH", 8 + len(payload), typ, 0) + payload


def _tlv(tag: int, data: bytes) -> bytes:
    return struct.pack("<IHH", 8 + len(data), tag, 0) + data


def build_ctmd_sample(tag_map: dict, imu_samples=None, sample_rate: float = 0.0,
                      camera_model: str = "", imu_orientation: str = "",
                      frame_readout_time: Optional[float] = None) -> bytes:
    """Encode one CTMD sample with the documented record/TLV framing."""
    def f64s(vals) -> bytes:
        return struct.pack(f"<{len(vals)}d", *vals)

    T = CTMD_TAGS
    focal = []
    lens = tag_map.get("lens", {})
    if "focal_length" in lens:
        focal.append(_tlv(T["focal_length"], f64s([lens["focal_length"]])))
    if "pixel_focal_length" in lens:
        focal.append(_tlv(T["pixel_focal_length"],
                          f64s(lens["pixel_focal_length"])))
    if "display_name" in lens:
        focal.append(_tlv(T["display_name"], lens["display_name"].encode()))
    if "distortion" in lens:
        focal.append(_tlv(T["distortion"], f64s(lens["distortion"])))
    if "enabled_corrections" in lens:
        focal.append(_tlv(T["enabled_corrections"],
                          bytes(lens["enabled_corrections"])))
    imager = tag_map.get("imager", {})
    if "pixel_width" in imager:
        focal.append(_tlv(T["pixel_width"],
                          struct.pack("<I", imager["pixel_width"])))
    if "pixel_height" in imager:
        focal.append(_tlv(T["pixel_height"],
                          struct.pack("<I", imager["pixel_height"])))
    if camera_model:
        focal.append(_tlv(T["camera_model"], camera_model.encode()))

    expo = []
    if "exposure_time" in imager:
        expo.append(_tlv(T["exposure_time"], f64s([imager["exposure_time"]])))
    if frame_readout_time is not None:
        expo.append(_tlv(T["frame_readout_time"], f64s([frame_readout_time])))

    vend = []
    if sample_rate:
        vend.append(_tlv(T["sample_rate"], f64s([sample_rate])))
    if imu_orientation:
        vend.append(_tlv(T["imu_orientation"], imu_orientation.encode()))
    if imu_samples:
        flat = [x for row in imu_samples for x in row]
        vend.append(_tlv(T["imu_samples"], f64s(flat)))

    out = [_record(REC_TIMECODE, struct.pack("<I", 0))]
    if focal:
        out.append(_record(REC_FOCAL, b"".join(focal)))
    if expo:
        out.append(_record(REC_EXPOSURE, b"".join(expo)))
    if vend:
        out.append(_record(REC_VENDOR_9, b"".join(vend)))
    return b"".join(out)


def build_ctmd_mp4(sample_payloads, fps: float = 30.0) -> bytes:
    """Wrap per-frame CTMD samples into an MP4 with a `CTMD` metadata track
    (shared container surgery: mp4.build_metadata_mp4)."""
    from .mp4 import build_metadata_mp4
    return build_metadata_mp4(b"CTMD", "Canon CTMD", sample_payloads, fps)
