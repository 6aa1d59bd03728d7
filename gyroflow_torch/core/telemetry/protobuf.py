"""GyroflowProtobuf wire decode (gyro_source/mod.rs:439-456).

The reference reads this format through the external telemetry-parser crate;
the message schema lives in the gyroflow-proto repo, which is not available
offline. Split accordingly — the same honest pattern as sony.SONY_USER_TAGS:

 * the WIRE layer below implements the protobuf wire format itself
   (varints, length-delimited fields, fixed32/64), which is fully documented
   (protobuf.dev/programming-guides/encoding) and self-describing enough to
   walk any message without a schema;
 * the FIELD-NUMBER registry mapping fields onto the reference's grouped tag
   maps (GroupId::Imager → TagId::FirstFrameTimestamp …) is PROJECT-DEFINED
   and adjustable once real clips are available. Unknown fields are counted,
   never misparsed.

The per-frame tag maps feed `manager._apply_camera_quirks`, whose Imager
timing quirk matches the reference exactly:
`first_frame_ts - exposure_time/2 + frame_readout_time/2`
(gyro_source/mod.rs:444-456).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

# MP4 timed-metadata sample format carrying one protobuf message per video
# frame (project-defined fourcc, adjustable like the field registry)
SAMPLE_FORMAT = b"gfpb"
# raw-stream magic for standalone .gfpb files: magic + length-delimited
# messages (varint length prefix per message)
RAW_MAGIC = b"GFPB\x01"


# ---------------------------------------------------------------------------
# Wire layer (schema-agnostic, spec-exact)
# ---------------------------------------------------------------------------

def read_varint(buf, pos: int, end: int) -> Tuple[int, int]:
    """Base-128 varint at buf[pos:end] → (value, next_pos)."""
    result = 0
    shift = 0
    while pos < end:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 64 bits")
    raise ValueError("truncated varint")


def iter_fields(buf, start: int = 0, end: Optional[int] = None):
    """Yield (field_number, wire_type, raw_value) for one message.

    raw_value: int for wire type 0 (varint), bytes for 1/2/5 (fixed64,
    length-delimited, fixed32). Deprecated group wire types (3/4) and
    reserved types raise — a misframed buffer must fail loudly, not
    misparse."""
    if end is None:
        end = len(buf)
    pos = start
    while pos < end:
        key, pos = read_varint(buf, pos, end)
        field_no = key >> 3
        wt = key & 7
        if field_no == 0:
            raise ValueError("field number 0 is invalid")
        if wt == 0:
            val, pos = read_varint(buf, pos, end)
        elif wt == 1:
            if pos + 8 > end:
                raise ValueError("truncated fixed64")
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = read_varint(buf, pos, end)
            if ln > end - pos:
                raise ValueError("length-delimited field overruns buffer")
            val = bytes(buf[pos:pos + ln])
            pos += ln
        elif wt == 5:
            if pos + 4 > end:
                raise ValueError("truncated fixed32")
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field_no, wt, val


def _to_double(wt: int, val) -> float:
    if wt == 1:
        return struct.unpack("<d", val)[0]
    if wt == 5:
        return float(struct.unpack("<f", val)[0])
    if wt == 0:
        return float(val)
    raise ValueError("scalar field with length-delimited wire type")


def _packed_doubles(val: bytes) -> List[float]:
    if len(val) % 8 == 0:
        return list(struct.unpack(f"<{len(val) // 8}d", val))
    if len(val) % 4 == 0:
        return [float(x) for x in struct.unpack(f"<{len(val) // 4}f", val)]
    raise ValueError("packed scalar field of non-4/8-multiple length")


# ---------------------------------------------------------------------------
# Field-number registry (PROJECT-DEFINED, pending real gyroflow-proto clips)
# ---------------------------------------------------------------------------
# kind: "string" | "double" | "varint" | "packed_double" | "message:<Name>"
# repeated message fields accumulate into lists.

REGISTRY: Dict[str, Dict[int, Tuple[str, str]]] = {
    "Main": {
        1: ("Header", "message:Header"),
        2: ("Imager", "message:Imager"),
        3: ("Gyroscope", "message:Gyroscope"),
        4: ("Accelerometer", "message:Accelerometer"),
    },
    "Header": {
        1: ("CameraBrand", "string"),
        2: ("CameraModel", "string"),
        3: ("FirmwareVersion", "string"),
        4: ("SampleRate", "double"),
        5: ("ImuOrientation", "string"),
        6: ("LensProfile", "string"),
        7: ("FrameReadoutTime", "double"),      # ms, full frame
        8: ("FrameReadoutDirection", "varint"),
    },
    "Imager": {
        1: ("FirstFrameTimestamp", "double"),   # ms
        2: ("ExposureTime", "double"),          # ms
        3: ("FrameReadoutTime", "double"),      # ms
        4: ("FrameNumber", "varint"),
    },
    # one message per IMU reading; repeated within Main
    "Gyroscope": {
        1: ("Timestamp", "double"),             # ms
        2: ("Data", "packed_double"),           # x, y, z deg/s
    },
    "Accelerometer": {
        1: ("Timestamp", "double"),             # ms
        2: ("Data", "packed_double"),           # x, y, z g
    },
}

_REPEATED = {"Gyroscope", "Accelerometer"}


def decode_message(buf, schema_name: str, stats: Optional[dict] = None,
                   registry: Optional[dict] = None,
                   repeated: Optional[set] = None) -> dict:
    """Decode one message through the registry into a tag-map dict.

    Fields absent from the registry are COUNTED in stats["unknown_fields"]
    and skipped — the wire layer still frames them exactly, so one unknown
    field never desynchronizes the rest of the message. `registry`/`repeated`
    default to the GyroflowProtobuf tables; other registry-driven formats
    (e.g. telemetry.dji) pass their own."""
    registry = REGISTRY if registry is None else registry
    repeated = _REPEATED if repeated is None else repeated
    schema = registry[schema_name]
    out: dict = {}
    for field_no, wt, val in iter_fields(buf):
        ent = schema.get(field_no)
        if ent is None:
            if stats is not None:
                stats["unknown_fields"] = stats.get("unknown_fields", 0) + 1
            continue
        name, kind = ent
        if kind == "string":
            if wt != 2:
                raise ValueError(f"{schema_name}.{name}: string with wire type {wt}")
            out[name] = val.decode("utf-8", "replace")
        elif kind == "double":
            out[name] = _to_double(wt, val)
        elif kind == "varint":
            if wt != 0:
                raise ValueError(f"{schema_name}.{name}: varint with wire type {wt}")
            out[name] = int(val)
        elif kind == "packed_double":
            if wt != 2:
                raise ValueError(f"{schema_name}.{name}: packed field with wire type {wt}")
            out[name] = _packed_doubles(val)
        elif kind.startswith("message:"):
            if wt != 2:
                raise ValueError(f"{schema_name}.{name}: submessage with wire type {wt}")
            sub = decode_message(val, kind.split(":", 1)[1], stats,
                                 registry, repeated)
            if kind.split(":", 1)[1] in repeated:
                out.setdefault(name, []).append(sub)
            else:
                out[name] = sub
        else:  # pragma: no cover — registry authoring error
            raise ValueError(f"unknown registry kind {kind}")
    return out


def encode_message(tag_map: dict, schema_name: str,
                   registry: Optional[dict] = None) -> bytes:
    """Inverse of decode_message (fixture builder + gyro export carrier)."""
    registry = REGISTRY if registry is None else registry
    schema = registry[schema_name]
    by_name = {name: (no, kind) for no, (name, kind) in schema.items()}
    out = bytearray()

    def varint(v: int) -> bytes:
        b = bytearray()
        while True:
            if v < 0x80:
                b.append(v)
                return bytes(b)
            b.append((v & 0x7F) | 0x80)
            v >>= 7

    def emit(no: int, wt: int, payload: bytes):
        out.extend(varint((no << 3) | wt))
        out.extend(payload)

    for name, val in tag_map.items():
        if name not in by_name:
            raise ValueError(f"{schema_name}.{name} not in registry")
        no, kind = by_name[name]
        if kind == "string":
            enc = str(val).encode("utf-8")
            emit(no, 2, varint(len(enc)) + enc)
        elif kind == "double":
            emit(no, 1, struct.pack("<d", float(val)))
        elif kind == "varint":
            emit(no, 0, varint(int(val)))
        elif kind == "packed_double":
            enc = struct.pack(f"<{len(val)}d", *[float(x) for x in val])
            emit(no, 2, varint(len(enc)) + enc)
        elif kind.startswith("message:"):
            sub_name = kind.split(":", 1)[1]
            vals = val if isinstance(val, list) else [val]
            for v in vals:
                enc = encode_message(v, sub_name, registry)
                emit(no, 2, varint(len(enc)) + enc)
    return bytes(out)


# ---------------------------------------------------------------------------
# FileMetadata assembly
# ---------------------------------------------------------------------------

def parse_samples(payloads: List[Tuple[bytes, float]],
                  progress_cb=None) -> FileMetadata:
    """payloads: (protobuf Main message bytes, sample_time_s) per frame."""
    fm = FileMetadata()
    stats: dict = {}
    tag_maps = []
    imu: Dict[float, TimeIMU] = {}
    header: dict = {}
    for i, (data, _t) in enumerate(payloads):
        tm = decode_message(data, "Main", stats)
        tag_maps.append(tm)
        if "Header" in tm:
            header.update(tm["Header"])
        for g in tm.get("Gyroscope", ()):
            d = g.get("Data") or []
            if len(d) >= 3 and "Timestamp" in g:
                ms = float(g["Timestamp"])
                rec = imu.setdefault(round(ms, 6), TimeIMU(timestamp_ms=ms))
                rec.gyro = np.asarray(d[:3], np.float64)
        for a in tm.get("Accelerometer", ()):
            d = a.get("Data") or []
            if len(d) >= 3 and "Timestamp" in a:
                ms = float(a["Timestamp"])
                rec = imu.setdefault(round(ms, 6), TimeIMU(timestamp_ms=ms))
                rec.accl = np.asarray(d[:3], np.float64)
        if progress_cb and (i & 63) == 0:
            progress_cb(i / max(len(payloads), 1))
    fm.raw_imu = [imu[k] for k in sorted(imu)]
    model = " ".join(s for s in (header.get("CameraBrand"),
                                 header.get("CameraModel")) if s)
    fm.detected_source = f"GyroflowProtobuf {model}".strip()
    fm.imu_orientation = header.get("ImuOrientation")
    if header.get("FrameReadoutTime"):
        fm.frame_readout_time = float(header["FrameReadoutTime"])
    if header.get("LensProfile"):
        fm.lens_profile = header["LensProfile"]
    fm.has_accurate_timestamps = True
    fm.additional_data["samples"] = tag_maps
    if stats.get("unknown_fields"):
        fm.additional_data["unknown_fields"] = stats["unknown_fields"]
    return fm


def has_gyroflow_proto(path: str) -> bool:
    from .mp4 import find_metadata_track, mapped
    try:
        with mapped(path) as buf:
            if bytes(buf[:len(RAW_MAGIC)]) == RAW_MAGIC:
                return True
            return find_metadata_track(buf, SAMPLE_FORMAT) is not None
    except (OSError, ValueError):
        return False


def parse_gyroflow_proto(path: str, progress_cb=None) -> FileMetadata:
    """MP4 `gfpb` metadata track, or a RAW_MAGIC-prefixed stream of
    varint-length-delimited Main messages."""
    from .mp4 import find_metadata_track, mapped
    with mapped(path) as buf:
        if bytes(buf[:len(RAW_MAGIC)]) == RAW_MAGIC:
            payloads = []
            pos, end = len(RAW_MAGIC), len(buf)
            while pos < end:
                ln, pos = read_varint(buf, pos, end)
                if ln > end - pos:
                    raise ValueError("truncated protobuf stream")
                payloads.append((bytes(buf[pos:pos + ln]), len(payloads) / 30.0))
                pos += ln
            return parse_samples(payloads, progress_cb)
        tr = find_metadata_track(buf, SAMPLE_FORMAT)
        if tr is None:
            raise ValueError("no GyroflowProtobuf track")
        payloads = [(bytes(buf[off:off + sz]), t)
                    for off, sz, t, _d in tr.samples()]
        return parse_samples(payloads, progress_cb)
