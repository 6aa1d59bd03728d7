"""SMPTE ST 336 (KLV) primitives for Sony RTMD metadata tracks.

The reference consumes Sony's `rtmd` track through the external
telemetry-parser crate (src/core/Cargo.toml:14); the crate's raw decoding is
not part of the reference repo. This module implements the documented
container structure from the public specs:

- SMPTE ST 336 "Data Encoding Protocol Using Key-Length-Value": each packet
  is a 16-byte SMPTE Universal Label key (starts 06 0E 2B 34), a BER length
  (short form < 0x80; long form 0x81-0x88 followed by that many length
  bytes), and the value.
- SMPTE RDD 18 "Acquisition Metadata" (the lens/camera sets Sony cameras
  write): local sets keyed by group ULs, each item a 2-byte local tag +
  2-byte big-endian length + value.

Group ULs (RDD 18 §5; byte 13 selects the set):

  06 0E 2B 34 02 53 01 01 0C 02 01 01 01 01 00 00   LensUnitMetadata
  06 0E 2B 34 02 53 01 01 0C 02 01 01 02 01 00 00   CameraUnitMetadata
  06 0E 2B 34 02 53 01 01 0C 03 01 01 01 01 00 00   UserDefinedAcquisitionMetadata
                                                     (vendor sets; Sony puts
                                                     gyro/accel/IBIS here)

RDD 18 local tags implemented (public assignments): 0x8000 IrisFNumber,
0x8001 FocusPositionFromImagePlane, 0x8004 LensZoom35mmEquivalent,
0x8005 LensZoomActualFocalLength, 0x8104/0x8105 ImageSensorDimension
Effective W/H, 0x8106 CaptureFrameRate, 0x8107 ImageSensorReadoutMode,
0x8109 ShutterSpeedTime, 0x810B ISOSensitivity.

The Sony user-defined items (gyro, accelerometer, IBIS shift/angle, lens
OSS, distortion polynomial, mesh) are NOT publicly standardized; their local
tag ids here are project-defined within the user-defined range (0xE4xx) and
isolated in `SONY_USER_TAGS` so a real-clip calibration only has to adjust
that registry — unknown tags/sets are counted and skipped, never misparsed.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

UL_PREFIX = bytes.fromhex("060E2B34")

UL_LENS_UNIT = bytes.fromhex("060E2B34025301010C02010101010000")
UL_CAMERA_UNIT = bytes.fromhex("060E2B34025301010C02010102010000")
UL_USER_DEFINED = bytes.fromhex("060E2B34025301010C03010101010000")

# RDD 18 local tags (public)
TAG_IRIS_F = 0x8000
TAG_FOCUS_IMAGE_PLANE = 0x8001
TAG_ZOOM_35MM = 0x8004
TAG_ZOOM_ACTUAL = 0x8005
TAG_SENSOR_EFF_W = 0x8104
TAG_SENSOR_EFF_H = 0x8105
TAG_CAPTURE_FRAME_RATE = 0x8106
TAG_READOUT_MODE = 0x8107
TAG_SHUTTER_TIME = 0x8109
TAG_ISO = 0x810B

# Project-defined Sony user-tag registry (user-defined range; see module doc).
SONY_USER_TAGS = {
    "camera_model": 0xE400,        # utf-8 string
    "frame_readout_time": 0xE401,  # f64 ms (full frame)
    "video_size": 0xE402,          # 2x u32
    "imu_orientation": 0xE403,     # ascii, e.g. b"XYZ"
    "gyro_freq": 0xE410,           # f64 Hz
    "gyro_offset": 0xE411,         # f64 ms
    "gyro_scaler": 0xE412,         # f64
    "gyro_data": 0xE413,           # N x (f64 t_ms, 3x f64 deg/s)
    "accel_data": 0xE414,          # N x (f64 t_ms, 3x f64 g)
    "ibis_shift": 0xE420,          # N x (f64 t, 3x f64)
    "ibis_angle": 0xE421,          # N x (f64 t, 3x f64)
    "lens_oss": 0xE422,            # N x (f64 t, 3x f64)
    "imager_first_frame_ts": 0xE430,   # f64
    "imager_exposure_time": 0xE431,    # f64
    "imager_sensor_size_px": 0xE432,   # 2x f64
    "imager_pixel_pitch": 0xE433,      # 2x f64
    "imager_capture_area_origin": 0xE434,  # 2x f64
    "imager_capture_area_size": 0xE435,    # 2x f64
    "lens_distortion_enabled": 0xE440,     # u8
    "lens_distortion_fl_nm": 0xE441,       # f64
    "lens_distortion_sensor_h_nm": 0xE442,  # f64
    "lens_distortion_coeff_scale": 0xE443,  # f64
    "lens_distortion_coeffs": 0xE444,       # N x f64
    "lens_display_name": 0xE445,            # utf-8
    "lens_focal_length": 0xE446,            # f64 mm
    "lens_pixel_focal_length": 0xE447,      # f64
    "mesh_size": 0xE450,           # 2x f64
    "mesh_divisions": 0xE451,      # 2x u32
    "mesh_raw": 0xE452,            # N x 2 f64 ((x, y) pairs, flattened)
    "fpd_data": 0xE453,            # f64 unk1, unk2, scale + N x 2 f64 unk4
    "mesh_pts": 0xE454,            # N x 2 f64 ((x, y) pairs, flattened)
    "frame_rate": 0xE460,          # f64
}
_USER_TAG_NAMES = {v: k for k, v in SONY_USER_TAGS.items()}


class KLVError(ValueError):
    pass


def read_ber_length(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode a BER length at pos. Returns (length, new_pos)."""
    if pos >= len(buf):
        raise KLVError("BER length past end of buffer")
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    nb = b0 & 0x7F
    if nb == 0 or nb > 8 or pos + 1 + nb > len(buf):
        raise KLVError(f"invalid BER long-form length (nb={nb})")
    val = 0
    for i in range(nb):
        val = (val << 8) | buf[pos + 1 + i]
    return val, pos + 1 + nb


def write_ber_length(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    while n:
        out.append(n & 0xFF)
        n >>= 8
    return bytes([0x80 | len(out)]) + bytes(reversed(out))


def iter_klv(buf: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Walk top-level ST 336 packets: yields (16-byte UL, value)."""
    pos = 0
    n = len(buf)
    while pos < n:
        if pos + 16 > n:
            raise KLVError("truncated UL key")
        key = buf[pos:pos + 16]
        if key[:4] != UL_PREFIX:
            raise KLVError(f"not a SMPTE UL at offset {pos}")
        ln, vpos = read_ber_length(buf, pos + 16)
        if vpos + ln > n:
            raise KLVError("KLV value exceeds buffer")
        yield key, buf[vpos:vpos + ln]
        pos = vpos + ln


def iter_local_set(value: bytes) -> Iterator[Tuple[int, bytes]]:
    """Walk an RDD 18 local set: 2-byte tag + 2-byte BE length items."""
    pos = 0
    n = len(value)
    while pos < n:
        if pos + 4 > n:
            raise KLVError("truncated local-set item header")
        tag, ln = struct.unpack_from(">HH", value, pos)
        pos += 4
        if pos + ln > n:
            raise KLVError("local-set item exceeds set")
        yield tag, value[pos:pos + ln]
        pos += ln


def encode_local_set(items: List[Tuple[int, bytes]]) -> bytes:
    return b"".join(struct.pack(">HH", tag, len(v)) + v
                    for tag, v in items)


def encode_klv(ul: bytes, value: bytes) -> bytes:
    assert len(ul) == 16
    return ul + write_ber_length(len(value)) + value


# ---------------------------------------------------------------------------
# Sony rtmd sample <-> tag map
# ---------------------------------------------------------------------------

def _f64s(v: bytes) -> List[float]:
    if len(v) % 8:
        raise KLVError("f64 array length not a multiple of 8")
    return list(struct.unpack(f">{len(v)//8}d", v))


def _samples(v: bytes) -> List[Tuple[float, float, float, float]]:
    vals = _f64s(v)
    if len(vals) % 4:
        raise KLVError("sample array not a multiple of 4 f64s")
    return [tuple(vals[i:i + 4]) for i in range(0, len(vals), 4)]


def decode_rtmd_sample(buf: bytes) -> Tuple[dict, int]:
    """One rtmd sample (concatenated KLV packets) -> (tag_map, skipped).

    tag_map follows the schema documented in telemetry/sony.py; `skipped`
    counts unknown ULs / local tags (flagged, never misparsed).
    """
    tm: dict = {}
    skipped = 0

    def ensure(key):
        return tm.setdefault(key, {})

    for ul, value in iter_klv(buf):
        if ul == UL_LENS_UNIT:
            lens = ensure("lens")
            for tag, v in iter_local_set(value):
                if tag == TAG_IRIS_F and len(v) == 2:
                    # RDD18: F-number as 16-bit, F = 2^((v/2^16)*8-1)... camera
                    # vendors differ; carry the raw code
                    lens["iris_code"] = struct.unpack(">H", v)[0]
                elif tag == TAG_ZOOM_ACTUAL and len(v) == 2:
                    # distance item: 16-bit float-ish code; carry raw mm*10
                    lens.setdefault("focal_length",
                                    struct.unpack(">H", v)[0] / 10.0)
                elif tag == TAG_FOCUS_IMAGE_PLANE and len(v) == 2:
                    lens["focus_code"] = struct.unpack(">H", v)[0]
                else:
                    skipped += 1
        elif ul == UL_CAMERA_UNIT:
            cam = ensure("camera")
            for tag, v in iter_local_set(value):
                if tag == TAG_CAPTURE_FRAME_RATE and len(v) == 8:
                    num, den = struct.unpack(">II", v)
                    if den:
                        tm["frame_rate"] = num / den
                elif tag == TAG_SENSOR_EFF_W and len(v) == 4:
                    cam["sensor_eff_w"] = struct.unpack(">I", v)[0]
                elif tag == TAG_SENSOR_EFF_H and len(v) == 4:
                    cam["sensor_eff_h"] = struct.unpack(">I", v)[0]
                elif tag == TAG_SHUTTER_TIME and len(v) == 8:
                    num, den = struct.unpack(">II", v)
                    if den:
                        cam["shutter_s"] = num / den
                elif tag == TAG_ISO and len(v) == 4:
                    cam["iso"] = struct.unpack(">I", v)[0]
                else:
                    skipped += 1
        elif ul == UL_USER_DEFINED:
            for tag, v in iter_local_set(value):
                name = _USER_TAG_NAMES.get(tag)
                if name is None:
                    skipped += 1
                    continue
                if name == "camera_model":
                    tm["camera_model"] = v.decode("utf-8", "replace")
                elif name == "frame_readout_time":
                    tm["frame_readout_time"] = _f64s(v)[0]
                elif name == "video_size":
                    tm["video_size"] = list(struct.unpack(">II", v))
                elif name == "imu_orientation":
                    tm["imu_orientation"] = v.decode("ascii", "replace")
                elif name == "frame_rate":
                    tm["frame_rate"] = _f64s(v)[0]
                elif name == "gyro_freq":
                    ensure("gyroscope")["frequency"] = _f64s(v)[0]
                elif name == "gyro_offset":
                    ensure("gyroscope")["time_offset"] = _f64s(v)[0]
                elif name == "gyro_scaler":
                    ensure("gyroscope")["scaler"] = _f64s(v)[0]
                elif name == "gyro_data":
                    ensure("gyroscope")["data"] = _samples(v)
                elif name == "accel_data":
                    ensure("accelerometer")["data"] = _samples(v)
                elif name == "ibis_shift":
                    ensure("ibis")["data"] = _samples(v)
                elif name == "ibis_angle":
                    ensure("ibis")["data2"] = _samples(v)
                elif name == "lens_oss":
                    ensure("lens_oss")["data"] = _samples(v)
                elif name.startswith("imager_"):
                    key = name[len("imager_"):]
                    vals = _f64s(v)
                    ensure("imager")[key] = vals[0] if len(vals) == 1 else list(vals)
                elif name == "lens_distortion_enabled":
                    ensure("lens_distortion")["enabled"] = bool(v and v[0])
                elif name.startswith("lens_distortion_"):
                    key = {"lens_distortion_fl_nm": "focal_length_nm",
                           "lens_distortion_sensor_h_nm": "effective_sensor_height_nm",
                           "lens_distortion_coeff_scale": "coeff_scale",
                           "lens_distortion_coeffs": "coeffs"}[name]
                    data = ensure("lens_distortion").setdefault("data", {})
                    vals = _f64s(v)
                    data[key] = vals if key == "coeffs" else vals[0]
                elif name == "lens_display_name":
                    ensure("lens")["display_name"] = v.decode("utf-8", "replace")
                elif name == "lens_focal_length":
                    ensure("lens")["focal_length"] = _f64s(v)[0]
                elif name == "lens_pixel_focal_length":
                    ensure("lens")["pixel_focal_length"] = _f64s(v)[0]
                elif name == "mesh_size":
                    d = ensure("mesh_correction").setdefault("data", {})
                    d["size"] = list(_f64s(v))
                elif name == "mesh_divisions":
                    d = ensure("mesh_correction").setdefault("data", {})
                    d["divisions"] = list(struct.unpack(">II", v))
                elif name in ("mesh_raw", "mesh_pts"):
                    vals = _f64s(v)
                    if len(vals) % 2:
                        raise KLVError("mesh point array not (x, y) pairs")
                    pts = [tuple(vals[i:i + 2]) for i in range(0, len(vals), 2)]
                    d = ensure("mesh_correction").setdefault("data", {})
                    d["raw_mesh" if name == "mesh_raw" else "mesh"] = pts
                elif name == "fpd_data":
                    vals = _f64s(v)
                    if len(vals) < 3 or (len(vals) - 3) % 2:
                        raise KLVError("malformed focal-plane-distortion item")
                    tm["focal_plane_distortion"] = {
                        "data": {"unk1": vals[0], "unk2": vals[1],
                                 "scale": vals[2],
                                 "unk4": [tuple(vals[i:i + 2])
                                          for i in range(3, len(vals), 2)]}}
        else:
            skipped += 1
    return tm, skipped


def encode_rtmd_sample(tm: dict) -> bytes:
    """tag map -> rtmd sample bytes (real ST 336 KLV, NOT the CBOR fixture
    path — used to build KLV fixtures and to re-embed telemetry)."""
    def f64s(*vals) -> bytes:
        return struct.pack(f">{len(vals)}d", *vals)

    def flat(samples) -> bytes:
        out = []
        for s in samples:
            out.extend(s)
        return struct.pack(f">{len(out)}d", *out)

    user: List[Tuple[int, bytes]] = []
    T = SONY_USER_TAGS
    if "camera_model" in tm:
        user.append((T["camera_model"], tm["camera_model"].encode()))
    if "frame_readout_time" in tm and tm["frame_readout_time"] is not None:
        user.append((T["frame_readout_time"], f64s(tm["frame_readout_time"])))
    if "video_size" in tm:
        user.append((T["video_size"], struct.pack(">II", *tm["video_size"])))
    if "imu_orientation" in tm:
        user.append((T["imu_orientation"], tm["imu_orientation"].encode()))
    if "frame_rate" in tm:
        user.append((T["frame_rate"], f64s(tm["frame_rate"])))
    g = tm.get("gyroscope", {})
    if "frequency" in g:
        user.append((T["gyro_freq"], f64s(g["frequency"])))
    if "time_offset" in g:
        user.append((T["gyro_offset"], f64s(g["time_offset"])))
    if "scaler" in g:
        user.append((T["gyro_scaler"], f64s(g["scaler"])))
    if g.get("data"):
        user.append((T["gyro_data"], flat(g["data"])))
    a = tm.get("accelerometer", {})
    if a.get("data"):
        user.append((T["accel_data"], flat(a["data"])))
    ib = tm.get("ibis", {})
    if ib.get("data"):
        user.append((T["ibis_shift"], flat(ib["data"])))
    if ib.get("data2"):
        user.append((T["ibis_angle"], flat(ib["data2"])))
    oss = tm.get("lens_oss", {})
    if oss.get("data"):
        user.append((T["lens_oss"], flat(oss["data"])))
    im = tm.get("imager", {})
    for key in ("first_frame_ts", "exposure_time", "sensor_size_px",
                "pixel_pitch", "capture_area_origin", "capture_area_size"):
        if key in im:
            v = im[key]
            vals = v if isinstance(v, (list, tuple)) else [v]
            user.append((T["imager_" + key], f64s(*vals)))
    ld = tm.get("lens_distortion")
    if ld:
        user.append((T["lens_distortion_enabled"],
                     bytes([1 if ld.get("enabled") else 0])))
        d = ld.get("data", {})
        if "focal_length_nm" in d:
            user.append((T["lens_distortion_fl_nm"], f64s(d["focal_length_nm"])))
        if "effective_sensor_height_nm" in d:
            user.append((T["lens_distortion_sensor_h_nm"],
                         f64s(d["effective_sensor_height_nm"])))
        if "coeff_scale" in d:
            user.append((T["lens_distortion_coeff_scale"], f64s(d["coeff_scale"])))
        if d.get("coeffs"):
            user.append((T["lens_distortion_coeffs"], f64s(*d["coeffs"])))
    lens = tm.get("lens", {})
    if "display_name" in lens:
        user.append((T["lens_display_name"], lens["display_name"].encode()))
    if "focal_length" in lens and lens["focal_length"] is not None:
        user.append((T["lens_focal_length"], f64s(lens["focal_length"])))
    if "pixel_focal_length" in lens and lens["pixel_focal_length"] is not None:
        user.append((T["lens_pixel_focal_length"], f64s(lens["pixel_focal_length"])))
    mc = tm.get("mesh_correction", {}).get("data", {})
    if mc:
        if "size" in mc:
            user.append((T["mesh_size"], f64s(*mc["size"])))
        if "divisions" in mc:
            user.append((T["mesh_divisions"], struct.pack(">II", *mc["divisions"])))
        if "raw_mesh" in mc:
            user.append((T["mesh_raw"], flat(mc["raw_mesh"])))
        if "mesh" in mc:
            user.append((T["mesh_pts"], flat(mc["mesh"])))
    fpd = tm.get("focal_plane_distortion", {}).get("data")
    if fpd:
        vals = [float(fpd["unk1"]), float(fpd["unk2"]), float(fpd["scale"])]
        for pair in fpd.get("unk4", []):
            vals.extend(float(x) for x in pair)
        user.append((T["fpd_data"], f64s(*vals)))

    out = []
    # a minimal RDD 18 lens set rides along so the decoder exercises the
    # public-tag path too
    lens_items: List[Tuple[int, bytes]] = []
    if "focal_length" in lens and lens["focal_length"] is not None:
        lens_items.append((TAG_ZOOM_ACTUAL, struct.pack(
            ">H", min(int(round(lens["focal_length"] * 10.0)), 0xFFFF))))
    if lens_items:
        out.append(encode_klv(UL_LENS_UNIT, encode_local_set(lens_items)))
    cam_items: List[Tuple[int, bytes]] = []
    if "frame_rate" in tm:
        fr = tm["frame_rate"]
        cam_items.append((TAG_CAPTURE_FRAME_RATE,
                          struct.pack(">II", int(round(fr * 1000)), 1000)))
    if cam_items:
        out.append(encode_klv(UL_CAMERA_UNIT, encode_local_set(cam_items)))
    out.append(encode_klv(UL_USER_DEFINED, encode_local_set(user)))
    return b"".join(out)


def looks_like_klv(buf: bytes) -> bool:
    return len(buf) >= 17 and buf[:4] == UL_PREFIX
