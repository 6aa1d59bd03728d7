"""`.gyroflow` project file import/export (versioned JSON, version 4).

Port of gyroflow src/core/lib.rs:1254-1871. The schema is the plugin
interchange format; gyro blobs are base91(zlib(CBOR)) (util.rs:44-57).
"""
from __future__ import annotations

import datetime
import enum
import json
import logging
import math
import os
from typing import Optional

import numpy as np

from .. import __version__
from ..utils.compression import compress_to_base91_cbor, decompress_from_base91_cbor
from .file_metadata import FileMetadata, TimeIMU
from .keyframes import KeyframeType
from .params import BackgroundMode, ReadoutDirection
from .time_quat import TimeQuat

log = logging.getLogger(__name__)


class GyroflowProjectType(enum.IntEnum):
    """lib.rs:2085."""
    Simple = 0
    WithGyroData = 1
    WithProcessedData = 2


def _quats_to_cbor(tq: TimeQuat) -> dict:
    # TimeQuat = BTreeMap<i64, UnitQuaternion>; nalgebra serializes [x, y, z, w]
    return {int(t): [float(q[1]), float(q[2]), float(q[3]), float(q[0])]
            for t, q in zip(tq.timestamps_us, tq.quats)}


def _quats_from_cbor(d: dict) -> TimeQuat:
    if not d:
        return TimeQuat()
    ts = np.asarray(sorted(d), dtype=np.int64)
    qs = np.asarray([[d[int(t)][3], d[int(t)][0], d[int(t)][1], d[int(t)][2]] for t in ts])
    return TimeQuat(ts, qs)


def _file_metadata_to_cbor(fm: FileMetadata) -> dict:
    return {
        "imu_orientation": fm.imu_orientation,
        "detected_source": fm.detected_source,
        "frame_readout_time": fm.frame_readout_time,
        "frame_rate": fm.frame_rate,
        "raw_imu": [
            {"timestamp_ms": float(v.timestamp_ms),
             "gyro": None if v.gyro is None else [float(x) for x in v.gyro],
             "accl": None if v.accl is None else [float(x) for x in v.accl],
             "magn": None if v.magn is None else [float(x) for x in v.magn]}
            for v in fm.raw_imu],
        "quaternions": _quats_to_cbor(fm.quaternions),
        "image_orientations": _quats_to_cbor(fm.image_orientations)
        if fm.image_orientations is not None else None,
        "gravity_vectors": None if fm.gravity_vectors is None else {
            int(t): [float(x) for x in v]
            for t, v in zip(fm.gravity_vectors["ts"], fm.gravity_vectors["vec"])},
        "per_frame_time_offsets": [float(x) for x in fm.per_frame_time_offsets],
        "digital_zoom": fm.digital_zoom,
        "lens_profile": fm.lens_profile if isinstance(fm.lens_profile, (str, dict)) else None,
        "has_accurate_timestamps": fm.has_accurate_timestamps,
    }


def _file_metadata_from_cbor(d: dict) -> FileMetadata:
    fm = FileMetadata()
    if not isinstance(d, dict):
        return fm
    fm.imu_orientation = d.get("imu_orientation")
    fm.detected_source = d.get("detected_source")
    fm.frame_readout_time = d.get("frame_readout_time")
    fm.frame_rate = d.get("frame_rate")
    for v in d.get("raw_imu") or []:
        fm.raw_imu.append(TimeIMU(
            timestamp_ms=float(v.get("timestamp_ms", 0.0)),
            gyro=np.asarray(v["gyro"], dtype=np.float64) if v.get("gyro") else None,
            accl=np.asarray(v["accl"], dtype=np.float64) if v.get("accl") else None,
            magn=np.asarray(v["magn"], dtype=np.float64) if v.get("magn") else None))
    if d.get("quaternions"):
        fm.quaternions = _quats_from_cbor(d["quaternions"])
    if d.get("image_orientations"):
        fm.image_orientations = _quats_from_cbor(d["image_orientations"])
    gv = d.get("gravity_vectors")
    if gv:
        ts = sorted(gv)
        fm.gravity_vectors = {"ts": np.asarray(ts, np.int64),
                              "vec": np.asarray([gv[t] for t in ts])}
    fm.per_frame_time_offsets = list(d.get("per_frame_time_offsets") or [])
    fm.digital_zoom = d.get("digital_zoom")
    fm.lens_profile = d.get("lens_profile")
    fm.has_accurate_timestamps = bool(d.get("has_accurate_timestamps", False))
    return fm


def export_gyroflow_data(mgr, typ: GyroflowProjectType = GyroflowProjectType.WithGyroData,
                         additional_data: Optional[dict] = None) -> str:
    """lib.rs:1254-1420."""
    params = mgr.params
    gyro = mgr.gyro
    smoothing = mgr.smoothing
    hl = smoothing.horizon_lock

    smoothing_params = [{"name": k, "value": v}
                        for k, v in smoothing.current.params().items()]
    horizon_amount = hl.horizonlockpercent if hl.lock_enabled else 0.0

    trim_ranges_ms = [(a * params.duration_ms, b * params.duration_ms)
                      for a, b in params.trim_ranges]

    obj = {
        "title": "Gyroflow data file",
        "version": 4,
        "app_version": __version__,
        "videofile": mgr.input_file or "",
        "calibration_data": mgr.lens.to_dict(),
        "date": datetime.date.today().isoformat(),
        "image_sequence_start": getattr(mgr, "image_sequence_start", 0),
        "image_sequence_fps": getattr(mgr, "image_sequence_fps", 0.0),
        "background_color": list(params.background),
        "background_mode": int(params.background_mode),
        "background_margin": params.background_margin,
        "background_margin_feather": params.background_margin_feather,
        "light_refraction_coefficient": params.light_refraction_coefficient,
        "video_info": {
            "width": params.size[0], "height": params.size[1],
            "rotation": params.video_rotation, "num_frames": params.frame_count,
            "fps": params.fps, "duration_ms": params.duration_ms,
            "fps_scale": params.fps_scale,
            "vfr_fps": params.get_scaled_fps(),
            "vfr_duration_ms": params.get_scaled_duration_ms(),
            "created_at": None,
        },
        "stabilization": {
            "fov": params.fov,
            "method": smoothing.current.get_name(),
            "smoothing_params": smoothing_params,
            "frame_readout_time": abs(params.frame_readout_time),
            "frame_readout_direction": params.frame_readout_direction.name,
            "adaptive_zoom_window": params.adaptive_zoom_window,
            "adaptive_zoom_center_offset": list(params.adaptive_zoom_center_offset),
            "adaptive_zoom_method": params.adaptive_zoom_method,
            "additional_rotation": list(params.additional_rotation),
            "additional_translation": list(params.additional_translation),
            "lens_correction_amount": params.lens_correction_amount,
            "horizon_lock_amount": horizon_amount,
            "horizon_lock_roll": hl.horizonroll,
            "horizon_lock_pitch_enabled": hl.lock_pitch,
            "horizon_lock_pitch": hl.horizonpitch,
            "automatic_lock": hl.automatic_lock,
            "turn_threshold": hl.turn_threshold,
            "turn_smoothing_ms": hl.turn_smoothing_ms,
            "turn_multiplier": hl.turn_multiplier,
            "tilt_accel_limit": (None if math.isinf(hl.tilt_accel_limit)
                                 else hl.tilt_accel_limit),
            "use_gravity_vectors": gyro.use_gravity_vectors,
            "horizon_lock_integration_method": gyro.horizon_lock_integration_method,
            "video_speed": params.video_speed,
            "video_speed_affects_smoothing": params.video_speed_affects_smoothing,
            "video_speed_affects_zooming": params.video_speed_affects_zooming,
            "video_speed_affects_zooming_limit": params.video_speed_affects_zooming_limit,
            "max_zoom": params.max_zoom,
            "max_zoom_iterations": params.max_zoom_iterations,
            "frame_offset": params.frame_offset,
            "focal_length_smoothing_enabled": params.focal_length_smoothing_enabled,
            "focal_length_smoothing_strength": params.focal_length_smoothing_strength,
        },
        "gyro_source": {
            "filepath": gyro.file_url,
            "lpf": gyro.imu_transforms.imu_lpf,
            "mf": gyro.imu_transforms.imu_mf,
            "glitch_filter": gyro.imu_transforms.glitch_filter,
            "glitch_strength": gyro.imu_transforms.glitch_strength,
            "rotation": gyro.imu_transforms.imu_rotation_angles,
            "acc_rotation": gyro.imu_transforms.acc_rotation_angles,
            "imu_orientation": gyro.imu_transforms.imu_orientation,
            "gyro_bias": gyro.imu_transforms.gyro_bias,
            "integration_method": gyro.integration_method,
            "sample_index": None,
            "detected_source": gyro.file_metadata.detected_source,
        },
        "offsets": {str(k): v for k, v in gyro.get_offsets().items()},
        "keyframes": mgr.keyframes.serialize(),
        "trim_ranges_ms": trim_ranges_ms,
    }

    if additional_data:
        obj.update(additional_data)

    gs = obj["gyro_source"]
    if typ == GyroflowProjectType.Simple:
        gs["file_metadata"] = {
            "detected_source": gyro.file_metadata.detected_source,
            "imu_orientation": gyro.file_metadata.imu_orientation,
            "frame_readout_time": gyro.file_metadata.frame_readout_time,
        }
    else:
        blob = compress_to_base91_cbor(_file_metadata_to_cbor(gyro.file_metadata))
        if blob:
            gs["file_metadata"] = blob

    if typ == GyroflowProjectType.WithProcessedData:
        imu_ts = []
        for t in gyro.quaternions.timestamps_us:
            ts_ms = t / 1000.0
            ts_ms += float(gyro.offset_at_gyro_timestamp(ts_ms))
            imu_ts.append(ts_ms)
        for name, value in (
                ("synced_imu_timestamps", imu_ts),
                ("integrated_quaternions", _quats_to_cbor(gyro.quaternions)),
                ("smoothed_quaternions", _quats_to_cbor(gyro.smoothed_quaternions)),
                ("adaptive_zoom_fovs", [float(f) for f in params.fovs])):
            blob = compress_to_base91_cbor(value)
            if blob:
                gs[name] = blob
        # per-frame focal length arrays for plugins (lib.rs:1391-1398)
        for name, value in (("focal_lengths", params.focal_lengths),
                            ("smoothed_focal_lengths", params.smoothed_focal_lengths)):
            if value:
                blob = compress_to_base91_cbor([None if v is None else float(v)
                                                for v in value])
                if blob:
                    gs[name] = blob

    return json.dumps(obj, indent=2, default=_json_default)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def get_version_from_gyroflow_file(path: str) -> int:
    """controller.rs:1280-1293 — the project's `version` field, 0 on error."""
    try:
        with open(path) as fh:
            obj = json.load(fh)
        return int(obj.get("version", 0))
    except Exception:
        return 0


def _resolve_near(path: str, project_path: str) -> str:
    """controller.rs get_new_videofile_url: when the recorded path no longer
    exists, look for the same filename next to the project file."""
    if not path or os.path.exists(path):
        return path
    sib = os.path.join(os.path.dirname(os.path.abspath(project_path)),
                       os.path.basename(path))
    return sib if os.path.exists(sib) else path


def get_urls_from_gyroflow_file(path: str):
    """controller.rs:1294-1342 — [videofile, gyro_source filepath], resolved
    next to the project file when the stored paths don't exist."""
    video = gyro = ""
    try:
        with open(path) as fh:
            obj = json.load(fh)
        video = _resolve_near(str(obj.get("videofile", "") or ""), path)
        gs = obj.get("gyro_source") or {}
        gyro = _resolve_near(str(gs.get("filepath", "") or ""), path)
    except Exception:
        pass
    return [video, gyro]


def import_gyroflow_data(mgr, data: str, blocking: bool = True):
    """lib.rs:1458-1871 (field subset matching export)."""
    obj = json.loads(data)
    if obj.get("title") != "Gyroflow data file":
        raise ValueError("Not a Gyroflow data file")

    params = mgr.params

    vi = obj.get("video_info") or {}
    params.size = (int(vi.get("width", params.size[0])), int(vi.get("height", params.size[1])))
    if params.output_size == (0, 0):
        params.output_size = params.size
    params.video_rotation = float(vi.get("rotation", params.video_rotation))
    params.frame_count = int(vi.get("num_frames", params.frame_count))
    params.fps = float(vi.get("fps", params.fps))
    params.duration_ms = float(vi.get("duration_ms", params.duration_ms))
    params.fps_scale = vi.get("fps_scale")
    # keyframe lookups scale with the VFR override (lib.rs:1219)
    mgr.keyframes.timestamp_scale = params.fps_scale

    if "background_color" in obj:
        params.background = tuple(obj["background_color"])
    params.background_mode = BackgroundMode.from_any(obj.get("background_mode", 0))
    params.background_margin = float(obj.get("background_margin", 0.0))
    params.background_margin_feather = float(obj.get("background_margin_feather", 0.0))
    params.light_refraction_coefficient = float(obj.get("light_refraction_coefficient", 1.0))

    st = obj.get("stabilization") or {}
    params.fov = float(st.get("fov", params.fov))
    params.frame_readout_time = float(st.get("frame_readout_time", params.frame_readout_time))
    params.frame_readout_direction = ReadoutDirection.from_any(
        st.get("frame_readout_direction", 0))
    params.adaptive_zoom_window = float(st.get("adaptive_zoom_window", 4.0))
    if "adaptive_zoom_center_offset" in st:
        params.adaptive_zoom_center_offset = tuple(st["adaptive_zoom_center_offset"])
    params.adaptive_zoom_method = int(st.get("adaptive_zoom_method", 1))
    if "additional_rotation" in st:
        params.additional_rotation = tuple(st["additional_rotation"])
    if "additional_translation" in st:
        params.additional_translation = tuple(st["additional_translation"])
    params.lens_correction_amount = float(st.get("lens_correction_amount", 1.0))
    params.video_speed = float(st.get("video_speed", 1.0))
    params.video_speed_affects_smoothing = bool(st.get("video_speed_affects_smoothing", True))
    params.video_speed_affects_zooming = bool(st.get("video_speed_affects_zooming", True))
    params.video_speed_affects_zooming_limit = bool(st.get("video_speed_affects_zooming_limit", True))
    params.max_zoom = st.get("max_zoom")
    params.max_zoom_iterations = int(st.get("max_zoom_iterations", 5))
    params.frame_offset = int(st.get("frame_offset", 0))
    params.focal_length_smoothing_enabled = bool(st.get("focal_length_smoothing_enabled", False))
    params.focal_length_smoothing_strength = float(st.get("focal_length_smoothing_strength", 0.5))

    # smoothing method is serialized BY NAME (lib.rs:1699-1707)
    method = st.get("method")
    if method:
        names = mgr.smoothing.get_names()
        if method in names:
            mgr.smoothing.set_current(names.index(method))
    for p in st.get("smoothing_params") or []:
        if "name" in p and "value" in p:
            mgr.smoothing.current.set_parameter(p["name"], float(p["value"]))

    _tal = st.get("tilt_accel_limit")
    mgr.smoothing.horizon_lock.set_horizon(
        float(st.get("horizon_lock_amount", 0.0)),
        float(st.get("horizon_lock_roll", 0.0)),
        lock_pitch=bool(st.get("horizon_lock_pitch_enabled", False)),
        pitch=float(st.get("horizon_lock_pitch", 0.0)),
        automatic_lock=bool(st.get("automatic_lock", False)),
        turn_threshold=float(st.get("turn_threshold", 5.0)),
        turn_smoothing_ms=float(st.get("turn_smoothing_ms", 500.0)),
        turn_multiplier=float(st.get("turn_multiplier", 1.0)),
        tilt_accel_limit=float(_tal) if _tal is not None else math.inf)

    gyro = mgr.gyro
    gs = obj.get("gyro_source") or {}
    gyro.file_url = gs.get("filepath", "")
    gyro.imu_transforms.imu_lpf = float(gs.get("lpf", 0.0))
    gyro.imu_transforms.imu_mf = int(gs.get("mf", 0))
    gyro.imu_transforms.glitch_filter = bool(gs.get("glitch_filter", False))
    gyro.imu_transforms.glitch_strength = float(gs.get("glitch_strength", 0.0))
    if gs.get("rotation"):
        gyro.imu_transforms.set_imu_rotation(*gs["rotation"])
    if gs.get("acc_rotation"):
        gyro.imu_transforms.set_acc_rotation(*gs["acc_rotation"])
    gyro.imu_transforms.imu_orientation = gs.get("imu_orientation")
    gyro.imu_transforms.gyro_bias = gs.get("gyro_bias")
    gyro.integration_method = int(gs.get("integration_method", 2))
    st_grav = st.get("use_gravity_vectors")
    if st_grav is not None:
        gyro.use_gravity_vectors = bool(st_grav)
    hlim = st.get("horizon_lock_integration_method")
    if hlim is not None:
        gyro.horizon_lock_integration_method = int(hlim)

    cal = obj.get("calibration_data")
    if cal:
        from .lens_profile import LensProfile
        mgr.lens = LensProfile.from_dict(cal)

    offsets = obj.get("offsets") or {}
    gyro.set_offsets({int(k): float(v) for k, v in offsets.items()})

    mgr.keyframes.deserialize(obj.get("keyframes") or {})
    mgr.keyframes.update_gyro(gyro)

    # legacy single trim range (lib.rs:1780-1784) and the horizontal-RS flag
    # of v1 projects (lib.rs:1666)
    if obj.get("trim_start") is not None and obj.get("trim_end") is not None:
        params.trim_ranges = [(float(obj["trim_start"]), float(obj["trim_end"]))]
    if st.get("horizontal_rs"):
        params.frame_readout_direction = (
            ReadoutDirection.RightToLeft if params.frame_readout_time < 0.0
            else ReadoutDirection.LeftToRight)
    if obj.get("trim_ranges_ms") and params.duration_ms > 0:
        dur = params.duration_ms
        params.trim_ranges = [
            (a / dur, ((dur + b) if b < 0.0 else b) / dur)
            for a, b in obj["trim_ranges_ms"]]

    fmd = gs.get("file_metadata")
    if isinstance(fmd, str):
        decoded = decompress_from_base91_cbor(fmd)
        if decoded is not None:
            gyro.duration_ms = params.get_scaled_duration_ms() or gyro.duration_ms
            gyro.load_from_telemetry(_file_metadata_from_cbor(decoded))
    elif gs.get("raw_imu") or gs.get("quaternions") \
            or gs.get("integrated_quaternions"):
        # legacy uncompressed gyro blobs (lib.rs:1563-1580): plain JSON
        # arrays/maps in the same serde shapes as the CBOR container.
        # (The compressed LEGACY path — base91(zlib(bincode)) — needs the
        # external crate's bincode layout and is not supported.)
        legacy = dict(gs)
        for k in ("quaternions", "image_orientations"):
            v = legacy.get(k)
            if isinstance(v, dict):
                legacy[k] = {int(t): q for t, q in v.items()}
        iq = legacy.get("integrated_quaternions")
        if isinstance(iq, dict) and not legacy.get("quaternions"):
            legacy["quaternions"] = {int(t): q for t, q in iq.items()}
        fm_legacy = _file_metadata_from_cbor(legacy)
        if fm_legacy.raw_imu or fm_legacy.quaternions is not None:
            gyro.duration_ms = params.get_scaled_duration_ms() or gyro.duration_ms
            gyro.load_from_telemetry(fm_legacy)

    # per-frame focal length arrays (lib.rs:1635-1641)
    for name, attr in (("focal_lengths", "focal_lengths"),
                       ("smoothed_focal_lengths", "smoothed_focal_lengths")):
        blob = gs.get(name)
        if isinstance(blob, str):
            fls = decompress_from_base91_cbor(blob)
            if isinstance(fls, list):
                setattr(params, attr,
                        [None if v is None else float(v) for v in fls])

    mgr.input_file = obj.get("videofile") or mgr.input_file
    mgr.image_sequence_start = int(obj.get("image_sequence_start", 0) or 0)
    mgr.image_sequence_fps = float(obj.get("image_sequence_fps", 0.0) or 0.0)
    # render-output settings object (written by the render queue / plugins;
    # lib.rs:1745-1751 reads the output size back, render_queue.rs:126-145
    # restores the full render config — kept on the manager for the CLI)
    out = obj.get("output")
    if isinstance(out, dict):
        ow = int(out.get("output_width", 0) or 0)
        oh = int(out.get("output_height", 0) or 0)
        if ow > 0 and oh > 0:
            params.output_size = (ow, oh)
        mgr.render_output_settings = dict(out)
    mgr.invalidate()
    if blocking and gyro.has_motion():
        mgr.recompute_blocking()
    return obj
