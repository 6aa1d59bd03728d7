"""StabilizationManager — the public facade, on PyTorch.

A copy of gyroflow_tpu.core.manager (port of gyroflow src/core/lib.rs:82+)
that imports only this package: its host modules are this package's copies.
Rewritten for torch: the device (``torch.device``: ``cuda:0`` unless the
caller names another card or the CPU), its listing, the per-frame matrix
upload, ``process_pixels``, which runs the CUDA kernels
(remap.remap_plane_cuda) on a CUDA device and the plain torch remap on the
CPU, and ``process_pixels_window``, which runs a window of frames through
parallel.pipeline's window step on the same device.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import trace
from .gyro_source import GyroSource
from .keyframes import KeyframeManager, KeyframeType
from .lens_profile import LensProfile
from .params import (BackgroundMode, ComputeParams, ReadoutDirection, StabilizationParams,
                     timestamp_at_frame)
from .smoothing import Smoothing
from .zooming import ZoomMethod, calculate_fovs

log = logging.getLogger(__name__)


def _cuda_device(i: int) -> torch.device:
    """cuda:i, or an error when there is no such card: the manager never
    falls back to the CPU on its own (pass device="cpu" for that)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= i < n:
        raise RuntimeError(f"no CUDA device cuda:{i} ({n} visible); "
                           f"pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", i)


def _resolve_device(device) -> torch.device:
    """The manager's device: cuda:0 when none is named; a named card must
    exist."""
    if device is None:
        return _cuda_device(0)
    device = torch.device(device)
    return _cuda_device(device.index or 0) if device.type == "cuda" else device


def _plane_dtypes(dtype: torch.dtype, max_pixel_value: float):
    """(remap out_dtype, dtype the plane is sampled in) of an uploaded plane:
    uint8 with max_pixel_value 255 stays uint8, uint16 stays uint16, any
    other plane is sampled as float32 and comes back float32."""
    if dtype == torch.uint8 and max_pixel_value == 255.0:
        return "uint8", dtype
    if dtype == torch.uint16:
        return "uint16", dtype
    return "f32", torch.float32


class StabilizationManager:
    def __init__(self, device=None):
        self.gyro = GyroSource()
        self.lens = LensProfile()
        self.smoothing = Smoothing()
        self.params = StabilizationParams()
        self.keyframes = KeyframeManager()
        self.input_file: Optional[str] = None
        self.image_sequence_start = 0     # lib.rs InputFile:61-62
        self.image_sequence_fps = 0.0
        # "output" object of an imported project (render_queue.rs:126-145)
        self.render_output_settings: Dict[str, object] = {}
        self.gpu_decoding = True          # lib.rs:134 "gpudecode" preference
        self.pose_estimator = None        # retained by autosync for overlays
        self.sync_lpf = 0.0               # lib.rs:1105 offset-search LPF
        # lib.rs:1978 accelerator pick: cuda:0 unless the caller names a device
        self.device = _resolve_device(device)
        self._compute_params: Optional[ComputeParams] = None
        self._stab_cache: Dict[int, object] = {}     # ts_us -> FrameTransform
        # guards _stab_cache: frame_transform_at is called concurrently from
        # the render main loop AND the decode-ahead prefetch thread
        # (renderer._AsyncReader); unguarded eviction can double-pop or
        # KeyError mid-render
        self._stab_lock = threading.Lock()
        self._mats_dev: Dict[int, object] = {}       # ts_us -> device (mats, mesh)
        self.current_compute_id = 0
        self._recompute_thread = None
        # invalidation contract (lib.rs:94-99, 904-915): lazy flags consumed
        # by process_pixels, and last-computed state checksums gating the
        # expensive stages in recompute_blocking/recompute_threaded
        self._smoothing_invalidated = False
        self._zooming_invalidated = False
        self._undistortion_invalidated = False
        self._smoothing_checksum = None
        self._zooming_checksum = None

    # ---- loading (lib.rs:155-354, 1909-1976) -------------------------------

    def init_from_video_data(self, duration_ms: float, fps: float, frame_count: int,
                             video_size: Tuple[int, int]):
        """lib.rs:155-170."""
        self.params.fps = fps
        self.params.frame_count = frame_count
        self.params.duration_ms = duration_ms
        self.params.size = video_size
        if not self.params.output_size or self.params.output_size == (0, 0):
            self.params.output_size = video_size
        self.gyro.init_from_params(self.params)
        if duration_ms < 10000.0:
            self.gyro.integration_method = 1  # Complementary for short videos (lib.rs:163)

    def load_gyro_data(self, path: str, progress_cb=None):
        """lib.rs:172-269 (front-end subset; per-camera quirks grow with parsers)."""
        from .telemetry import parse_telemetry_file
        fm = parse_telemetry_file(path, size=self.params.size, fps=self.params.fps,
                                  progress_cb=progress_cb)
        self._apply_camera_quirks(fm)
        if fm.imu_orientation:
            self.gyro.imu_transforms.imu_orientation = fm.imu_orientation
        if fm.frame_readout_time is not None and self.params.frame_readout_time == 0.0:
            self.params.frame_readout_time = fm.frame_readout_time
        if self.params.duration_ms <= 0.0 and fm.raw_imu:
            self.params.duration_ms = fm.raw_imu[-1].timestamp_ms
            self.params.fps = self.params.fps or 30.0
            self.params.frame_count = int(self.params.duration_ms / 1000.0 * self.params.fps)
        self.gyro.duration_ms = self.params.get_scaled_duration_ms() or self.gyro.duration_ms
        self.gyro.file_url = path
        self.gyro.load_from_telemetry(fm)
        self.keyframes.update_gyro(self.gyro)
        self._try_lens_autoload(fm)
        self.invalidate()

    def _apply_camera_quirks(self, fm):
        """Per-camera load quirks (lib.rs:234-252).

        The parsed readout direction flows into params; Blackmagic clips
        recorded rotated 90/180/270 switch the rolling-shutter readout
        direction and the IMU orientation string (the sensor scans its long
        axis regardless of the mounted orientation)."""
        if fm.frame_readout_direction is not None:
            self.params.frame_readout_direction = ReadoutDirection.from_any(
                fm.frame_readout_direction)
        src = fm.detected_source or ""
        if src.startswith("Blackmagic "):
            rot = fm.additional_data.get("rotation")
            try:
                rot = int(rot) if rot is not None else None
            except (TypeError, ValueError):
                rot = None
            if rot in (90, 270):
                log.info("Using horizontal rolling shutter correction")
                if rot == 90:
                    self.params.frame_readout_direction = ReadoutDirection.RightToLeft
                    fm.imu_orientation = "xYz"
                else:
                    self.params.frame_readout_direction = ReadoutDirection.LeftToRight
                    fm.imu_orientation = "Xyz"
            elif rot == 180:
                self.params.frame_readout_direction = ReadoutDirection.BottomToTop
                fm.imu_orientation = "YXz"
        elif src.startswith("GyroflowProtobuf"):
            # gyro_source/mod.rs:444-456: per-frame time offset from each
            # sample's Imager group: first_frame_ts - exposure/2 + readout/2.
            # The protobuf wire schema lives in the external gyroflow-proto
            # repo (not available offline), so the carriage here is the
            # pre-parsed per-sample tag maps in additional_data["samples"];
            # the timing quirk itself matches the reference exactly.
            samples = (fm.additional_data or {}).get("samples") or []
            for tag_map in samples:
                imager = tag_map.get("Imager") if isinstance(tag_map, dict) else None
                if not isinstance(imager, dict):
                    continue
                first_ts = imager.get("FirstFrameTimestamp")
                if first_ts is None:
                    continue
                exposure = float(imager.get("ExposureTime") or 0.0)
                readout = float(imager.get("FrameReadoutTime") or 0.0)
                fm.per_frame_time_offsets.append(
                    float(first_ts) - exposure / 2.0 + readout / 2.0)
        elif src.startswith("Canon"):
            # gyro_source/mod.rs:491-499: apply the Canon tag-map quirks when
            # parsed CTMD tags ride along (project import / pre-parsed
            # metadata; a native CTMD demuxer needs real footage to validate)
            tm = (fm.additional_data or {}).get("tag_map")
            if isinstance(tm, dict):
                from .telemetry import canon
                sr = fm.additional_data.get("sample_rate") or 1000.0
                off = canon.get_time_offset(fm, tm, sample_rate=float(sr),
                                            fps=self.params.fps)
                if off is not None:
                    fm.per_frame_time_offsets.append(off)
                canon.init_lens_profile(
                    fm, tm, self.params.size, 0.0,
                    camera_model=src.replace("Canon", "").strip(),
                    video_rotation=int(self.params.video_rotation))

    def _try_lens_autoload(self, fm):
        """Lens autoload by camera identifier (lib.rs:1929-1956)."""
        if self.lens.is_valid():
            return
        try:
            from .camera_identifier import CameraIdentifier
            from .lens_profile_database import LensProfileDatabase
            cid = CameraIdentifier.from_metadata(
                fm, self.params.size[0], self.params.size[1], self.params.fps)
            if not cid.identifier:
                return
            db = LensProfileDatabase()
            prof = db.find_by_identifier(cid.get_identifier_for_autoload())
            if prof is not None:
                self.lens = prof
                log.info("lens profile autoloaded: %s", prof.name)
        except Exception as e:  # noqa: BLE001 — autoload is best-effort
            log.debug("lens autoload failed: %s", e)

    def load_lens_profile(self, path_or_json: str):
        """lib.rs:356-368."""
        if path_or_json.strip().startswith("{"):
            self.lens = LensProfile.from_json(path_or_json)
        else:
            self.lens = LensProfile.load_from_file(path_or_json)
        try:
            from .lens_profile_database import LensProfileDatabase
            self.lens.resolve_interpolations(LensProfileDatabase())
        except Exception:
            self.lens.resolve_interpolations(None)
        self.invalidate()

    def set_size(self, w: int, h: int):
        self.params.size = (w, h)
        self.invalidate()

    def set_output_size(self, w: int, h: int):
        self.params.output_size = (w, h)
        self.invalidate()

    # ---- params ------------------------------------------------------------

    def set_smoothing_method(self, idx: int):
        self.smoothing.set_current(idx)
        self.invalidate()

    def set_smoothing_param(self, name: str, val: float):
        self.smoothing.current.set_parameter(name, val)
        self.invalidate()

    def set_horizon_lock(self, lock_percent: float, roll: float, **kw):
        self.smoothing.horizon_lock.set_horizon(lock_percent, roll, **kw)
        self.invalidate()

    def set_imu_lpf(self, lpf: float):
        self.gyro.imu_transforms.imu_lpf = lpf
        self.gyro.apply_transforms()
        self.invalidate()

    def set_imu_median_filter(self, size: int):
        self.gyro.imu_transforms.imu_mf = size
        self.gyro.apply_transforms()
        self.invalidate()

    def set_imu_orientation(self, orientation: str):
        self.gyro.imu_transforms.imu_orientation = orientation
        self.gyro.apply_transforms()
        self.invalidate()

    def set_imu_rotation(self, pitch: float, roll: float, yaw: float):
        self.gyro.imu_transforms.set_imu_rotation(pitch, roll, yaw)
        self.gyro.apply_transforms()
        self.invalidate()

    def set_imu_bias(self, bx: float, by: float, bz: float):
        self.gyro.imu_transforms.gyro_bias = [bx, by, bz]
        self.gyro.apply_transforms()
        self.invalidate()

    def estimate_bias(self, timestamps_fract) -> Tuple[float, float, float]:
        """Estimate gyro bias from ~400 ms of presumed-stationary footage
        around each fractional timestamp (controller.rs:552-570; uses the
        first range like the reference). Returns (bx, by, bz) deg/s."""
        fracts = list(timestamps_fract) if not isinstance(timestamps_fract, str) \
            else [float(x) for x in timestamps_fract.split(";") if x]
        dur = self.params.duration_ms
        for x in fracts:
            start = max(x * dur - 200.0, 0.0)
            stop = min(x * dur + 200.0, dur)
            return self.gyro.find_bias(start, stop)
        return (0.0, 0.0, 0.0)

    def set_background_color(self, r: float, g: float, b: float, a: float = 1.0):
        """controller.rs set_background_color (0..1 RGBA)."""
        self.params.background = (r, g, b, a)

    def get_smoothing_max_angles(self) -> Tuple[float, float, float]:
        """Max pitch/yaw/roll correction angles (controller.rs
        get_smoothing_max_angles; computed during recompute_smoothness)."""
        return tuple(self.gyro.max_angles)

    def quats_at_timestamp(self, timestamp_ms: float):
        """(org, smoothed) quaternions at a video timestamp — the chart
        lookup pair (controller.rs quats_at_timestamp)."""
        return (self.gyro.org_quat_at_timestamp(timestamp_ms),
                self.gyro.smoothed_quat_at_timestamp(timestamp_ms))

    def get_scaling_ratio(self) -> float:
        """lib.rs:1013 — input width over output width."""
        return self.params.size[0] / max(self.params.output_size[0], 1)

    def get_min_fov(self) -> float:
        """lib.rs:1014."""
        return self.params.min_fov

    def get_turn_speed(self, timestamp_ms: float) -> float:
        """Stabilization-roll turn rate in deg/s over a 60-frame lookback
        (controller.rs:1516-1546; feeds the automatic horizon-lock ramp UI)."""
        from . import quaternion as quat
        fps = self.params.fps or 30.0
        lookback_ms = 60.0 * 1000.0 / fps
        if timestamp_ms < lookback_ms:
            return float("nan")
        def stab_roll(ts):
            org = self.gyro.org_quat_at_timestamp(ts)
            smooth = self.gyro.smoothed_quat_at_timestamp(ts)
            # nalgebra `smooth / org` is smooth * org^-1; stab = its inverse
            stab = quat.inverse(quat.multiply(smooth, quat.inverse(org)))
            return quat.euler_angles(stab)[2]
        change = math.degrees(stab_roll(timestamp_ms)
                              - stab_roll(timestamp_ms - lookback_ms))
        while change > 180.0:
            change -= 360.0
        while change < -180.0:
            change += 360.0
        return change / (lookback_ms / 1000.0)

    def get_x_angle(self, timestamp_ms: float) -> float:
        """Stabilization roll angle in degrees (controller.rs:1547-1555)."""
        from . import quaternion as quat
        org = self.gyro.org_quat_at_timestamp(timestamp_ms)
        smooth = self.gyro.smoothed_quat_at_timestamp(timestamp_ms)
        stab = quat.inverse(quat.multiply(smooth, quat.inverse(org)))
        return math.degrees(float(quat.euler_angles(stab)[2]))

    def mesh_at_frame(self, frame: int):
        """Mesh-correction floats for one frame (controller.rs:1507-1515)."""
        mc = self.gyro.file_metadata.mesh_correction \
            if self.gyro.file_metadata else []
        if mc and 0 <= frame < len(mc):
            return list(mc[frame][1])
        return []

    def set_lens_param(self, param: str, value: float):
        """Adjust one lens-calibration scalar (lib.rs:1110-1129)."""
        fp = self.lens.fisheye_params
        if len(fp.camera_matrix) != 3 or len(fp.distortion_coeffs) < 4:
            return
        m = {"fx": (0, 0), "fy": (1, 1), "cx": (0, 2), "cy": (1, 2)}
        if param in m:
            i, j = m[param]
            fp.camera_matrix[i][j] = value
        elif param in ("k1", "k2", "k3", "k4"):
            fp.distortion_coeffs[int(param[1]) - 1] = value
        else:
            return
        self.invalidate()

    def frequency_graph(self, idx: int, timestamp_ms: float, sample_rate: float,
                        fft_size: int):
        """Uniformly-resampled raw-IMU axis window for the frequency graph
        (controller.rs:613-667): axis idx 0-2 = gyro xyz, 3-5 = accel xyz,
        `fft_size` samples at `sample_rate` Hz ending ~fft_size/2 samples
        after the (offset-corrected) timestamp. Returns (samples, sample_rate)
        — ([], 0.0) when not enough data, like the reference's empty set."""
        raw = self.gyro.get_raw_imu()
        if not raw:
            return [], 0.0
        dt_ms = 1000.0 / sample_rate
        center = timestamp_ms - self.gyro.offset_at_video_timestamp(timestamp_ms)
        last_ts = center + dt_ms * fft_size / 2.0
        sample_ts = max(min(last_ts, raw[-1].timestamp_ms) - fft_size * dt_ms, 0.0)
        prev_ts = 0.0
        prev_val = 0.0
        samples = []
        for x in raw:
            vec = x.gyro if idx < 3 else x.accl
            val = float(vec[idx % 3]) if vec is not None else 0.0
            while x.timestamp_ms > sample_ts and len(samples) < fft_size:
                denom = x.timestamp_ms - prev_ts
                frac = (sample_ts - prev_ts) / denom if denom else 0.0
                samples.append(prev_val + (val - prev_val) * min(max(frac, 0.0), 1.0))
                sample_ts += dt_ms
            if len(samples) >= fft_size:
                break
            prev_ts = x.timestamp_ms
            prev_val = val
        if len(samples) == fft_size:
            return samples, sample_rate
        return [], 0.0

    def has_gravity_vectors(self) -> bool:
        """controller.rs:2142."""
        fm = self.gyro.file_metadata
        return bool(fm and fm.gravity_vectors
                    and len(fm.gravity_vectors.get("vec", ())) > 0)

    def has_per_frame_focal_length(self) -> bool:
        """controller.rs:2145."""
        fm = self.gyro.file_metadata
        return bool(fm and fm.lens_params)

    def has_per_frame_lens_data(self) -> bool:
        """controller.rs:2380 — per-frame lens params or mesh correction."""
        fm = self.gyro.file_metadata
        return bool(fm and (fm.lens_params or fm.mesh_correction))

    def load_default_preset(self) -> bool:
        """Apply the user's default.gyroflow preset when one exists
        (controller.rs:870-881: settings dir first, then the profile DB)."""
        import os
        from .lens_profile_database import default_db_paths
        from .settings import data_dir
        candidates = [os.path.join(data_dir(), "lens_profiles",
                                   "default.gyroflow")]
        candidates += [os.path.join(p, "default.gyroflow")
                       for p in default_db_paths()]
        for path in candidates:
            if os.path.exists(path):
                from .project_file import import_gyroflow_data
                with open(path) as fh:
                    import_gyroflow_data(self, fh.read(), blocking=False)
                return True
        return False

    @staticmethod
    def merge_mp4(file_list, output_path: str) -> dict:
        """Join chaptered recordings (controller.rs:2179-2246 mp4_merge);
        inputs are natural-sorted like the reference's human_sort."""
        from ..utils.merge import natural_sorted
        from ..utils.mp4_merge import merge_mp4 as _merge
        return _merge(natural_sorted(file_list), output_path)

    @staticmethod
    def merge_gcsv(file_list, output_path: str):
        """Merge companion .gcsv chapter logs (controller.rs:2248-2353) in
        the same natural order as merge_mp4 — one human_sort feeds both in
        the reference, so the telemetry timeline matches the joined video."""
        from ..utils.merge import merge_gcsv as _merge, natural_sorted
        return _merge(natural_sorted(file_list), output_path)

    def export_lens_profile(self, path: str):
        """Write the active lens profile as reference-compatible JSON
        (controller.rs export_lens_profile)."""
        import json
        with open(path, "w") as fh:
            json.dump(self.lens.to_dict(), fh, indent=2)

    def set_integration_method(self, method: int):
        self.gyro.integration_method = method
        self.gyro.integrate()
        self.invalidate()

    def set_sync_offset(self, timestamp_us: int, offset_ms: float):
        self.gyro.set_offset(timestamp_us, offset_ms)
        self.keyframes.update_gyro(self.gyro)
        self.invalidate_zooming()   # lib.rs routing

    def set_trim_ranges(self, ranges):
        self.params.trim_ranges = list(ranges)
        self.invalidate()

    # keyframe invalidation routing (lib.rs:2016-2041 keyframes_updated)
    _ZOOM_KEYFRAMES = frozenset((
        KeyframeType.VideoRotation, KeyframeType.ZoomingSpeed,
        KeyframeType.AdditionalTranslationX, KeyframeType.AdditionalTranslationY,
        KeyframeType.AdditionalTranslationZ, KeyframeType.ZoomingCenterX,
        KeyframeType.ZoomingCenterY))
    _SMOOTHING_KEYFRAMES = frozenset((
        KeyframeType.LockHorizonAmount, KeyframeType.LockHorizonRoll,
        KeyframeType.LockHorizonPitchEnabled, KeyframeType.LockHorizonPitch,
        KeyframeType.AdditionalRotationX, KeyframeType.AdditionalRotationY,
        KeyframeType.AdditionalRotationZ,
        KeyframeType.SmoothingParamTimeConstant,
        KeyframeType.SmoothingParamTimeConstant2,
        KeyframeType.SmoothingParamSmoothness, KeyframeType.SmoothingParamPitch,
        KeyframeType.SmoothingParamRoll, KeyframeType.SmoothingParamYaw))

    def _keyframes_updated(self, typ: KeyframeType):
        """lib.rs:2016-2041: route a keyframe change to the cheapest stage
        that consumes it; unknown types fall back to the blanket
        invalidation (the reference's `_ => {}` relies on its checksums —
        keyframes aren't hashed here, so the safe superset is correct)."""
        if typ in self._ZOOM_KEYFRAMES:
            self.invalidate_zooming()
        elif typ in self._SMOOTHING_KEYFRAMES:
            self.invalidate_smoothing()
        else:
            self.invalidate()

    def set_keyframe(self, typ: KeyframeType, timestamp_us: int, value: float):
        self.keyframes.set(typ, timestamp_us, value)
        self._keyframes_updated(typ)

    def remove_keyframe(self, typ: KeyframeType, timestamp_us: int):
        self.keyframes.remove(typ, timestamp_us)
        self._keyframes_updated(typ)

    def is_keyframed(self, typ: KeyframeType) -> bool:
        return self.keyframes.is_keyframed(typ)

    def keyframe_value_at_video_timestamp(self, typ: KeyframeType, ts_ms: float):
        return self.keyframes.value_at_video_timestamp(typ, ts_ms)

    # ---- controller-parity thin setters (lib.rs:938-1214) ------------------
    # The reference façade exposes one setter per parameter with targeted
    # invalidation; the functional recompute here makes every setter a field
    # write + generic invalidation (recompute_blocking rebuilds the chain).

    def set_video_rotation(self, v: float):
        self.params.video_rotation = float(v)
        self.invalidate()

    def set_stab_enabled(self, v: bool):
        self.params.stab_enabled = bool(v)
        self.invalidate()

    def set_frame_readout_time(self, v: float):
        self.params.frame_readout_time = float(v)
        self.invalidate()

    def set_frame_readout_direction(self, v):
        from .params import ReadoutDirection
        self.params.frame_readout_direction = \
            v if isinstance(v, ReadoutDirection) else ReadoutDirection.from_any(v)
        self.invalidate()

    def set_adaptive_zoom(self, v: float):
        self.params.adaptive_zoom_window = float(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_zooming_center_x(self, v: float):
        c = self.params.adaptive_zoom_center_offset
        self.params.adaptive_zoom_center_offset = (float(v), c[1])
        self.invalidate_zooming()   # lib.rs routing

    def set_zooming_center_y(self, v: float):
        c = self.params.adaptive_zoom_center_offset
        self.params.adaptive_zoom_center_offset = (c[0], float(v))
        self.invalidate_zooming()   # lib.rs routing

    def set_zooming_method(self, v: int):
        self.params.adaptive_zoom_method = int(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_additional_rotation_x(self, v: float):
        r = self.params.additional_rotation
        self.params.additional_rotation = (float(v), r[1], r[2])
        self.invalidate()

    def set_additional_rotation_y(self, v: float):
        r = self.params.additional_rotation
        self.params.additional_rotation = (r[0], float(v), r[2])
        self.invalidate()

    def set_additional_rotation_z(self, v: float):
        r = self.params.additional_rotation
        self.params.additional_rotation = (r[0], r[1], float(v))
        self.invalidate()

    def set_additional_translation_x(self, v: float):
        t = self.params.additional_translation
        self.params.additional_translation = (float(v), t[1], t[2])
        self.invalidate_zooming()   # lib.rs routing

    def set_additional_translation_y(self, v: float):
        t = self.params.additional_translation
        self.params.additional_translation = (t[0], float(v), t[2])
        self.invalidate_zooming()   # lib.rs routing

    def set_additional_translation_z(self, v: float):
        t = self.params.additional_translation
        self.params.additional_translation = (t[0], t[1], float(v))
        self.invalidate_zooming()   # lib.rs routing

    def set_fov(self, v: float):
        self.params.fov = float(v)
        self.invalidate()

    def set_fov_overview(self, v: bool):
        self.params.fov_overview = bool(v)
        self.invalidate()

    def set_show_safe_area(self, v: bool):
        self.params.show_safe_area = bool(v)

    def set_lens_correction_amount(self, v: float):
        self.params.lens_correction_amount = float(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_frame_offset(self, v: int):
        self.params.frame_offset = int(v)
        self.invalidate()

    def set_light_refraction_coefficient(self, v: float):
        self.params.light_refraction_coefficient = float(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_background_mode(self, v: int):
        from .params import BackgroundMode
        self.params.background_mode = \
            v if isinstance(v, BackgroundMode) else BackgroundMode(int(v))
        self.invalidate()

    def set_background_margin(self, v: float):
        self.params.background_margin = float(v)
        self.invalidate()

    def set_background_margin_feather(self, v: float):
        self.params.background_margin_feather = float(v)
        self.invalidate()

    def set_input_horizontal_stretch(self, v: float):
        self.lens.input_horizontal_stretch = float(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_input_vertical_stretch(self, v: float):
        self.lens.input_vertical_stretch = float(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_max_zoom(self, v: float, iterations: int = 5):
        self.params.max_zoom = float(v)
        self.params.max_zoom_iterations = int(iterations)
        self.invalidate()

    def set_video_speed(self, v: float, link_with_smoothing: bool = True,
                        link_with_zooming: bool = True,
                        link_with_zooming_limit: bool = True):
        self.params.video_speed = float(v)
        self.params.video_speed_affects_smoothing = bool(link_with_smoothing)
        self.params.video_speed_affects_zooming = bool(link_with_zooming)
        self.params.video_speed_affects_zooming_limit = bool(link_with_zooming_limit)
        self.invalidate()

    def set_digital_lens_name(self, name):
        self.lens.digital_lens = name or None
        self.invalidate_zooming()   # lib.rs routing

    def set_digital_lens_param(self, index: int, value: float):
        p = list(self.lens.digital_lens_params or [])
        while len(p) <= index:
            p.append(0.0)
        p[index] = float(value)
        self.lens.digital_lens_params = p
        self.invalidate_zooming()   # lib.rs routing

    def set_lens_is_asymmetrical(self, v: bool):
        self.lens.asymmetrical = bool(v)
        self.invalidate_zooming()   # lib.rs routing

    def set_use_gravity_vectors(self, v: bool):
        self.gyro.use_gravity_vectors = bool(v)
        self.gyro.integrate()
        self.invalidate()

    def set_horizon_lock_integration_method(self, v: int):
        self.gyro.horizon_lock_integration_method = int(v)
        self.gyro.integrate()
        self.invalidate()

    def remove_offset(self, timestamp_us: int):
        self.gyro.remove_offset(timestamp_us)
        self.invalidate_zooming()   # lib.rs routing

    def clear_offsets(self):
        self.gyro.clear_offsets()
        self.invalidate_zooming()   # lib.rs routing

    def override_video_fps(self, fps: float, recompute: bool = True):
        """VFR override (lib.rs:1214-1231): scale all timing by fps_scale."""
        self.params.fps_scale = (fps / self.params.fps) \
            if (fps > 0 and self.params.fps > 0 and fps != self.params.fps) \
            else None
        # keyframes are stored at original video timestamps; lookups must
        # scale with the override (lib.rs:1219 keyframes.timestamp_scale)
        self.keyframes.timestamp_scale = self.params.fps_scale
        self.invalidate()
        if recompute:
            self.recompute_blocking()

    def recompute_gyro(self):
        """Re-apply IMU transforms + reintegrate (lib.rs:1101-1104)."""
        self.gyro.apply_transforms()
        self.gyro.integrate()
        self.invalidate()

    def load_video_file(self, path: str, load_telemetry: bool = True):
        """Probe a video, init sizes, auto-load embedded telemetry + lens
        (lib.rs:1909-1976 load_video_file)."""
        from ..render.video_io import probe_video
        info = probe_video(path)
        self.init_from_video_data(info.duration_ms, info.fps,
                                  info.frame_count, (info.width, info.height))
        self.input_file = path
        if load_telemetry and not self.gyro.has_motion():
            try:
                self.load_gyro_data(path)
            except Exception as e:  # noqa: BLE001 — plain videos lack telemetry
                log.debug("no embedded telemetry in %s: %s", path, e)
        return info

    def set_glitch_filter(self, enabled: bool, strength: float = 0.0):
        """Gyro glitch-repair pre-filter (lib.rs:1084-1087)."""
        self.gyro.imu_transforms.glitch_filter = bool(enabled)
        self.gyro.imu_transforms.glitch_strength = float(strength)
        self.gyro.apply_transforms()
        self.gyro.integrate()
        self.invalidate()

    def set_sync_lpf(self, lpf: float):
        """Low-pass cutoff applied to both streams during offset estimation
        (lib.rs:1105-1108); consumed by autosync's cost functions."""
        self.sync_lpf = float(lpf)

    def set_offset(self, timestamp_us: int, offset_ms: float):
        """Reference name for set_sync_offset (lib.rs:1064)."""
        self.set_sync_offset(timestamp_us, offset_ms)

    def keyframe_id(self, typ: KeyframeType, timestamp_us: int):
        kf = self._keyframe_at(typ, timestamp_us)
        return kf.id if kf is not None else None

    def recompute_adaptive_zoom_static(self):
        """Reference name (lib.rs:515): one static zoom pass."""
        self.recompute_adaptive_zoom()

    def export_gyroflow_data(self, typ=None,
                             additional_data: Optional[dict] = None) -> str:
        from .project_file import GyroflowProjectType, export_gyroflow_data
        return export_gyroflow_data(self, typ or GyroflowProjectType.WithGyroData,
                                    additional_data=additional_data)

    def import_gyroflow_data(self, data: str, blocking: bool = True):
        from .project_file import import_gyroflow_data
        return import_gyroflow_data(self, data, blocking=blocking)

    def set_device(self, i: int):
        """Pick the accelerator by index (lib.rs:1978): cuda:i. Raises when
        there is no such card."""
        self.device = _cuda_device(i)
        self._mats_dev.clear()

    def set_acc_rotation(self, pitch_deg: float, roll_deg: float,
                         yaw_deg: float):
        """Accelerometer-only rotation (lib.rs:1092-1094)."""
        self.gyro.imu_transforms.set_acc_rotation(pitch_deg, roll_deg, yaw_deg)
        self.gyro.apply_transforms()
        self.gyro.integrate()
        self.invalidate()

    def set_keyframe_easing(self, typ: KeyframeType, timestamp_us: int, easing):
        from .keyframes import Easing
        self.keyframes.set_easing(
            typ, timestamp_us,
            easing if isinstance(easing, Easing) else Easing(easing))
        self._keyframes_updated(typ)

    def set_keyframe_timestamp(self, typ: KeyframeType, keyframe_id: int,
                               new_timestamp_us: int):
        """Move a keyframe in time, addressed by its id like the reference
        (lib.rs:1995-2004); a timestamp is also accepted as a fallback."""
        kfs = self.keyframes.keyframes.get(typ) or {}
        old_ts = next((ts for ts, kf in kfs.items() if kf.id == keyframe_id),
                      None)
        if old_ts is None and keyframe_id in kfs:
            old_ts = keyframe_id              # timestamp-addressed fallback
        kf = kfs.pop(old_ts, None) if old_ts is not None else None
        if kf is not None:
            kfs[new_timestamp_us] = kf
            self._keyframes_updated(typ)

    def _keyframe_at(self, typ: KeyframeType, timestamp_us: int):
        """Closest-snapped keyframe lookup (keyframes.rs get_closest)."""
        kfs = self.keyframes.keyframes.get(typ) or {}
        kf = kfs.get(timestamp_us)
        if kf is None and kfs:
            ts = self.keyframes._closest_timestamp(typ, timestamp_us)
            kf = kfs.get(ts)
        return kf

    def keyframe_easing(self, typ: KeyframeType, timestamp_us: int):
        kf = self._keyframe_at(typ, timestamp_us)
        return kf.easing if kf is not None else None

    def clear_keyframes_type(self, typ: KeyframeType):
        self.keyframes.clear_type(typ)
        self._keyframes_updated(typ)

    def clear(self):
        """Reset to a fresh manager state (lib.rs clear + InputFile reset,
        lib.rs:1205-1212)."""
        from .gyro_source import GyroSource
        self.gyro = GyroSource()
        self.keyframes.clear()
        self.params.trim_ranges = []
        self.params.fovs = []
        self.params.minimal_fovs = []
        self.pose_estimator = None
        self.input_file = None
        self.render_output_settings = {}
        self.image_sequence_start = 0
        self.image_sequence_fps = 0.0
        self.invalidate()

    def set_render_params(self, size, output_size):
        """lib.rs:1190-1212."""
        self.params.size = tuple(size)
        self.set_output_size(*output_size)
        self.invalidate()

    def export_gyroflow_file(self, path: str, typ=None,
                             additional_data: Optional[dict] = None):
        """Write a .gyroflow project (lib.rs export_gyroflow_file)."""
        from .project_file import GyroflowProjectType, export_gyroflow_data
        typ = typ or GyroflowProjectType.WithGyroData
        with open(path, "w") as fh:
            fh.write(export_gyroflow_data(self, typ,
                                          additional_data=additional_data))

    def import_gyroflow_file(self, path: str, blocking: bool = True):
        """Load a .gyroflow project (lib.rs import_gyroflow_file)."""
        from .project_file import import_gyroflow_data
        with open(path) as fh:
            return import_gyroflow_data(self, fh.read(), blocking=blocking)

    # granular invalidation (lib.rs:1016-1028): each level zeroes its state
    # checksum (so the next recompute re-runs that stage) and marks the lazy
    # flag consumed by process_pixels (lib.rs:904-915)
    def invalidate_smoothing(self):
        """lib.rs:1016-1020: smoothing dirty → zooming dirty too (the FOV
        solve consumes the smoothed quats)."""
        self._smoothing_checksum = None
        self._smoothing_invalidated = True
        self.invalidate_zooming()

    def invalidate_zooming(self):
        """lib.rs:1021-1024 (+ undistortion here: the ComputeParams snapshot
        carries the fovs, so it must be rebuilt after a zoom change)."""
        self._zooming_checksum = None
        self._zooming_invalidated = True
        self.invalidate_undistortion()

    def invalidate_undistortion(self):
        self._undistortion_invalidated = True
        self._compute_params = None
        # bump the generation BEFORE clearing: an in-flight prefetch
        # (renderer decode-ahead thread) captured the old id and will skip
        # its cache insert, so a stale FrameTransform can never repopulate
        # the just-cleared cache
        self.current_compute_id += 1
        with self._stab_lock:
            self._stab_cache.clear()
        self._mats_dev.clear()

    def invalidate_blocking_smoothing(self):
        """lib.rs:1026: mark for the lazy blocking recompute that the next
        process_pixels performs (lib.rs:904-915)."""
        self.invalidate_smoothing()

    def invalidate_blocking_zooming(self):
        self.invalidate_zooming()

    def invalidate_blocking_undistortion(self):
        self.invalidate_undistortion()

    def invalidate_ongoing_computations(self):
        self.current_compute_id += 1

    def set_of_method(self, v):
        """Optical-flow method for sync + debug overlays (lib.rs:950;
        0 akaze, 1 pyrlk, 2 dis); clears retained pose results."""
        names = {"akaze": 0, "pyrlk": 1, "dis": 2}
        if isinstance(v, str):
            v = names.get(v.lower(), 2)   # unknown -> reference default (dis)
        self.params.of_method = int(v)
        self.pose_estimator = None

    def set_show_detected_features(self, v: bool):
        self.params.show_detected_features = bool(v)

    def set_show_optical_flow(self, v: bool):
        self.params.show_optical_flow = bool(v)

    def get_features_pixels(self, timestamp_us: int, size=None):
        """Detected feature points at the closest synced frame, scaled to
        `size` (lib.rs:793-810). Returns [(x, y)] or None."""
        est = getattr(self, "pose_estimator", None)
        if est is None or not est.results:
            return None
        keys = sorted(est.results)
        import bisect
        k = bisect.bisect_left(keys, timestamp_us)
        cands = [i for i in (k - 1, k) if 0 <= i < len(keys)]
        if not cands:
            return None
        i0 = min(cands, key=lambda i: abs(keys[i] - timestamp_us))
        if abs(keys[i0] - timestamp_us) > 2000:     # closest within 2 ms
            return None
        r = est.results[keys[i0]]
        if r.of_points is None:
            return None
        size = size or self.params.size
        ratio = size[1] / max(est.size[1], 1)
        return [(int(x * ratio), int(y * ratio)) for x, y in r.of_points[0]]

    def get_opticalflow_pixels(self, timestamp_us: int, num_frames: int = 1,
                               size=None):
        """Optical-flow trail pixels over the next `num_frames` synced frame
        pairs (lib.rs:812-832). Returns [(x, y, age)] or None."""
        est = getattr(self, "pose_estimator", None)
        if est is None or not est.results:
            return None
        keys = sorted(est.results)
        import bisect
        k = bisect.bisect_left(keys, timestamp_us)
        cands = [i for i in (k - 1, k) if 0 <= i < len(keys)]
        if not cands:
            return None
        i0 = min(cands, key=lambda i: abs(keys[i] - timestamp_us))
        if abs(keys[i0] - timestamp_us) > 2000:
            return None
        size = size or self.params.size
        ratio = size[1] / max(est.size[1], 1)
        out = []
        for i in range(num_frames):
            if i0 + i >= len(keys):
                break
            r = est.results[keys[i0 + i]]
            if r.of_points is None:
                continue
            for (x0, y0), (x1, y1) in zip(*r.of_points):
                # Bresenham-style walk of the flow line (lib.rs:823-826)
                n = max(int(max(abs(x1 - x0), abs(y1 - y0)) * ratio), 1)
                for t in range(n + 1):
                    f = t / n
                    out.append((int((x0 + (x1 - x0) * f) * ratio),
                                int((y0 + (y1 - y0) * f) * ratio), i))
        return out or None

    def draw_overlays(self, drawing, timestamp_us: int, clear: bool = True):
        """Fill a DrawCanvas with the debug overlays for this frame
        (lib.rs:835-876: yellow OF trails on input, green features).
        clear=False preserves caller-drawn pixels (user overlay canvases)."""
        from .drawing import COLOR_GREEN, COLOR_YELLOW, STAGE_ON_INPUT
        if clear:
            drawing.clear()
        p = self.params
        y_inv = p.framebuffer_inverted
        if p.show_optical_flow:
            num_frames = 1 if p.of_method == 2 else 3
            for (x, y, a) in self.get_opticalflow_pixels(
                    timestamp_us, num_frames, p.size) or []:
                drawing.put_pixel(x, y, COLOR_YELLOW, min(a, 3),
                                  STAGE_ON_INPUT, y_inv, 1)
        if p.show_detected_features:
            for (x, y) in self.get_features_pixels(timestamp_us, p.size) or []:
                drawing.put_pixel(x, y, COLOR_GREEN, 0, STAGE_ON_INPUT,
                                  y_inv, 3)
        if p.zooming_debug_points_map:
            # adaptive-zoom polygon debug (lib.rs:869-887): normalized output
            # points mapped through the frame's fov into output pixels
            from .drawing import COLOR_RED, STAGE_ON_OUTPUT
            keys = [k for k in sorted(p.zooming_debug_points_map)
                    if k >= timestamp_us - 1000]
            if keys:
                frame = int(timestamp_us / 1e6 * p.get_scaled_fps() + 0.5)
                fov = max((p.fov + (1.0 if p.fov_overview else 0.0)) *
                          (p.fovs[frame] if frame < len(p.fovs) else 1.0),
                          0.0001)
                fov *= p.size[0] / max(p.output_size[0], 1)
                wr = p.size[0] / max(p.output_size[0], 1)
                hr = p.size[1] / max(p.output_size[1], 1)
                for (px, py) in p.zooming_debug_points_map[keys[0]]:
                    x = (px - 0.5) / fov * wr + 0.5
                    y = (py - 0.5) / fov * hr + 0.5
                    if x >= 0.0 and y >= 0.0:
                        drawing.put_pixel(int(x * p.output_size[0]),
                                          int(y * p.output_size[1]),
                                          COLOR_RED, 0, STAGE_ON_OUTPUT,
                                          y_inv, 4)
        cal = getattr(self, "lens_calibrator", None)
        if p.is_calibrator and cal is not None:
            # chessboard corner overlay for the calibrator frame
            # (lib.rs:860-867)
            from math import floor
            frame = int(floor(timestamp_us / 1e6 * p.get_scaled_fps() + 0.5))
            det = cal.all_matches.get(frame)
            if det is not None and det.points is not None:
                from ..calibration.drawing import draw_chessboard_corners
                draw_chessboard_corners(
                    cal.width, cal.height, drawing,
                    (cal.columns, cal.rows), det.points, True, y_inv)

    def get_smoothing_algs(self):
        """Registry names [None, Default, Plain, Fixed] (lib.rs:1164-1166)."""
        return self.smoothing.get_names()

    def get_smoothing_status(self):
        """Current smoothing algorithm + parameter values (lib.rs:1161)."""
        cur = self.smoothing.current
        return {"name": cur.get_name(), "params": dict(cur.params())}

    def disable_lens_stretch(self, adjust_size: bool = False):
        """Fold the lens input stretch into the frame size (lib.rs:994-1014)."""
        xs = self.lens.input_horizontal_stretch
        ys = self.lens.input_vertical_stretch
        if (xs > 0.01 and xs != 1.0) or (ys > 0.01 and ys != 1.0):
            if adjust_size:
                w, h = self.params.size
                self.params.size = (int(round(w * max(xs, 0.01))),
                                    int(round(h * max(ys, 0.01))))
            self.lens.input_horizontal_stretch = 1.0
            self.lens.input_vertical_stretch = 1.0
            self.invalidate()

    def extract_focal_lengths(self):
        """Per-frame focal lengths from telemetry lens params (lib.rs:416)."""
        from .focal_length_smoothing import extract_focal_lengths
        params = ComputeParams.from_manager(self)
        return extract_focal_lengths(params)

    def get_optimal_sync_points(self, target_sync_points: int,
                                initial_offset_ms: float = 0.0):
        """FFT-based sync-point picker over the trim ranges (lib.rs:2043)."""
        from ..sync.optimsync import pick_sync_points_fft
        dur_ms = self.params.get_scaled_duration_ms()
        ranges = self.params.trim_ranges or None
        raw = self.gyro.file_metadata.raw_imu if self.gyro.file_metadata else []
        return pick_sync_points_fft(raw, dur_ms, target_sync_points, ranges)

    @staticmethod
    def project_has_motion_data(data) -> bool:
        """Whether a .gyroflow blob embeds usable gyro (lib.rs:1873-1906)."""
        import json as _json
        from ..utils.compression import decompress_from_base91_cbor
        try:
            obj = _json.loads(data)
        except (ValueError, TypeError):
            return False
        gs = obj.get("gyro_source")
        if not isinstance(gs, dict):
            return False
        blob = gs.get("file_metadata")
        if blob:
            try:
                fm = decompress_from_base91_cbor(blob)
                if isinstance(fm, dict) and (fm.get("raw_imu")
                                             or fm.get("quaternions")):
                    return True
            except Exception:  # noqa: BLE001 — malformed blob = no motion
                pass
        # compatibility with older formats (lib.rs:1881-1903)
        return bool(gs.get("raw_imu") or gs.get("quaternions")
                    or gs.get("integrated_quaternions"))

    def set_gpu_decoding(self, v: bool):
        """Hardware-offloaded decode preference (lib.rs:1131; consumed by
        the ffmpeg reader's -hwaccel auto)."""
        self.gpu_decoding = bool(v)

    @staticmethod
    def list_gpu_devices():
        """Accelerator inventory (controller list_gpu_devices): the CUDA
        cards' names, or ["cpu"] when there is none."""
        if not torch.cuda.is_available():
            return ["cpu"]
        return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]

    def invalidate(self):
        """Blanket invalidation = the safe superset (smoothing + zooming +
        undistortion). Setters with a 1:1 reference routing call
        invalidate_zooming()/invalidate_undistortion() directly; the
        checksum gates make a spurious blanket call cheap anyway."""
        self.invalidate_smoothing()

    # ---- recompute (lib.rs:515-640) ----------------------------------------

    def _smoothing_state_checksum(self, gyro_checksum: Optional[int] = None) -> int:
        """smoothing/mod.rs:107-115 via lib.rs:663."""
        if gyro_checksum is None:
            gyro_checksum = self.gyro.get_checksum()
        return self.smoothing.get_state_checksum(gyro_checksum)

    def _zooming_state_checksum(self) -> int:
        """zooming/mod.rs get_checksum over the compute-params fields the FOV
        solve reads (lens coeffs, sizes, fps, max zoom, trims, rotation,
        window, FL smoothing). Zoom params NOT in this hash (method, center
        offsets, …) zero the stored checksum via invalidate_zooming instead —
        same split as the reference."""
        p = self.params
        coeffs = np.asarray(self.lens.get_distortion_coeffs(),
                            np.float64).ravel().tolist()
        return hash((
            tuple(coeffs), tuple(p.size), tuple(p.output_size),
            p.get_scaled_fps(), p.max_zoom or 0.0, p.max_zoom_iterations,
            tuple(tuple(r) for r in p.trim_ranges), p.video_rotation,
            p.adaptive_zoom_window, p.focal_length_smoothing_enabled,
            p.focal_length_smoothing_strength,
        ))

    def _recompute_gated(self, cancelled=None) -> bool:
        """Checksum-gated recompute chain (lib.rs:660-712): re-run smoothing
        only when its state checksum moved, the FOV solve only when smoothing
        changed or the zoom checksum moved. Returns False if cancelled."""
        def _c():
            return cancelled is not None and cancelled()

        smoothing_changed = False
        sc = self._smoothing_state_checksum()
        if sc != self._smoothing_checksum:
            self.recompute_smoothness()
            if _c():
                return False
            smoothing_changed = True
            self._smoothing_checksum = self._smoothing_state_checksum()
        if _c():
            return False
        zc = self._zooming_state_checksum()
        if smoothing_changed or zc != self._zooming_checksum:
            self.recompute_adaptive_zoom()
            if _c():
                return False
            self._zooming_checksum = zc
        self.recompute_undistortion()
        self._smoothing_invalidated = False
        self._zooming_invalidated = False
        self._undistortion_invalidated = False
        return True

    def _lazy_recompute_if_invalidated(self):
        """lib.rs:904-915: a render call after setter-based invalidation does
        a blocking recompute instead of serving stale smoothed quats/fovs.
        Steady-state cost is one bool check; after a spurious blanket
        invalidation it costs two checksum evaluations + a ComputeParams
        rebuild (the expensive scans are checksum-gated)."""
        if (self._smoothing_invalidated or self._zooming_invalidated
                or self._undistortion_invalidated):
            self._recompute_gated()

    def recompute_smoothness(self):
        params = ComputeParams.from_manager(self)
        params.calculate_camera_fovs()
        quats, max_angles = self.gyro.recompute_smoothness(
            self.smoothing.current, self.smoothing.horizon_lock, params)
        self.gyro.smoothed_quaternions = quats
        self.gyro.max_angles = max_angles

    def _apply_focal_length_smoothing(self, params: ComputeParams):
        if not params.focal_length_smoothing_enabled:
            return
        from .focal_length_smoothing import apply_focal_length_smoothing
        apply_focal_length_smoothing(params, self.params)

    def recompute_adaptive_zoom(self):
        """lib.rs:524-605 incl. the max-zoom iteration loop."""
        params = ComputeParams.from_manager(self)
        params.calculate_camera_fovs()
        self._apply_focal_length_smoothing(params)

        lens_fov_adjustment = self.lens.optimal_fov or 1.0
        fovs, minimal_fovs, dbg = self._zoom_static(params)
        if self.params.zooming_debug_points:
            self.params.zooming_debug_points_map = dict(dbg)   # lib.rs:539
        params.fovs = fovs
        params.minimal_fovs = minimal_fovs
        self.params.set_fovs(list(fovs), lens_fov_adjustment)
        self.params.minimal_fovs = list(minimal_fovs)

        max_zoom_param = self.params.max_zoom or 0.0
        kfs = self.keyframes.keyframes.get(KeyframeType.MaxZoom)
        max_zoom_max = max((kf.value for kf in kfs.values()), default=max_zoom_param) \
            if kfs else max_zoom_param
        max_zoom_iters = self.params.max_zoom_iterations
        scaling_factor = self.params.size[0] / max(self.params.output_size[0], 1)

        if max_zoom_max > 50.0 and max_zoom_iters > 0:
            params.smoothing_fov_limit_per_frame = [1.0] * len(params.fovs)
            thresholds = [0.95, 0.9, 0.85, 0.8]
            for it in range(max_zoom_iters):
                any_above = False
                for i, fov in enumerate(params.fovs):
                    ts = timestamp_at_frame(i, params.scaled_fps)
                    zl = params.keyframes.value_at_video_timestamp(KeyframeType.MaxZoom, ts)
                    zoom_limit = (max_zoom_param if zl is None else zl) / 100.0
                    if params.video_speed_affects_zooming_limit and \
                            (params.video_speed != 1.0 or
                             params.keyframes.is_keyframed(KeyframeType.VideoSpeed)):
                        vs = params.keyframes.value_at_video_timestamp(KeyframeType.VideoSpeed, ts)
                        vs = abs(params.video_speed if vs is None else vs)
                        zoom_limit *= min(1.0 + (vs - 1.0) / 4.0, 1.8)
                    fov_limit = 1.0 / (zoom_limit * scaling_factor)
                    if fov < fov_limit:
                        any_above = True
                        th = thresholds[it] if it < len(thresholds) else thresholds[-1]
                        params.smoothing_fov_limit_per_frame[i] *= min(fov / fov_limit, th)
                if not any_above:
                    if it == 0:
                        params.smoothing_fov_limit_per_frame = []
                    break
                quats, max_angles = self.gyro.recompute_smoothness(
                    self.smoothing.current, self.smoothing.horizon_lock, params)
                self.gyro.smoothed_quaternions = quats
                self.gyro.max_angles = max_angles
                self._apply_focal_length_smoothing(params)
                fovs, minimal_fovs, dbg = self._zoom_static(params)
                if self.params.zooming_debug_points:
                    self.params.zooming_debug_points_map = dict(dbg)
                params.fovs = fovs
                params.minimal_fovs = minimal_fovs
                self.params.set_fovs(list(fovs), lens_fov_adjustment)
                self.params.minimal_fovs = list(minimal_fovs)

    def _zoom_static(self, params: ComputeParams):
        frames = self.params.frame_count
        fps = self.params.get_scaled_fps()
        timestamps = [(i, i * 1000.0 / fps) for i in range(frames)]
        return calculate_fovs(params, timestamps, ZoomMethod(self.params.adaptive_zoom_method))

    def recompute_undistortion(self):
        self._compute_params = ComputeParams.from_manager(self)
        with self._stab_lock:
            self._stab_cache.clear()
        self._mats_dev.clear()

    def recompute_blocking(self):
        """lib.rs:625-629, checksum-gated like recompute_threaded: a
        zoom-only change skips the 6-pass smoothing scan; a pixel-only
        change skips the FOV solve too."""
        self._recompute_gated()

    def recompute_threaded(self, cb=None) -> int:
        """lib.rs:636-791: background recompute with compute-id cancellation.

        Returns the compute id immediately; the work runs on a daemon thread,
        re-checking `current_compute_id` between stages and aborting silently
        when a newer invalidation/recompute supersedes it. `cb(compute_id)`
        fires only for the computation that survives to the end. Thread-safe
        enough for the reference's pattern (one writer at a time; stale
        threads drop their results instead of publishing them).
        """
        import random
        import threading

        self.current_compute_id = compute_id = random.getrandbits(62)

        def _cancelled() -> bool:
            return self.current_compute_id != compute_id

        def work():
            try:
                if _cancelled():
                    return
                if not self._recompute_gated(cancelled=_cancelled):
                    return
                if _cancelled():
                    return
                if cb is not None:
                    cb(compute_id)
            except Exception as e:   # surfaced like the reference's error log
                log.error("recompute_threaded failed: %s", e)

        t = threading.Thread(target=work, daemon=True,
                             name=f"recompute-{compute_id:x}")
        self._recompute_thread = t
        t.start()
        return compute_id

    # ---- processing (lib.rs:889-936 + stabilization/mod.rs) ----------------

    def get_compute_params(self) -> ComputeParams:
        if self._compute_params is None:
            self.recompute_undistortion()
        return self._compute_params

    def frame_transform_at(self, timestamp_ms: float, frame: Optional[int] = None,
                           rid: Optional[int] = None):
        """rid: the request id of the lookup's gf.ft span, the frame's video
        timestamp in us (None: the adjusted timestamp in us, its cache key)."""
        from ..ops.frame_transform import frame_transform_at
        from .params import frame_at_timestamp
        key = int(round(timestamp_ms * 1000.0))
        with trace.span("gf.ft", key if rid is None else rid) as sp:
            gen = self.current_compute_id   # BEFORE the params snapshot
            cp = self.get_compute_params()
            if frame is None:
                frame = frame_at_timestamp(timestamp_ms, cp.scaled_fps)
            with self._stab_lock:
                hit = self._stab_cache.get(key)
            if hit is not None:
                sp.note("hit")
                return hit
            sp.note("miss")
            ft = frame_transform_at(cp, timestamp_ms, frame)
            with self._stab_lock:
                # skip the insert if params were invalidated while computing —
                # a decode-ahead prefetch running with the old ComputeParams
                # must not repopulate the just-cleared cache with stale geometry
                if gen == self.current_compute_id:
                    # bounded: a long render walks monotonically increasing ts,
                    # so insertion order IS recency; unbounded growth would leak
                    # ~120 KB of matrices per 4K frame (4+ GB over a 10-min clip)
                    while len(self._stab_cache) >= 256:
                        self._stab_cache.pop(next(iter(self._stab_cache)), None)
                    self._stab_cache[key] = ft
            return ft

    def _mats_on_device(self, timestamp_ms: float, ft):
        """Device copies of ft.matrices / ft.mesh_data, cached per timestamp:
        the Y and UV planes of one frame share the same (rows, 14) matrix
        stack (geometry lives in luma coordinates — HAS_SOURCE_RECT maps the
        chroma buffer), so uploading it once per frame instead of once per
        plane halves the per-frame host->device matrix traffic. The mesh
        buffer goes up packed (cuda_coords.kernel_mesh: the coords kernel's
        block appended to the reference buffer)."""
        from ..ops.cuda_coords import kernel_mesh
        key = int(round(timestamp_ms * 1000.0))
        hit = self._mats_dev.get(key)
        if hit is None:
            while len(self._mats_dev) >= 64:
                self._mats_dev.pop(next(iter(self._mats_dev)))
            mesh = kernel_mesh(ft.mesh_data, ft.kernel_cfg)
            if mesh is not None:
                mesh = trace.to_device(torch.from_numpy(mesh), self.device)
            mats = torch.from_numpy(np.ascontiguousarray(ft.matrices, np.float32))
            hit = (trace.to_device(mats, self.device), mesh)
            self._mats_dev[key] = hit
        return hit

    def _plane_cfg_dyn(self, ft, frame_shape, interpolation, plane_index,
                       max_pixel_value, plane_rects, background_override,
                       drawing):
        """Per-plane KernelConfig + KernelDynamics from a FrameTransform
        (shared by the single-frame and windowed process_pixels paths)."""
        pw, ph = frame_shape[1], frame_shape[0]
        vw, vh = self.params.size
        if plane_rects and (pw, ph) != (vw, vh):
            # subsampled plane: keep luma geometry, map via rects
            from ..ops.kernel_params import HAS_OUTPUT_RECT, HAS_SOURCE_RECT
            ow, oh = self.params.output_size
            pow_ = max(int(round(ow * pw / max(vw, 1))), 1)
            poh = max(int(round(oh * ph / max(vh, 1))), 1)
            cfg = ft.kernel_cfg._replace(
                interpolation=interpolation, plane_index=plane_index,
                source_rect=(0, 0, pw, ph), output_rect=(0, 0, pow_, poh),
                out_size=(pow_, poh),
                flags=ft.kernel_cfg.flags | HAS_SOURCE_RECT | HAS_OUTPUT_RECT)
        else:
            cfg = ft.kernel_cfg._replace(
                interpolation=interpolation, plane_index=plane_index,
                width=pw, height=ph)
        if drawing is not None:
            from ..ops.kernel_params import DRAWING_ENABLED
            cfg = cfg._replace(flags=cfg.flags | DRAWING_ENABLED)
        dyn = ft.kernel_dyn._replace(
            max_pixel_value=np.float32(max_pixel_value),
            pixel_value_limit=np.float32(max_pixel_value))
        if interpolation > 8:
            # EWA cubic-family coefficients (stabilization/mod.rs:24-48):
            # FrameTransform builds dynamics interpolation-agnostically, so
            # attach them here — zero coeffs would zero every tap weight and
            # silently render pure background (caught by end-to-end verify,
            # round 5)
            from ..ops.remap import ewa_coeffs
            ewp, ewq = ewa_coeffs(interpolation)
            dyn = dyn._replace(ewa_coeffs_p=np.asarray(ewp, np.float32),
                               ewa_coeffs_q=np.asarray(ewq, np.float32))
        if background_override is not None:
            bgv = np.zeros(4, np.float32)
            bgo = np.asarray(background_override, np.float32).reshape(-1)
            bgv[:bgo.shape[0]] = bgo
            dyn = dyn._replace(background=bgv)
        return cfg, dyn

    def _adjusted_ts_ms(self, timestamp_us: int) -> float:
        """fps_scale / frame_offset timestamp adjustments (lib.rs:893-902)."""
        ts_ms = timestamp_us / 1000.0
        if self.params.fps_scale:
            ts_ms /= self.params.fps_scale
        if self.params.frame_offset:
            ts_ms += self.params.frame_offset * 1000.0 / max(
                self.params.get_scaled_fps(), 1e-9)
        return ts_ms

    def process_pixels_window(self, timestamps_us, frames, device_mesh=None,
                              interpolation: int = 8, plane_index: int = 0,
                              max_pixel_value: float = 255.0,
                              plane_rects: bool = False,
                              background_override=None):
        """Stabilize a window of F frames of one plane (gyroflow_tpu
        manager.py:1351; render_queue.rs:677).

        frames: (F, H, W, C) numpy array or tensor, uint8/uint16/float32;
        timestamps_us: F video timestamps. device_mesh: a
        parallel.pipeline.make_frame_mesh whose first device is
        ``self.device`` (None: the 1 x 1 mesh on ``self.device``); frames go
        data-parallel over its "dp" rows, each dp row's frames uploaded in
        one copy to each of its devices, and output rows over its "sp"
        columns. Returns (out (F, OH, OW, C) tensor on ``self.device`` in the
        output dtype of process_pixels, info dict). Each frame comes out as
        process_pixels would give it: on CUDA devices each of its bands
        through the coords kernel and the sampler or EWA kernel, on the CPU
        through the plain torch remap. A window whose kernel configs differ
        goes through process_pixels frame by frame. Each frame's Sony mesh /
        focal-plane buffer (a Sony clip's frames share one kernel config)
        goes up packed (cuda_coords.kernel_mesh) with the window's matrices,
        and frame i's remap reads frame i's buffer."""
        from ..ops.cuda_coords import kernel_mesh
        from ..parallel.pipeline import (make_frame_mesh, stabilize_window_production,
                                         stack_dynamics, stack_meshes)

        with trace.span("gf.process_pixels_window", timestamps_us[0]):
            mesh = device_mesh if device_mesh is not None else make_frame_mesh(device=self.device)
            if mesh.device != self.device:
                raise ValueError(f"frame mesh on {mesh.device}, manager on {self.device}")
            imgs = torch.as_tensor(frames)
            if not self.params.stab_enabled:
                with trace.span("gf.upload"):
                    return trace.to_device(imgs, self.device), {"fov": 1.0, "backend": "none"}

            self._lazy_recompute_if_invalidated()
            fts = [self.frame_transform_at(self._adjusted_ts_ms(ts), rid=ts)
                   for ts in timestamps_us]
            plane_shape = tuple(imgs.shape[1:])
            cfgs, dyns = zip(*(self._plane_cfg_dyn(ft, plane_shape, interpolation, plane_index,
                                                   max_pixel_value, plane_rects,
                                                   background_override, None) for ft in fts))
            if any(c != cfgs[0] for c in cfgs):
                # one step needs one config for the whole window: process the
                # frames one by one instead of aborting the render
                log.info("frame window not batchable (kernel configs differ); per-frame fallback")
                outs, info = [], {}
                for ts, img in zip(timestamps_us, imgs):
                    o, info = self.process_pixels(
                        ts, img, interpolation=interpolation, plane_index=plane_index,
                        max_pixel_value=max_pixel_value, plane_rects=plane_rects,
                        background_override=background_override)
                    outs.append(o)
                info = dict(info)
                info["backend"] = str(info.get("backend", "")) + "+per-frame"
                return torch.stack(outs), info

            out_dtype, in_dtype = _plane_dtypes(imgs.dtype, max_pixel_value)
            mats = np.stack([ft.matrices for ft in fts]).astype(np.float32)
            out, backend = stabilize_window_production(
                mesh, imgs, mats, cfgs[0], stack_dynamics(dyns), out_dtype=out_dtype,
                meshes=stack_meshes([kernel_mesh(ft.mesh_data, ft.kernel_cfg) for ft in fts]),
                in_dtype=in_dtype)
            info = {"fov": fts[0].fov, "minimal_fov": fts[0].minimal_fov,
                    "backend": backend}
            return out, info

    def process_pixels(self, timestamp_us: int, frame_plane,
                       interpolation: int = 8, plane_index: int = 0,
                       max_pixel_value: float = 255.0, drawing=None,
                       plane_rects: bool = False, background_override=None,
                       defer_overflow: bool = False):
        """Stabilize one plane (H, W, C) at the given video timestamp.

        frame_plane: numpy array or torch tensor, uint8/uint16/float32; it is
        uploaded to ``self.device`` in its native dtype. Returns (output
        tensor on ``self.device``, info dict) like ProcessedInfo
        (stabilization/mod.rs:195-201). uint16 planes come back uint16
        (rint, clamp to max_pixel_value), uint8 planes with
        max_pixel_value 255 as uint8, everything else float32.

        On a CUDA device the plane runs through the coords kernel and the
        sampler kernel, or for EWA (interpolation 10-13) the EWA kernel
        (remap.remap_plane_cuda); on the CPU through the plain torch remap.
        interpolation: 2 bilinear, 4 bicubic, 8 lanczos4, 10-13 EWA
        (RobidouxSharp, Robidoux, Mitchell, CatmullRom). plane_rects=True
        enables subsampled-plane processing (chroma planes of planar YUV):
        geometry stays in luma coordinates while
        source/output rects map the plane buffer (stabilization/mod.rs:
        230-231). background_override replaces the RGBA background with this
        plane's converted color (rendering/mod.rs:506-516). There is no
        window ladder, so defer_overflow is accepted and info["overflow"] is
        always False."""
        from ..ops import remap

        with trace.span("gf.process_pixels", timestamp_us):
            ts_ms = self._adjusted_ts_ms(timestamp_us)
            with trace.span("gf.upload"):
                img = trace.to_device(torch.as_tensor(frame_plane), self.device).contiguous()

            if not self.params.stab_enabled:
                return img, {"fov": 1.0, "backend": "none"}

            self._lazy_recompute_if_invalidated()
            ft = self.frame_transform_at(ts_ms, rid=timestamp_us)
            cfg, dyn = self._plane_cfg_dyn(
                ft, tuple(img.shape), interpolation, plane_index, max_pixel_value,
                plane_rects, background_override, drawing)

            out_dtype, in_dtype = _plane_dtypes(img.dtype, max_pixel_value)
            img = img.to(in_dtype)
            mats, mesh = self._mats_on_device(ts_ms, ft)
            if self.device.type == "cuda":
                out = remap.remap_plane_cuda(img, mats, cfg, dyn, mesh, drawing=drawing,
                                             out_dtype=out_dtype)
                backend = "cuda"
            else:
                out = remap.remap_plane(img, mats, cfg, dyn, mesh, drawing=drawing,
                                        out_dtype=out_dtype)
                backend = "torch-cpu"
            info = {"fov": ft.fov, "minimal_fov": ft.minimal_fov,
                    "focal_length": ft.focal_length, "backend": backend}
            if defer_overflow:
                info["overflow"] = False
            return out, info

    # ---- misc --------------------------------------------------------------

    def get_cloned(self) -> "StabilizationManager":
        """lib.rs:1168 (render-queue per-job clone)."""
        import copy
        m = StabilizationManager(device=self.device)
        m.gyro = self.gyro.clone()
        m.lens = copy.deepcopy(self.lens)
        m.smoothing = self.smoothing.clone()
        m.params = copy.deepcopy(self.params)
        m.keyframes = self.keyframes.clone()
        m.input_file = self.input_file
        m.image_sequence_start = self.image_sequence_start
        m.image_sequence_fps = self.image_sequence_fps
        m.render_output_settings = dict(self.render_output_settings)
        return m

    def offset_at_video_timestamp(self, timestamp_ms: float) -> float:
        return float(self.gyro.offset_at_video_timestamp(timestamp_ms))
