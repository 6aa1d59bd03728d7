"""Stabilization parameters + frozen compute snapshot.

Ports gyroflow src/core/stabilization_params.rs (StabilizationParams,
BackgroundMode, ReadoutDirection, video-speed ramped timestamps) and
stabilization/compute_params.rs (ComputeParams::from_manager,
calculate_camera_fovs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import numpy as np

from .keyframes import KeyframeManager, KeyframeType
from .time_quat import interp_series


def timestamp_at_frame(frame: int, fps: float) -> float:
    """lib.rs:2068."""
    return frame * 1000.0 / fps


def frame_at_timestamp(timestamp_ms: float, fps: float) -> int:
    """lib.rs:2069."""
    return int(round(timestamp_ms * (fps / 1000.0)))


class BackgroundMode(IntEnum):
    SolidColor = 0
    RepeatPixels = 1
    MirrorPixels = 2
    MarginWithFeather = 3

    @classmethod
    def from_any(cls, v):
        if isinstance(v, str):
            return {"RepeatPixels": cls.RepeatPixels, "MirrorPixels": cls.MirrorPixels,
                    "MarginWithFeather": cls.MarginWithFeather}.get(v, cls.SolidColor)
        try:
            return cls(int(v))
        except ValueError:
            return cls.SolidColor


class ReadoutDirection(IntEnum):
    TopToBottom = 0
    BottomToTop = 1
    LeftToRight = 2
    RightToLeft = 3

    @classmethod
    def from_any(cls, v):
        if isinstance(v, str):
            return {"BottomToTop": cls.BottomToTop, "LeftToRight": cls.LeftToRight,
                    "RightToLeft": cls.RightToLeft}.get(v, cls.TopToBottom)
        try:
            return cls(int(v))
        except ValueError:
            return cls.TopToBottom

    @property
    def is_horizontal(self) -> bool:
        return self in (ReadoutDirection.LeftToRight, ReadoutDirection.RightToLeft)

    @property
    def is_inverted(self) -> bool:
        return self in (ReadoutDirection.BottomToTop, ReadoutDirection.RightToLeft)


@dataclass
class StabilizationParams:
    """User-facing stabilization parameters (stabilization_params.rs:63-196)."""
    size: Tuple[int, int] = (0, 0)
    output_size: Tuple[int, int] = (0, 0)
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    frame_readout_time: float = 0.0
    frame_readout_direction: ReadoutDirection = ReadoutDirection.TopToBottom
    adaptive_zoom_window: float = 4.0
    adaptive_zoom_center_offset: Tuple[float, float] = (0.0, 0.0)
    adaptive_zoom_method: int = 1
    additional_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    additional_translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fov: float = 1.0
    fov_overview: bool = False
    max_zoom: Optional[float] = 130.0
    max_zoom_iterations: int = 5
    show_safe_area: bool = False
    fovs: List[float] = field(default_factory=list)
    minimal_fovs: List[float] = field(default_factory=list)
    min_fov: float = 1.0
    fps: float = 0.0
    fps_scale: Optional[float] = None
    video_speed: float = 1.0
    video_speed_affects_smoothing: bool = True
    video_speed_affects_zooming: bool = True
    video_speed_affects_zooming_limit: bool = True
    speed_ramped_timestamps: Optional[Dict[int, int]] = None
    frame_count: int = 0
    duration_ms: float = 0.0
    trim_ranges: List[Tuple[float, float]] = field(default_factory=list)
    video_rotation: float = 0.0
    lens_correction_amount: float = 1.0
    light_refraction_coefficient: float = 1.0
    background_mode: BackgroundMode = BackgroundMode.SolidColor
    background_margin: float = 0.0
    background_margin_feather: float = 0.0
    framebuffer_inverted: bool = False
    is_calibrator: bool = False
    stab_enabled: bool = True
    # sync debug visualization (stabilization_params.rs:115-117; 0 akaze,
    # 1 pyrlk, 2 dis — optical_flow/mod.rs:28-34, default 2)
    of_method: int = 2
    show_detected_features: bool = False
    show_optical_flow: bool = False
    # adaptive-zoom debug polygon (stabilization_params.rs:120; flag +
    # per-timestamp normalized points filled by the zoom solver)
    zooming_debug_points: bool = False
    zooming_debug_points_map: Dict[int, list] = field(default_factory=dict)
    frame_offset: int = 0
    focal_lengths: List[Optional[float]] = field(default_factory=list)
    smoothed_focal_lengths: List[Optional[float]] = field(default_factory=list)
    focal_length_smoothing_enabled: bool = False
    focal_length_smoothing_strength: float = 0.5

    def get_trim_ratio(self) -> float:
        if not self.trim_ranges:
            return 1.0
        return sum(b - a for a, b in self.trim_ranges)

    def get_scaled_duration_ms(self) -> float:
        return self.duration_ms / self.fps_scale if self.fps_scale else self.duration_ms

    def get_scaled_fps(self) -> float:
        return self.fps * self.fps_scale if self.fps_scale else self.fps

    def set_fovs(self, fovs: List[float], lens_fov_adjustment: float):
        """stabilization_params.rs:218-229."""
        if fovs:
            min_fov = min(fovs) * (self.size[0] / max(self.output_size[0], 1))
            if lens_fov_adjustment <= 0.0001:
                lens_fov_adjustment = 1.0
            self.min_fov = min_fov / lens_fov_adjustment
        else:
            self.min_fov = 1.0
        self.fovs = list(fovs)

    def calculate_ramped_timestamps(self, keyframes: KeyframeManager,
                                    speed_inverse: bool, map_inverse: bool):
        """stabilization_params.rs:231-263 (video-speed time remapping)."""
        if keyframes.is_keyframed(KeyframeType.VideoSpeed) or self.video_speed != 1.0:
            fps = self.fps
            ramped_ts = 0.0
            prev_real_ts = 0.0
            m: Dict[int, int] = {}
            for i in range(self.frame_count):
                ts = timestamp_at_frame(i, fps)
                vid_speed = keyframes.value_at_video_timestamp(KeyframeType.VideoSpeed, ts)
                if vid_speed is None:
                    vid_speed = self.video_speed
                if speed_inverse:
                    vid_speed = 1.0 / vid_speed
                ramped_ts += (ts - prev_real_ts) / vid_speed
                prev_real_ts = ts
                if map_inverse:
                    m[int(round(ts * 1000.0))] = int(round(ramped_ts * 1000.0))
                else:
                    m[int(round(ramped_ts * 1000.0))] = int(round(ts * 1000.0))
            self.speed_ramped_timestamps = m

    def get_source_timestamp_at_ramped_timestamp(self, timestamp_us: int) -> int:
        """stabilization_params.rs:265-283."""
        m = self.speed_ramped_timestamps
        if not m:
            return timestamp_us
        keys = np.asarray(sorted(m), dtype=np.int64)
        if len(keys) == 1:
            return int(m[int(keys[0])])
        vals = np.asarray([m[int(k)] for k in keys], dtype=np.float64)
        return int(round(float(interp_series(keys, vals, timestamp_us / 1000.0))))


@dataclass
class ComputeParams:
    """Frozen snapshot for compute (compute_params.rs:14-138)."""
    gyro: object = None                # GyroSource
    lens: object = None                # LensProfile
    keyframes: KeyframeManager = field(default_factory=KeyframeManager)
    fovs: List[float] = field(default_factory=list)
    minimal_fovs: List[float] = field(default_factory=list)
    camera_diagonal_fovs: List[float] = field(default_factory=list)
    frame_count: int = 0
    fov_scale: float = 1.0
    fov_overview: bool = False
    show_safe_area: bool = False
    width: int = 1
    height: int = 1
    output_width: int = 1
    output_height: int = 1
    video_rotation: float = 0.0
    lens_correction_amount: float = 1.0
    light_refraction_coefficient: float = 1.0
    video_speed: float = 1.0
    video_speed_affects_smoothing: bool = True
    video_speed_affects_zooming: bool = True
    video_speed_affects_zooming_limit: bool = True
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    background_mode: BackgroundMode = BackgroundMode.SolidColor
    background_margin: float = 0.0
    background_margin_feather: float = 0.0
    frame_readout_time: float = 0.0
    frame_readout_direction: ReadoutDirection = ReadoutDirection.TopToBottom
    trim_ranges: List[Tuple[float, float]] = field(default_factory=list)
    scaled_fps: float = 0.0
    scaled_duration_ms: float = 0.0
    adaptive_zoom_window: float = 0.0
    adaptive_zoom_center_offset: Tuple[float, float] = (0.0, 0.0)
    adaptive_zoom_method: int = 1
    additional_rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    additional_translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    framebuffer_inverted: bool = False
    suppress_rotation: bool = False
    fov_algorithm_margin: float = 2.0
    smoothing_fov_limit_per_frame: List[float] = field(default_factory=list)
    max_zoom: Optional[float] = None
    max_zoom_iterations: int = 5
    zooming_debug_points: bool = False
    distortion_model: object = None    # ops.distortion_models.DistortionModel
    digital_lens: object = None
    digital_lens_params: Optional[List[float]] = None
    focal_lengths: List[Optional[float]] = field(default_factory=list)
    smoothed_focal_lengths: List[Optional[float]] = field(default_factory=list)
    focal_length_smoothing_enabled: bool = False
    focal_length_smoothing_strength: float = 0.5

    @classmethod
    def from_manager(cls, mgr) -> "ComputeParams":
        from ..ops.distortion_models import get_model
        p = mgr.params
        lens = mgr.lens
        distortion_model = get_model(lens.distortion_model or "opencv_fisheye")
        digital_lens = get_model(lens.digital_lens) if lens.digital_lens else None
        return cls(
            gyro=mgr.gyro, lens=lens,
            keyframes=mgr.keyframes.clone(),
            fovs=list(p.fovs), minimal_fovs=list(p.minimal_fovs),
            max_zoom=p.max_zoom, max_zoom_iterations=p.max_zoom_iterations,
            zooming_debug_points=p.zooming_debug_points,
            frame_count=p.frame_count, fov_scale=p.fov,
            fov_overview=p.fov_overview, show_safe_area=p.show_safe_area,
            width=max(p.size[0], 1), height=max(p.size[1], 1),
            output_width=max(p.output_size[0], 1), output_height=max(p.output_size[1], 1),
            video_rotation=p.video_rotation, background=tuple(p.background),
            background_mode=p.background_mode, background_margin=p.background_margin,
            background_margin_feather=p.background_margin_feather,
            lens_correction_amount=p.lens_correction_amount,
            light_refraction_coefficient=p.light_refraction_coefficient,
            framebuffer_inverted=p.framebuffer_inverted,
            frame_readout_time=p.frame_readout_time,
            frame_readout_direction=p.frame_readout_direction,
            trim_ranges=list(p.trim_ranges),
            scaled_fps=p.get_scaled_fps(), scaled_duration_ms=p.get_scaled_duration_ms(),
            adaptive_zoom_window=p.adaptive_zoom_window,
            adaptive_zoom_center_offset=p.adaptive_zoom_center_offset,
            additional_rotation=p.additional_rotation,
            additional_translation=p.additional_translation,
            adaptive_zoom_method=p.adaptive_zoom_method,
            video_speed=p.video_speed,
            video_speed_affects_smoothing=p.video_speed_affects_smoothing,
            video_speed_affects_zooming=p.video_speed_affects_zooming,
            video_speed_affects_zooming_limit=p.video_speed_affects_zooming_limit,
            distortion_model=distortion_model, digital_lens=digital_lens,
            digital_lens_params=list(lens.digital_lens_params) if lens.digital_lens_params else None,
            focal_lengths=list(p.focal_lengths),
            smoothed_focal_lengths=list(p.smoothed_focal_lengths),
            focal_length_smoothing_enabled=p.focal_length_smoothing_enabled,
            focal_length_smoothing_strength=p.focal_length_smoothing_strength,
        )

    def calculate_camera_fovs(self):
        """compute_params.rs:140-155: per-frame diagonal FOV in degrees."""
        from ..ops.frame_transform import get_lens_data_at_timestamp
        n = self.frame_count if (self.gyro is not None and
                                 len(self.gyro.file_metadata.lens_params) > 1) else 1
        self.camera_diagonal_fovs = []
        diag = math.hypot(self.width, self.height)
        for f in range(max(n, 1)):
            ts = timestamp_at_frame(f, self.scaled_fps) if self.scaled_fps else 0.0
            cam, *_ = get_lens_data_at_timestamp(self, ts, False)
            d_fov = 2.0 * math.atan(diag / (2.0 * cam[1, 1])) * 180.0 / math.pi
            self.camera_diagonal_fovs.append(d_fov)
