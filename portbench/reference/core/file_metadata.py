"""Parsed telemetry container.

Port of gyroflow src/core/gyro_source/file_metadata.rs:41-130:
raw IMU samples, camera-provided quaternions/gravity/image orientations,
per-timestamp lens params, per-frame time offsets, IBIS/OIS splines, mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .time_quat import TimeQuat


@dataclass
class TimeIMU:
    """telemetry_parser::util::IMUData: gyro deg/s, accl m/s^2, magn uT."""
    timestamp_ms: float
    gyro: Optional[np.ndarray] = None
    accl: Optional[np.ndarray] = None
    magn: Optional[np.ndarray] = None


@dataclass
class LensParamsEntry:
    """Per-timestamp lens metadata (Sony etc.) — file_metadata.rs fields."""
    pixel_focal_length: Optional[Tuple[float, float]] = None
    focal_length: Optional[float] = None
    pixel_pitch: Optional[Tuple[int, int]] = None
    capture_area_size: Optional[Tuple[float, float]] = None
    sensor_size_px: Optional[Tuple[float, float]] = None
    principal_point: Optional[Tuple[float, float]] = None
    distortion_coefficients: List[float] = field(default_factory=list)


@dataclass
class CameraStabData:
    """IBIS/OIS metadata per frame (file_metadata.rs:41-50)."""
    ibis_spline: object = None      # CatmullRom over sensor rows
    ois_spline: object = None
    offset: float = 0.0
    crop_area: Tuple[float, float, float, float] = (0, 0, 1, 1)
    sensor_size: Tuple[float, float] = (1, 1)
    pixel_pitch: Tuple[float, float] = (1, 1)


@dataclass
class FileMetadata:
    """file_metadata.rs:52-103."""
    imu_orientation: Optional[str] = None
    raw_imu: List[TimeIMU] = field(default_factory=list)
    quaternions: TimeQuat = field(default_factory=TimeQuat)
    gravity_vectors: Optional[dict] = None         # {"ts": int64[], "vec": (N,3)}
    image_orientations: Optional[TimeQuat] = None
    detected_source: Optional[str] = None
    frame_readout_time: Optional[float] = None
    frame_readout_direction: Optional[object] = None   # ReadoutDirection
    frame_rate: Optional[float] = None
    lens_profile: Optional[object] = None          # dict or profile name
    lens_positions: Dict[int, float] = field(default_factory=dict)
    lens_params: Dict[int, LensParamsEntry] = field(default_factory=dict)
    camera_identifier: Optional[object] = None
    has_accurate_timestamps: bool = False
    additional_data: dict = field(default_factory=dict)
    per_frame_time_offsets: List[float] = field(default_factory=list)
    digital_zoom: Optional[float] = None
    camera_stab_data: List[CameraStabData] = field(default_factory=list)
    mesh_correction: List[Tuple[np.ndarray, np.ndarray]] = field(default_factory=list)

    def has_motion(self) -> bool:
        return bool(self.raw_imu) or len(self.quaternions) > 0

    def thin(self) -> "FileMetadata":
        return self
