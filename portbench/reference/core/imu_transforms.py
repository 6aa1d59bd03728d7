"""IMU sample transforms (orientation remap, rotation, bias).

Port of gyroflow src/core/gyro_source/imu_transforms.rs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import quaternion as quat

DEG2RAD = math.pi / 180.0


@dataclass
class IMUTransforms:
    imu_orientation: Optional[str] = None       # e.g. "xYz"
    imu_rotation_angles: Optional[list] = None  # [pitch, roll, yaw] deg
    acc_rotation_angles: Optional[list] = None
    imu_lpf: float = 0.0                        # Hz
    imu_mf: int = 0                             # median filter size
    glitch_filter: bool = False
    glitch_strength: float = 0.0
    gyro_bias: Optional[list] = None

    _imu_rotation: Optional[np.ndarray] = field(default=None, repr=False)
    _acc_rotation: Optional[np.ndarray] = field(default=None, repr=False)

    def set_imu_rotation(self, pitch_deg: float, roll_deg: float, yaw_deg: float):
        """Rotation3::from_euler_angles(yaw, pitch, roll) — note arg order quirk
        (imu_transforms.rs:46-57: nalgebra from_euler_angles(r,p,y) gets
        (yaw_deg, pitch_deg, roll_deg))."""
        if abs(pitch_deg) > 0 or abs(roll_deg) > 0 or abs(yaw_deg) > 0:
            self.imu_rotation_angles = [pitch_deg, roll_deg, yaw_deg]
            self._imu_rotation = quat.to_rotation_matrix(quat.from_euler_xyz(
                yaw_deg * DEG2RAD, pitch_deg * DEG2RAD, roll_deg * DEG2RAD))
        else:
            self.imu_rotation_angles = None
            self._imu_rotation = None

    def set_acc_rotation(self, pitch_deg: float, roll_deg: float, yaw_deg: float):
        if abs(pitch_deg) > 0 or abs(roll_deg) > 0 or abs(yaw_deg) > 0:
            self.acc_rotation_angles = [pitch_deg, roll_deg, yaw_deg]
            self._acc_rotation = quat.to_rotation_matrix(quat.from_euler_xyz(
                yaw_deg * DEG2RAD, pitch_deg * DEG2RAD, roll_deg * DEG2RAD))
        else:
            self.acc_rotation_angles = None
            self._acc_rotation = None

    @property
    def imu_rotation(self) -> Optional[np.ndarray]:
        if self._imu_rotation is None and self.imu_rotation_angles:
            self.set_imu_rotation(*self.imu_rotation_angles)
        return self._imu_rotation

    def has_any(self) -> bool:
        return ((self.imu_orientation or "XYZ") != "XYZ"
                or self.imu_rotation_angles is not None
                or self.acc_rotation_angles is not None
                or (self.gyro_bias is not None and any(abs(b) > 0 for b in self.gyro_bias))
                or self.imu_lpf > 0.0 or self.imu_mf > 0 or self.glitch_filter)

    def transform(self, v: np.ndarray, is_acc: bool) -> np.ndarray:
        out = np.array(v, dtype=np.float64)
        if self.gyro_bias is not None:
            out = out + np.asarray(self.gyro_bias)
        if self.imu_orientation and self.imu_orientation != "XYZ":
            out = orient(out, self.imu_orientation)
        if is_acc and self.acc_rotation_angles is not None:
            if self._acc_rotation is None:
                self.set_acc_rotation(*self.acc_rotation_angles)
            out = self._acc_rotation @ out
        elif self.imu_rotation is not None:
            out = self.imu_rotation @ out
        return out


def orient(inp: np.ndarray, io: str) -> np.ndarray:
    """Axis remap by orientation string like "xYz" (imu_transforms.rs:74-84)."""
    def comp(o: str) -> float:
        return {"X": inp[0], "x": -inp[0], "Y": inp[1], "y": -inp[1],
                "Z": inp[2], "z": -inp[2]}[o]
    return np.array([comp(io[0]), comp(io[1]), comp(io[2])])
