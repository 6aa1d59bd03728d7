"""Fixed camera orientation (smoothing/fixed.rs)."""
from __future__ import annotations

import math

import numpy as np

from .. import quaternion as quat
from ..keyframes import KeyframeType
from ..time_quat import TimeQuat
from .base import SmoothingAlgorithm

DEG2RAD = math.pi / 180.0


def quat_for_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """fixed.rs:117-132: Rz(yaw)·Rx(pitch)·Ry(roll+90°)·[Rz(90°)·Ry(90°)]."""
    x = np.array([1.0, 0.0, 0.0])
    y = np.array([0.0, 1.0, 0.0])
    z = np.array([0.0, 0.0, 1.0])
    rot_x = quat.from_axis_angle(x, pitch * DEG2RAD)
    rot_y = quat.from_axis_angle(y, (roll + 90.0) * DEG2RAD)
    rot_z = quat.from_axis_angle(z, yaw * DEG2RAD)
    correction = quat.multiply(quat.from_axis_angle(z, 90.0 * DEG2RAD),
                               quat.from_axis_angle(y, 90.0 * DEG2RAD))
    return quat.multiply(rot_z, quat.multiply(rot_x, quat.multiply(rot_y, correction)))


class Fixed(SmoothingAlgorithm):
    def __init__(self):
        self.roll = 0.0
        self.pitch = 0.0
        self.yaw = 0.0

    def get_name(self) -> str:
        return "Fixed camera"

    def params(self):
        return {"roll": self.roll, "pitch": self.pitch, "yaw": self.yaw}

    def smooth(self, tq: TimeQuat, duration_ms: float, compute_params) -> TimeQuat:
        if len(tq) == 0 or duration_ms <= 0.0:
            return tq.copy()
        kf = compute_params.keyframes
        keyed = any(kf.is_keyframed(t) for t in (KeyframeType.SmoothingParamRoll,
                                                 KeyframeType.SmoothingParamPitch,
                                                 KeyframeType.SmoothingParamYaw))
        n = len(tq)
        if not keyed:
            fixed_q = quat_for_rpy(self.roll, self.pitch, self.yaw)
            return TimeQuat(tq.timestamps_us.copy(), np.tile(fixed_q, (n, 1)))
        out = np.empty((n, 4))
        for i, ts in enumerate(tq.timestamps_us):
            t_ms = ts / 1000.0
            r = kf.value_at_gyro_timestamp(KeyframeType.SmoothingParamRoll, t_ms)
            p = kf.value_at_gyro_timestamp(KeyframeType.SmoothingParamPitch, t_ms)
            y = kf.value_at_gyro_timestamp(KeyframeType.SmoothingParamYaw, t_ms)
            out[i] = quat_for_rpy(self.roll if r is None else r,
                                  self.pitch if p is None else p,
                                  self.yaw if y is None else y)
        return TimeQuat(tq.timestamps_us.copy(), out)
