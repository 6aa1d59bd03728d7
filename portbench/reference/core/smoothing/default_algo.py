"""Velocity-dampened smoothing — the "Default" algorithm.

Port of gyroflow src/core/smoothing/default_algo.rs:213-513 (10-step
algorithm documented at its head): angular velocity -> bidirectional EMA ->
normalize by max velocity (500°/s x smoothness x FOV ratio; halved for the
second pass) -> forward+reverse slerp with per-sample alpha between
max_smoothness and alpha_0_1s time constants -> second pass weighted by
smoothed normalized distance.

Axis convention (camera space): euler x component = pitch, y = yaw, z = roll
(default_algo.rs multiplies euler.0 by pitch_factor).
"""
from __future__ import annotations

import math

import numpy as np

from .. import quaternion as quat
from ..keyframes import KeyframeType
from ..params import frame_at_timestamp
from ..time_quat import TimeQuat
from .base import SmoothingAlgorithm, ema_scan_f, per_axis_scan

MAX_VELOCITY = 500.0
FOV_REFERENCE = 120.0
RAD_TO_DEG = 180.0 / math.pi


class DefaultAlgo(SmoothingAlgorithm):
    def __init__(self):
        self.smoothness = 0.5
        self.smoothness_pitch = 0.5
        self.smoothness_yaw = 0.5
        self.smoothness_roll = 0.5
        self.per_axis = False
        self.second_pass = True
        self.trim_range_only = True
        self.max_smoothness = 1.0
        self.alpha_0_1s = 0.1

    def get_name(self) -> str:
        return "Default"

    def params(self):
        return {
            "smoothness": self.smoothness, "smoothness_pitch": self.smoothness_pitch,
            "smoothness_yaw": self.smoothness_yaw, "smoothness_roll": self.smoothness_roll,
            "per_axis": 1.0 if self.per_axis else 0.0,
            "trim_range_only": 1.0 if self.trim_range_only else 0.0,
            "max_smoothness": self.max_smoothness, "alpha_0_1s": self.alpha_0_1s,
        }

    def smooth(self, tq: TimeQuat, duration_ms: float, compute_params) -> TimeQuat:
        if len(tq) == 0 or duration_ms <= 0.0:
            return tq.copy()
        from . import get_trimmed_quats

        cp = compute_params
        keyframes = cp.keyframes
        sample_rate = len(tq) / (duration_ms / 1000.0)
        rad_to_deg_per_sec = sample_rate * RAD_TO_DEG

        def get_alpha(tc):
            return 1.0 - math.exp(-(1.0 / sample_rate) / tc)

        tq = get_trimmed_quats(tq, cp.scaled_duration_ms, self.trim_range_only, cp.trim_ranges)
        ts = tq.timestamps_us
        qs = tq.quats
        n = len(ts)

        # keyframed params per timestamp (default_algo.rs:229-254)
        vs_active = cp.video_speed_affects_smoothing and \
            (cp.video_speed != 1.0 or keyframes.is_keyframed(KeyframeType.VideoSpeed))

        def keyed(typ, default, is_tc):
            if not (keyframes.is_keyframed(typ) or vs_active):
                return None
            out = np.empty(n)
            for i in range(n):
                t_ms = ts[i] / 1000.0
                val = keyframes.value_at_gyro_timestamp(typ, t_ms)
                if val is None:
                    val = default
                if cp.video_speed_affects_smoothing:
                    vs = keyframes.value_at_gyro_timestamp(KeyframeType.VideoSpeed, t_ms)
                    if vs is None:
                        vs = cp.video_speed
                    vs = abs(vs)
                    val *= (1.0 + (vs - 1.0) / 2.0) if is_tc else vs
                out[i] = val
            return out

        k_tc = keyed(KeyframeType.SmoothingParamTimeConstant, self.max_smoothness, True)
        k_tc2 = keyed(KeyframeType.SmoothingParamTimeConstant2, self.alpha_0_1s, True)
        k_s = keyed(KeyframeType.SmoothingParamSmoothness, self.smoothness, False)
        k_sp = keyed(KeyframeType.SmoothingParamPitch, self.smoothness_pitch, False)
        k_sy = keyed(KeyframeType.SmoothingParamYaw, self.smoothness_yaw, False)
        k_sr = keyed(KeyframeType.SmoothingParamRoll, self.smoothness_roll, False)

        alpha_smoothness = np.full(n, get_alpha(self.max_smoothness)) if k_tc is None \
            else np.vectorize(get_alpha)(k_tc)
        alpha_0_1s = np.full(n, get_alpha(self.alpha_0_1s)) if k_tc2 is None \
            else np.vectorize(get_alpha)(k_tc2)

        sm = np.full(n, self.smoothness) if k_s is None else k_s
        sm_p = np.full(n, self.smoothness_pitch) if k_sp is None else k_sp
        sm_y = np.full(n, self.smoothness_yaw) if k_sy is None else k_sy
        sm_r = np.full(n, self.smoothness_roll) if k_sr is None else k_sr

        # 1. velocity (deg/s) per sample (default_algo.rs:259-280)
        velocity = np.zeros((n, 3))
        dist = quat.multiply(quat.inverse(qs[:-1]), qs[1:])
        if self.per_axis:
            roll, pitch, yaw = quat.euler_angles(dist)
            velocity[1:, 0] = np.abs(roll) * rad_to_deg_per_sec
            velocity[1:, 1] = np.abs(pitch) * rad_to_deg_per_sec
            velocity[1:, 2] = np.abs(yaw) * rad_to_deg_per_sec
        else:
            velocity[1:] = (quat.angle_of(dist) * rad_to_deg_per_sec)[:, None]

        # 2. smooth velocity with alpha_0_1s both directions
        velocity = ema_scan_f(velocity, alpha_0_1s)
        velocity = ema_scan_f(velocity, alpha_0_1s, reverse=True)

        # 3. normalize by max velocity incl. FOV ratio + fov-limit (:293-333)
        fovs = cp.camera_diagonal_fovs
        fov_ratio = np.ones(n)
        if len(fovs) == 1:
            fov_ratio[:] = fovs[0] / FOV_REFERENCE
        elif len(fovs) > 1:
            for i in range(n):
                f = frame_at_timestamp(ts[i] / 1000.0, cp.scaled_fps)
                fov_ratio[i] = fovs[f] / FOV_REFERENCE if 0 <= f < len(fovs) else 1.0
        limit = cp.smoothing_fov_limit_per_frame
        if limit:
            for i in range(n):
                f = frame_at_timestamp(ts[i] / 1000.0, cp.scaled_fps)
                if 0 <= f < len(limit):
                    fov_ratio[i] *= limit[f]

        half = 0.5 if self.second_pass else 1.0
        if self.per_axis:
            velocity[:, 0] /= MAX_VELOCITY * sm_p * fov_ratio * half
            velocity[:, 1] /= MAX_VELOCITY * sm_y * fov_ratio * half
            velocity[:, 2] /= MAX_VELOCITY * sm_r * fov_ratio * half
        else:
            velocity[:, 0] /= MAX_VELOCITY * sm * fov_ratio * half

        # 4-5. first bidirectional pass with velocity-interpolated alpha
        smoothed = self._varying_pass(qs, velocity, alpha_smoothness, alpha_0_1s)
        smoothed = self._varying_pass(smoothed, velocity, alpha_smoothness, alpha_0_1s,
                                      reverse=True)
        if not self.second_pass:
            return TimeQuat(ts.copy(), smoothed)

        # 6. distance smoothed->raw (:396-416)
        d = quat.multiply(quat.inverse(qs), smoothed)
        if self.per_axis:
            roll, pitch, yaw = quat.euler_angles(d)
            distance = np.stack([np.abs(roll), np.abs(pitch), np.abs(yaw)], axis=-1)
        else:
            distance = np.repeat(quat.angle_of(d)[:, None], 3, axis=1)

        # 7. normalize, discard < 0.5 (:418-430)
        axes = 3 if self.per_axis else 1
        for a in range(axes):
            mx = distance[:, a].max()
            if mx > 0:
                distance[:, a] /= mx
            distance[:, a] = np.where(distance[:, a] < 0.5, 0.0, distance[:, a])

        # 8. smooth distance (:432-441)
        distance = ema_scan_f(distance, alpha_0_1s)
        distance = ema_scan_f(distance, alpha_0_1s, reverse=True)

        # 9. normalize to 0.5..1.0 (:443-464)
        for a in range(axes):
            mx = distance[:, a].max()
            if mx > 0:
                distance[:, a] /= mx
            distance[:, a] = (distance[:, a] + 1.0) / 2.0
        if not self.per_axis:
            distance[:, 1] = distance[:, 0]
            distance[:, 2] = distance[:, 0]

        # 10. second bidirectional pass weighted by velocity*distance
        ratio = velocity * distance if self.per_axis else velocity
        if not self.per_axis:
            ratio = velocity.copy()
            ratio[:, 0] = velocity[:, 0] * distance[:, 0]
        smoothed = self._varying_pass(smoothed, ratio, alpha_smoothness, alpha_0_1s)
        smoothed = self._varying_pass(smoothed, ratio, alpha_smoothness, alpha_0_1s,
                                      reverse=True)
        return TimeQuat(ts.copy(), smoothed)

    def _varying_pass(self, qs, ratio, alpha_smoothness, alpha_0_1s, reverse=False):
        n = qs.shape[0]
        if self.per_axis:
            factors = np.minimum(
                alpha_smoothness[:, None] * (1.0 - ratio) + alpha_0_1s[:, None] * ratio, 1.0)
            return per_axis_scan(qs, factors, reverse=reverse)
        val = np.minimum(alpha_smoothness * (1.0 - ratio[:, 0]) + alpha_0_1s * ratio[:, 0], 1.0)
        from .base import slerp_scan
        return slerp_scan(qs, val, reverse=reverse)
