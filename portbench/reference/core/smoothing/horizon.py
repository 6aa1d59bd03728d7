"""Horizon lock.

Port of gyroflow src/core/smoothing/horizon.rs: roll (optionally pitch)
lock via test-vector yaw/pitch decomposition, gravity-vector branch with
interpolated gravity, automatic lock (turn-rate threshold + smoothed dynamic
tilt + acceleration limit), keyframable lock amount blended by slerp.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .. import quaternion as quat
from ..keyframes import KeyframeType
from ..time_quat import TimeQuat

X_AXIS = np.array([1.0, 0.0, 0.0])
Y_AXIS = np.array([0.0, 1.0, 0.0])
Z_AXIS = np.array([0.0, 0.0, 1.0])
DEG2RAD = math.pi / 180.0


def lock_horizon_angle(q: np.ndarray, roll_correction: float, lock_pitch: bool,
                       pitch_correction: float) -> np.ndarray:
    """horizon.rs:8-24 (vectorized over leading dims)."""
    test_vec = quat.rotate_vector(q, Z_AXIS)
    pitch = pitch_correction if lock_pitch else np.arcsin(np.clip(-test_vec[..., 2], -1, 1))
    yaw = np.arctan2(test_vec[..., 1], test_vec[..., 0])

    rot_yaw = quat.from_axis_angle(Y_AXIS, yaw)
    rot_pitch = quat.from_axis_angle(X_AXIS, pitch)
    rot_roll = quat.from_axis_angle(Z_AXIS, np.broadcast_to(roll_correction, np.shape(yaw)))

    initial = quat.multiply(quat.from_axis_angle(Y_AXIS, math.pi / 2),
                            quat.from_axis_angle(Z_AXIS, math.pi / 2))
    return quat.multiply(initial, quat.multiply(rot_yaw, quat.multiply(rot_pitch, rot_roll)))


class HorizonLock:
    def __init__(self):
        self.lock_enabled = False
        self.horizonlockpercent = 100.0
        self.horizonroll = 0.0
        self.lock_pitch = False
        self.horizonpitch = 0.0
        self.automatic_lock = False
        self.turn_threshold = 5.0
        self.turn_smoothing_ms = 500.0
        self.turn_multiplier = 1.0
        self.tilt_accel_limit = math.inf

    def set_horizon(self, lock_percent, roll, lock_pitch=False, pitch=0.0,
                    automatic_lock=False, turn_threshold=5.0, turn_smoothing_ms=500.0,
                    turn_multiplier=1.0, tilt_accel_limit=math.inf):
        self.horizonroll = roll
        self.horizonlockpercent = lock_percent
        self.lock_enabled = lock_percent > 1e-6
        self.horizonpitch = pitch
        self.lock_pitch = lock_pitch
        self.automatic_lock = automatic_lock
        self.turn_threshold = turn_threshold
        self.turn_smoothing_ms = turn_smoothing_ms
        self.turn_multiplier = turn_multiplier
        self.tilt_accel_limit = tilt_accel_limit

    def get_checksum(self) -> int:
        return hash((self.horizonlockpercent, self.horizonroll, self.lock_pitch,
                     self.horizonpitch, self.turn_threshold, self.turn_smoothing_ms,
                     self.turn_multiplier, self.tilt_accel_limit))

    def _roll_rates(self, org: TimeQuat) -> dict:
        """Smoothed roll turn rates for automatic lock (horizon.rs:85-115)."""
        rates = {}
        tau_s = self.turn_smoothing_ms / 1000.0
        ts = org.timestamps_us
        # reference uses current_euler.2 (the z component) as roll in camera space
        _, _, z_comp = quat.euler_angles(org.quats)
        prev_smoothed = None
        for i in range(1, len(ts)):
            dt = (ts[i] - ts[i - 1]) / 1_000_000.0
            if 0.0 < dt < 1.0:
                diff_deg = (z_comp[i] - z_comp[i - 1]) * 180.0 / math.pi
                while diff_deg > 180.0:
                    diff_deg -= 360.0
                while diff_deg < -180.0:
                    diff_deg += 360.0
                rate = diff_deg / dt
                alpha = 1.0 if tau_s <= 0.0 else dt / (tau_s + dt)
                smoothed = rate if prev_smoothed is None else \
                    prev_smoothed * (1.0 - alpha) + rate * alpha
                prev_smoothed = smoothed
                rates[int(ts[i])] = smoothed
        return rates

    def _dynamic_tilt(self, ts_list, rates) -> np.ndarray:
        """Turn-following tilt with smoothing + accel limit (horizon.rs:137-225)."""
        tau_s = self.turn_smoothing_ms / 1000.0
        out = np.zeros(len(ts_list))
        prev_tilt = None
        prev_ts = None
        for i, ts in enumerate(ts_list):
            rate = rates.get(int(ts), 0.0)
            target = rate * self.turn_multiplier if abs(rate) > self.turn_threshold else 0.0
            if prev_ts is not None:
                dt = (ts - prev_ts) / 1_000_000.0
                alpha = 1.0 if tau_s <= 0.0 else min(max(dt / (tau_s + dt), 0.0), 1.0)
            else:
                alpha = 1.0
            smoothed = target if prev_tilt is None else \
                prev_tilt * (1.0 - alpha) + target * alpha
            accel_limited = smoothed
            if math.isfinite(self.tilt_accel_limit) and prev_tilt is not None and prev_ts is not None:
                dt = (ts - prev_ts) / 1_000_000.0
                if dt > 0.0:
                    max_change = self.tilt_accel_limit * dt
                    change = smoothed - prev_tilt
                    if abs(change) > max_change:
                        accel_limited = prev_tilt + math.copysign(max_change, change)
            prev_tilt = accel_limited
            prev_ts = ts
            out[i] = accel_limited
        return out

    def lock(self, quats: TimeQuat, org_quats: TimeQuat,
             grav: Optional[dict], use_grav: bool, compute_params) -> TimeQuat:
        """Apply the lock in place semantics; returns the locked TimeQuat."""
        keyframes = compute_params.keyframes
        if not (self.lock_enabled or keyframes.is_keyframed(KeyframeType.LockHorizonAmount)):
            return quats

        ts = quats.timestamps_us
        n = len(ts)
        qs = quats.quats.copy()

        rates = self._roll_rates(org_quats) if self.automatic_lock else {}
        tilt = self._dynamic_tilt(ts, rates) if self.automatic_lock else np.zeros(n)

        def keyed(typ, default):
            if not keyframes.is_keyframed(typ):
                return np.full(n, default)
            out = np.empty(n)
            for i in range(n):
                v = keyframes.value_at_gyro_timestamp(typ, ts[i] / 1000.0)
                out[i] = default if v is None else v
            return out

        video_rotation = keyed(KeyframeType.VideoRotation, compute_params.video_rotation)
        horizonroll = keyed(KeyframeType.LockHorizonRoll, self.horizonroll) + video_rotation
        lockpercent = keyed(KeyframeType.LockHorizonAmount, self.horizonlockpercent)

        if grav is not None and use_grav and len(grav.get("ts", [])) > 0:
            # gravity-vector branch (horizon.rs:121-185)
            gts = np.asarray(grav["ts"], dtype=np.int64)
            gvecs = np.asarray(grav["vec"], dtype=np.float64)
            org_aligned = org_quats.quats[
                np.searchsorted(org_quats.timestamps_us, ts).clip(0, len(org_quats) - 1)]
            for i in range(n):
                gv = _interp_grav(gts, gvecs, int(ts[i]))
                ori = quat.to_rotation_matrix(org_aligned[i])
                sm = quat.to_rotation_matrix(qs[i])
                corr = ori.T @ sm
                angle_corr = math.atan2(-corr[0, 1], corr[0, 0])
                total_roll = horizonroll[i] + tilt[i]
                rot_z = quat.to_rotation_matrix(quat.from_axis_angle(
                    Z_AXIS, -angle_corr + math.atan2(gv[0], gv[1]) + total_roll * DEG2RAD))
                locked = sm @ rot_z
                locked_q = quat.from_rotation_matrix(locked)
                qs[i] = quat.slerp(locked_q, qs[i], 1.0 - lockpercent[i] / 100.0)
            return TimeQuat(ts.copy(), qs)

        horizonpitch = keyed(KeyframeType.LockHorizonPitch, self.horizonpitch)
        lock_pitch = keyed(KeyframeType.LockHorizonPitchEnabled,
                           1.0 if self.lock_pitch else 0.0) != 0.0

        for i in range(n):
            total_roll = horizonroll[i] + tilt[i]
            locked = lock_horizon_angle(qs[i], total_roll * DEG2RAD, bool(lock_pitch[i]),
                                        horizonpitch[i] * DEG2RAD)
            qs[i] = quat.slerp(locked, qs[i], 1.0 - lockpercent[i] / 100.0)
        return TimeQuat(ts.copy(), qs)


def _interp_grav(gts: np.ndarray, gvecs: np.ndarray, timestamp_us: int) -> np.ndarray:
    """horizon.rs:235-259; fallback +Y like the caller."""
    if len(gts) == 0:
        return Y_AXIS
    if len(gts) == 1:
        return gvecs[0]
    lookup = min(max(timestamp_us, int(gts[0])), int(gts[-1]))
    i = int(np.searchsorted(gts, lookup, side="right")) - 1
    i = min(max(i, 0), len(gts) - 2)
    if gts[i] == lookup:
        return gvecs[i]
    frac = (timestamp_us - gts[i]) / (gts[i + 1] - gts[i])
    return gvecs[i] + (gvecs[i + 1] - gvecs[i]) * frac
