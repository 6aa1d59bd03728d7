"""Orientation time-series engine.

Port of gyroflow src/core/gyro_source/mod.rs: telemetry container +
IMU transform application + integrator dispatch + sync offsets (with the
RANSAC-style line fit) + quaternion lookups + recompute_smoothness.
"""
from __future__ import annotations

import copy
import logging
import math
from typing import Dict, Optional

import numpy as np

from . import quaternion as quat
from .file_metadata import FileMetadata, TimeIMU
from .filtering import (lowpass_gyro_forward_backward, lowpass_quats_forward_backward,
                        median_gyro_forward_backward)
from .imu_integration import INTEGRATORS, integrate_complementary, quaternion_converter
from .imu_transforms import IMUTransforms
from .time_quat import TimeQuat, interp_series

log = logging.getLogger(__name__)

DEG2RAD = math.pi / 180.0


class GyroSource:
    def __init__(self):
        self.duration_ms: float = 0.0
        self.raw_imu: list = []               # transformed copy (if transforms active)
        self.imu_transforms = IMUTransforms()
        self.integration_method: int = 2      # VQF default (gyro_source/mod.rs:79)
        self.quaternions = TimeQuat()
        self.smoothed_quaternions = TimeQuat()
        self.use_gravity_vectors = False
        self.horizon_lock_integration_method = 1
        self.max_angles = (0.0, 0.0, 0.0)
        self.prevent_recompute = False
        self.file_metadata = FileMetadata()
        self.offsets: Dict[int, float] = {}           # ts_us -> offset_ms
        self.offsets_linear: Dict[int, float] = {}
        self.offsets_adjusted: Dict[int, float] = {}
        self.file_url: str = ""

    def clone(self) -> "GyroSource":
        g = GyroSource.__new__(GyroSource)
        g.__dict__.update(self.__dict__)
        g.imu_transforms = copy.copy(self.imu_transforms)
        g.quaternions = self.quaternions.copy()
        g.smoothed_quaternions = self.smoothed_quaternions.copy()
        g.offsets = dict(self.offsets)
        g.offsets_linear = dict(self.offsets_linear)
        g.offsets_adjusted = dict(self.offsets_adjusted)
        return g

    def has_motion(self) -> bool:
        return self.file_metadata.has_motion()

    def init_from_params(self, stabilization_params):
        self.duration_ms = stabilization_params.get_scaled_duration_ms()

    # ---- loading -----------------------------------------------------------

    def load_from_telemetry(self, file_metadata: FileMetadata):
        """gyro_source/mod.rs:566-615."""
        self.file_metadata = file_metadata
        self.quaternions = TimeQuat()
        self.smoothed_quaternions = TimeQuat()
        self.raw_imu = []

        has_quats = (file_metadata.quaternions is not None
                     and len(file_metadata.quaternions) > 0)
        if has_quats:
            # camera quaternions win when present (mod.rs:576-595): the
            # integration method switches to 0 ("use provided quats") and the
            # duration is re-derived from the quaternion timeline
            self.integration_method = 0
            ts = file_metadata.quaternions.timestamps_us
            n = len(ts)
            if n > 1:
                imu_duration = (float(ts[-1]) - float(ts[0])) / 1000.0 \
                    * ((n + 1.0) / n)
                if abs(imu_duration - self.duration_ms) > 0.01 \
                        and imu_duration > 0.0:
                    log.warning("IMU duration %.1f differs from video "
                                "duration %.1f", imu_duration, self.duration_ms)
                    self.duration_ms = imu_duration

        if file_metadata.raw_imu:
            raw = file_metadata.raw_imu
            first_ts = raw[0].timestamp_ms
            last_ts = raw[-1].timestamp_ms
            n = len(raw)
            imu_duration = (last_ts - first_ts) * ((n + 1.0) / n)
            if abs(imu_duration - self.duration_ms) > 0.01 and imu_duration > 0.0:
                if not has_quats:
                    log.warning("IMU duration %.1f differs from video "
                                "duration %.1f", imu_duration, self.duration_ms)
                    self.duration_ms = imu_duration
            self.apply_transforms()
        else:
            self.integrate()    # method 0 copies/converts the quaternions

    def apply_transforms(self):
        """gyro_source/mod.rs:822-855."""
        fm = self.file_metadata
        if self.imu_transforms.has_any():
            self.raw_imu = [TimeIMU(v.timestamp_ms,
                                    None if v.gyro is None else np.array(v.gyro, dtype=np.float64),
                                    None if v.accl is None else np.array(v.accl, dtype=np.float64),
                                    None if v.magn is None else np.array(v.magn, dtype=np.float64))
                            for v in fm.raw_imu]
            for x in self.raw_imu:
                if x.gyro is not None:
                    x.gyro = self.imu_transforms.transform(x.gyro, False)
                if x.accl is not None:
                    x.accl = self.imu_transforms.transform(x.accl, True)
                if x.magn is not None:
                    x.magn = self.imu_transforms.transform(x.magn, False)
            if self.imu_transforms.imu_lpf > 0.0 and fm.raw_imu and self.duration_ms > 0.0:
                sample_rate = len(fm.raw_imu) / (self.duration_ms / 1000.0)
                try:
                    lowpass_gyro_forward_backward(self.imu_transforms.imu_lpf, sample_rate, self.raw_imu)
                except ValueError as e:
                    log.error("Filter error: %s", e)
            if self.imu_transforms.imu_mf > 0 and fm.raw_imu and self.duration_ms > 0.0:
                sample_rate = len(fm.raw_imu) / (self.duration_ms / 1000.0)
                median_gyro_forward_backward(self.imu_transforms.imu_mf, sample_rate, self.raw_imu)
        else:
            self.raw_imu = []
        self.integrate()

    def get_raw_imu(self) -> list:
        """gyro_source/mod.rs:690-693."""
        return self.raw_imu if self.raw_imu else self.file_metadata.raw_imu

    def integrate(self):
        """gyro_source/mod.rs:616-653."""
        fm = self.file_metadata
        m = self.integration_method
        if m == 0:
            src = fm.detected_source or ""
            if src.startswith("GoPro") and len(fm.quaternions) > 0 and \
                    (fm.gravity_vectors is None or not self.use_gravity_vectors):
                log.info("No gravity vectors - using accelerometer")
                self.quaternions = quaternion_converter(
                    self.horizon_lock_integration_method, fm.quaternions,
                    fm.image_orientations or TimeQuat(), self.get_raw_imu(), self.duration_ms)
            else:
                self.quaternions = fm.quaternions.copy()
            if self.imu_transforms.glitch_filter and len(self.quaternions) >= 8:
                from .filtering import GlitchRepairParams, repair_quats
                patched = repair_quats(self.quaternions,
                                       GlitchRepairParams.from_strength(
                                           self.imu_transforms.glitch_strength))
                if patched:
                    log.info("Glitch filter: repaired %d sample(s)", patched)
            if self.imu_transforms.imu_lpf > 0.0 and len(self.quaternions) > 0 and self.duration_ms > 0.0:
                sample_rate = len(self.quaternions) / (self.duration_ms / 1000.0)
                try:
                    self.quaternions = lowpass_quats_forward_backward(
                        self.imu_transforms.imu_lpf, sample_rate, self.quaternions)
                except ValueError as e:
                    log.error("Filter error: %s", e)
            if self.imu_transforms.imu_rotation is not None:
                rot_q = quat.from_rotation_matrix(self.imu_transforms.imu_rotation)
                self.quaternions = self.quaternions.map_quats(
                    lambda qs: quat.multiply(rot_q, qs))
        elif m in INTEGRATORS:
            self.quaternions = INTEGRATORS[m](self.get_raw_imu(), self.duration_ms)
        else:
            log.error("Unknown integrator %s", m)

    # ---- smoothing ---------------------------------------------------------

    def recompute_smoothness(self, alg, horizon_lock, compute_params):
        """gyro_source/mod.rs:655-688: additional rotation -> horizon lock ->
        smooth -> invert to correction (sq = sq^-1 * q)."""
        from .keyframes import KeyframeType
        fm = self.file_metadata
        smoothed = self.quaternions.copy()

        cp = compute_params
        kf = cp.keyframes
        add_rot = cp.additional_rotation
        keyed = any(kf.is_keyframed(t) for t in (KeyframeType.AdditionalRotationX,
                                                 KeyframeType.AdditionalRotationY,
                                                 KeyframeType.AdditionalRotationZ))
        if keyed or any(abs(a) > 0 for a in add_rot):
            qs = smoothed.quats
            for i, ts in enumerate(smoothed.timestamps_us):
                t_ms = ts / 1000.0
                rx = kf.value_at_gyro_timestamp(KeyframeType.AdditionalRotationX, t_ms)
                ry = kf.value_at_gyro_timestamp(KeyframeType.AdditionalRotationY, t_ms)
                rz = kf.value_at_gyro_timestamp(KeyframeType.AdditionalRotationZ, t_ms)
                rx = (add_rot[0] if rx is None else rx) * DEG2RAD
                ry = (add_rot[1] if ry is None else ry) * DEG2RAD
                rz = (add_rot[2] if rz is None else rz) * DEG2RAD
                # Quat64::from_euler_angles(y, x, z) (mod.rs:666)
                additional = quat.from_euler_xyz(ry, rx, rz)
                qs[i] = quat.multiply(qs[i], additional)

        # Lock horizon, then smooth (mod.rs:670-674)
        smoothed = horizon_lock.lock(smoothed, self.quaternions,
                                     fm.gravity_vectors, self.use_gravity_vectors, cp)
        smoothed = alg.smooth(smoothed, self.duration_ms, cp)

        from .smoothing import get_max_angles
        max_angles = get_max_angles(self.quaternions, smoothed, cp)

        # invert to correction: sq = sq^-1 * q (mod.rs:682-686)
        n = min(len(smoothed), len(self.quaternions))
        corr = quat.multiply(quat.inverse(smoothed.quats[:n]), self.quaternions.quats[:n])
        out = smoothed.quats.copy()
        out[:n] = corr
        return TimeQuat(smoothed.timestamps_us.copy(), out), max_angles

    # ---- offsets (gyro_source/mod.rs:695-820) ------------------------------

    def set_offset(self, timestamp_us: int, offset_ms: float):
        if math.isfinite(offset_ms):
            self.offsets[int(timestamp_us)] = offset_ms
            self.adjust_offsets()

    def remove_offset(self, timestamp_us: int):
        self.offsets.pop(int(timestamp_us), None)
        self.adjust_offsets()

    def clear_offsets(self):
        self.offsets.clear()
        self.offsets_adjusted.clear()

    def remove_offsets_near(self, timestamp_us: int, range_ms: float):
        """Drop offsets within ±range_ms of a timestamp (mod.rs:721-725)."""
        r = int(round(range_ms * 1000.0))
        self.offsets = {k: v for k, v in self.offsets.items()
                        if not (timestamp_us - r <= k < timestamp_us + r)}
        self.adjust_offsets()

    def get_offsets_plus_linear(self) -> Dict[int, tuple]:
        """{ts: (offset, linear-fit offset)} for charting (mod.rs:714-716)."""
        return {k: (v, self.offsets_linear.get(k, v))
                for k, v in self.offsets.items()}

    def get_sample_rate(self) -> float:
        """Raw-IMU sample rate in Hz (mod.rs get_sample_rate)."""
        raw = self.file_metadata.raw_imu if self.file_metadata else []
        if len(raw) < 2 or self.duration_ms <= 0.0:
            return 0.0
        return len(raw) / (self.duration_ms / 1000.0)

    def get_offsets(self) -> Dict[int, float]:
        return self.offsets

    def set_offsets(self, offsets: Dict[int, float]):
        self.offsets = {int(k): float(v) for k, v in offsets.items()}
        self.adjust_offsets()

    def remove_offsets_near(self, ts: int, range_ms: float):
        range_us = int(round(range_ms * 1000.0))
        self.offsets = {k: v for k, v in self.offsets.items()
                        if not (ts - range_us <= k < ts + range_us)}
        self.adjust_offsets()

    @staticmethod
    def _line_fit(offsets: Dict[int, float]):
        ks = np.asarray(sorted(offsets), dtype=np.float64)
        vs = np.asarray([offsets[int(k)] for k in ks])
        a = np.stack([ks, np.ones_like(ks)], axis=-1)
        sol, *_ = np.linalg.lstsq(a, vs, rcond=None)
        resid = float(((a @ sol - vs) ** 2).sum())
        return [float(sol[0]), float(sol[1]), resid]

    def adjust_offsets(self):
        """RANSAC-ish two-point line hypotheses + refit (mod.rs:744-820)."""
        if self.prevent_recompute:
            return
        if len(self.offsets) > 1:
            keys = list(self.offsets)
            n = len(keys)
            best_offsets: Dict[int, float] = {}
            best_r2 = 1000.0
            best_coeffs = [0.0, 0.0, 0.0]
            max_fitting_error = 5.0
            for i in range(n):
                for j in range(n):
                    if i == j:
                        continue
                    denom = keys[j] - keys[i]
                    slope = (self.offsets[keys[j]] - self.offsets[keys[i]]) / denom
                    intersect = self.offsets[keys[i]] - keys[i] * slope
                    within = {k: v for k, v in self.offsets.items()
                              if abs((k * slope + intersect) - v) < max_fitting_error}
                    if len(within) >= len(best_offsets) and within != best_offsets:
                        sol = self._line_fit(within)
                        close_constant = abs(sol[0]) < 0.1
                        if len(within) > 2 and close_constant:
                            if sol[2] < best_r2:
                                best_r2 = sol[2]
                                best_offsets = within
                                best_coeffs = sol
                        elif close_constant:
                            best_offsets = within
                            best_coeffs = sol
            self.offsets_linear = {}
            if best_offsets:
                for k in self.offsets:
                    self.offsets_linear[k] = k * best_coeffs[0] + best_coeffs[1]
            else:
                sol = self._line_fit(self.offsets)
                for k in self.offsets:
                    self.offsets_linear[k] = k * sol[0] + sol[1]
        else:
            self.offsets_linear = dict(self.offsets)
        self.offsets_adjusted = {k + int(round(v * 1000.0)): v
                                 for k, v in self.offsets.items()}

    def _offset_at(self, offsets: Dict[int, float], timestamp_ms) -> np.ndarray:
        if not offsets:
            return np.zeros_like(np.asarray(timestamp_ms, dtype=np.float64))
        ks = np.asarray(sorted(offsets), dtype=np.int64)
        vs = np.asarray([offsets[int(k)] for k in ks])
        if len(ks) == 1:
            return np.full_like(np.asarray(timestamp_ms, dtype=np.float64), vs[0])
        return interp_series(ks, vs, timestamp_ms)

    def offset_at_video_timestamp(self, timestamp_ms):
        return self._offset_at(self.offsets_adjusted, timestamp_ms)

    def offset_at_gyro_timestamp(self, timestamp_ms):
        return self._offset_at(self.offsets, timestamp_ms)

    def find_bias(self, timestamp_start_ms: float, timestamp_stop_ms: float):
        """Mean negated gyro over a (presumed stationary) video-time range
        (gyro_source/mod.rs:979-1002). Returns a (bx, by, bz) deg/s triple
        suitable for set_imu_bias."""
        ts_start = timestamp_start_ms - float(
            self.offset_at_video_timestamp(timestamp_start_ms))
        ts_stop = timestamp_stop_ms - float(
            self.offset_at_video_timestamp(timestamp_stop_ms))
        bias = np.zeros(3)
        n = 0
        for x in self.file_metadata.raw_imu:
            if x.gyro is not None and ts_start < x.timestamp_ms < ts_stop:
                bias -= np.asarray(x.gyro, dtype=np.float64)
                n += 1
        return tuple(bias / max(n, 1))

    # ---- lookups (gyro_source/mod.rs:857-882) ------------------------------

    def _quat_at(self, tq: TimeQuat, timestamp_ms):
        timestamp_ms = np.asarray(timestamp_ms, dtype=np.float64)
        if len(tq) < 2 or self.duration_ms <= 0.0:
            return np.broadcast_to(quat.identity(), timestamp_ms.shape + (4,)).copy()
        adj = timestamp_ms - self.offset_at_video_timestamp(timestamp_ms)
        return tq.at_timestamp(adj)

    def org_quat_at_timestamp(self, timestamp_ms):
        return self._quat_at(self.quaternions, timestamp_ms)

    def smoothed_quat_at_timestamp(self, timestamp_ms):
        return self._quat_at(self.smoothed_quaternions, timestamp_ms)

    def get_checksum(self) -> int:
        t = self.imu_transforms
        return hash((
            self.file_metadata.detected_source, t.imu_orientation,
            tuple(t.imu_rotation_angles or ()), tuple(t.acc_rotation_angles or ()),
            t.imu_lpf, t.imu_mf, t.glitch_filter, t.glitch_strength,
            tuple(t.gyro_bias or ()), self.integration_method,
            self.use_gravity_vectors, self.horizon_lock_integration_method,
            self.duration_ms, len(self.quaternions),
            tuple(sorted(self.offsets.items())),
        ))
