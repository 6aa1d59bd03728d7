"""IMU orientation integrators.

Port of gyroflow src/core/imu_integration/mod.rs: method ids match
GyroSource::integrate (gyro_source/mod.rs:616-653):
  0 = camera quaternions (handled by GyroSource), 1 = Complementary,
  2 = VQF (offline variant, vqf.py), 3 = SimpleGyro, 4 = SimpleGyroAccel,
  5 = Mahony, 6 = Madgwick.

Axis convention: sensor (x,y,z) -> body (-y, x, z), angles deg/s -> rad/s
(mod.rs:163, 199, 246). Initial orientation = from_euler_angles(pi/2, 0, 0).
"""
from __future__ import annotations

import logging
import math
from typing import List

import numpy as np

from .. import quaternion as quat
from ..file_metadata import TimeIMU
from ..time_quat import TimeQuat
from .complementary import ComplementaryFilterV2

log = logging.getLogger(__name__)

DEG2RAD = math.pi / 180.0

INTEGRATOR_NAMES = {
    0: "None (camera quaternions)",
    1: "Complementary",
    2: "VQF",
    3: "SimpleGyro",
    4: "SimpleGyro + accelerometer",
    5: "Mahony",
    6: "Madgwick",
}


def _init_orientation() -> np.ndarray:
    """UnitQuaternion::from_euler_angles(FRAC_PI_2, 0, 0)."""
    return quat.from_euler_xyz(math.pi / 2, 0.0, 0.0)


def _collect(imu_data: List[TimeIMU]):
    ts = np.asarray([v.timestamp_ms for v in imu_data], dtype=np.float64)
    return ts


def integrate_simple_gyro(imu_data: List[TimeIMU], duration_ms: float) -> TimeQuat:
    """mod.rs:152-180."""
    if not imu_data:
        return TimeQuat()
    sample_time_ms = duration_ms / len(imu_data)
    orientation = _init_orientation()
    prev_time = imu_data[0].timestamp_ms - sample_time_ms
    ts_out = []
    qs_out = []
    for v in imu_data:
        if v.gyro is None:
            continue
        g = v.gyro
        omega = np.array([-g[1], g[0], g[2]]) * DEG2RAD
        dt = (v.timestamp_ms - prev_time) / 1000.0
        delta_q = quat.from_rotvec(omega * dt)
        orientation = quat.normalize(quat.multiply(orientation, delta_q))
        ts_out.append(int(v.timestamp_ms * 1000.0))
        qs_out.append(orientation)
        prev_time = v.timestamp_ms
    return TimeQuat(np.asarray(ts_out, np.int64), np.asarray(qs_out))


def integrate_simple_gyro_accel(imu_data: List[TimeIMU], duration_ms: float) -> TimeQuat:
    """mod.rs:186-231."""
    if not imu_data:
        return TimeQuat()
    sample_time_ms = duration_ms / len(imu_data)
    orientation = _init_orientation()
    prev_time = imu_data[0].timestamp_ms - sample_time_ms
    start_time = prev_time
    up = np.array([0.0, 0.0, 1.0])
    ts_out = []
    qs_out = []
    for v in imu_data:
        if v.gyro is None:
            continue
        g = v.gyro
        omega = np.array([-g[1], g[0], g[2]]) * DEG2RAD
        a = v.accl if v.accl is not None else np.zeros(3)
        acc = np.array([-a[1], a[0], a[2]])
        n = np.linalg.norm(acc)
        acc = acc / n if n > 0 else np.zeros(3)
        gm = np.linalg.norm(acc)
        if 0.9 <= gm <= 1.1:
            acc_world = quat.rotate_vector(orientation, acc)
            correction_world = np.cross(acc_world, up)
            weight = 10.0 if (v.timestamp_ms - start_time) < 15000.0 else 0.6
            correction_body = weight * quat.rotate_vector(quat.conjugate(orientation),
                                                          correction_world)
            omega = omega + correction_body
        dt = (v.timestamp_ms - prev_time) / 1000.0
        delta_q = quat.from_rotvec(omega * dt)
        orientation = quat.normalize(quat.multiply(orientation, delta_q))
        ts_out.append(int(v.timestamp_ms * 1000.0))
        qs_out.append(orientation)
        prev_time = v.timestamp_ms
    return TimeQuat(np.asarray(ts_out, np.int64), np.asarray(qs_out))


def integrate_complementary(imu_data: List[TimeIMU], duration_ms: float) -> TimeQuat:
    """mod.rs:61-106 driving ComplementaryFilterV2."""
    if not imu_data:
        return TimeQuat()
    sample_time_ms = duration_ms / len(imu_data)
    f = ComplementaryFilterV2()
    f.set_initial_settle_time(min(duration_ms / 1000.0 * 0.05, 2.0))
    prev_time = imu_data[0].timestamp_ms - sample_time_ms
    ts_out = []
    qs_out = []
    for v in imu_data:
        if v.gyro is None:
            continue
        g = v.gyro
        a = np.array(v.accl, dtype=np.float64) if v.accl is not None else np.zeros(3)
        if a[0] == 0.0 and a[1] == 0.0 and a[2] == 0.0:
            a[0] += 0.0000001
        acc = np.array([-a[1], a[0], a[2]])
        f.update(acc[0], acc[1], acc[2],
                 -g[1] * DEG2RAD, g[0] * DEG2RAD, g[2] * DEG2RAD,
                 (v.timestamp_ms - prev_time) / 1000.0)
        w, x, y, z = f.get_orientation()
        ts_out.append(int(v.timestamp_ms * 1000.0))
        qs_out.append(quat.normalize(np.array([w, x, y, z])))
        prev_time = v.timestamp_ms
    return TimeQuat(np.asarray(ts_out, np.int64), np.asarray(qs_out))


def _integrate_ahrs(imu_data: List[TimeIMU], duration_ms: float, update_fn) -> TimeQuat:
    if not imu_data:
        return TimeQuat()
    sample_time_s = duration_ms / 1000.0 / len(imu_data)
    q = _init_orientation()
    prev_time = imu_data[0].timestamp_ms - sample_time_s
    ts_out = []
    qs_out = []
    state = {}
    for v in imu_data:
        if v.gyro is None:
            continue
        g = v.gyro
        gyro = np.array([-g[1], g[0], g[2]]) * DEG2RAD
        a = np.array(v.accl, dtype=np.float64) if v.accl is not None else np.zeros(3)
        if a[0] == 0.0 and a[1] == 0.0 and a[2] == 0.0:
            a[0] += 0.0000001
        accl = np.array([-a[1], a[0], a[2]])
        dt = (v.timestamp_ms - prev_time) / 1000.0
        q2 = update_fn(q, gyro, accl, dt, state)
        if q2 is not None:
            q = q2
            ts_out.append(int(v.timestamp_ms * 1000.0))
            qs_out.append(q)
        prev_time = v.timestamp_ms
    return TimeQuat(np.asarray(ts_out, np.int64), np.asarray(qs_out))


def _mahony_update(q, gyro, accl, dt, state, kp=0.5, ki=0.0):
    """Mahony IMU update (matches the ahrs crate's update_imu)."""
    an = np.linalg.norm(accl)
    if an == 0.0:
        return None
    acc = accl / an
    # estimated gravity direction from quaternion (body frame)
    w, x, y, z = q
    v = np.array([2.0 * (x * z - w * y),
                  2.0 * (w * x + y * z),
                  w * w - x * x - y * y + z * z])
    e = np.cross(acc, v)
    if ki > 0.0:
        state["integral"] = state.get("integral", np.zeros(3)) + e * dt
        gyro = gyro + ki * state["integral"]
    gyro = gyro + kp * e
    qdot = 0.5 * quat.multiply(q, np.array([0.0, gyro[0], gyro[1], gyro[2]]))
    return quat.normalize(q + qdot * dt)


def _madgwick_update(q, gyro, accl, dt, state, beta=0.02):
    """Madgwick IMU update (matches the ahrs crate's update_imu)."""
    an = np.linalg.norm(accl)
    if an == 0.0:
        return None
    acc = accl / an
    w, x, y, z = q
    # gradient of objective function
    f = np.array([
        2.0 * (x * z - w * y) - acc[0],
        2.0 * (w * x + y * z) - acc[1],
        2.0 * (0.5 - x * x - y * y) - acc[2],
    ])
    J = np.array([
        [-2.0 * y, 2.0 * z, -2.0 * w, 2.0 * x],
        [2.0 * x, 2.0 * w, 2.0 * z, 2.0 * y],
        [0.0, -4.0 * x, -4.0 * y, 0.0],
    ])
    step = J.T @ f
    sn = np.linalg.norm(step)
    if sn > 0:
        step = step / sn
    qdot = 0.5 * quat.multiply(q, np.array([0.0, gyro[0], gyro[1], gyro[2]])) - beta * step
    return quat.normalize(q + qdot * dt)


def integrate_mahony(imu_data, duration_ms):
    return _integrate_ahrs(imu_data, duration_ms, _mahony_update)


def integrate_madgwick(imu_data, duration_ms):
    return _integrate_ahrs(imu_data, duration_ms, _madgwick_update)


def integrate_vqf(imu_data, duration_ms):
    from .vqf import integrate_vqf as _vqf
    return _vqf(imu_data, duration_ms)


INTEGRATORS = {
    1: integrate_complementary,
    2: integrate_vqf,
    3: integrate_simple_gyro,
    4: integrate_simple_gyro_accel,
    5: integrate_mahony,
    6: integrate_madgwick,
}


def quaternion_converter(method: int, org_quaternions: TimeQuat,
                         image_orientations: TimeQuat, imu_data, duration_ms) -> TimeQuat:
    """QuaternionConverter::convert (mod.rs:31-52): blend integrated horizon
    reference into camera-provided quats for GoPro horizon lock."""
    fn = {0: integrate_complementary, 1: integrate_vqf, 2: integrate_simple_gyro_accel,
          3: integrate_mahony, 4: integrate_madgwick}.get(method, integrate_vqf)
    integrated = fn(imu_data, duration_ms)
    boost = 1
    corr_sm = quat.identity()
    out_q = np.empty_like(org_quaternions.quats)
    its = integrated.timestamps_us
    iqs = integrated.quats
    iots = image_orientations.timestamps_us if image_orientations is not None else np.zeros(0, np.int64)
    ioqs = image_orientations.quats if image_orientations is not None else np.zeros((0, 4))
    for i, org_ts in enumerate(org_quaternions.timestamps_us):
        j = np.searchsorted(its, org_ts, side="left")
        n_quat = iqs[j] if j < len(its) else quat.identity()
        j2 = np.searchsorted(iots, org_ts, side="left")
        io_quat = ioqs[j2] if j2 < len(iots) else quat.identity()
        org_quat = org_quaternions.quats[i]
        corr = quat.multiply(n_quat, quat.inverse(
            quat.multiply(org_quat, quat.inverse(io_quat))))
        alpha = 1.0 if boost > 0 else 0.005
        boost = max(boost - 1, 0)
        corr_sm = quat.slerp(corr_sm, corr, alpha)
        out_q[i] = quat.multiply(corr_sm, org_quat)
    return TimeQuat(org_quaternions.timestamps_us.copy(), out_q)
