"""Complementary attitude filter V2.

Port of gyroflow src/core/imu_integration/complementary_v2.rs (itself
derived from the imu_tools complementary filter): gyro prediction + adaptive
accel correction, steady-state bias estimation, gravity autoscale, initial
settle boost. Quaternion convention here: internal state q is the inverse
(fixed-wrt-body), as in the Rust source; ``get_orientation`` returns body-wrt-
fixed (w, x, y, z).
"""
from __future__ import annotations

import math

GRAVITY = 9.81
ANGULAR_VELOCITY_THRESHOLD = 0.01
ACCELERATION_THRESHOLD = 0.1
DELTA_ANGULAR_VELOCITY_THRESHOLD = 0.01
DELTA_ACCELERATION_THRESHOLD = 0.05
GRAV_AUTOSCALE_THRESHOLD = 1.0
ACC_FILT_TIMECONSTANT = 0.1
GRAV_AUTOSCALE_ALPHA = 0.005
STEADY_WAIT_THRESHOLD = 0.2


def _normalize_vec(x, y, z):
    n = math.sqrt(x * x + y * y + z * z)
    if math.isfinite(n) and n != 0.0:
        return x / n, y / n, z / n
    return x, y, z


def _normalize_quat(q0, q1, q2, q3):
    n = math.sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3)
    if math.isfinite(n) and n != 0.0:
        return q0 / n, q1 / n, q2 / n, q3 / n
    return q0, q1, q2, q3


def _invert(q0, q1, q2, q3):
    return q0, -q1, -q2, -q3


def _qmul(p0, p1, p2, p3, q0, q1, q2, q3):
    return (
        p0 * q0 - p1 * q1 - p2 * q2 - p3 * q3,
        p0 * q1 + p1 * q0 + p2 * q3 - p3 * q2,
        p0 * q2 - p1 * q3 + p2 * q0 + p3 * q1,
        p0 * q3 + p1 * q2 - p2 * q1 + p3 * q0,
    )


def _rotate_vec(x, y, z, q0, q1, q2, q3):
    """rotate_vector_by_quaternion (complementary_v2.rs:492-498)."""
    vx = (q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3) * x + 2.0 * (q1 * q2 - q0 * q3) * y + 2.0 * (q1 * q3 + q0 * q2) * z
    vy = 2.0 * (q1 * q2 + q0 * q3) * x + (q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3) * y + 2.0 * (q2 * q3 - q0 * q1) * z
    vz = 2.0 * (q1 * q3 - q0 * q2) * x + 2.0 * (q2 * q3 + q0 * q1) * y + (q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3) * z
    return vx, vy, vz


def _scale_quat(gain, dq0, dq1, dq2, dq3):
    """SLERP toward identity by gain (complementary_v2.rs:462-481)."""
    if dq0 < 0.0:
        dq0 = -dq0
        dq1, dq2, dq3 = -dq1, -dq2, -dq3
    if dq0 > 0.9995:  # lerp region
        q0 = (1.0 - gain) + gain * dq0
        q1, q2, q3 = gain * dq1, gain * dq2, gain * dq3
    else:
        angle = math.acos(min(max(dq0, -1.0), 1.0))
        a = math.sin(angle * (1.0 - gain)) / math.sin(angle)
        b = math.sin(angle * gain) / math.sin(angle)
        q0 = a + b * dq0
        q1, q2, q3 = b * dq1, b * dq2, b * dq3
    return _normalize_quat(q0, q1, q2, q3)


class ComplementaryFilterV2:
    def __init__(self):
        self.gain_acc = 0.0004
        self.prev_gain_acc = 0.0
        self.gain_mag = 0.0004
        self.bias_alpha = 0.001
        self.do_bias_estimation = True
        self.do_adaptive_gain = True
        self.do_gravity_autoscale = True
        self.gravity = GRAVITY
        self.initialized = False
        self.steady_state = False
        self.partial_steady_state = False
        self.q = (1.0, 0.0, 0.0, 0.0)
        self.a_filt = (0.0, 0.0, 0.0)
        self.a_prev = (0.0, 0.0, 0.0)
        self.w_prev = (0.0, 0.0, 0.0)
        self.w_bias = (0.0, 0.0, 0.0)
        self.time = 0.0
        self.time_steady = 0.0
        self.initial_settle_time = 2.0

    def set_initial_settle_time(self, t):
        self.initial_settle_time = t

    def set_orientation(self, q0, q1, q2, q3):
        self.q = _invert(q0, q1, q2, q3)

    def get_orientation(self):
        return _invert(*self.q)

    def update(self, ax, ay, az, wx, wy, wz, dt):
        if not self.initialized:
            self.q = self._get_measurement(ax, ay, az)
            self.a_filt = (ax, ay, az)
            self.a_prev = (ax, ay, az)
            self.initialized = True
            return
        axf, ayf, azf = self._filter_acc(ax, ay, az, dt)
        self.steady_state = self._check_state(ax, ay, az, wx, wy, wz)
        self.time_steady = self.time_steady + dt if self.steady_state else 0.0

        if self.do_bias_estimation:
            self._update_biases(wx, wy, wz)
        if self.do_gravity_autoscale:
            self._autoscale_gravity()

        pred = self._get_prediction(wx, wy, wz, dt)
        dq_acc = self._get_acc_correction(axf, ayf, azf, *pred)
        gain = self._get_adaptive_gain(self.gain_acc, axf, ayf, azf, dt)
        dq_acc = _scale_quat(gain, *dq_acc)
        self.q = _normalize_quat(*_qmul(*pred, *dq_acc))
        self.time += dt

    def _filter_acc(self, ax, ay, az, dt):
        a = 1.0 - math.exp(-dt / ACC_FILT_TIMECONSTANT)
        self.a_filt = (a * ax + (1 - a) * self.a_filt[0],
                       a * ay + (1 - a) * self.a_filt[1],
                       a * az + (1 - a) * self.a_filt[2])
        return self.a_filt

    def _update_biases(self, wx, wy, wz):
        if self.time_steady > STEADY_WAIT_THRESHOLD:
            self.w_bias = (self.w_bias[0] + self.bias_alpha * (wx - self.w_bias[0]),
                           self.w_bias[1] + self.bias_alpha * (wy - self.w_bias[1]),
                           self.w_bias[2] + self.bias_alpha * (wz - self.w_bias[2]))

    def _autoscale_gravity(self):
        if self.partial_steady_state:
            mag = math.sqrt(sum(v * v for v in self.a_filt))
            if abs(mag - GRAVITY) < GRAV_AUTOSCALE_THRESHOLD:
                self.gravity = self.gravity * (1.0 - GRAV_AUTOSCALE_ALPHA) + GRAV_AUTOSCALE_ALPHA * mag

    def _check_state(self, ax, ay, az, wx, wy, wz):
        acc_magnitude = math.sqrt(ax * ax + ay * ay + az * az)
        acc_th = abs(acc_magnitude - self.gravity) < ACCELERATION_THRESHOLD
        acc_component_steady = (abs(ax - self.a_filt[0]) < DELTA_ACCELERATION_THRESHOLD or
                                abs(ay - self.a_filt[1]) < DELTA_ACCELERATION_THRESHOLD or
                                abs(az - self.a_filt[2]) < DELTA_ACCELERATION_THRESHOLD)
        acc_delta_th = (abs(ax - self.a_prev[0]) < DELTA_ACCELERATION_THRESHOLD or
                        abs(ay - self.a_prev[1]) < DELTA_ACCELERATION_THRESHOLD or
                        abs(az - self.a_prev[2]) < DELTA_ACCELERATION_THRESHOLD)
        gyro_delta_th = (abs(wx - self.w_prev[0]) < DELTA_ANGULAR_VELOCITY_THRESHOLD or
                         abs(wy - self.w_prev[1]) < DELTA_ANGULAR_VELOCITY_THRESHOLD or
                         abs(wz - self.w_prev[2]) < DELTA_ANGULAR_VELOCITY_THRESHOLD)
        gyro_th = (abs(wx - self.w_bias[0]) < ANGULAR_VELOCITY_THRESHOLD or
                   abs(wy - self.w_bias[1]) < ANGULAR_VELOCITY_THRESHOLD or
                   abs(wz - self.w_bias[2]) < ANGULAR_VELOCITY_THRESHOLD)
        self.w_prev = (wx, wy, wz)
        self.a_prev = (ax, ay, az)
        self.partial_steady_state = acc_component_steady and acc_delta_th and gyro_delta_th and gyro_th
        return acc_th and self.partial_steady_state

    def _get_prediction(self, wx, wy, wz, dt):
        wxu = wx - self.w_bias[0]
        wyu = wy - self.w_bias[1]
        wzu = wz - self.w_bias[2]
        q0, q1, q2, q3 = self.q
        p0 = q0 + 0.5 * dt * (wxu * q1 + wyu * q2 + wzu * q3)
        p1 = q1 + 0.5 * dt * (-wxu * q0 - wyu * q3 + wzu * q2)
        p2 = q2 + 0.5 * dt * (wxu * q3 - wyu * q0 - wzu * q1)
        p3 = q3 + 0.5 * dt * (-wxu * q2 + wyu * q1 - wzu * q0)
        return _normalize_quat(p0, p1, p2, p3)

    def _get_measurement(self, ax, ay, az):
        ax, ay, az = _normalize_vec(ax, ay, az)
        if az >= 0.0:
            q0 = math.sqrt((az + 1.0) * 0.5)
            return (q0, -ay / (2.0 * q0), ax / (2.0 * q0), 0.0)
        x = math.sqrt((1.0 - az) * 0.5)
        return (-ay / (2.0 * x), x, 0.0, ax / (2.0 * x))

    def _get_acc_correction(self, ax, ay, az, p0, p1, p2, p3):
        ax, ay, az = _normalize_vec(ax, ay, az)
        gx, gy, gz = _rotate_vec(ax, ay, az, p0, -p1, -p2, -p3)
        dq0 = math.sqrt(max((gz + 1.0) * 0.5, 1e-30))
        return (dq0, -gy / (2.0 * dq0), gx / (2.0 * dq0), 0.0)

    def _get_adaptive_gain(self, alpha, ax, ay, az, dt):
        if not self.do_adaptive_gain:
            return alpha
        a_mag = math.sqrt(ax * ax + ay * ay + az * az)
        w_mag = math.sqrt(sum(v * v for v in self.w_prev))
        error = abs(a_mag - self.gravity) / self.gravity
        gain_iir_alpha = 1.0 - math.exp(-dt / 0.15)
        if self.time_steady > STEADY_WAIT_THRESHOLD:
            new_gain = 8.0 * alpha
        else:
            settle = max(15.0 - self.time / self.initial_settle_time * 14.0, 8.0) \
                if self.time < self.initial_settle_time else 1.0
            new_gain = math.exp(-40.0 * error - 1.0 * w_mag) * alpha * settle
        gain = new_gain if new_gain < self.prev_gain_acc else \
            gain_iir_alpha * new_gain + (1.0 - gain_iir_alpha) * self.prev_gain_acc
        self.prev_gain_acc = gain
        return gain
