"""VQF attitude filter — the reference's default integrator.

Faithful port of gyroflow src/core/imu_integration/vqf.rs (itself a port
of Laidig & Seel's VQF, https://github.com/dlaidig/vqf): realtime filter with
rest detection + gyro-bias Kalman estimation, and the offline variant
(forward+backward bias passes with covariance-weighted averaging, zero-phase
acc filtering) used by the integrator (imu_integration/mod.rs:113-146,
tau_acc=40, tau_mag=40).

Magnetometer samples of [0,0,0] are ignored (the reference always feeds zeros).
This is the designated C++ native hot loop; the Python version is the
correctness reference.
"""
from __future__ import annotations

import logging
import math
import sys
from dataclasses import dataclass, field

import numpy as np

from .. import quaternion as quat_np
from ..time_quat import TimeQuat

log = logging.getLogger(__name__)

EPS = sys.float_info.epsilon
DEG2RAD = math.pi / 180.0
M_PI = math.pi
M_SQRT2 = math.sqrt(2.0)
NAN = math.nan


@dataclass
class VQFParams:
    tau_acc: float = 3.0
    tau_mag: float = 9.0
    motion_bias_est_enabled: bool = True
    rest_bias_est_enabled: bool = True
    mag_dist_rejection_enabled: bool = True
    bias_sigma_init: float = 0.5
    bias_forgetting_time: float = 100.0
    bias_clip: float = 2.0
    bias_sigma_motion: float = 0.1
    bias_vertical_forgetting_factor: float = 0.0001
    bias_sigma_rest: float = 0.03
    rest_min_t: float = 1.5
    rest_filter_tau: float = 0.5
    rest_th_gyr: float = 2.0
    rest_th_acc: float = 0.5
    mag_current_tau: float = 0.05
    mag_ref_tau: float = 20.0
    mag_norm_th: float = 0.1
    mag_dip_th: float = 10.0
    mag_new_time: float = 20.0
    mag_new_first_time: float = 5.0
    mag_new_min_gyr: float = 20.0
    mag_min_undisturbed_time: float = 0.5
    mag_max_rejection_time: float = 60.0
    mag_rejection_factor: float = 2.0


# ---- scalar helpers (vqf.rs:717-930) ---------------------------------------

def quat_multiply(q1, q2):
    return [
        q1[0] * q2[0] - q1[1] * q2[1] - q1[2] * q2[2] - q1[3] * q2[3],
        q1[0] * q2[1] + q1[1] * q2[0] + q1[2] * q2[3] - q1[3] * q2[2],
        q1[0] * q2[2] - q1[1] * q2[3] + q1[2] * q2[0] + q1[3] * q2[1],
        q1[0] * q2[3] + q1[1] * q2[2] - q1[2] * q2[1] + q1[3] * q2[0],
    ]


def quat_rotate(q, v):
    return [
        (1 - 2 * q[2] * q[2] - 2 * q[3] * q[3]) * v[0] + 2 * v[1] * (q[2] * q[1] - q[0] * q[3]) + 2 * v[2] * (q[0] * q[2] + q[3] * q[1]),
        2 * v[0] * (q[0] * q[3] + q[2] * q[1]) + v[1] * (1 - 2 * q[1] * q[1] - 2 * q[3] * q[3]) + 2 * v[2] * (q[2] * q[3] - q[1] * q[0]),
        2 * v[0] * (q[3] * q[1] - q[0] * q[2]) + 2 * v[1] * (q[0] * q[1] + q[3] * q[2]) + v[2] * (1 - 2 * q[1] * q[1] - 2 * q[2] * q[2]),
    ]


def quat_apply_delta(q, delta):
    c = math.cos(delta / 2.0)
    s = math.sin(delta / 2.0)
    return [c * q[0] - s * q[3], c * q[1] - s * q[2], c * q[2] + s * q[1], c * q[3] + s * q[0]]


def norm(v, n):
    return math.sqrt(sum(v[i] * v[i] for i in range(n)))


def normalize(v, n):
    l = norm(v, n)
    if l < EPS:
        return
    for i in range(n):
        v[i] /= l


def clip(v, n, lo, hi):
    for i in range(n):
        v[i] = min(max(v[i], lo), hi)


def gain_from_tau(tau, ts):
    if tau < 0.0:
        return 0.0
    if tau == 0.0:
        return 1.0
    return 1.0 - math.exp(-ts / tau)


def filter_coeffs(tau, ts):
    fc = (M_SQRT2 / (2.0 * M_PI)) / tau
    c = math.tan(M_PI * fc * ts)
    d = c * c + M_SQRT2 * c + 1.0
    b0 = c * c / d
    b = [b0, 2.0 * b0, b0]
    a = [2.0 * (c * c - 1.0) / d, (1.0 - M_SQRT2 * c + c * c) / d]
    return b, a


def filter_initial_state(x0, b, a, state, off):
    state[off] = x0 * (1.0 - b[0])
    state[off + 1] = x0 * (b[2] - a[1])


def filter_step(x, b, a, state, off):
    y = b[0] * x + state[off]
    state[off] = b[1] * x - a[0] * y + state[off + 1]
    state[off + 1] = b[2] * x - a[1] * y
    return y


def filter_vec(x, n, tau, ts, b, a, state, out):
    """vqf.rs:847-877: averaging-based init then biquad steps."""
    if math.isnan(state[0]):
        if math.isnan(state[1]):
            state[1] = 0.0
            for i in range(n):
                state[2 + i] = 0.0
        state[1] += 1.0
        for i in range(n):
            state[2 + i] += x[i]
            out[i] = state[2 + i] / state[1]
        if state[1] * ts >= tau:
            for i in range(n):
                filter_initial_state(out[i], b, a, state, 2 * i)
        return
    for i in range(n):
        out[i] = filter_step(x[i], b, a, state, 2 * i)


def mat3_mult(m1, m2):
    return [m1[0]*m2[0]+m1[1]*m2[3]+m1[2]*m2[6], m1[0]*m2[1]+m1[1]*m2[4]+m1[2]*m2[7], m1[0]*m2[2]+m1[1]*m2[5]+m1[2]*m2[8],
            m1[3]*m2[0]+m1[4]*m2[3]+m1[5]*m2[6], m1[3]*m2[1]+m1[4]*m2[4]+m1[5]*m2[7], m1[3]*m2[2]+m1[4]*m2[5]+m1[5]*m2[8],
            m1[6]*m2[0]+m1[7]*m2[3]+m1[8]*m2[6], m1[6]*m2[1]+m1[7]*m2[4]+m1[8]*m2[7], m1[6]*m2[2]+m1[7]*m2[5]+m1[8]*m2[8]]


def mat3_mult_tps_first(m1, m2):
    return [m1[0]*m2[0]+m1[3]*m2[3]+m1[6]*m2[6], m1[0]*m2[1]+m1[3]*m2[4]+m1[6]*m2[7], m1[0]*m2[2]+m1[3]*m2[5]+m1[6]*m2[8],
            m1[1]*m2[0]+m1[4]*m2[3]+m1[7]*m2[6], m1[1]*m2[1]+m1[4]*m2[4]+m1[7]*m2[7], m1[1]*m2[2]+m1[4]*m2[5]+m1[7]*m2[8],
            m1[2]*m2[0]+m1[5]*m2[3]+m1[8]*m2[6], m1[2]*m2[1]+m1[5]*m2[4]+m1[8]*m2[7], m1[2]*m2[2]+m1[5]*m2[5]+m1[8]*m2[8]]


def mat3_mult_tps_second(m1, m2):
    return [m1[0]*m2[0]+m1[1]*m2[1]+m1[2]*m2[2], m1[0]*m2[3]+m1[1]*m2[4]+m1[2]*m2[5], m1[0]*m2[6]+m1[1]*m2[7]+m1[2]*m2[8],
            m1[3]*m2[0]+m1[4]*m2[1]+m1[5]*m2[2], m1[3]*m2[3]+m1[4]*m2[4]+m1[5]*m2[5], m1[3]*m2[6]+m1[4]*m2[7]+m1[5]*m2[8],
            m1[6]*m2[0]+m1[7]*m2[1]+m1[8]*m2[2], m1[6]*m2[3]+m1[7]*m2[4]+m1[8]*m2[5], m1[6]*m2[6]+m1[7]*m2[7]+m1[8]*m2[8]]


def mat3_inv(m):
    a = m[4]*m[8] - m[5]*m[7]
    d = m[2]*m[7] - m[1]*m[8]
    g = m[1]*m[5] - m[2]*m[4]
    b = m[5]*m[6] - m[3]*m[8]
    e = m[0]*m[8] - m[2]*m[6]
    h = m[2]*m[3] - m[0]*m[5]
    c = m[3]*m[7] - m[4]*m[6]
    f = m[1]*m[6] - m[0]*m[7]
    i = m[0]*m[4] - m[1]*m[3]
    det = m[0]*a + m[1]*b + m[2]*c
    if -EPS <= det <= EPS:
        return [0.0] * 9
    return [a/det, d/det, g/det, b/det, e/det, h/det, c/det, f/det, i/det]


def mat3_mult_vec(r, v):
    return [r[0]*v[0]+r[1]*v[1]+r[2]*v[2], r[3]*v[0]+r[4]*v[1]+r[5]*v[2], r[6]*v[0]+r[7]*v[1]+r[8]*v[2]]


# ---- realtime filter (vqf.rs:132-334) --------------------------------------

class VQF:
    def __init__(self, params: VQFParams, gyr_ts: float, acc_ts: float = 0.0):
        self.params = params
        self.gyr_ts = gyr_ts
        self.acc_ts = acc_ts if acc_ts > 0.0 else gyr_ts
        self.acc_lp_b, self.acc_lp_a = filter_coeffs(params.tau_acc, self.acc_ts)
        self.bias_p0 = (params.bias_sigma_init * 100.0) ** 2
        self.bias_v = (0.1 * 100.0) ** 2 * self.acc_ts / params.bias_forgetting_time
        p_motion = (params.bias_sigma_motion * 100.0) ** 2
        self.bias_motion_w = p_motion ** 2 / self.bias_v + p_motion
        self.bias_vertical_w = self.bias_motion_w / max(params.bias_vertical_forgetting_factor, 1e-10)
        p_rest = (params.bias_sigma_rest * 100.0) ** 2
        self.bias_rest_w = p_rest ** 2 / self.bias_v + p_rest
        self.rest_gyr_lp_b, self.rest_gyr_lp_a = filter_coeffs(params.rest_filter_tau, self.gyr_ts)
        self.rest_acc_lp_b, self.rest_acc_lp_a = filter_coeffs(params.rest_filter_tau, self.acc_ts)
        self.reset_state()

    def reset_state(self):
        self.gyr_quat = [1.0, 0.0, 0.0, 0.0]
        self.acc_quat = [1.0, 0.0, 0.0, 0.0]
        self.rest_detected = False
        self.last_acc_lp = [0.0] * 3
        self.acc_lp_state = [NAN] * 8
        self.bias = [0.0] * 3
        self.bias_p = [self.bias_p0, 0, 0, 0, self.bias_p0, 0, 0, 0, self.bias_p0]
        self.motion_bias_est_r_lp_state = [NAN] * 20
        self.motion_bias_est_bias_lp_state = [NAN] * 6
        self.rest_last_squared_deviations = [0.0, 0.0]
        self.rest_t = 0.0
        self.rest_last_gyr_lp = [NAN] * 3
        self.rest_gyr_lp_state = [NAN] * 8
        self.rest_last_acc_lp = [0.0] * 3
        self.rest_acc_lp_state = [NAN] * 8

    def update_gyr(self, gyr):
        p = self.params
        if p.rest_bias_est_enabled or p.mag_dist_rejection_enabled:
            filter_vec(gyr, 3, p.rest_filter_tau, self.gyr_ts, self.rest_gyr_lp_b,
                       self.rest_gyr_lp_a, self.rest_gyr_lp_state, self.rest_last_gyr_lp)
            lp = self.rest_last_gyr_lp
            self.rest_last_squared_deviations[0] = ((gyr[0] - lp[0]) ** 2 +
                                                    (gyr[1] - lp[1]) ** 2 +
                                                    (gyr[2] - lp[2]) ** 2)
            bias_clip = p.bias_clip * DEG2RAD
            if (self.rest_last_squared_deviations[0] >= (p.rest_th_gyr * DEG2RAD) ** 2
                    or abs(lp[0]) > bias_clip or abs(lp[1]) > bias_clip or abs(lp[2]) > bias_clip):
                self.rest_t = 0.0
                self.rest_detected = False

        g = [gyr[0] - self.bias[0], gyr[1] - self.bias[1], gyr[2] - self.bias[2]]
        gyr_norm = norm(g, 3)
        angle = gyr_norm * self.gyr_ts
        if gyr_norm > EPS:
            c = math.cos(angle / 2.0)
            s = math.sin(angle / 2.0) / gyr_norm
            self.gyr_quat = quat_multiply(self.gyr_quat, [c, s * g[0], s * g[1], s * g[2]])
            normalize(self.gyr_quat, 4)

    def get_quat6d(self):
        return quat_multiply(self.acc_quat, self.gyr_quat)

    def update_acc(self, acc):
        if acc[0] == 0.0 and acc[1] == 0.0 and acc[2] == 0.0:
            return
        p = self.params
        if p.rest_bias_est_enabled:
            filter_vec(acc, 3, p.rest_filter_tau, self.acc_ts, self.rest_acc_lp_b,
                       self.rest_acc_lp_a, self.rest_acc_lp_state, self.rest_last_acc_lp)
            lp = self.rest_last_acc_lp
            self.rest_last_squared_deviations[1] = ((acc[0] - lp[0]) ** 2 +
                                                    (acc[1] - lp[1]) ** 2 +
                                                    (acc[2] - lp[2]) ** 2)
            if self.rest_last_squared_deviations[1] >= p.rest_th_acc ** 2:
                self.rest_t = 0.0
                self.rest_detected = False
            else:
                self.rest_t += self.acc_ts
                if self.rest_t >= p.rest_min_t:
                    self.rest_detected = True

        acc_earth = quat_rotate(self.gyr_quat, acc)
        filter_vec(acc_earth, 3, p.tau_acc, self.acc_ts, self.acc_lp_b, self.acc_lp_a,
                   self.acc_lp_state, self.last_acc_lp)
        acc_earth = quat_rotate(self.acc_quat, self.last_acc_lp)
        normalize(acc_earth, 3)

        q_w = math.sqrt(max((acc_earth[2] + 1.0) / 2.0, 0.0))
        if q_w > 1e-6:
            acc_corr = [q_w, 0.5 * acc_earth[1] / q_w, -0.5 * acc_earth[0] / q_w, 0.0]
        else:
            acc_corr = [0.0, 1.0, 0.0, 0.0]
        self.acc_quat = quat_multiply(acc_corr, self.acc_quat)
        normalize(self.acc_quat, 4)

        if p.motion_bias_est_enabled or p.rest_bias_est_enabled:
            bias_clip = p.bias_clip * DEG2RAD
            q = self.get_quat6d()
            r = [1 - 2*q[2]*q[2] - 2*q[3]*q[3],
                 2*(q[2]*q[1] - q[0]*q[3]),
                 2*(q[0]*q[2] + q[3]*q[1]),
                 2*(q[0]*q[3] + q[2]*q[1]),
                 1 - 2*q[1]*q[1] - 2*q[3]*q[3],
                 2*(q[2]*q[3] - q[1]*q[0]),
                 2*(q[3]*q[1] - q[0]*q[2]),
                 2*(q[0]*q[1] + q[3]*q[2]),
                 1 - 2*q[1]*q[1] - 2*q[2]*q[2]]
            bias_lp = [r[0]*self.bias[0] + r[1]*self.bias[1] + r[2]*self.bias[2],
                       r[3]*self.bias[0] + r[4]*self.bias[1] + r[5]*self.bias[2]]
            r_in = list(r)
            filter_vec(r_in, 9, p.tau_acc, self.acc_ts, self.acc_lp_b, self.acc_lp_a,
                       self.motion_bias_est_r_lp_state, r)
            b_in = list(bias_lp)
            filter_vec(b_in, 2, p.tau_acc, self.acc_ts, self.acc_lp_b, self.acc_lp_a,
                       self.motion_bias_est_bias_lp_state, bias_lp)

            w = [0.0] * 3
            e = [0.0] * 3
            if self.rest_detected and p.rest_bias_est_enabled:
                for i in range(3):
                    e[i] = self.rest_last_gyr_lp[i] - self.bias[i]
                r = [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]
                w = [self.bias_rest_w] * 3
            elif p.motion_bias_est_enabled:
                e[0] = (-acc_earth[1] / self.acc_ts + bias_lp[0]
                        - r[0]*self.bias[0] - r[1]*self.bias[1] - r[2]*self.bias[2])
                e[1] = (acc_earth[0] / self.acc_ts + bias_lp[1]
                        - r[3]*self.bias[0] - r[4]*self.bias[1] - r[5]*self.bias[2])
                e[2] = -r[6]*self.bias[0] - r[7]*self.bias[1] - r[8]*self.bias[2]
                w = [self.bias_motion_w, self.bias_motion_w, self.bias_vertical_w]
            else:
                w = [-1.0] * 3

            for i in (0, 4, 8):
                if self.bias_p[i] < self.bias_p0:
                    self.bias_p[i] += self.bias_v
            if w[0] >= 0.0:
                clip(e, 3, -bias_clip, bias_clip)
                k = mat3_mult_tps_second(self.bias_p, r)
                k = mat3_mult(r, k)
                k[0] += w[0]; k[4] += w[1]; k[8] += w[2]
                k = mat3_inv(k)
                k = mat3_mult_tps_first(r, k)
                k = mat3_mult(self.bias_p, k)
                self.bias[0] += k[0]*e[0] + k[1]*e[1] + k[2]*e[2]
                self.bias[1] += k[3]*e[0] + k[4]*e[1] + k[5]*e[2]
                self.bias[2] += k[6]*e[0] + k[7]*e[1] + k[8]*e[2]
                k = mat3_mult(k, r)
                k = mat3_mult(k, self.bias_p)
                for i in range(9):
                    self.bias_p[i] -= k[i]
                clip(self.bias, 3, -bias_clip, bias_clip)

    def update(self, gyr, acc, mag=None):
        self.update_gyr(gyr)
        self.update_acc(acc)
        # nonzero magnetometer heading correction not yet ported (the
        # reference integrator always feeds zero mag, vqf mod.rs:126)


# ---- offline variant (vqf.rs:938-1241) -------------------------------------

def _lowpass_butter_filtfilt(acc_i: np.ndarray, ts: float, tau: float) -> np.ndarray:
    """Zero-phase forward+backward Butterworth with VQF's averaging init
    (vqf.rs:999-1022) — vectorized over the 3 channels."""
    n = acc_i.shape[0]
    b, a = filter_coeffs(tau, ts)
    out = acc_i.copy()

    # forward with averaging-based init
    state = [NAN] * 8
    y = [0.0] * 3
    for i in range(n):
        filter_vec(out[i], 3, tau, ts, b, a, state, y)
        out[i] = y
    # backward with initial state from last sample
    for j in range(3):
        filter_initial_state(out[n - 1, j], b, a, state, 2 * j)
    for i in range(n - 1, -1, -1):
        filter_vec(out[i], 3, tau, ts, b, a, state, y)
        out[i] = y
    return out


def offline_vqf(gyr: np.ndarray, acc: np.ndarray, n: int, ts: float,
                params: VQFParams) -> np.ndarray:
    """Returns (n, 4) quat6d array (w,x,y,z). gyr/acc are (n,3)."""
    bias = np.zeros((n, 3))
    bias_p_inv1 = [None] * n

    vqf = VQF(params, ts)
    for i in range(n):
        vqf.update(gyr[i], acc[i])
        bias[i] = vqf.bias
        bias_p_inv1[i] = mat3_inv(vqf.bias_p)

    vqf.reset_state()
    for i in range(n - 1, -1, -1):
        vqf.update([-gyr[i, 0], -gyr[i, 1], -gyr[i, 2]], acc[i])
        bias2 = list(vqf.bias)
        bias_p_inv2 = mat3_inv(vqf.bias_p)
        b1 = mat3_mult_vec(bias_p_inv1[i], bias[i])
        b2 = mat3_mult_vec(bias_p_inv2, bias2)
        diff = [b1[0] - b2[0], b1[1] - b2[1], b1[2] - b2[2]]
        psum = [bias_p_inv1[i][j] + bias_p_inv2[j] for j in range(9)]
        pinv = mat3_inv(psum)
        bias[i] = mat3_mult_vec(pinv, diff)

    # gyroscope integration with the blended bias (vqf.rs:984-997)
    quat3d = np.empty((n, 4))
    q = [1.0, 0.0, 0.0, 0.0]
    for i in range(n):
        g = [gyr[i, 0] - bias[i, 0], gyr[i, 1] - bias[i, 1], gyr[i, 2] - bias[i, 2]]
        gn = norm(g, 3)
        angle = gn * ts
        if gn > EPS:
            c = math.cos(angle / 2.0)
            s = math.sin(angle / 2.0) / gn
            q = quat_multiply(q, [c, s * g[0], s * g[1], s * g[2]])
            normalize(q, 4)
        quat3d[i] = q

    # transform acc to inertial frame (vectorized)
    acc_i = quat_np.rotate_vector(quat3d, acc)

    # zero-phase filter acc in inertial frame
    acc_i = _lowpass_butter_filtfilt(acc_i, ts, params.tau_acc)

    # inclination correction (vqf.rs:1024-1048)
    quat6d = np.empty((n, 4))
    acc_quat = [1.0, 0.0, 0.0, 0.0]
    for i in range(n):
        acc_earth = quat_rotate(acc_quat, acc_i[i])
        normalize(acc_earth, 3)
        q_w = math.sqrt(max((acc_earth[2] + 1.0) / 2.0, 0.0))
        if q_w > 1e-6:
            corr = [q_w, 0.5 * acc_earth[1] / q_w, -0.5 * acc_earth[0] / q_w, 0.0]
        else:
            corr = [0.0, 1.0, 0.0, 0.0]
        acc_quat = quat_multiply(corr, acc_quat)
        normalize(acc_quat, 4)
        quat6d[i] = quat_multiply(acc_quat, quat3d[i])
    return quat6d


def integrate_vqf(imu_data, duration_ms):
    """VQFIntegrator::integrate (imu_integration/mod.rs:113-146)."""
    if not imu_data:
        return TimeQuat()
    n = len(imu_data)
    sample_time = duration_ms / (n * 1000.0)
    gyr = np.zeros((n, 3))
    acc = np.zeros((n, 3))
    for i, v in enumerate(imu_data):
        g = v.gyro if v.gyro is not None else np.zeros(3)
        a = v.accl if v.accl is not None else np.zeros(3)
        gyr[i] = [-g[1] * DEG2RAD, g[0] * DEG2RAD, g[2] * DEG2RAD]
        acc[i] = [-a[1], a[0], a[2]]

    params = VQFParams(tau_acc=40.0, tau_mag=40.0)
    from ... import native as _native
    if _native.available():
        pv = np.asarray([params.tau_acc, params.bias_sigma_init,
                         params.bias_forgetting_time, params.bias_clip,
                         params.bias_sigma_motion, params.bias_vertical_forgetting_factor,
                         params.bias_sigma_rest, params.rest_min_t,
                         params.rest_filter_tau, params.rest_th_gyr, params.rest_th_acc,
                         1.0 if params.motion_bias_est_enabled else 0.0,
                         1.0 if params.rest_bias_est_enabled else 0.0])
        quat6d = _native.vqf_offline(gyr, acc, sample_time, pv)
    else:
        quat6d = offline_vqf(gyr, acc, n, sample_time, params)

    ts_out = np.asarray([int(v.timestamp_ms * 1000.0) for v in imu_data], np.int64)
    return TimeQuat(ts_out, quat_np.normalize(quat6d))
