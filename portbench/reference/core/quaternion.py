"""Vectorized quaternion math on numpy float64 arrays.

Convention: quaternions are arrays of shape ``(..., 4)`` ordered ``(w, x, y, z)``,
matching nalgebra's ``Quaternion::new(w, x, y, z)`` used throughout the reference
engine (e.g. gyroflow src/core/gyro_source/mod.rs).

TPU note: the reference does all orientation math in f64 (TPU has no f64), so this
module is the *host-side* engine — integration, smoothing and per-frame transform
construction run here once per recompute; only the resulting f32 row matrices are
shipped to the device (same split the reference uses for its GPUs).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "identity", "normalize", "conjugate", "inverse", "multiply", "rotate_vector",
    "from_axis_angle", "from_rotvec", "to_rotvec", "from_euler_xyz",
    "to_rotation_matrix", "from_rotation_matrix", "slerp", "slerp_shortest",
    "angle_between", "angle_of", "dot",
]


def identity(shape=()) -> np.ndarray:
    q = np.zeros(tuple(shape) + (4,), dtype=np.float64)
    q[..., 0] = 1.0
    return q


def normalize(q: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    n = np.where(n == 0.0, 1.0, n)
    return q / n


def conjugate(q: np.ndarray) -> np.ndarray:
    out = np.array(q, copy=True)
    out[..., 1:] *= -1.0
    return out


def inverse(q: np.ndarray) -> np.ndarray:
    """Inverse of unit quaternion(s) == conjugate."""
    return conjugate(q)


def dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, axis=-1)


def multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product a*b (apply b's rotation first, then a, for column vectors)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def rotate_vector(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) v of shape (...,3) by unit quaternion(s) q."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def from_axis_angle(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    angle = np.asarray(angle, dtype=np.float64)
    n = np.linalg.norm(axis, axis=-1, keepdims=True)
    n = np.where(n == 0.0, 1.0, n)
    u = axis / n
    half = angle / 2.0
    s = np.sin(half)
    return np.concatenate([np.cos(half)[..., None], u * s[..., None]], axis=-1)


def from_rotvec(rv: np.ndarray) -> np.ndarray:
    """Exponential map: rotation vector (axis*angle, rad) -> unit quaternion."""
    rv = np.asarray(rv, dtype=np.float64)
    angle = np.linalg.norm(rv, axis=-1)
    half = angle / 2.0
    # sin(x)/x stable around 0
    small = angle < 1e-9
    k = np.where(small, 0.5 - angle * angle / 48.0, np.sin(half) / np.where(small, 1.0, angle))
    return np.concatenate([np.cos(half)[..., None], rv * k[..., None]], axis=-1)


def to_rotvec(q: np.ndarray) -> np.ndarray:
    """Log map: unit quaternion -> rotation vector (axis*angle, rad), w>=0 branch."""
    q = np.asarray(q, dtype=np.float64)
    q = np.where(q[..., 0:1] < 0.0, -q, q)
    w = np.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    n = np.linalg.norm(v, axis=-1)
    angle = 2.0 * np.arctan2(n, w)
    small = n < 1e-9
    scale = np.where(small, 2.0 / np.where(w == 0, 1.0, w), angle / np.where(small, 1.0, n))
    return v * scale[..., None]


def from_euler_xyz(roll_x: np.ndarray, pitch_y: np.ndarray, yaw_z: np.ndarray) -> np.ndarray:
    """Intrinsic rotations applied as Rz*Ry*Rx (nalgebra ``from_euler_angles`` order)."""
    qx = from_axis_angle(np.array([1.0, 0, 0]), np.asarray(roll_x, dtype=np.float64))
    qy = from_axis_angle(np.array([0, 1.0, 0]), np.asarray(pitch_y, dtype=np.float64))
    qz = from_axis_angle(np.array([0, 0, 1.0]), np.asarray(yaw_z, dtype=np.float64))
    return multiply(qz, multiply(qy, qx))


def to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion(s) -> rotation matrix/matrices of shape (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    m[..., 0, 0] = 1 - 2 * (yy + zz)
    m[..., 0, 1] = 2 * (xy - wz)
    m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz)
    m[..., 1, 1] = 1 - 2 * (xx + zz)
    m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy)
    m[..., 2, 1] = 2 * (yz + wx)
    m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def from_rotation_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix/matrices (...,3,3) -> unit quaternion(s), Shepperd's method."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m, axis1=-2, axis2=-1)
    q = np.empty(m.shape[:-2] + (4,), dtype=np.float64)

    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    # branchless: compute all four candidate solutions, pick the best-conditioned
    cand = np.stack([
        1.0 + t,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], axis=-1)
    best = np.argmax(cand, axis=-1)
    s = np.sqrt(np.maximum(np.take_along_axis(cand, best[..., None], axis=-1)[..., 0], 1e-30)) * 2.0

    w0 = s / 4.0
    x0 = (m[..., 2, 1] - m[..., 1, 2]) / s
    y0 = (m[..., 0, 2] - m[..., 2, 0]) / s
    z0 = (m[..., 1, 0] - m[..., 0, 1]) / s

    w1 = (m[..., 2, 1] - m[..., 1, 2]) / s
    x1 = s / 4.0
    y1 = (m[..., 0, 1] + m[..., 1, 0]) / s
    z1 = (m[..., 0, 2] + m[..., 2, 0]) / s

    w2 = (m[..., 0, 2] - m[..., 2, 0]) / s
    x2 = (m[..., 0, 1] + m[..., 1, 0]) / s
    y2 = s / 4.0
    z2 = (m[..., 1, 2] + m[..., 2, 1]) / s

    w3 = (m[..., 1, 0] - m[..., 0, 1]) / s
    x3 = (m[..., 0, 2] + m[..., 2, 0]) / s
    y3 = (m[..., 1, 2] + m[..., 2, 1]) / s
    z3 = s / 4.0

    ws = np.stack([w0, w1, w2, w3], axis=-1)
    xs = np.stack([x0, x1, x2, x3], axis=-1)
    ys = np.stack([y0, y1, y2, y3], axis=-1)
    zs = np.stack([z0, z1, z2, z3], axis=-1)
    bi = best[..., None]
    q[..., 0] = np.take_along_axis(ws, bi, axis=-1)[..., 0]
    q[..., 1] = np.take_along_axis(xs, bi, axis=-1)[..., 0]
    q[..., 2] = np.take_along_axis(ys, bi, axis=-1)[..., 0]
    q[..., 3] = np.take_along_axis(zs, bi, axis=-1)[..., 0]
    return normalize(q)


def slerp(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical linear interpolation WITHOUT hemisphere flipping.

    Matches nalgebra's ``UnitQuaternion::slerp`` (used by the reference's quat
    lookup, gyro_source/mod.rs:857-882): interpolates along the actual arc between
    a and b, falling back to nlerp when nearly parallel or nearly antipodal.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    d = np.clip(np.sum(a * b, axis=-1), -1.0, 1.0)
    theta = np.arccos(d)
    sin_theta = np.sin(theta)
    degenerate = np.abs(sin_theta) < 1e-9
    safe_sin = np.where(degenerate, 1.0, sin_theta)
    wa = np.where(degenerate, 1.0 - t, np.sin((1.0 - t) * theta) / safe_sin)
    wb = np.where(degenerate, t, np.sin(t * theta) / safe_sin)
    return normalize(a * wa[..., None] + b * wb[..., None])


def slerp_shortest(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Slerp with hemisphere flip (shortest path in SO(3))."""
    b = np.asarray(b, dtype=np.float64)
    d = np.sum(np.asarray(a) * b, axis=-1)
    b = np.where(d[..., None] < 0.0, -b, b)
    return slerp(a, b, t)


def angle_of(q: np.ndarray) -> np.ndarray:
    """Rotation angle (rad) of unit quaternion(s), in [0, pi].

    atan2 form, matching nalgebra's UnitQuaternion::angle."""
    w = np.abs(q[..., 0])
    n = np.linalg.norm(q[..., 1:], axis=-1)
    return 2.0 * np.arctan2(n, w)


def euler_angles(q: np.ndarray):
    """(roll_x, pitch_y, yaw_z) such that R = Rz(yaw) @ Ry(pitch) @ Rx(roll).

    Matches nalgebra's Rotation3::euler_angles (Slabaugh's method)."""
    m = to_rotation_matrix(q)
    m20 = np.clip(m[..., 2, 0], -1.0, 1.0)
    gimbal = np.abs(m20) >= 1.0 - 1e-12
    pitch = -np.arcsin(m20)
    roll = np.arctan2(m[..., 2, 1], m[..., 2, 2])
    yaw = np.arctan2(m[..., 1, 0], m[..., 0, 0])
    # gimbal lock: nalgebra picks yaw = 0
    roll_g = np.arctan2(-m[..., 1, 2], m[..., 1, 1])
    roll = np.where(gimbal, roll_g, roll)
    yaw = np.where(gimbal, 0.0, yaw)
    pitch = np.where(gimbal, np.where(m20 < 0, np.pi / 2, -np.pi / 2), pitch)
    return roll, pitch, yaw


def angle_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return angle_of(multiply(inverse(a), b))
