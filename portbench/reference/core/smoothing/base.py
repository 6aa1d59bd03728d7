"""Smoothing algorithm base + sequential scan primitives.

The slerp-EMA chains are inherently sequential (each output feeds the next);
they run on host f64 like the reference (rayon has no parallelism there either
— default_algo.rs:338-387 is a serial fold). `slerp_scan`/`ema_scan_f` are the
shared primitives; a C++ drop-in for them is the planned native hot-loop.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .. import quaternion as quat


class SmoothingAlgorithm:
    """Mirror of the SmoothingAlgorithm trait (smoothing/mod.rs:21-32)."""

    def get_name(self) -> str:
        raise NotImplementedError

    def params(self) -> Dict[str, float]:
        raise NotImplementedError

    def set_parameter(self, name: str, val: float):
        if hasattr(self, name):
            cur = getattr(self, name)
            setattr(self, name, (val > 0.1) if isinstance(cur, bool) else val)

    def get_parameter(self, name: str) -> float:
        v = getattr(self, name, 0.0)
        return float(v) if not isinstance(v, bool) else (1.0 if v else 0.0)

    def get_checksum(self) -> int:
        return hash(tuple(sorted(self.params().items())))

    def smooth(self, tq, duration_ms: float, compute_params):
        raise NotImplementedError


def ema_scan_f(values: np.ndarray, alphas, reverse: bool = False) -> np.ndarray:
    """Sequential EMA: v[i] = v[i-1]*(1-a[i]) + x[i]*a[i], first kept as-is.

    values: (N,) or (N,C); alphas: scalar or (N,). Matches the reference's
    forward/backward velocity+distance smoothing loops (default_algo.rs:282-291).
    """
    from ... import native as _native
    if _native.available() and np.asarray(values).shape[0] > 2:
        return _native.ema_scan(np.asarray(values, dtype=np.float64), alphas, reverse)
    v = np.array(values, dtype=np.float64, copy=True)
    n = v.shape[0]
    if n == 0:
        return v
    a = np.broadcast_to(np.asarray(alphas, dtype=np.float64), (n,))
    idxs = range(n - 2, -1, -1) if reverse else range(1, n)
    prev = v[-1] if reverse else v[0]
    for i in idxs:
        prev = prev * (1.0 - a[i]) + v[i] * a[i]
        v[i] = prev
    return v


def slerp_scan(quats: np.ndarray, alphas, reverse: bool = False) -> np.ndarray:
    """Sequential slerp-EMA: q = slerp(q, x[i], a[i]); q0 = first element.

    quats: (N,4) f64. alphas: scalar or (N,) (clamped to <=1 by callers).
    """
    from ... import native as _native
    if _native.available() and np.asarray(quats).shape[0] > 2:
        return _native.slerp_scan(np.asarray(quats, dtype=np.float64), alphas, reverse)
    out = np.array(quats, dtype=np.float64, copy=True)
    n = out.shape[0]
    if n == 0:
        return out
    a = np.broadcast_to(np.asarray(alphas, dtype=np.float64), (n,))
    order = range(n - 2, -1, -1) if reverse else range(1, n)
    q = out[-1] if reverse else out[0]
    for i in order:
        q = quat.slerp(q, out[i], a[i])
        out[i] = q
    return out


def per_axis_scan(quats: np.ndarray, factors: np.ndarray, reverse: bool = False) -> np.ndarray:
    """Per-axis variant: q *= from_euler(euler(q^-1 * x) * factor) per sample.

    factors: (N,3) pitch/yaw/roll multipliers (already min'ed with 1).
    Matches default_algo.rs per_axis branches.
    """
    from ... import native as _native
    if _native.available() and np.asarray(quats).shape[0] > 2:
        return _native.per_axis_scan(np.asarray(quats, dtype=np.float64),
                                     np.asarray(factors, dtype=np.float64), reverse)
    out = np.array(quats, dtype=np.float64, copy=True)
    n = out.shape[0]
    if n == 0:
        return out
    order = range(n - 2, -1, -1) if reverse else range(1, n)
    q = out[-1] if reverse else out[0]
    for i in order:
        d = quat.multiply(quat.inverse(q), out[i])
        roll, pitch, yaw = quat.euler_angles(d)
        rot = quat.from_euler_xyz(roll * factors[i, 0], pitch * factors[i, 1],
                                  yaw * factors[i, 2])
        q = quat.multiply(q, rot)
        out[i] = q
    return out
