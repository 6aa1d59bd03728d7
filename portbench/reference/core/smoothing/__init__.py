"""Camera-path smoothing framework.

Port of gyroflow src/core/smoothing/mod.rs: algorithm registry in the
reference's order [None, Default, Plain, Fixed] (index is serialized by name in
projects — lib.rs:1699), trim-range-only slerp-hold, max-angle reporting, and
the Smoothing facade owning the HorizonLock.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .. import quaternion as quat
from ..time_quat import TimeQuat
from .base import SmoothingAlgorithm, ema_scan_f, slerp_scan
from .none_algo import NoSmoothing
from .plain import Plain
from .fixed import Fixed
from .default_algo import DefaultAlgo
from .horizon import HorizonLock

__all__ = ["Smoothing", "SmoothingAlgorithm", "NoSmoothing", "Plain", "Fixed",
           "DefaultAlgo", "HorizonLock", "get_trimmed_quats", "get_max_angles"]


def get_trimmed_quats(tq: TimeQuat, duration_ms: float, trim_range_only: bool,
                      trim_ranges: List[Tuple[float, float]]) -> TimeQuat:
    """Outside trim ranges, replace quats by slerp between range-edge quats
    (smoothing/mod.rs:120-159) so smoothing ignores out-of-range motion."""
    if not (trim_range_only and trim_ranges) or len(tq) == 0:
        return tq

    ts = tq.timestamps_us
    qs = tq.quats.copy()
    ranges = [(int(round(a * duration_ms * 1000.0)), int(round(b * duration_ms * 1000.0)))
              for a, b in trim_ranges]

    # boundary quats for each gap between/before/after ranges
    def quat_at_or_after(t):
        i = np.searchsorted(ts, t, side="left")
        return tq.quats[i] if i < len(ts) else None

    def quat_before(t):
        i = np.searchsorted(ts, t, side="left") - 1
        return tq.quats[i] if i >= 0 else None

    inside = np.zeros(len(ts), dtype=bool)
    for a, b in ranges:
        inside |= (ts >= a) & (ts <= b)

    # For each outside sample, find surrounding range edges and slerp/hold.
    # Before the first range: hold first range's start quat. After the last:
    # hold the quat just before last range end. Between ranges r and r+1:
    # slerp from last in-range quat of r to first of r+1 by time fraction.
    edges = []  # (gap_start_ts, gap_end_ts, q_prev, q_next)
    first_q = quat_at_or_after(ranges[0][0])
    if first_q is not None:
        mask = ts < ranges[0][0]
        qs[mask] = first_q
    for ri in range(len(ranges) - 1):
        a_end = ranges[ri][1]
        b_start = ranges[ri + 1][0]
        q_prev_i = np.searchsorted(ts, a_end, side="right") - 1
        q_prev = tq.quats[q_prev_i] if q_prev_i >= 0 else None
        q_next = quat_at_or_after(b_start)
        if q_prev is None or q_next is None:
            continue
        mask = (ts > a_end) & (ts < b_start)
        if mask.any():
            prev_ts = ts[q_prev_i]
            next_i = np.searchsorted(ts, b_start, side="left")
            next_ts = ts[next_i]
            denom = max(next_ts - prev_ts, 1)
            frac = (ts[mask] - prev_ts) / denom
            qs[mask] = quat.slerp(q_prev, q_next, frac)
    last_q = quat_before(ranges[-1][1])
    if last_q is not None:
        mask = ts > ranges[-1][1]
        qs[mask] = last_q
    return TimeQuat(ts, qs)


def get_max_angles(quats: TimeQuat, smoothed: TimeQuat, compute_params) -> Tuple[float, float, float]:
    """(pitch, yaw, roll) max deviation in degrees (smoothing/mod.rs:161-184)."""
    ranges = [(a * compute_params.scaled_duration_ms * 1000.0,
               b * compute_params.scaled_duration_ms * 1000.0)
              for a, b in compute_params.trim_ranges]
    ts = smoothed.timestamps_us
    within = np.ones(len(ts), dtype=bool)
    if ranges:
        within = np.zeros(len(ts), dtype=bool)
        for a, b in ranges:
            within |= (ts >= a) & (ts <= b)
    if not within.any() or len(quats) == 0:
        return (0.0, 0.0, 0.0)
    # align originals by timestamp (same grid in practice)
    org = quats.quats[np.searchsorted(quats.timestamps_us, ts[within]).clip(0, len(quats) - 1)]
    dist = quat.multiply(quat.inverse(smoothed.quats[within]), org)
    roll, pitch, yaw = quat.euler_angles(dist)
    r2d = 180.0 / math.pi
    return (float(np.abs(pitch).max()) * r2d, float(np.abs(yaw).max()) * r2d,
            float(np.abs(roll).max()) * r2d)


class Smoothing:
    """Registry + current algorithm + horizon lock (smoothing/mod.rs:48-117)."""

    def __init__(self):
        self.algs: List[SmoothingAlgorithm] = [NoSmoothing(), DefaultAlgo(), Plain(), Fixed()]
        self.current_id = 1
        self.horizon_lock = HorizonLock()

    def set_current(self, idx: int):
        self.current_id = min(idx, len(self.algs) - 1)

    @property
    def current(self) -> SmoothingAlgorithm:
        return self.algs[self.current_id]

    def get_names(self) -> List[str]:
        return [a.get_name() for a in self.algs]

    def get_state_checksum(self, gyro_checksum: int) -> int:
        return hash((gyro_checksum, self.current_id,
                     self.current.get_checksum(), self.horizon_lock.get_checksum()))

    def clone(self) -> "Smoothing":
        s = Smoothing()
        s.current_id = self.current_id
        for name, val in self.current.params().items():
            s.current.set_parameter(name, val)
        import copy
        s.horizon_lock = copy.copy(self.horizon_lock)
        return s
