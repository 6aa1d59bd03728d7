"""Time-indexed quaternion series with vectorized slerp lookup.

Replaces the reference's ``TimeQuat = BTreeMap<i64 microseconds, UnitQuaternion<f64>>``
(gyroflow src/core/gyro_source/mod.rs:34) with a sorted int64-µs timestamp
array plus an (N, 4) float64 quaternion array. Lookup semantics match
``GyroSource::quat_at_timestamp`` (gyro_source/mod.rs:857-882): round the query to
µs, clamp to [first, last], bracket, slerp by the time fraction.

Being array-based rather than a tree means every per-row / per-frame lookup is one
vectorized ``searchsorted`` + batched slerp — this is what lets the rolling-shutter
row transforms be built as a single (H,) batch instead of the reference's
rayon-parallel per-row loop (frame_transform.rs:249).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import quaternion as quat


@dataclass
class TimeQuat:
    """Sorted timestamps in microseconds + unit quaternions (w,x,y,z)."""
    timestamps_us: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    quats: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), dtype=np.float64))

    def __post_init__(self):
        self.timestamps_us = np.asarray(self.timestamps_us, dtype=np.int64)
        self.quats = np.asarray(self.quats, dtype=np.float64).reshape(-1, 4)
        if self.timestamps_us.shape[0] != self.quats.shape[0]:
            raise ValueError("timestamps and quats must have the same length")

    def __len__(self) -> int:
        return int(self.timestamps_us.shape[0])

    def is_empty(self) -> bool:
        return len(self) == 0

    def copy(self) -> "TimeQuat":
        return TimeQuat(self.timestamps_us.copy(), self.quats.copy())

    @classmethod
    def from_dict(cls, d: dict) -> "TimeQuat":
        ts = np.fromiter(d.keys(), dtype=np.int64, count=len(d))
        order = np.argsort(ts, kind="stable")
        qs = np.asarray(list(d.values()), dtype=np.float64).reshape(-1, 4)
        return cls(ts[order], qs[order])

    def first_ts(self) -> int:
        return int(self.timestamps_us[0])

    def last_ts(self) -> int:
        return int(self.timestamps_us[-1])

    def at_timestamp(self, timestamp_ms) -> np.ndarray:
        """Vectorized quat lookup at video timestamp(s) in milliseconds.

        Returns identity if fewer than 2 samples (matching the reference guard).
        ``timestamp_ms`` may be a scalar or any-shape array; result is (...,4).
        """
        timestamp_ms = np.asarray(timestamp_ms, dtype=np.float64)
        if len(self) < 2:
            return np.broadcast_to(quat.identity(), timestamp_ms.shape + (4,)).copy()

        ts = self.timestamps_us
        lookup = np.rint(timestamp_ms * 1000.0).astype(np.int64)
        lookup = np.clip(lookup, ts[0], ts[-1])

        # index of the left bracket: largest i with ts[i] <= lookup
        i1 = np.searchsorted(ts, lookup, side="right") - 1
        i1 = np.clip(i1, 0, len(self) - 2)
        i2 = i1 + 1

        t1 = ts[i1]
        t2 = ts[i2]
        exact = t1 == lookup
        delta = (t2 - t1).astype(np.float64)
        delta = np.where(delta == 0.0, 1.0, delta)
        frac = (lookup - t1).astype(np.float64) / delta
        frac = np.where(exact, 0.0, frac)

        q1 = self.quats[i1]
        q2 = self.quats[i2]
        return quat.slerp(q1, q2, frac)

    def map_quats(self, fn) -> "TimeQuat":
        return TimeQuat(self.timestamps_us.copy(), fn(self.quats))


def interp_series(timestamps_us: np.ndarray, values: np.ndarray, timestamp_ms,
                  clamp_inner: bool = True):
    """Linear interpolation of a scalar series keyed by µs timestamps.

    Matches ``GyroSource::offset_at_timestamp`` (gyro_source/mod.rs:884-908):
    0 entries -> 0.0, 1 entry -> that value, else clamp query to
    [first+1, last-1] µs and linearly interpolate (the reference clamps the
    *lookup* key but interpolates with the unclamped query; we reproduce that).
    """
    timestamps_us = np.asarray(timestamps_us, dtype=np.int64)
    values = np.asarray(values, dtype=np.float64)
    t = np.asarray(timestamp_ms, dtype=np.float64)
    if len(timestamps_us) == 0:
        return np.zeros_like(t)
    if len(timestamps_us) == 1:
        return np.full_like(t, values[0])

    ts_us = (t * 1000.0).astype(np.int64)
    lookup = np.clip(ts_us, timestamps_us[0] + 1, timestamps_us[-1] - 1) if clamp_inner else ts_us
    i1 = np.searchsorted(timestamps_us, lookup, side="right") - 1
    i1 = np.clip(i1, 0, len(timestamps_us) - 2)
    i2 = i1 + 1
    t1 = timestamps_us[i1]
    t2 = timestamps_us[i2]
    exact = t1 == lookup
    delta = (t2 - t1).astype(np.float64)
    delta = np.where(delta == 0.0, 1.0, delta)
    frac = (ts_us - t1).astype(np.float64) / delta
    out = values[i1] + (values[i2] - values[i1]) * frac
    return np.where(exact, values[i1], out)
