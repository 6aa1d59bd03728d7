"""Gyro/quaternion pre-filters.

Port of gyroflow src/core/filtering.rs: 2nd-order Butterworth low-pass
(RBJ biquad, DirectForm2Transposed) run forward+backward over gyro/accel
channels and over raw quaternion components, and a moving-window median filter.
The quat glitch-repair (filtering.rs:163+) is a follow-up milestone (off by
default in the reference: IMUTransforms::glitch_filter = false).
"""
from __future__ import annotations

import bisect
import math
from collections import deque
from typing import List

import numpy as np

from .file_metadata import TimeIMU
from .time_quat import TimeQuat

Q_BUTTERWORTH = 1.0 / math.sqrt(2.0)


class Biquad:
    """RBJ low-pass biquad, DirectForm2Transposed (matches the biquad crate)."""

    def __init__(self, freq: float, sample_rate: float):
        if freq <= 0.0 or freq * 2.0 >= sample_rate:
            raise ValueError("invalid cutoff frequency")
        omega = 2.0 * math.pi * freq / sample_rate
        cos_o = math.cos(omega)
        alpha = math.sin(omega) / (2.0 * Q_BUTTERWORTH)
        a0 = 1.0 + alpha
        self.b0 = ((1.0 - cos_o) / 2.0) / a0
        self.b1 = (1.0 - cos_o) / a0
        self.b2 = self.b0
        self.a1 = (-2.0 * cos_o) / a0
        self.a2 = (1.0 - alpha) / a0
        self.s1 = 0.0
        self.s2 = 0.0

    def run(self, x: float) -> float:
        y = self.b0 * x + self.s1
        self.s1 = self.b1 * x - self.a1 * y + self.s2
        self.s2 = self.b2 * x - self.a2 * y
        return y

    def run_array(self, xs: np.ndarray) -> np.ndarray:
        out = np.empty_like(xs)
        b0, b1, b2, a1, a2 = self.b0, self.b1, self.b2, self.a1, self.a2
        s1, s2 = self.s1, self.s2
        for i in range(len(xs)):
            x = xs[i]
            y = b0 * x + s1
            s1 = b1 * x - a1 * y + s2
            s2 = b2 * x - a2 * y
            out[i] = y
        self.s1, self.s2 = s1, s2
        return out


def lowpass_gyro_forward_backward(freq: float, sample_rate: float,
                                  data: List[TimeIMU]) -> None:
    """filtering.rs:43-71 — in-place, separate filter states per channel/direction."""
    if freq <= 0.0 or freq * 2.0 >= sample_rate:
        return
    for is_rev in (False, True):
        filters = [Biquad(freq, sample_rate) for _ in range(6)]
        order = reversed(data) if is_rev else iter(data)
        for x in order:
            if x.gyro is not None:
                for c in range(3):
                    x.gyro[c] = filters[c].run(float(x.gyro[c]))
            if x.accl is not None:
                for c in range(3):
                    x.accl[c] = filters[3 + c].run(float(x.accl[c]))


def lowpass_quats_forward_backward(freq: float, sample_rate: float,
                                   tq: TimeQuat) -> TimeQuat:
    """filtering.rs:72-94: filter raw (x,y,z,w) coords then renormalize.

    nalgebra coords order is (x, y, z, w); four channels, f64."""
    if freq <= 0.0 or freq * 2.0 >= sample_rate:
        return tq
    coords = np.stack([tq.quats[:, 1], tq.quats[:, 2], tq.quats[:, 3], tq.quats[:, 0]],
                      axis=-1)
    for is_rev in (False, True):
        filters = [Biquad(freq, sample_rate) for _ in range(4)]
        sl = coords[::-1] if is_rev else coords
        for c in range(4):
            sl[:, c] = filters[c].run_array(sl[:, c])
    out = np.stack([coords[:, 3], coords[:, 0], coords[:, 1], coords[:, 2]], axis=-1)
    n = np.linalg.norm(out, axis=-1, keepdims=True)
    n = np.where(n == 0, 1.0, n)
    return TimeQuat(tq.timestamps_us.copy(), out / n)


class MovingMedian:
    """Streaming moving-window median (matches the median crate's Filter)."""

    def __init__(self, size: int):
        self.size = max(size, 1)
        self.window = deque()
        self.sorted: list = []

    def consume(self, x: float) -> float:
        self.window.append(x)
        bisect.insort(self.sorted, x)
        if len(self.window) > self.size:
            old = self.window.popleft()
            del self.sorted[bisect.bisect_left(self.sorted, old)]
        n = len(self.sorted)
        mid = n // 2
        if n % 2 == 1:
            return self.sorted[mid]
        return (self.sorted[mid - 1] + self.sorted[mid]) / 2.0


def median_gyro_forward_backward(size: int, sample_rate: float,
                                 data: List[TimeIMU]) -> None:
    """filtering.rs:131-160."""
    if size <= 0:
        return
    for is_rev in (False, True):
        filters = [MovingMedian(size) for _ in range(6)]
        order = reversed(data) if is_rev else iter(data)
        for x in order:
            if x.gyro is not None:
                for c in range(3):
                    x.gyro[c] = filters[c].consume(float(x.gyro[c]))
            if x.accl is not None:
                for c in range(3):
                    x.accl[c] = filters[3 + c].consume(float(x.accl[c]))


# ---------------------------------------------------------------------------
# Quaternion glitch repair (filtering.rs:163-417)
# ---------------------------------------------------------------------------

from dataclasses import dataclass

from . import quaternion as _quat


@dataclass
class GlitchRepairParams:
    """filtering.rs:164-207."""
    residual_window: float = 0.04
    threshold_multiplier: float = 1.5
    absolute_floor: float = 195.0
    merge_gap: float = 0.5
    expand_multiplier: float = 1.15
    quiet_duration: float = 0.05
    smoothing_window: float = 0.01
    max_duration: float = 2.5
    force_long_regions: bool = False
    passes: int = 2

    @classmethod
    def from_strength(cls, s: float) -> "GlitchRepairParams":
        # The reference UI slider bounds strength to [0, 100]; clamp here too —
        # an unclamped project-file value would scale `passes` without bound.
        s = min(max(s, 0.0), 100.0)
        p = cls()
        p.absolute_floor = 195.0 * 2.0 ** ((50.0 - s) / 30.0)
        p.max_duration = 0.75 + s * 0.015
        p.passes = max(1 + int(s // 33.0), 1)
        return p


def _moving_average(values: np.ndarray, window: int) -> np.ndarray:
    n = len(values)
    if window < 1:
        return values.copy()
    half = window // 2
    csum = np.concatenate([[0.0], np.cumsum(values)])
    lo = np.maximum(np.arange(n) - half, 0)
    hi = np.minimum(np.arange(n) + half, n - 1)
    return (csum[hi + 1] - csum[lo]) / (hi - lo + 1)


def _residual_magnitudes(times: np.ndarray, quats: np.ndarray,
                         smoothing_window_s: float) -> np.ndarray:
    """filtering.rs:268-291: deviation of angular velocity from its local trend."""
    n = len(times)
    dt = 0.0005
    for i in range(1, min(n, 50)):
        d = times[i] - times[i - 1]
        if d > 0:
            dt = d
            break
    window = max(3, int(round(smoothing_window_s / dt)))
    if window % 2 == 0:
        window += 1

    g = np.zeros((n, 3))
    dts = np.diff(times)
    rel = _quat.multiply(quats[1:], _quat.inverse(quats[:-1]))
    rv = _quat.to_rotvec(rel) * (180.0 / math.pi)
    nz = dts > 0
    g[1:][nz] = rv[nz] / dts[nz][:, None]
    s = np.stack([_moving_average(g[:, k], window) for k in range(3)], axis=1)
    return np.linalg.norm(g - s, axis=1)


def _rolling_max(mags, times, i, half_window_s):
    n = len(mags)
    lo = i
    while lo > 0 and times[lo - 1] >= times[i] - half_window_s:
        lo -= 1
    hi = i
    while hi < n - 1 and times[hi + 1] <= times[i] + half_window_s:
        hi += 1
    return mags[lo:hi + 1].max()


def _expand_region(times, mags, lo, hi, expand_threshold, quiet_duration,
                   smoothing_window):
    """filtering.rs:306-337."""
    n = len(times)
    half = smoothing_window / 2.0
    i = lo
    quiet_since = None
    while i > 0:
        i -= 1
        if _rolling_max(mags, times, i, half) > expand_threshold:
            quiet_since = None
            lo = i
        else:
            if quiet_since is None:
                quiet_since = times[i]
            if quiet_since - times[i] >= quiet_duration:
                break
    j = hi
    quiet_since = None
    while j < n - 1:
        j += 1
        if _rolling_max(mags, times, j, half) > expand_threshold:
            quiet_since = None
            hi = j
        else:
            if quiet_since is None:
                quiet_since = times[j]
            if times[j] - quiet_since >= quiet_duration:
                break
    return lo, hi


def _detect_bad_regions(times, mags, p: GlitchRepairParams):
    """filtering.rs:339-394."""
    baseline = float(np.percentile(mags, 99))
    threshold = max(baseline * p.threshold_multiplier, p.absolute_floor)
    expand_threshold = max(baseline * p.expand_multiplier,
                           p.absolute_floor * p.expand_multiplier / p.threshold_multiplier)
    flagged = np.nonzero(mags > threshold)[0]
    if len(flagged) == 0:
        return [], []
    cores = []
    start = prev = flagged[0]
    for i in flagged[1:]:
        if times[i] - times[prev] > p.merge_gap:
            cores.append((start, prev))
            start = i
        prev = i
    cores.append((start, prev))

    accepted, suspicious = [], []
    for lo, hi in cores:
        dur = times[hi] - times[lo]
        if dur > p.max_duration and not p.force_long_regions:
            suspicious.append((lo, hi, dur))
        else:
            accepted.append((lo, hi))
    if not accepted:
        return [], suspicious
    expanded = [_expand_region(times, mags, lo, hi, expand_threshold,
                               p.quiet_duration, p.smoothing_window)
                for lo, hi in accepted]
    merged = [expanded[0]]
    for lo, hi in expanded[1:]:
        if lo <= merged[-1][1] + 1:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged, suspicious


def repair_quats(tq: TimeQuat, params: GlitchRepairParams) -> int:
    """GlitchRepair::repair_quats (filtering.rs:210-242), in place on tq."""
    n = len(tq)
    if n < 8:
        return 0
    times = tq.timestamps_us.astype(np.float64) / 1_000_000.0
    quats = tq.quats
    total = 0
    for _ in range(max(params.passes, 1)):
        mags = _residual_magnitudes(times, quats, params.residual_window)
        regions, suspicious = _detect_bad_regions(times, mags, params)
        for lo, hi, dur in suspicious:
            import logging
            logging.getLogger(__name__).debug(
                "Glitch repair: region [%.3f, %.3f] (dur %.3f) left as real motion",
                times[lo], times[hi], dur)
        if not regions:
            break
        for lo, hi in regions:
            if lo == 0 and hi + 1 >= n:
                continue
            if lo == 0 or hi + 1 >= n:
                anchor = quats[hi + 1] if lo == 0 else quats[lo - 1]
                quats[lo:hi + 1] = anchor
            else:
                t0, t1 = times[lo - 1], times[hi + 1]
                span = t1 - t0
                frac = np.clip((times[lo:hi + 1] - t0) / span, 0.0, 1.0) \
                    if span > 0 else np.zeros(hi - lo + 1)
                quats[lo:hi + 1] = _quat.slerp(quats[lo - 1], quats[hi + 1], frac)
            total += hi - lo + 1
    return total
