"""Optimal sync-point picker via STFT of gyro magnitude.

Port of synchronization/optimsync.rs: resample gyro to a uniform grid,
sliding exact-Blackman-windowed FFT (window = 1s of samples, step 16
samples), per-window band energies LF [0,2) / MF [2,30) / HF [30,2000) Hz
summed over the three axes, rank = MF penalized by HF and LF (or LF+MF for
low-motion clips), non-maximum suppression with an 8-second radius, then one
peak per equal time segment.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


def blackman_exact(width: int) -> np.ndarray:
    """optimsync.rs:15-27 ('exact Blackman' coefficients)."""
    a0, a1, a2 = 7938.0 / 18608.0, 9240.0 / 18608.0, 1430.0 / 18608.0
    n = np.arange(width, dtype=np.float32)
    size = width - 1
    return (a0 - a1 * np.cos(2 * np.pi * n / size)
            + a2 * np.cos(4 * np.pi * n / size)).astype(np.float32)


def nlfunc(arg: np.ndarray, trip_point: float) -> np.ndarray:
    """optimsync.rs:229-235."""
    return np.where(arg < trip_point, 0.0, arg - trip_point)


class OptimSync:
    def __init__(self, raw_imu: list):
        """optimsync.rs:29-67: uniform-grid resample at the average rate."""
        samples = [(v.timestamp_ms, v.gyro) for v in raw_imu if v.gyro is not None]
        if len(samples) < 4:
            raise ValueError("not enough gyro samples")
        ts = np.asarray([s[0] for s in samples])
        gyr = np.asarray([s[1] for s in samples], np.float64)
        duration_ms = ts[-1] - ts[0]
        if duration_ms <= 0:
            raise ValueError("zero-duration gyro")
        self.sample_rate = len(samples) / duration_ms * 1000.0
        n = int(duration_ms * self.sample_rate / 1000.0)
        grid = np.arange(n) * 1000.0 / self.sample_rate
        self.gyro = np.stack([np.interp(grid, ts - ts[0], gyr[:, j])
                              for j in range(3)])  # (3, N)

    def run(self, target_sync_points: int,
            trim_ranges_s: List[Tuple[float, float]]) -> Tuple[List[float], np.ndarray, float]:
        """optimsync.rs:69-226 — returns (sync points ms, rank, step seconds)."""
        sr = self.sample_rate
        step = 16
        nms_radius = int((sr / 16.0 / 2.0) * 8.0)
        fft_size = int(round(sr))
        if self.gyro.shape[1] < fft_size or fft_size < 4:
            return [], np.zeros(0, np.float32), step / sr
        scale = math.sqrt(1.0 / fft_size) / fft_size * 256.0
        win = blackman_exact(fft_size)

        half = fft_size // 2
        n_wins = (self.gyro.shape[1] - fft_size) // step + 1
        idx = np.arange(fft_size)[None, :] + step * np.arange(n_wins)[:, None]
        merged = np.zeros((n_wins, half), np.float32)
        for ch in range(3):
            chunks = self.gyro[ch][idx].astype(np.float32) * win[None, :]
            cm = np.fft.fft(chunks, axis=1)
            # zip(cm, cm.rev()).take(N/2): pair bin i with bin N-1-i
            spec = np.abs(cm[:, :half] + cm[:, ::-1][:, :half]).astype(np.float32) * scale
            merged += spec

        def bin_of(freq):
            return int(min(max(round(fft_size / sr * freq), 0), half - 1))

        def band(lo, hi):
            return merged[:, bin_of(lo):bin_of(hi)].sum(axis=1)

        lf, mf, hf = band(0.0, 2.0), band(2.0, 30.0), band(30.0, 2000.0)
        low_motion = (mf.max(initial=0.0) < 50.0)
        if low_motion:
            rank = (lf + mf) / (1.0 + nlfunc(hf, 450.0) * 0.003)
        else:
            rank = mf / (1.0 + nlfunc(hf, 450.0) * 0.003) / (1.0 + nlfunc(lf, 650.0) * 0.003)
        rank_full = rank.copy()

        ratio = step / sr
        times = np.arange(len(rank)) * ratio
        in_trim = np.zeros(len(rank), bool)
        for a, b in trim_ranges_s:
            in_trim |= (times >= a) & (times <= b)
        rank[(rank < 50.0) | ~in_trim] = 0.0
        total = len(rank) * ratio
        if total > 12.0:
            rank[(times < 2.0) | (times >= total - 2.0)] = 0.0

        # NMS (optimsync.rs:172-179): zero every sample strictly dominated
        # inside the radius of another
        rank_nms = rank.copy()
        order = np.argsort(rank)[::-1]
        for i in order:
            if rank[i] <= 0.0:
                break
            lo, hi = max(i - nms_radius, 0), min(i + nms_radius, len(rank) - 1)
            seg = rank[lo:hi]
            rank_nms[lo:hi] = np.where(seg < rank[i], 0.0, rank_nms[lo:hi])

        seg_size = (len(rank_nms) + target_sync_points - 1) // target_sync_points
        points = []
        for i in range(target_sync_points):
            a = i * seg_size
            b = min(a + seg_size, len(rank_nms))
            if a >= b:
                continue
            j = a + int(np.argmax(rank_nms[a:b]))
            if rank_nms[j] >= 0.1:
                points.append((j * step + fft_size / 2.0) / sr * 1000.0)
        return points, rank_full, ratio


def pick_sync_points_fft(raw_imu: list, duration_ms: float, count: int,
                         trim_ranges: Optional[List[Tuple[float, float]]] = None
                         ) -> Optional[List[float]]:
    """Entry mirroring Controller::start_autosync's OptimSync usage; returns
    None if the signal is unusable (caller falls back to the chunk heuristic)."""
    try:
        osync = OptimSync(raw_imu)
    except ValueError:
        return None
    dur_s = duration_ms / 1000.0
    ranges = ([(a * dur_s, b * dur_s) for a, b in trim_ranges]
              if trim_ranges else [(0.0, dur_s)])
    points, _rank, _ratio = osync.run(count, ranges)
    return points or None
