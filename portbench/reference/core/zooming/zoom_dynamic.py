"""Temporal FOV filtering.

Port of gyroflow src/core/zooming/zoom_dynamic.rs: gaussian rolling-min
or envelope-follower smoothing of the per-frame minimal FOVs, with keyframed /
video-speed-scaled window support.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..keyframes import KeyframeType


@dataclass
class DataPerTimestamp:
    fps: float
    window: float
    frames: int
    half_frames: int
    gaussian_window: np.ndarray


def get_frames_per_window(cp) -> int:
    frames = int(math.floor(cp.adaptive_zoom_window * cp.scaled_fps))
    if frames % 2 == 0:
        frames += 1
    return frames


def gaussian_window_fn(width: int, std: float) -> np.ndarray:
    """zoom_dynamic.rs:121-126: x in [-w/2, w/2] inclusive (w+1 taps)."""
    sig2 = 2.0 * std * std
    xs = np.arange(-(width // 2), width // 2 + 1)
    return np.exp(-(xs.astype(np.float64) ** 2) / sig2)


def gaussian_window_normalized(m: int, std: float) -> np.ndarray:
    w = gaussian_window_fn(m, std)
    return w / w.sum()


def pad_edge(arr: np.ndarray, pad: Tuple[int, int]) -> np.ndarray:
    if len(arr) == 0:
        return np.zeros(pad[0] + pad[1])
    return np.concatenate([np.full(pad[0], arr[0]), arr, np.full(pad[1], arr[-1])])


def min_rolling(a: np.ndarray, window: int) -> np.ndarray:
    return np.asarray([a[i:i + window].min() for i in range(len(a) - window + 1)])


def convolve(v: np.ndarray, filt: np.ndarray) -> np.ndarray:
    return np.asarray([np.dot(v[i:i + len(filt)], filt)
                       for i in range(len(v) - len(filt) + 1)])


def envelope_follower(a: np.ndarray, data_per_ts: List[DataPerTimestamp],
                      alpha: Optional[float]) -> np.ndarray:
    """zoom_dynamic.rs:165-189: two-pass min-tracking EMA."""
    n = len(a)
    if n == 0:
        return a
    if alpha is not None:
        alphas = np.full(n, alpha)
    else:
        alphas = np.asarray([1.0 - math.exp(-(1.0 / d.fps) / d.window) for d in data_per_ts])

    rev = np.empty(n)
    q = a[-1]
    for i in range(n - 1, -1, -1):
        q = min(a[i], a[i] * alphas[i] + q * (1.0 - alphas[i]))
        rev[n - 1 - i] = q
    out = np.empty(n)
    q = rev[-1]
    for j in range(n - 1, -1, -1):
        i = n - 1 - j   # forward order over original indices
        x = rev[j]
        q = min(x, x * alphas[i] + q * (1.0 - alphas[i]))
        out[i] = q
    return out


def compute(cp, fov_values: List[float], timestamps, method) -> Tuple[List[float], List[float]]:
    """zoom_dynamic.rs:15-112."""
    from . import ZoomMethod
    window = cp.adaptive_zoom_window
    fovs = np.asarray(fov_values, dtype=np.float64)
    fov_minimal = list(fov_values)
    kf = cp.keyframes

    dyn = kf.is_keyframed(KeyframeType.ZoomingSpeed) or \
        (cp.video_speed_affects_zooming and
         (cp.video_speed != 1.0 or kf.is_keyframed(KeyframeType.VideoSpeed)))

    if dyn:
        max_window = 0
        data_per_ts = []
        for _frame, ts in timestamps:
            w = kf.value_at_video_timestamp(KeyframeType.ZoomingSpeed, ts)
            w = window if w is None else w
            if cp.video_speed_affects_zooming:
                vs = kf.value_at_video_timestamp(KeyframeType.VideoSpeed, ts)
                vs = cp.video_speed if vs is None else vs
                w *= abs(vs)
            # frames from the per-timestamp window (the reference calls
            # get_frames_per_window on unmodified cp; kept bit-faithful)
            frames = get_frames_per_window(cp)
            max_window = max(max_window, frames)
            data_per_ts.append(DataPerTimestamp(
                fps=cp.scaled_fps, window=w, frames=frames, half_frames=frames // 2,
                gaussian_window=gaussian_window_normalized(frames, frames / 6.0)))

        if method == ZoomMethod.GaussianFilter:
            half = max_window // 2
            padded = pad_edge(fovs, (half, half))
            fov_min = np.asarray([
                padded[i + (half - d.half_frames): i + (half - d.half_frames) + d.frames].min()
                for i, d in enumerate(data_per_ts)])
            padded2 = pad_edge(fov_min, (half, half))
            fovs = np.asarray([
                np.dot(padded2[i + (half - d.half_frames): i + (half - d.half_frames) + d.frames],
                       d.gaussian_window)
                for i, d in enumerate(data_per_ts)])
        else:
            second = 1.0 - math.exp(-(1.0 / cp.scaled_fps) / 0.2)
            fovs = envelope_follower(fovs, data_per_ts, None)
            fovs = envelope_follower(fovs, data_per_ts, second)
    else:
        if method == ZoomMethod.GaussianFilter:
            frames = get_frames_per_window(cp)
            padded = pad_edge(fovs, (frames // 2, frames // 2))
            fov_min = min_rolling(padded, frames)
            padded2 = pad_edge(fov_min, (frames // 2, frames // 2))
            gaussian = gaussian_window_normalized(frames, frames / 6.0)
            fovs = convolve(padded2, gaussian)
        else:
            first = 1.0 - math.exp(-(1.0 / cp.scaled_fps) / window)
            second = 1.0 - math.exp(-(1.0 / cp.scaled_fps) / 0.2)
            fovs = envelope_follower(fovs, [], first)
            fovs = envelope_follower(fovs, [], second)

    return list(fovs), fov_minimal
