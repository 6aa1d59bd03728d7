"""Focal-length smoothing (power-zoom lenses).

Port of gyroflow src/core/smoothing/focal_length.rs plus the manager's
apply/extract logic (lib.rs:416-513): dequantize the per-frame focal-length
metadata with a Gaussian, then adaptive velocity-gated smoothing; the
dequantized/smoothed ratio becomes the per-frame FOV compensation.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .params import ComputeParams, StabilizationParams, timestamp_at_frame


def smooth_focal_lengths_gaussian(focal_lengths: List[Optional[float]],
                                  strength: float, window_size: int) -> List[Optional[float]]:
    """focal_length.rs:8-60."""
    if not focal_lengths or strength <= 0.0:
        return list(focal_lengths)
    if window_size % 2 == 0:
        window_size += 1
    half = window_size // 2
    sigma = (window_size / 6.0) * (1.0 + strength * 2.0)
    xs = np.arange(window_size) - half
    kernel = np.exp(-xs * xs / (2.0 * sigma * sigma))
    kernel /= kernel.sum()

    n = len(focal_lengths)
    out: List[Optional[float]] = []
    for i in range(n):
        if focal_lengths[i] is None:
            out.append(None)
            continue
        ws = 0.0
        w = 0.0
        for j in range(window_size):
            idx = min(max(i + j - half, 0), n - 1)
            fl = focal_lengths[idx]
            if fl is not None:
                ws += fl * kernel[j]
                w += kernel[j]
        if w > 0.0:
            sm = ws / w
            out.append(focal_lengths[i] * (1.0 - strength) + sm * strength)
        else:
            out.append(focal_lengths[i])
    return out


def smooth_focal_lengths_adaptive(focal_lengths: List[Optional[float]], fps: float,
                                  max_smoothness_time: float, min_smoothness_time: float,
                                  max_velocity: float) -> List[Optional[float]]:
    """focal_length.rs:63-139."""
    n = len(focal_lengths)
    if n < 2 or fps <= 0.0:
        return list(focal_lengths)
    dt = 1.0 / fps
    alpha_max = 1.0 - math.exp(-dt / max(max_smoothness_time, 1e-3))
    alpha_min = 1.0 - math.exp(-dt / max(min_smoothness_time, 1e-3))

    velocity = np.zeros(n)
    for i in range(1, n):
        prev, curr = focal_lengths[i - 1], focal_lengths[i]
        if prev is not None and curr is not None and prev > 0.0:
            velocity[i] = abs((curr - prev) * fps / prev)
    velocity[0] = velocity[1] if n > 1 else 0.0
    for i in range(1, n):
        velocity[i] = velocity[i - 1] * (1.0 - alpha_min) + velocity[i] * alpha_min
    for i in range(n - 2, -1, -1):
        velocity[i] = velocity[i + 1] * (1.0 - alpha_min) + velocity[i] * alpha_min

    def alpha_at(i):
        ratio = min(velocity[i] / max_velocity, 1.0) if max_velocity > 1e-6 else 1.0
        return alpha_max * (1.0 - ratio) + alpha_min * ratio

    seed = None
    start_idx = 0
    for i, v in enumerate(focal_lengths):
        if v is not None:
            seed, start_idx = v, i
            break
    if seed is None:
        return list(focal_lengths)

    smoothed: List[Optional[float]] = [None] * n
    state = seed
    for i in range(start_idx, n):
        if focal_lengths[i] is not None:
            a = alpha_at(i)
            state = state * (1.0 - a) + focal_lengths[i] * a
        smoothed[i] = state
    state = smoothed[n - 1] if smoothed[n - 1] is not None else seed
    for i in range(n - 1, start_idx - 1, -1):
        if smoothed[i] is not None:
            a = alpha_at(i)
            state = state * (1.0 - a) + smoothed[i] * a
            smoothed[i] = state
    return smoothed


def extract_focal_lengths(params: ComputeParams) -> List[Optional[float]]:
    """lib.rs:416-439."""
    from ..ops.frame_transform import _get_closest
    fm = params.gyro.file_metadata
    if not fm.lens_params:
        return []
    out = []
    for frame in range(params.frame_count):
        ts_us = int(round(timestamp_at_frame(frame, params.scaled_fps) * 1000.0))
        val = _get_closest(fm.lens_params, ts_us, 100000)
        out.append(float(val.focal_length) if val is not None and val.focal_length else None)
    return out


def apply_focal_length_smoothing(params: ComputeParams, sp: StabilizationParams):
    """lib.rs:442-513."""
    enabled = sp.focal_length_smoothing_enabled
    strength = sp.focal_length_smoothing_strength
    focal_lengths = extract_focal_lengths(params) if (params.gyro is not None and
                                                      params.gyro.file_metadata.lens_params) else []
    active = enabled and bool(focal_lengths)
    if active:
        dequantize_window = max(int(round(params.scaled_fps * 0.5)), 5)
        dequantized = smooth_focal_lengths_gaussian(focal_lengths, 1.0, dequantize_window)
        s = min(max(strength, 0.0), 1.0)
        max_smoothness_time = 0.1 * (300.0 ** s)
        min_smoothness_time = 0.05 + 0.35 * s * s
        velocity_threshold = 0.3 + 7.7 * (s ** 1.5)
        smoothed = smooth_focal_lengths_adaptive(
            dequantized, params.scaled_fps, max_smoothness_time,
            min_smoothness_time, velocity_threshold)
        params.focal_lengths = dequantized
        params.smoothed_focal_lengths = smoothed
        params.focal_length_smoothing_enabled = True
        sp.smoothed_focal_lengths = smoothed
    else:
        params.focal_lengths = []
        params.smoothed_focal_lengths = []
        params.focal_length_smoothing_enabled = False
        sp.smoothed_focal_lengths = []
    sp.focal_lengths = focal_lengths
