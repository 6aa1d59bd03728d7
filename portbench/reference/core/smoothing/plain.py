"""Plain 3D smoothing: bidirectional slerp-EMA (smoothing/plain.rs).

alpha = 1 - exp(-(1/rate)/tc); keyframable time constant, video-speed scaling,
per-sample alpha divided by the smoothing-fov-limit scaler chain (plain.rs:73-152).
"""
from __future__ import annotations

import math

import numpy as np

from ..keyframes import KeyframeType
from ..params import frame_at_timestamp
from ..time_quat import TimeQuat
from .base import SmoothingAlgorithm, slerp_scan


class Plain(SmoothingAlgorithm):
    def __init__(self):
        self.time_constant = 0.25
        self.trim_range_only = True

    def get_name(self) -> str:
        return "Plain 3D"

    def params(self):
        return {"time_constant": self.time_constant,
                "trim_range_only": 1.0 if self.trim_range_only else 0.0}

    def smooth(self, tq: TimeQuat, duration_ms: float, compute_params) -> TimeQuat:
        if len(tq) == 0 or duration_ms <= 0.0:
            return tq.copy()
        from . import get_trimmed_quats

        keyframes = compute_params.keyframes
        sample_rate = len(tq) / (duration_ms / 1000.0)

        def get_alpha(tc):
            return 1.0 - math.exp(-(1.0 / sample_rate) / tc)

        alpha = get_alpha(self.time_constant) if self.time_constant > 0 else 1.0

        tq = get_trimmed_quats(tq, compute_params.scaled_duration_ms,
                               self.trim_range_only, compute_params.trim_ranges)
        ts = tq.timestamps_us
        n = len(ts)

        alphas = np.full(n, alpha)
        keyframed = keyframes.is_keyframed(KeyframeType.SmoothingParamTimeConstant) or \
            (compute_params.video_speed_affects_smoothing and
             (compute_params.video_speed != 1.0 or keyframes.is_keyframed(KeyframeType.VideoSpeed)))
        if keyframed:
            for i in range(n):
                t_ms = ts[i] / 1000.0
                val = keyframes.value_at_gyro_timestamp(KeyframeType.SmoothingParamTimeConstant, t_ms)
                if val is None:
                    val = self.time_constant
                if compute_params.video_speed_affects_smoothing:
                    vs = keyframes.value_at_gyro_timestamp(KeyframeType.VideoSpeed, t_ms)
                    if vs is None:
                        vs = compute_params.video_speed
                    val *= abs(vs)
                alphas[i] = get_alpha(val)

        # smoothing-fov-limit scaler chain (plain.rs:117-136): per-sample scale
        # from the max-zoom iteration, smoothed forward+backward by alpha
        scalers = np.ones(n)
        limit = compute_params.smoothing_fov_limit_per_frame
        if limit:
            for i in range(n):
                f = frame_at_timestamp(ts[i] / 1000.0, compute_params.scaled_fps)
                if 0 <= f < len(limit):
                    scalers[i] = limit[f]
            prev = scalers[0]
            for i in range(1, n):
                scalers[i] = prev * (1.0 - alphas[i]) + scalers[i] * alphas[i]
                prev = scalers[i]
            prev = scalers[-1]
            for i in range(n - 2, -1, -1):
                scalers[i] = prev * (1.0 - alphas[i]) + scalers[i] * alphas[i]
                prev = scalers[i]

        eff = alphas / scalers
        smoothed = slerp_scan(tq.quats, eff)
        smoothed = slerp_scan(smoothed, eff, reverse=True)
        return TimeQuat(ts.copy(), smoothed)
