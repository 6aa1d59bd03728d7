"""Adaptive zoom (FOV) solver.

Port of gyroflow src/core/zooming/: iterative border-polygon FOV
estimation per frame + temporal filtering (gaussian rolling-min or envelope
follower).
"""
from __future__ import annotations

import hashlib
from enum import IntEnum
from typing import Dict, List, Tuple

import numpy as np

from .fov_iterative import FovIterative
from . import zoom_dynamic


class ZoomMethod(IntEnum):
    GaussianFilter = 0
    EnvelopeFollower = 1


def calculate_fovs(compute_params, timestamps: List[Tuple[int, float]],
                   method: ZoomMethod):
    """zooming/mod.rs:35-70. Returns (fovs, minimal_fovs, debug_points)."""
    if not timestamps:
        return [], [], {}

    import copy
    cp = copy.copy(compute_params)
    cp.fov_scale = 1.0
    cp.fovs = []
    cp.minimal_fovs = []
    org_output_size = (cp.output_width, cp.output_height)
    cp.output_width = cp.width
    cp.output_height = cp.height

    estimator = FovIterative(cp, org_output_size)
    fov_values = estimator.compute(timestamps, cp.trim_ranges)
    debug_points = estimator.debug_points

    if cp.adaptive_zoom_window < -0.9:
        # static zoom: global min
        fov_minimal = list(fov_values)
        m = min(fov_values) if fov_values else 1.0
        return [m] * len(fov_values), fov_minimal, debug_points
    elif cp.adaptive_zoom_window > 0.0001:
        fovs, fov_minimal = zoom_dynamic.compute(cp, list(fov_values), timestamps, method)
        return fovs, fov_minimal, debug_points
    else:
        return [1.0] * len(fov_values), list(fov_values), debug_points


def get_checksum(compute_params) -> int:
    """zooming/mod.rs:72-96."""
    cp = compute_params
    return hash((
        tuple(cp.lens.get_distortion_coeffs()), cp.width, cp.height,
        cp.output_width, cp.output_height, cp.scaled_fps,
        cp.max_zoom or 0.0, cp.max_zoom_iterations, tuple(map(tuple, cp.trim_ranges)),
        cp.video_rotation, cp.adaptive_zoom_window,
        cp.focal_length_smoothing_enabled, cp.focal_length_smoothing_strength,
    ))
