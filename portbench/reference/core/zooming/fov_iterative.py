"""Iterative border-polygon FOV estimation.

Port of gyroflow src/core/zooming/fov_iterative.rs: undistort a
120-point border polygon, shrink a centered aspect-constrained rectangle to
the nearest polygon point, refine 30x around it, up to 4 extra iterations.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ...ops.undistort_points import undistort_points_with_rolling_shutter
from ..keyframes import KeyframeType


def interpolate_points(pts: np.ndarray, steps: int) -> np.ndarray:
    """fov_iterative.rs:173-184."""
    d = steps + 1
    n = len(pts)
    new_len = d * n - steps
    i = np.arange(new_len)
    idx1 = i // d
    idx2 = np.minimum(idx1 + 1, n - 1)
    f = (i % d) / d
    return pts[idx1] + f[:, None] * (pts[idx2] - pts[idx1])


class FovIterative:
    def __init__(self, compute_params, org_output_size):
        cp = compute_params
        ratio = cp.width / max(org_output_size[0], 1)
        self.input_dim = (float(cp.width), float(cp.height))
        self.output_dim = (org_output_size[0] * ratio, org_output_size[1] * ratio)
        self.output_inv_aspect = self.output_dim[1] / self.output_dim[0]
        self.cp = cp
        self.debug_points: Dict[int, list] = {}

    def points_around_rect(self, w: float, h: float, w_div: int, h_div: int) -> np.ndarray:
        """fov_iterative.rs:153-170."""
        m = self.cp.fov_algorithm_margin
        w -= m * 2.0
        h -= m * 2.0
        wcnt = max(w_div, 2) - 1
        hcnt = max(h_div, 2) - 1
        wstep = w / wcnt
        hstep = h / hcnt
        pts = []
        for i in range(wcnt):
            pts.append((i * wstep, 0.0))
        for i in range(hcnt):
            pts.append((w, i * hstep))
        for i in range(wcnt):
            pts.append(((wcnt - i) * wstep, h))
        for i in range(hcnt):
            pts.append((0.0, (hcnt - i) * hstep))
        return np.asarray(pts) + m

    def nearest_edge(self, polygon: np.ndarray, center, initial):
        """fov_iterative.rs:136-151: aspect-constrained shrink fold."""
        best_idx = None
        best = initial
        for i in range(len(polygon)):
            ax = abs(polygon[i, 0] - center[0])
            ay = abs(polygon[i, 1] - center[1])
            if ax < best[0] and ay < best[1]:
                if ay > ax * self.output_inv_aspect:
                    best_idx, best = i, (ay / self.output_inv_aspect, ay)
                else:
                    best_idx, best = i, (ax, ax * self.output_inv_aspect)
        return best_idx, best

    def find_fov(self, rect: np.ndarray, ts: float, frame: int, center, kv) -> float:
        """fov_iterative.rs:103-134."""
        az_cx, az_cy, lca = kv
        polygon = np.asarray(undistort_points_with_rolling_shutter(
            rect, ts, frame, self.cp, lca, False), dtype=np.float64)
        polygon[:, 0] -= az_cx * self.input_dim[0]
        polygon[:, 1] -= az_cy * self.input_dim[1]
        if self.cp.zooming_debug_points:
            self.debug_points[int(round(ts * 1000.0))] = [
                (x / self.input_dim[0], y / self.input_dim[1]) for x, y in polygon]

        initial = (1000000.0, 1000000.0 * self.output_inv_aspect)
        nearest = (None, initial)
        nearest = self.nearest_edge(polygon, center, nearest[1])
        for _ in range(1, 5):
            if nearest[0] is None:
                break
            idx = nearest[0]
            n = len(rect)
            relevant = np.asarray([rect[(idx - 1) % n], rect[idx], rect[(idx + 1) % n]])
            distorted = interpolate_points(relevant, 30)
            polygon = np.asarray(undistort_points_with_rolling_shutter(
                distorted, ts, frame, self.cp, lca, False), dtype=np.float64)
            polygon[:, 0] -= az_cx * self.input_dim[0]
            polygon[:, 1] -= az_cy * self.input_dim[1]
            nearest = self.nearest_edge(polygon, center, nearest[1])
        return nearest[1][0] * 2.0 / self.output_dim[0]

    def compute(self, timestamps: List[Tuple[int, float]], ranges) -> List[float]:
        """fov_iterative.rs:34-70 (reference runs rayon; single host thread here —
        candidate for the batched device zoom solve)."""
        if not timestamps:
            return []
        kf = self.cp.keyframes
        rect = self.points_around_rect(self.input_dim[0], self.input_dim[1], 31, 31)
        center = (self.input_dim[0] / 2.0, self.input_dim[1] / 2.0)
        keyed = (kf.is_keyframed(KeyframeType.ZoomingCenterX) or
                 kf.is_keyframed(KeyframeType.ZoomingCenterY) or
                 kf.is_keyframed(KeyframeType.LensCorrectionStrength))
        fovs = []
        for frame, ts in timestamps:
            if keyed:
                def val(t, d):
                    v = kf.value_at_video_timestamp(t, ts)
                    return d if v is None else v
                kv = (val(KeyframeType.ZoomingCenterX, self.cp.adaptive_zoom_center_offset[0]),
                      val(KeyframeType.ZoomingCenterY, self.cp.adaptive_zoom_center_offset[1]),
                      val(KeyframeType.LensCorrectionStrength, self.cp.lens_correction_amount))
            else:
                kv = (self.cp.adaptive_zoom_center_offset[0],
                      self.cp.adaptive_zoom_center_offset[1],
                      self.cp.lens_correction_amount)
            fovs.append(self.find_fov(rect, ts, frame, center, kv))

        if ranges:
            l = len(timestamps) - 1
            max_fov = max(fovs)
            for i in range(len(fovs)):
                within = any(math.floor(l * a) <= i <= math.ceil(l * b) for a, b in ranges)
                if not within:
                    fovs[i] = max_fov
        return fovs
