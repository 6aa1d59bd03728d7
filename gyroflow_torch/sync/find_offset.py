"""Offset solvers over undistorted optical-flow point pairs.

Ports of gyroflow src/core/synchronization/find_offset/:
- rs_sync.rs:17-120 — the DEFAULT, highest-quality method: a full-sync cost
  minimization over per-point-timestamped 3D rays (rolling-shutter aware),
  seeded by the fast essential-matrix median. The reference delegates the
  solver to the external `rs-sync` crate; this is an equivalent built on the
  same data (set_track_result inputs: normalized rays + per-row timestamps,
  set_quats quaternion convention) with a coarse-grid + shrinking-grid
  refinement in place of the crate's pre_sync/full_sync.
- visual_features.rs:10-150 — pixel-distance cost between rolling-shutter
  undistorted point pairs, 1 ms grid then 0.01 ms refinement; also its
  `for_rs` mode that estimates the frame readout time itself.
- rs_sync.rs guess_orient — IMU orientation search over all 48 axis maps.
"""
from __future__ import annotations

import logging
import math
from typing import List, Optional, Tuple

import numpy as np

from ..core import quaternion as quat
from ..ops.undistort_points import (undistort_points_for_optical_flow,
                                    undistort_points_with_rolling_shutter)

log = logging.getLogger(__name__)

# rot(pi, x): set_quats' IMU->camera hand-off rotation (rs_sync.rs:233)
_ROT_PI_X = np.asarray([0.0, 1.0, 0.0, 0.0])


def collect_matched_points(estimator, from_us: int, to_us: int):
    """rs_sync.rs collect_points: [(ts_a_us, p0, ts_b_us, p1)] in range."""
    out = []
    for ts in sorted(estimator.results):
        if from_us <= ts < to_us:
            fr = estimator.results[ts]
            if fr.of_points is not None and len(fr.of_points[0]) >= 2:
                out.append((ts, fr.of_points[0], fr.next_ts, fr.of_points[1]))
    return out


def _effective_readout_s(params) -> float:
    """rs_sync.rs:77-85: fallback to half a frame; global shutter ~0."""
    frt = params.frame_readout_time
    if frt == 0.0:
        frt = 1000.0 / max(params.scaled_fps, 1e-9) / 2.0
    if getattr(params.lens, "global_shutter", False):
        frt = 0.01
    return frt / 1000.0


class RsSyncProblem:
    """Track rays + gyro quats -> offset cost (SyncProblem equivalent)."""

    def __init__(self, params, estimator, from_us: int, to_us: int,
                 gyro=None):
        self.params = params
        g = gyro if gyro is not None else params.gyro
        if g.get_offsets():
            # org_quat_at_timestamp subtracts stored offsets; the solver's
            # candidate offset must replace them, not stack on top (rs_sync.rs
            # solves against the raw gyro clock) — else a second sync point
            # converges to ~0 and overwrites the true offset
            g = g.clone()
            g.clear_offsets()
        self.gyro = g
        self.readout_s = _effective_readout_s(params)
        height = float(estimator.size[1])
        self.tracks = []   # (tss_a ms, tss_b ms, rays_a (N,3), rays_b (N,3))
        for (ts_a, p0, ts_b, p1) in collect_matched_points(estimator, from_us, to_us):
            a = np.asarray(undistort_points_for_optical_flow(
                p0, ts_a, params, estimator.size), np.float64)
            b = np.asarray(undistort_points_for_optical_flow(
                p1, ts_b, params, estimator.size), np.float64)
            good = (np.abs(a) < 100).all(axis=1) & (np.abs(b) < 100).all(axis=1)
            if good.sum() < 4:
                continue
            a, b, pa, pb = a[good], b[good], p0[good], p1[good]
            # per-point timestamps: frame center convention (frame_transform
            # start_ts = ts - readout/2), row phase from the PIXEL y
            tss_a = ts_a / 1e3 + self.readout_s * 1e3 * (pa[:, 1] / height - 0.5)
            tss_b = ts_b / 1e3 + self.readout_s * 1e3 * (pb[:, 1] / height - 0.5)
            ra = np.concatenate([a, np.ones((len(a), 1))], axis=1)
            rb = np.concatenate([b, np.ones((len(b), 1))], axis=1)
            ra /= np.linalg.norm(ra, axis=1, keepdims=True)
            rb /= np.linalg.norm(rb, axis=1, keepdims=True)
            self.tracks.append((tss_a, tss_b, ra, rb))

    def _sync_quat_at(self, ts_ms: np.ndarray) -> np.ndarray:
        """set_quats convention: Q(t) = conj(org_quat(t) * rot(pi,x)).

        Right-multiplying by a constant and conjugating both commute with
        slerp, so looking up org quats and transforming is exact."""
        q = self.gyro.org_quat_at_timestamp(ts_ms)
        q = quat.multiply(q, _ROT_PI_X)
        return quat.conjugate(q)

    def cost(self, offset_ms: float) -> float:
        """Trimmed ray-misalignment under the gyro rotation at this offset.

        Real-gyro time = video time - offset (gyro_source offset convention).
        """
        total = 0.0
        n = 0
        for (tss_a, tss_b, ra, rb) in self.tracks:
            qa = self._sync_quat_at(tss_a - offset_ms)
            qb = self._sync_quat_at(tss_b - offset_ms)
            wa = quat.rotate_vector(qa, ra)
            wb = quat.rotate_vector(qb, rb)
            err = 1.0 - np.sum(wa * wb, axis=1)
            err.sort()
            keep = max(int(len(err) * 0.9), 1)   # trim mismatched tracks
            total += float(err[:keep].sum())
            n += keep
        return total / n if n else math.inf

    def full_sync(self, initial_offset_ms: float, step_ms: float = 3.0,
                  radius_ms: float = 3000.0, refine_iters: int = 6
                  ) -> Optional[Tuple[float, float]]:
        """Coarse grid then shrinking-grid refinement. Returns (offset, cost)."""
        if not self.tracks:
            return None
        best = (initial_offset_ms, math.inf)
        steps = int(radius_ms / step_ms)
        for i in range(-steps, steps + 1):
            o = initial_offset_ms + i * step_ms
            c = self.cost(o)
            if c < best[1]:
                best = (o, c)
        if not math.isfinite(best[1]):
            return None
        step = step_ms
        for _ in range(refine_iters):
            step /= 3.0
            center = best[0]
            for i in (-2, -1, 1, 2):
                o = center + i * step
                c = self.cost(o)
                if c < best[1]:
                    best = (o, c)
            if step < 0.01:
                break
        return best


def find_offsets_rs_sync(mgr, estimator, ranges_us, initial_offset: float,
                         search_size: float,
                         initial_from_essential: Optional[float] = None
                         ) -> List[Tuple[float, float, float]]:
    """rs_sync.rs find_offsets. Returns [(mid_ts_ms, offset_ms, cost)]."""
    params = mgr.get_compute_params()
    offsets = []
    for (from_us, to_us) in ranges_us:
        init = initial_offset if initial_from_essential is None \
            else initial_from_essential
        radius = search_size if initial_from_essential is None else 3000.0
        problem = RsSyncProblem(params, estimator, from_us, to_us)
        res = problem.full_sync(init, radius_ms=radius)
        if res is None:
            continue
        offset, cost = res
        if abs(offset - init) < radius * 0.9:
            offsets.append(((from_us + to_us) / 2.0 / 1e3, offset, cost))
        else:
            log.warning("rs-sync point out of acceptable range (%.1f >= %.1f)",
                        abs(offset - init), radius * 0.9)
    return offsets


def guess_orientation(mgr, estimator, ranges_us,
                      initial_offset: float = 0.0,
                      search_size: float = 3000.0) -> Optional[Tuple[str, float]]:
    """rs_sync.rs guess_orient: pick the IMU orientation string with the
    lowest total coarse-sync cost across all 48 axis maps."""
    params = mgr.get_compute_params()
    orients = [
        "YxZ", "Xyz", "XZy", "Zxy", "zyX", "yxZ", "ZXY", "zYx", "ZYX", "yXz",
        "YZX", "XyZ", "Yzx", "zXy", "YXz", "xyz", "yZx", "XYZ", "zxy", "xYz",
        "XYz", "zxY", "zXY", "xZy", "zyx", "xyZ", "Yxz", "xzy", "yZX", "yzX",
        "ZYx", "xYZ", "zYX", "ZxY", "yzx", "xZY", "Xzy", "XzY", "YzX", "Zyx",
        "XZY", "yxz", "xzY", "ZyX", "YXZ", "yXZ", "YZx", "ZXy"]
    best = None
    for orient in orients:
        clone = mgr.gyro.clone()
        clone.imu_transforms.imu_orientation = orient
        clone.apply_transforms()
        clone.integrate()
        total = 0.0
        for (from_us, to_us) in ranges_us:
            problem = RsSyncProblem(params, estimator, from_us, to_us,
                                    gyro=clone)
            steps = int(search_size / 3.0)
            costs = [problem.cost(initial_offset + i * 3.0)
                     for i in range(-steps, steps + 1, max(steps // 50, 1))]
            finite = [c for c in costs if math.isfinite(c)]
            total += min(finite) if finite else 0.0
        if best is None or total < best[1]:
            best = (orient, total)
    return best


def find_offsets_visual_features(mgr, estimator, ranges_us,
                                 initial_offset: float, search_size: float,
                                 for_rs: bool = False
                                 ) -> List[Tuple[float, float, float]]:
    """visual_features.rs find_offsets. for_rs=True estimates the frame
    readout time instead (returns [(0, readout_ms, cost)])."""
    import copy
    params = mgr.get_compute_params()
    if not for_rs:
        params.gyro = params.gyro.clone()
        params.gyro.offsets.clear()
        params.gyro.offsets_linear.clear()
        params.gyro.offsets_adjusted.clear()
    w, h = params.width, params.height
    final = []

    for (from_us, to_us) in ranges_us:
        matched = collect_matched_points(estimator, from_us, to_us)
        if not matched:
            continue
        # scale processing-size pixels up to video size for the RS undistort
        sx = params.width / max(estimator.size[0], 1)
        sy = params.height / max(estimator.size[1], 1)
        scaled = [(ts_a, p0 * np.asarray([sx, sy]), ts_b, p1 * np.asarray([sx, sy]))
                  for (ts_a, p0, ts_b, p1) in matched]

        def calculate_distance(offs_ms: float, rs: Optional[float] = None) -> float:
            p = params
            if rs is not None:
                p = copy.copy(params)
                p.frame_readout_time = rs
            total = 0.0
            for (ts_a, p0, ts_b, p1) in scaled:
                u1 = undistort_points_with_rolling_shutter(
                    p0, ts_a / 1e3 - offs_ms, None, p, 1.0, False)
                u2 = undistort_points_with_rolling_shutter(
                    p1, ts_b / 1e3 - offs_ms, None, p, 1.0, False)
                inb = ((u1 > 0) & (u1 < [w, h])).all(axis=1) & \
                      ((u2 > 0) & (u2 < [w, h])).all(axis=1)
                if not inb.any():
                    continue
                d = np.sum((u2[inb] - u1[inb]).astype(np.float64) ** 2, axis=1)
                d.sort()
                # discard the longest 10% (wrong matches), vf.rs:83-86
                total += float(d[:max(int(len(d) * 0.9), 1)].sum())
            return total

        if for_rs:
            fps = params.scaled_fps
            max_rs = 1000.0 / max(fps, 1e-9)
            cands = [(i, calculate_distance(0.0, float(i)))
                     for i in range(-int(max_rs), int(max_rs))]
            lo = min(cands, key=lambda t: t[1])
            fine = [(lo[0] - 1.0 + i * 0.01,
                     calculate_distance(0.0, lo[0] - 1.0 + i * 0.01))
                    for i in range(200)]
            lo = min(fine, key=lambda t: t[1])
            final.append((0.0, lo[0], lo[1]))
            continue

        cands = [(initial_offset - search_size / 2.0 + i,
                  calculate_distance(initial_offset - search_size / 2.0 + i))
                 for i in range(int(search_size))]
        if not cands:
            continue
        lo = min(cands, key=lambda t: t[1])
        fine = [(lo[0] - 1.0 + i * 0.01,
                 calculate_distance(lo[0] - 1.0 + i * 0.01))
                for i in range(200)]
        lo = min(fine, key=lambda t: t[1])
        if abs(lo[0] - initial_offset) < search_size * 0.9:
            mid = (from_us + (to_us - from_us) / 2.0) / 1e3
            final.append((mid, lo[0], lo[1]))
        else:
            log.warning("visual-features point out of acceptable range")
    return final
