"""Automatic gyro-video offset estimation.

Port of AutosyncProcess (synchronization/autosync.rs) + the essential-matrix
offset search (find_offset/essential_matrix.rs): pick sync points (high-motion
regions, like OptimSync's FFT point picker), run optical flow around them,
brute-force the offset at 1 ms steps then refine at 0.01 ms, accept if inside
90% of the search window.
"""
from __future__ import annotations

import logging
import math
from typing import List, Optional, Tuple

import numpy as np

from ..core.file_metadata import TimeIMU
from ..core.filtering import lowpass_gyro_forward_backward
from .pose_estimator import PoseEstimator

log = logging.getLogger(__name__)


def pick_sync_points(mgr, count: int = 2, chunk_ms: float = 2500.0) -> List[float]:
    """Choose sync timestamps: OptimSync's STFT rank (optimsync.rs) when the
    gyro signal supports it, else a chunked activity heuristic."""
    raw = mgr.gyro.get_raw_imu()
    dur = mgr.params.duration_ms
    if not raw or dur <= 0:
        return [dur * (i + 1) / (count + 1) for i in range(count)]
    from .optimsync import pick_sync_points_fft
    pts = pick_sync_points_fft(raw, dur, count, mgr.params.trim_ranges or None)
    if pts:
        return sorted(pts)
    mags = np.asarray([np.linalg.norm(v.gyro) if v.gyro is not None else 0.0 for v in raw])
    ts = np.asarray([v.timestamp_ms for v in raw])
    n_chunks = max(int(dur / chunk_ms), 1)
    scores = []
    for c in range(n_chunks):
        a, b = c * chunk_ms, (c + 1) * chunk_ms
        m = (ts >= a) & (ts < b)
        scores.append((float(mags[m].mean()) if m.any() else 0.0, (a + b) / 2.0))
    # margin: avoid the first/last chunk (seeking + settle)
    scores = scores[1:-1] or scores
    scores.sort(reverse=True)
    return sorted(t for _s, t in scores[:count])


def calculate_cost(offs_ms: float, of_items: List[TimeIMU],
                   gyro_ts: np.ndarray, gyro_vals: np.ndarray) -> float:
    """essential_matrix.rs:104-124 (weights 70/70/100, next-sample lookup)."""
    total = 0.0
    matches = 0
    for o in of_items:
        if o.gyro is None:
            continue
        t = o.timestamp_ms - offs_ms
        i = np.searchsorted(gyro_ts, t, side="left")
        if i >= len(gyro_ts):
            continue
        g = gyro_vals[i]
        og = o.gyro
        matches += 1
        total += (g[0] - og[0]) ** 2 * 70.0
        total += (g[1] - og[1]) ** 2 * 70.0
        total += (g[2] - og[2]) ** 2 * 100.0
    if of_items and matches > len(of_items) // 2:
        return total / matches
    return math.inf


def find_offset_for_range(mgr, of_items: List[TimeIMU], initial_offset: float,
                          search_size: float) -> Optional[Tuple[float, float]]:
    """essential_matrix.rs:20-88. Returns (offset_ms, cost) or None."""
    if not of_items:
        return None
    max_angle = max((max(abs(v.gyro[0]), abs(v.gyro[1]), abs(v.gyro[2]))
                     for v in of_items if v.gyro is not None), default=0.0)
    if max_angle < 3.0:
        log.info("No movement detected (max %.1f deg/s), skipping sync point", max_angle)
        return None

    raw = mgr.gyro.get_raw_imu()
    if not raw:
        return None
    first_ts = of_items[0].timestamp_ms
    last_ts = of_items[-1].timestamp_ms
    gyro_items = [TimeIMU(v.timestamp_ms, None if v.gyro is None else v.gyro.copy(),
                          None if v.accl is None else v.accl.copy())
                  for v in raw
                  if first_ts - search_size <= v.timestamp_ms + initial_offset <= last_ts + search_size]
    if not gyro_items:
        return None

    sample_rate = len(raw) / (mgr.gyro.duration_ms / 1000.0)
    of_f = [TimeIMU(v.timestamp_ms, v.gyro.copy() if v.gyro is not None else None)
            for v in of_items]
    fps = mgr.params.get_scaled_fps()
    try:
        lowpass_gyro_forward_backward(20.0, fps, of_f)
    except ValueError:
        pass
    try:
        lowpass_gyro_forward_backward(20.0, sample_rate, gyro_items)
    except ValueError:
        pass

    g_ts = np.asarray([v.timestamp_ms for v in gyro_items])
    g_vals = np.asarray([v.gyro if v.gyro is not None else np.zeros(3) for v in gyro_items])

    # coarse: 1ms steps over +-search_size
    best = (None, math.inf)
    for i in range(int(search_size) * 2):
        offs = initial_offset - search_size + i
        c = calculate_cost(offs, of_f, g_ts, g_vals)
        if c < best[1]:
            best = (offs, c)
    if best[0] is None:
        return None
    # refine: 0.01ms steps over +-2ms
    center = best[0]
    for i in range(400):
        offs = center - 2.0 + i * 0.01
        c = calculate_cost(offs, of_f, g_ts, g_vals)
        if c < best[1]:
            best = (offs, c)
    if abs(best[0] - initial_offset) < search_size * 0.9:
        return best
    log.warning("Sync point out of acceptable range")
    return None


OFFSET_METHODS = ("essential_matrix", "rs_sync", "visual_features")


def run_autosync(mgr, video_path: str, search_size: float = 3000.0,
                 initial_offset: float = 0.0, sync_points: int = 2,
                 processing_resolution: int = 720,
                 time_per_syncpoint: float = 1.5,
                 of_method: Optional[str] = None,
                 offset_method: str = "rs_sync",
                 pose_method=0,
                 calc_initial_fast: bool = True) -> List[Tuple[float, float]]:
    """AutosyncProcess (autosync.rs:15-130) + offsets-method dispatch
    (sync/mod.rs:382-389; default rs-sync like the reference). Returns
    [(ts_ms, offset_ms)] and applies them to the manager's gyro offsets."""
    import cv2
    from ..render.video_io import VideoReader

    if offset_method not in OFFSET_METHODS:
        offset_method = "rs_sync"
    if of_method is None:
        # params.of_method ids: 0 akaze, 1 pyrlk, 2 dis (optical_flow/mod.rs)
        of_method = {0: "akaze", 1: "pyrlk", 2: "dis"}.get(
            getattr(mgr.params, "of_method", 1), "pyrlk")
    cp = mgr.get_compute_params()
    all_results = {}
    points = pick_sync_points(mgr, sync_points)
    reader = VideoReader(video_path)
    fps = reader.fps
    scale = min(processing_resolution / max(reader.height, 1), 1.0)
    size = (int(reader.width * scale), int(reader.height * scale))

    applied = []
    for ts_mid in points:
        frame0 = max(int((ts_mid - time_per_syncpoint * 500.0) / 1000.0 * fps), 0)
        frame1 = int((ts_mid + time_per_syncpoint * 500.0) / 1000.0 * fps)
        est = PoseEstimator(cp, size, of_method=of_method,
                            pose_method=pose_method)
        reader.seek_frame(frame0)
        range_us = (int(frame0 / fps * 1e6), int((frame1 + 1) / fps * 1e6))
        for idx in range(frame0, frame1 + 1):
            try:
                ts_us, rgb = next(reader)
            except StopIteration:
                break
            gray = cv2.cvtColor(rgb.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            if scale < 1.0:
                gray = cv2.resize(gray, size)
            est.feed_frame(ts_us, gray, fps)
        all_results.update(est.results)

        # fast essential-matrix estimate — the result for the essential
        # method, the initial guess for rs-sync (rs_sync.rs:26-45)
        ess = None
        if offset_method != "visual_features" and \
                (offset_method == "essential_matrix" or calc_initial_fast):
            of_items = est.recalculate_gyro_data(
                fps, lpf_hz=getattr(mgr, "sync_lpf", 0.0))
            ess = find_offset_for_range(mgr, of_items, initial_offset, search_size)

        if offset_method == "essential_matrix":
            if ess is not None:
                mgr.set_sync_offset(int(ts_mid * 1000.0), ess[0])
                applied.append((ts_mid, ess[0]))
            continue

        from .find_offset import (find_offsets_rs_sync,
                                  find_offsets_visual_features)
        if offset_method == "rs_sync":
            offs = find_offsets_rs_sync(
                mgr, est, [range_us], initial_offset, search_size,
                initial_from_essential=ess[0] if ess is not None else None)
        else:
            offs = find_offsets_visual_features(
                mgr, est, [range_us], initial_offset, search_size)
        for (_mid_ms, offset_ms, _cost) in offs:
            mgr.set_sync_offset(int(ts_mid * 1000.0), offset_ms)
            applied.append((ts_mid, offset_ms))
    reader.close()
    if all_results:
        # retain the last estimator (with every sync point's results) for
        # the debug overlays (lib.rs:793-832 read pose_estimator results)
        est.results = all_results
        mgr.pose_estimator = est
    return applied
