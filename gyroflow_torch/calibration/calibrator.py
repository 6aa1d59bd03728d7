"""Fisheye lens calibrator.

Port of gyroflow src/core/calibration/mod.rs: feed frames, detect
chessboard corners (14x8 SB detector with marker, plain fallback), run OpenCV
fisheye calibration over randomly-sampled frame subsets picking the lowest RMS
(mod.rs:205-310). Produces a LensProfile in the shared JSON schema.
"""
from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.lens_profile import CameraParams, Dimensions, LensProfile

log = logging.getLogger(__name__)


@dataclass
class DetectedPoints:
    frame: int
    timestamp_us: int
    points: np.ndarray      # (N, 2) f64, full-resolution coords
    avg_sharpness: float = 0.0


class LensCalibrator:
    def __init__(self, columns: int = 14, rows: int = 8, max_images: int = 9,
                 iterations: int = 14, max_sharpness: float = 5.0,
                 no_marker: bool = False):
        """Defaults from calibration/mod.rs:69-96."""
        self.columns = columns
        self.rows = rows
        self.max_images = max_images
        self.iterations = iterations
        self.max_sharpness = max_sharpness
        self.sum_sharpness = 0.0
        self.no_marker = no_marker      # plain boards without the center marker
        self.width = 0
        self.height = 0
        self.image_points: Dict[int, DetectedPoints] = {}
        self.all_matches: Dict[int, DetectedPoints] = {}
        self.used_points: Dict[int, DetectedPoints] = {}
        self.forced_frames: set = set()
        self.k = np.eye(3)
        self.d = np.zeros(4)
        self.rms = 0.0
        # objp: (x, y) grid (mod.rs:89-92)
        self.objp = np.array([(x, y, 0.0) for y in range(rows) for x in range(columns)],
                             dtype=np.float64)

    def clear(self):
        self.all_matches.clear()
        self.image_points.clear()
        self.used_points.clear()
        self.sum_sharpness = 0.0

    def feed_frame(self, timestamp_us: int, frame: int, gray: np.ndarray,
                   org_size: Optional[Tuple[int, int]] = None) -> bool:
        """Detect chessboard corners on a grayscale frame (mod.rs:104-203):
        contrast/brightness boost + histogram equalization, SB detector with
        CALIB_CB_MARKER (or without, for marker-less boards — `no_marker` or
        automatic fallback), sharpness gate (reject blurry frames unless
        forced)."""
        import cv2
        if self.width == 0:
            self.height, self.width = (org_size[1], org_size[0]) if org_size else gray.shape[:2]
        if frame in self.all_matches:   # cached detection (mod.rs:124-131)
            det = self.all_matches[frame]
            if det.avg_sharpness < self.max_sharpness \
                    or frame in self.forced_frames:
                self.image_points[frame] = det
                self.sum_sharpness += det.avg_sharpness
            return frame in self.image_points
        grid = (self.columns, self.rows)
        # contrast 2.0 / brightness -50 + equalize_hist (mod.rs:139-150)
        boosted = np.clip(gray.astype(np.float64) * 2.0 - 50.0, 0, 255).astype(np.uint8)
        boosted = cv2.equalizeHist(boosted)
        marker = getattr(cv2, "CALIB_CB_MARKER", 0)
        flag_sets = ((0,) if self.no_marker else (marker, 0))
        found, corners = False, None
        for img in (boosted, gray):
            for flags in flag_sets:
                try:
                    found, corners = cv2.findChessboardCornersSB(img, grid, flags=flags)
                except cv2.error:
                    found = False
                if found:
                    break
            if found:
                break
        if not found or corners is None or len(corners) != self.columns * self.rows:
            return False
        scale_x = self.width / gray.shape[1]
        scale_y = self.height / gray.shape[0]
        pts = corners.reshape(-1, 2).astype(np.float64)
        pts[:, 0] *= scale_x
        pts[:, 1] *= scale_y
        sharpness = 0.0
        try:
            sharpness = float(cv2.estimateChessboardSharpness(gray, grid, corners)[0][0])
        except cv2.error:
            pass
        det = DetectedPoints(frame, timestamp_us, pts, sharpness)
        self.all_matches[frame] = det
        if sharpness < self.max_sharpness or frame in self.forced_frames:
            self.image_points[frame] = det
            self.sum_sharpness += sharpness
            return True
        log.debug("frame %d too blurry (sharpness %.2f >= %.2f)", frame,
                  sharpness, self.max_sharpness)
        return False

    def draw_corners(self, frame: int, canvas, inverted: bool = False) -> bool:
        """Overlay the frame's detected corners into a DrawCanvas
        (controller.rs update_calib_model -> calibration/drawing.rs)."""
        det = self.all_matches.get(frame)
        if det is None:
            return False
        from .drawing import draw_chessboard_corners
        pts = [(float(x), float(y)) for x, y in det.points]
        draw_chessboard_corners(self.width, self.height, canvas,
                                (self.columns, self.rows), pts,
                                found=len(pts) == self.columns * self.rows,
                                inverted=inverted)
        return True

    def _run_one(self, frames: List[int]) -> Tuple[float, np.ndarray, np.ndarray]:
        import cv2
        # cv2 fisheye requires (1, N, D)-shaped views
        objpoints = [self.objp.reshape(1, -1, 3).astype(np.float64) for _ in frames]
        imgpoints = [self.image_points[f].points.reshape(1, -1, 2).astype(np.float64)
                     for f in frames]
        k = np.eye(3)
        d = np.zeros((4, 1))
        flags = (getattr(cv2.fisheye, "CALIB_RECOMPUTE_EXTRINSIC",
                         getattr(cv2, "CALIB_RECOMPUTE_EXTRINSIC", 0)) |
                 getattr(cv2.fisheye, "CALIB_FIX_SKEW",
                         getattr(cv2, "CALIB_FIX_SKEW", 0)))
        criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 1e-6)
        rms, k, d, _rv, _tv = cv2.fisheye.calibrate(
            objpoints, imgpoints, (self.width, self.height), k, d,
            flags=flags, criteria=criteria)
        return float(rms), k, d.reshape(-1)

    def calibrate(self, only_used: bool = False) -> float:
        """mod.rs:205-310: random-subset search for the lowest-RMS calibration."""
        found = sorted(self.used_points if only_used else self.image_points)
        if len(found) < 2:
            raise ValueError("Not enough detected frames to calibrate")
        iterations = self.iterations
        if len(found) <= self.max_images or self.max_images == 0 or only_used:
            iterations = 1

        best = (float("inf"), None, None, None)
        for _ in range(iterations):
            if iterations > 1:
                lo, hi = found[0], found[-1]
                step = max(int((hi - lo) / self.max_images), 1)
                chosen = set()
                val = lo
                for _ in range(self.max_images):
                    in_slice = [f for f in found if val <= f < val + step]
                    if in_slice:
                        chosen.add(random.choice(in_slice))
                    val += step
            else:
                chosen = set(found if only_used else
                             random.sample(found, min(self.max_images, len(found)))
                             if self.max_images else found)
            chosen |= self.forced_frames & set(found)
            frames = sorted(chosen)
            if len(frames) < 2:
                continue
            try:
                rms, k, d = self._run_one(frames)
            except Exception as e:  # noqa: BLE001 — cv2 raises on degenerate sets
                log.debug("calibration attempt failed: %s", e)
                continue
            if rms < best[0]:
                best = (rms, k, d, frames)

        if best[1] is None:
            raise RuntimeError("Calibration failed on all frame subsets")
        self.rms, self.k, self.d, used = best
        self.used_points = {f: self.image_points[f] for f in used}
        return self.rms

    def to_lens_profile(self, camera_brand: str = "", camera_model: str = "",
                        fps: float = 0.0) -> LensProfile:
        p = LensProfile(
            name=f"{camera_brand}_{camera_model}".strip("_"),
            camera_brand=camera_brand, camera_model=camera_model,
            calib_dimension=Dimensions(self.width, self.height),
            orig_dimension=Dimensions(self.width, self.height),
            fps=fps,
            num_images=len(self.used_points),
            fisheye_params=CameraParams(
                RMS_error=self.rms,
                camera_matrix=[list(r) for r in self.k],
                distortion_coeffs=list(self.d)),
            distortion_model="opencv_fisheye",
            calibrator_version="gyroflow-tpu",
            official=False)
        p.init()
        return p
