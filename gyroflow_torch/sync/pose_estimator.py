"""Camera pose estimation from frame pairs (gyro-video sync).

Port of gyroflow src/core/synchronization/: optical flow (PyrLK via
OpenCV — optical_flow/pyrlk.rs) -> undistorted point pairs -> essential-matrix
pose (find_essential_mat.rs) -> per-pair rotation vector scaled to rad/s
(mod.rs:146), then the synthetic-gyro assembly of recalculate_gyro_data
(mod.rs:269-361: mid-frame timestamps, X/Y swap, deg/s).
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.file_metadata import TimeIMU
from ..core.filtering import lowpass_gyro_forward_backward

log = logging.getLogger(__name__)

RAD2DEG = 180.0 / math.pi


@dataclass
class FrameResult:
    """sync/mod.rs:52-64 (SyncResult)."""
    timestamp_us: int
    rotvec: Optional[np.ndarray] = None     # rad/s (already fps-scaled)
    points: int = 0
    # matched optical-flow pixel pairs (for rs-sync / visual_features):
    # p0 at timestamp_us, p1 at next_ts (sync/mod.rs optical_flow map)
    of_points: Optional[Tuple[np.ndarray, np.ndarray]] = None
    next_ts: int = 0


OF_METHODS = ("pyrlk", "dis", "akaze")  # OpticalFlowMethod (optical_flow/mod.rs:11-36)

# ---- Almeida rotation-only estimator (estimate_pose/almeida.rs) ------------

_ALMEIDA_EPS = 0.001 * math.pi / 180.0
_ALMEIDA_ALPHA = 0.5


class _AlmeidaCamera:
    """almeida.rs Camera: flow deltas of candidate rotations through the full
    lens model (lens_correction_amount forced to 0 like PoseAlmeida::init)."""

    def __init__(self, est: "PoseEstimator", ts_ms: float):
        import copy
        from ..ops.frame_transform import get_lens_data_at_timestamp
        self.cp = copy.copy(est.cp)
        self.cp.lens_correction_amount = 0.0
        self.ts_ms = ts_ms
        (self.camera_matrix, self.coeffs, _r, _h, _v, _f) = \
            get_lens_data_at_timestamp(self.cp, ts_ms, False)
        self.vw = float(self.cp.width)
        self.vh = float(self.cp.height)

    def delta(self, pos01: np.ndarray, rot3: np.ndarray) -> np.ndarray:
        from ..ops.undistort_points import undistort_points
        pts = pos01 * [self.vw, self.vh]
        und = undistort_points(pts, np.asarray(self.camera_matrix, np.float64),
                               self.coeffs, np.asarray(rot3, np.float64),
                               np.asarray(self.camera_matrix, np.float64),
                               None, self.cp, 1.0, 1.0, self.ts_ms, None, None)
        return np.asarray(und, np.float64) / [self.vw, self.vh] - pos01

    def axis_deltas(self, pos01: np.ndarray):
        """(droll, dpitch, dyaw) flow derivatives at eps (rotation-independent,
        hoisted out of the iteration loop)."""
        from ..core import quaternion as quat
        def rot(rx, ry, rz):
            return quat.to_rotation_matrix(quat.from_euler_xyz(rx, ry, rz))
        return (self.delta(pos01, rot(0.0, _ALMEIDA_EPS, 0.0)),
                self.delta(pos01, rot(_ALMEIDA_EPS, 0.0, 0.0)),
                self.delta(pos01, rot(0.0, 0.0, -_ALMEIDA_EPS)))

    def point_angle(self, pos_px: np.ndarray) -> np.ndarray:
        cm = self.camera_matrix
        p = pos_px - [cm[0][2], cm[1][2]]
        return np.arctan(p / [cm[0][0], cm[1][1]])


def _almeida_solve_given(pos, mot, cam: _AlmeidaCamera):
    """almeida.rs solve_ypr_given: iterative LS of (roll, pitch, yaw)."""
    from ..core import quaternion as quat
    d_axes = cam.axis_deltas(pos)          # 3 x (N, 2)
    limit = int(math.ceil(15.0 / _ALMEIDA_ALPHA))
    q = quat.identity()
    for i in range(limit):
        alpha = 1.0 if i == limit - 1 else _ALMEIDA_ALPHA
        delta = cam.delta(pos, quat.to_rotation_matrix(q))
        v0 = mot - delta
        vs = [v0, *d_axes]
        a = np.array([[np.sum(vs[i1] * vs[j1]) for j1 in (1, 2, 3)]
                      for i1 in (1, 2, 3)])
        b = np.array([np.sum(vs[i1] * vs[0]) for i1 in (1, 2, 3)])
        try:
            model = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            model = np.zeros(3)
        model = model * _ALMEIDA_EPS * alpha
        roll = quat.from_euler_xyz(0.0, model[0], 0.0)
        pitch = quat.from_euler_xyz(model[1], 0.0, 0.0)
        yaw = quat.from_euler_xyz(0.0, 0.0, -model[2])
        inc = quat.multiply(quat.multiply(pitch, roll), yaw)
        q = quat.multiply(q, inc)
    return quat.inverse(q)


def _almeida_solve_ransac(pos, mot, est: "PoseEstimator", ts_ms: float,
                          num_iters: int = None, inlier_angle_deg: float = 0.05,
                          num_samples: int = 1000):
    """almeida.rs solve_ypr_ransac. The inlier test uses pixel coordinates for
    point_angle (the reference passes normalized coords into a pixel-space
    intrinsics subtraction; consistent units keep the test meaningful)."""
    from ..core import quaternion as quat
    cam = _AlmeidaCamera(est, ts_ms)
    n = len(pos)
    num_iters = est.almeida_iters if num_iters is None else num_iters
    if n < 3:
        return None
    rng = np.random.default_rng(0)
    target = math.radians(inlier_angle_deg)
    best_mask = None
    best_count = -1
    for _ in range(num_iters):
        idx = rng.choice(n, size=3, replace=n < 3)
        fit = _almeida_solve_given(pos[idx], mot[idx], cam)
        sub = rng.choice(n, size=min(num_samples, n), replace=False)
        mat = quat.to_rotation_matrix(quat.inverse(fit))
        delta = cam.delta(pos[sub], mat)
        sample = pos[sub] + delta
        vec = mot[sub] - delta
        ang = cam.point_angle(sample * [cam.vw, cam.vh])
        resid = np.sum((vec * np.cos(ang)) ** 2, axis=1)
        mask = sub[resid <= target * target]
        if len(mask) > best_count:
            best_count = len(mask)
            best_mask = mask
    if best_mask is None or len(best_mask) < 3:
        return None
    return _almeida_solve_given(pos[best_mask], mot[best_mask], cam)
# estimate_pose/mod.rs:28-36 int mapping
POSE_METHODS = ("essential_matrix", "almeida", "eight_point", "homography")


class PoseEstimator:
    def __init__(self, compute_params, processing_size: Tuple[int, int],
                 of_method: str = "pyrlk", pose_method=0):
        self.cp = compute_params
        self.size = processing_size
        self.of_method = of_method if of_method in OF_METHODS else "pyrlk"
        if isinstance(pose_method, str):
            pose_method = POSE_METHODS.index(pose_method) \
                if pose_method in POSE_METHODS else 0
        self.pose_method = int(pose_method)
        self.almeida_iters = 200   # almeida.rs num_iters
        self.results: Dict[int, FrameResult] = {}
        self.estimated_gyro: List[TimeIMU] = []
        self._prev = None  # (timestamp_us, gray, pts)
        self._dis = None

    def _flow_pairs(self, prev_gray, gray, prev_pts):
        """Matched point pairs (p0, p1) by the selected optical-flow method."""
        import cv2
        if self.of_method == "dis":
            # optical_flow/opencv_dis.rs: dense DIS flow sampled at features
            if self._dis is None:
                self._dis = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
            flow = self._dis.calc(prev_gray, gray, None)
            p0 = prev_pts.reshape(-1, 2)
            xi = np.clip(p0[:, 0].round().astype(int), 0, gray.shape[1] - 1)
            yi = np.clip(p0[:, 1].round().astype(int), 0, gray.shape[0] - 1)
            return p0, p0 + flow[yi, xi]
        if self.of_method == "akaze":
            # optical_flow/akaze.rs: feature match instead of tracking.
            # Binary descriptors + Hamming match; ORB stands in when the cv2
            # build ships without AKAZE.
            det = (cv2.AKAZE_create() if hasattr(cv2, "AKAZE_create")
                   else cv2.ORB_create(nfeatures=800))
            k0, d0 = det.detectAndCompute(prev_gray, None)
            k1, d1 = det.detectAndCompute(gray, None)
            if d0 is None or d1 is None or len(k0) < 8 or len(k1) < 8:
                return np.zeros((0, 2)), np.zeros((0, 2))
            matches = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(d0, d1)
            matches = sorted(matches, key=lambda m: m.distance)[:300]
            p0 = np.asarray([k0[m.queryIdx].pt for m in matches])
            p1 = np.asarray([k1[m.trainIdx].pt for m in matches])
            return p0, p1
        nxt, st, _err = cv2.calcOpticalFlowPyrLK(prev_gray, gray, prev_pts, None,
                                                 winSize=(21, 21), maxLevel=3)
        if nxt is None or st is None:
            return np.zeros((0, 2)), np.zeros((0, 2))
        ok = st.reshape(-1) == 1
        return prev_pts.reshape(-1, 2)[ok], nxt.reshape(-1, 2)[ok]

    def feed_frame(self, timestamp_us: int, gray: np.ndarray, fps: float):
        """Track features from the previous frame and estimate the pair pose."""
        import cv2
        from ..ops.undistort_points import undistort_points_for_optical_flow

        pts = cv2.goodFeaturesToTrack(gray, maxCorners=200, qualityLevel=0.01,
                                      minDistance=16)
        if self._prev is not None and self._prev[2] is not None:
            prev_ts, prev_gray, prev_pts = self._prev
            p0, p1 = self._flow_pairs(prev_gray, gray, prev_pts)
            if len(p0) >= 8:
                # retain raw pairs for rs-sync / visual_features (rs_sync.rs
                # collect_points); pose estimation may still fail below
                self.results[prev_ts] = FrameResult(
                    prev_ts, of_points=(np.asarray(p0, np.float64),
                                        np.asarray(p1, np.float64)),
                    next_ts=timestamp_us, points=int(len(p0)))
                u0 = np.asarray(undistort_points_for_optical_flow(
                    p0.astype(np.float64), prev_ts, self.cp, self.size), np.float64)
                u1 = np.asarray(undistort_points_for_optical_flow(
                    p1.astype(np.float64), timestamp_us, self.cp, self.size), np.float64)
                good = (np.abs(u0) < 100).all(axis=1) & (np.abs(u1) < 100).all(axis=1)
                u0, u1 = u0[good], u1[good]
                if self.pose_method == 1:
                    R = self._pose_almeida(p0, p1, prev_ts)
                elif self.pose_method == 2 and len(u0) >= 8:
                    R = self._pose_eight_point(u0, u1)
                elif self.pose_method == 3 and len(u0) >= 8:
                    R = self._pose_homography(u0, u1)
                elif len(u0) >= 8:
                    R = self._pose_essential(u0, u1)
                else:
                    R = None
                if R is not None:
                    rv, _ = cv2.Rodrigues(R)
                    dt_s = (timestamp_us - prev_ts) / 1e6
                    if dt_s > 0:
                        fr = self.results.get(prev_ts) or FrameResult(prev_ts)
                        fr.rotvec = rv.reshape(3) / dt_s
                        fr.points = int(len(u0))
                        self.results[prev_ts] = fr
        self._prev = (timestamp_us, gray, pts)

    # ---- pose methods (estimate_pose/mod.rs registry) ----------------------

    @staticmethod
    def _pose_essential(u0, u1):
        """find_essential_mat.rs:37-45: LMEDS, threshold 1e-5, 4000 iters,
        triangulated recoverPose, >= 10 inliers."""
        import cv2
        E, mask = cv2.findEssentialMat(u0, u1, np.eye(3), method=cv2.LMEDS,
                                       prob=0.999, threshold=1e-5, maxIters=4000)
        if E is None or E.shape != (3, 3):
            return None
        inliers, R, _t, _mask2, _tri = cv2.recoverPose(
            E, u0, u1, np.eye(3), distanceThresh=100000.0, mask=mask)
        return R if inliers >= 10 else None

    @staticmethod
    def _pose_eight_point(u0, u1):
        """eight_point.rs: 8-point algorithm inside a robust consensus loop
        over escalating thresholds (arrsac 1e-10/1e-8/1e-6 -> RANSAC reproj
        ladder on normalized coords)."""
        import cv2
        for thr in (1e-4, 1e-3, 1e-2):
            F, mask = cv2.findFundamentalMat(u0, u1, cv2.FM_RANSAC, thr, 0.999,
                                             2000)
            if F is None or F.shape != (3, 3):
                continue
            # normalized coords -> fundamental == essential
            inliers, R, _t, _m = cv2.recoverPose(F, u0, u1, mask=mask)
            if inliers >= 10:
                return R
        log.warning("eight-point: couldn't find model")
        return None

    @staticmethod
    def _pose_homography(u0, u1):
        """find_homography.rs: RANSAC homography on undistorted normalized
        points, decompose, pick the solution with the smallest |t|."""
        import cv2
        H, _mask = cv2.findHomography(u0, u1, cv2.RANSAC, 0.001,
                                      maxIters=2000, confidence=0.999)
        if H is None:
            return None
        n, Rs, Ts, _Ns = cv2.decomposeHomographyMat(H, np.eye(3))
        if not n:
            return None
        best = min(range(n), key=lambda i: float(Ts[i].reshape(-1) @ Ts[i].reshape(-1)))
        return Rs[best]

    def _pose_almeida(self, p0, p1, timestamp_us: int):
        """almeida.rs: iterative least-squares of roll/pitch/yaw increments on
        the optical-flow field (RANSAC over 3-point fits). Returns the frame
        rotation matrix (the estimator's inverse-of-point-rotation, inverted
        again per PoseAlmeida::estimate_pose)."""
        from ..core import quaternion as quat
        w, h = float(self.size[0]), float(self.size[1])
        pos = np.asarray(p0, np.float64) / [w, h]
        mot = (np.asarray(p1, np.float64) - np.asarray(p0, np.float64)) / [w, h]
        if len(pos) < 3:
            return None
        ts_ms = timestamp_us / 1000.0
        q = _almeida_solve_ransac(pos, mot, self, ts_ms)
        if q is None:
            return None
        # estimator returns inverse already; estimate_pose inverts again
        return quat.to_rotation_matrix(quat.inverse(q))

    def recalculate_gyro_data(self, fps: float, lpf_hz: float = 0.0):
        """mod.rs:269-361: mid-frame timestamps, X/Y swap, deg/s, optional LPF."""
        gyro = []
        keys = sorted(self.results)
        for i, k in enumerate(keys):
            r = self.results[k]
            if r.rotvec is None:
                continue
            ts_ms = k / 1000.0
            if i + 1 < len(keys):
                ts_ms += (keys[i + 1] / 1000.0 - ts_ms) / 2.0
            e = r.rotvec
            gyro.append(TimeIMU(timestamp_ms=ts_ms,
                                gyro=np.array([e[1] * RAD2DEG, e[0] * RAD2DEG,
                                               e[2] * RAD2DEG])))
        if lpf_hz > 0.0 and fps > 0.0:
            lowpass_gyro_forward_backward(lpf_hz, fps, gyro)
        self.estimated_gyro = gyro
        return gyro
