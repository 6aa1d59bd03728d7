"""Sparse point undistortion — host path used by zoom / sync / stmap.

Port of gyroflow src/core/stabilization/cpu_undistort.rs:636-858
(undistort_points + RS/optical-flow wrappers), vectorized numpy f32/f64.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.keyframes import KeyframeType
from .frame_transform import frame_transform_for_points, get_lens_data_at_timestamp
from .np_models import get_np_model


def _np_params(params, distortion_coeffs):
    k = np.zeros(12)
    k[:len(distortion_coeffs)] = np.asarray(distortion_coeffs)[:12]
    dl = np.zeros(16)
    if params.digital_lens_params:
        dl[:min(16, len(params.digital_lens_params))] = params.digital_lens_params[:16]
    return k, dict(
        digital_lens_params=dl, width=float(params.width), height=float(params.height),
        output_width=float(params.output_width), output_height=float(params.output_height))


def undistort_points(distorted: np.ndarray, camera_matrix: np.ndarray,
                     distortion_coeffs, rotation: np.ndarray, p: Optional[np.ndarray],
                     rot_per_point: Optional[np.ndarray], params,
                     lens_correction_amount: float, fov: float, timestamp_ms: float,
                     shift_per_point: Optional[np.ndarray],
                     mesh: Optional[np.ndarray]) -> np.ndarray:
    """cpu_undistort.rs:652-858 (incl. the FPD/mesh correction path)."""
    pts = np.atleast_2d(np.asarray(distorted, dtype=np.float64))
    n = pts.shape[0]
    f = (camera_matrix[0, 0], camera_matrix[1, 1])
    c = (camera_matrix[0, 2], camera_matrix[1, 2])

    rr = rotation
    if p is not None:
        rr = p @ rr

    v = params.keyframes.value_at_video_timestamp(KeyframeType.LightRefractionCoeff, timestamp_ms)
    lrc = params.light_refraction_coefficient if v is None else v

    k, npp = _np_params(params, distortion_coeffs)
    model_und, model_dist = get_np_model(params.distortion_model.id)
    digital = get_np_model(params.digital_lens.id) if params.digital_lens is not None else None

    x = pts[:, 0].copy()
    y = pts[:, 1].copy()
    if params.lens.input_horizontal_stretch > 0.001:
        x *= params.lens.input_horizontal_stretch
    if params.lens.input_vertical_stretch > 0.001:
        y *= params.lens.input_vertical_stretch

    if digital is not None:
        dpt, dvalid = digital[0](np.stack([x, y], -1), k, npp)
        x = np.where(dvalid, dpt[:, 0], x)
        y = np.where(dvalid, dpt[:, 1], y)

    if mesh is not None and len(mesh) > 9:
        # FPD with += then distorting mesh (cpu_undistort.rs:712-751)
        from ..core.splines import interpolate_mesh
        size = (mesh[3], mesh[4])
        ox, oy = mesh[5], mesh[6]
        cw, ch = mesh[7], mesh[8]
        o = int(mesh[0])
        if mesh[0] > 0.0 and o < len(mesh) and mesh[o] > 0.0:
            stblz_grid = mesh[4] / 8.0
            mu = (x - 0.0) * cw / params.width + ox
            mv = (y - 0.0) * ch / params.height + oy
            idx = np.clip(np.floor(mv / stblz_grid), 0, 7).astype(int)
            delta = mv - stblz_grid * idx
            sh = np.asarray(mesh[o + 4:o + 4 + 16]).reshape(8, 2)
            prefix = np.concatenate([[0.0, 0.0], np.cumsum(sh, axis=0).reshape(-1)])[:16].reshape(8, 2)
            mu = mu + sh[idx, 0] * delta + prefix[idx, 0] * stblz_grid
            mv = mv + sh[idx, 1] * delta + prefix[idx, 1] * stblz_grid
            x = (mu - ox) * params.width / cw
            y = (mv - oy) * params.height / ch
        if mesh[0] > 10.0:
            mu = (x - 0.0) * cw / params.width + ox
            mv = (y - 0.0) * ch / params.height + oy
            pos = interpolate_mesh(mu, mv, size, np.asarray(mesh, np.float64))
            x = (pos[:, 0] - ox) * params.width / cw
            y = (pos[:, 1] - oy) * params.height / ch

    if shift_per_point is not None:
        # IBIS/OIS shift removal (cpu_undistort.rs:752-760) — note the reference
        # reuses the partially-updated x for y (kept bit-faithfully)
        sx, sy, ra, ox, oy = (shift_per_point[:, i] for i in range(5))
        cos_a = np.cos(ra)
        sin_a = np.sin(ra)
        x = x - c[0] - ox + sx
        y = y - c[1] - oy + sy
        x = cos_a * x - sin_a * y + c[0]
        y = sin_a * x + cos_a * y + c[1]

    pw = np.stack([(x - c[0]) / f[0], (y - c[1]) / f[1]], -1)

    und, valid = model_und(pw, k, npp)

    if lrc != 1.0 and lrc > 0.0:
        r = np.linalg.norm(und, axis=-1)
        nz = r != 0
        rs = np.where(nz, r, 1.0)
        sin_theta_d = (rs / np.sqrt(1.0 + rs * rs)) / lrc
        r_d = sin_theta_d / np.sqrt(np.maximum(1.0 - sin_theta_d**2, 1e-12))
        und = und * np.where(nz, r_d / rs, 1.0)[:, None]

    rots = rot_per_point if rot_per_point is not None else np.broadcast_to(rr, (n, 3, 3))
    if rot_per_point is not None and len(rot_per_point) < n:
        rots = np.concatenate([rot_per_point,
                               np.broadcast_to(rr, (n - len(rot_per_point), 3, 3))])
    homo = np.concatenate([und, np.ones((n, 1))], axis=-1)
    pr = np.einsum("nij,nj->ni", rots, homo)
    out = pr[:, :2] / pr[:, 2:3]

    if lens_correction_amount < 1.0:
        out_c = np.array([params.output_width / 2.0, params.output_height / 2.0])
        amount = lens_correction_amount
        factor = max(1.0 - amount, 0.001)
        out_f = np.array([f[0] / fov / factor, f[1] / fov / factor])

        def r_of(o):
            q = o.copy()
            if digital is not None:
                uz = (q - out_c) * fov + out_c
                d, dv = digital[0](uz, k, npp)
                q = np.where(dv[:, None], (d - out_c) / fov + out_c, q)
            nrm = (q - out_c) / out_f
            d, dv = model_und(nrm, k, npp)
            nrm = np.where(dv[:, None], d, nrm)
            if lrc != 1.0 and lrc > 0.0:
                r = np.linalg.norm(nrm, axis=-1)
                nz = r != 0
                rs = np.where(nz, r, 1.0)
                std = (rs / np.sqrt(1 + rs * rs)) / lrc
                rd = std / np.sqrt(np.maximum(1 - std * std, 1e-12))
                nrm = nrm * np.where(nz, rd / rs, 1.0)[:, None]
            return nrm * out_f + out_c

        # initial guess: closed-form inverse blended toward pt (cpu_undistort.rs:819-832)
        nrm = (out - out_c) / out_f
        d = model_dist(nrm[:, 0], nrm[:, 1], np.ones(n), k, npp)
        p2 = d * out_f + out_c
        if digital is not None:
            uz = (p2 - out_c) * fov + out_c
            dd = digital[1](uz[:, 0], uz[:, 1], np.ones(n), k, npp)
            p2 = (dd - out_c) / fov + out_c
        finite = np.isfinite(p2).all(axis=-1)
        o = np.where(finite[:, None], p2 * factor + out * amount, out)

        # Newton on g(o) = amount*o + (1-amount)*R(o) - pt (cpu_undistort.rs:834-851)
        done = np.zeros(n, dtype=bool)
        for _ in range(10):
            r = r_of(o)
            g = amount * o + factor * r - out
            done = done | ((np.abs(g[:, 0]) < 0.02) & (np.abs(g[:, 1]) < 0.02))
            if done.all():
                break
            eps = 1.0
            rx = r_of(o + np.array([eps, 0.0]))
            ry = r_of(o + np.array([0.0, eps]))
            j11 = amount + factor * (rx[:, 0] - r[:, 0]) / eps
            j21 = factor * (rx[:, 1] - r[:, 1]) / eps
            j12 = factor * (ry[:, 0] - r[:, 0]) / eps
            j22 = amount + factor * (ry[:, 1] - r[:, 1]) / eps
            det = j11 * j22 - j12 * j21
            bad = ~np.isfinite(det) | (np.abs(det) < 1e-9)
            done = done | bad
            det = np.where(bad, 1.0, det)
            dx = (j22 * g[:, 0] - j12 * g[:, 1]) / det
            dy = (-j21 * g[:, 0] + j11 * g[:, 1]) / det
            bad2 = ~np.isfinite(dx) | ~np.isfinite(dy)
            done = done | bad2
            upd = ~done
            o[upd, 0] -= np.where(bad2, 0.0, dx)[upd]
            o[upd, 1] -= np.where(bad2, 0.0, dy)[upd]
        out = o

    out = np.where(valid[:, None], out, -1000000.0)
    return out.astype(np.float32)


def undistort_points_with_rolling_shutter(distorted, timestamp_ms: float,
                                          frame: Optional[int], params,
                                          lens_correction_amount: float,
                                          use_fovs: bool) -> np.ndarray:
    """cpu_undistort.rs:636-641."""
    pts = np.atleast_2d(np.asarray(distorted, dtype=np.float64))
    if pts.size == 0:
        return np.zeros((0, 2), np.float32)
    scaled_k, dist, new_k, rotations, shifts, mesh, fov = frame_transform_for_points(
        params, pts, timestamp_ms, frame, use_fovs)
    return undistort_points(pts, scaled_k, dist, rotations[0], np.eye(3),
                            rotations, params, lens_correction_amount, fov,
                            timestamp_ms, shifts, mesh)


def undistort_points_for_optical_flow(distorted, timestamp_us: int, params,
                                      points_dims) -> np.ndarray:
    """cpu_undistort.rs:642-650."""
    img_dim_ratio = points_dims[0] / max(params.width, 1)
    camera_matrix, dist, *_ = get_lens_data_at_timestamp(
        params, timestamp_us / 1000.0, False)
    scaled_k = camera_matrix * img_dim_ratio
    return undistort_points(distorted, scaled_k, dist, np.eye(3), None, None,
                            params, 1.0, 1.0, timestamp_us / 1000.0, None, None)
