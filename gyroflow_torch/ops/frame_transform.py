"""Per-frame transform construction — the host-side f64 math feeding the kernel.

Port of gyroflow src/core/stabilization/frame_transform.rs. The per-row table
(rayon par_iter in the reference, :249-308: the rolling-shutter matrices and
the IBIS / OIS shifts) is built in one pass of native/ft_rows.cpp whenever the
native library loads, else as one vectorized numpy batch (_rows_numpy, its
twin to the bit), and emitted as the (matrix_count, 14) f32 table the kernels
consume.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import native as _native
from .. import trace
from ..core import quaternion as quat
from ..core.keyframes import KeyframeType
from ..core.params import ComputeParams, frame_at_timestamp
from .kernel_params import (ANY_UNDERWATER, FRAMEBUFFER_INVERTED, HAS_DIGITAL_LENS,
                            HAS_FPD_DATA, HAS_IBIS_DATA, HAS_MESH_DATA, HORIZONTAL_RS,
                            KernelConfig, KernelDynamics)


def _get_closest(d: dict, key_us: int, max_dist_us: int):
    """MapClosest::get_closest (util.rs:71): nearest key within max_dist."""
    if not d:
        return None
    keys = sorted(d)
    import bisect
    i = bisect.bisect_left(keys, key_us)
    best = None
    for j in (i - 1, i):
        if 0 <= j < len(keys) and abs(keys[j] - key_us) <= max_dist_us:
            if best is None or abs(keys[j] - key_us) < abs(best - key_us):
                best = keys[j]
    return d[best] if best is not None else None


@dataclass
class FrameTransform:
    matrices: np.ndarray = field(default_factory=lambda: np.zeros((1, 14), np.float32))
    kernel_cfg: Optional[KernelConfig] = None
    kernel_dyn: Optional[KernelDynamics] = None
    fov: float = 1.0
    minimal_fov: float = 1.0
    focal_length: Optional[float] = None
    mesh_data: Optional[np.ndarray] = None


def get_frame_readout_time(params: ComputeParams, can_invert: bool,
                           timestamp_ms: float, file_metadata) -> float:
    """frame_transform.rs:22-36."""
    frt = abs(params.frame_readout_time)
    scale = 1.0
    lp = _get_closest(file_metadata.lens_params, int(round(timestamp_ms * 1000.0)), 100000)
    if lp is not None and lp.capture_area_size and lp.sensor_size_px:
        if lp.sensor_size_px[1]:
            scale = lp.capture_area_size[1] / lp.sensor_size_px[1]
    if can_invert and params.framebuffer_inverted and not params.frame_readout_direction.is_horizontal:
        frt *= -1.0
    if params.frame_readout_direction.is_inverted:
        frt *= -1.0
    return frt * scale


def get_new_k(params: ComputeParams, camera_matrix: np.ndarray, fov: float) -> np.ndarray:
    """frame_transform.rs:37-51."""
    horizontal_ratio = params.lens.input_horizontal_stretch \
        if params.lens.input_horizontal_stretch > 0.01 else 1.0
    img_dim_ratio = 1.0 / horizontal_ratio
    new_k = camera_matrix.copy()
    new_k[0, 0] = new_k[0, 0] * img_dim_ratio / fov
    new_k[1, 1] = new_k[1, 1] * img_dim_ratio / fov
    new_k[0, 2] = params.output_width / 2.0
    new_k[1, 2] = params.output_height / 2.0
    return new_k


def get_fov(params: ComputeParams, frame: int, use_fovs: bool, timestamp_ms: float,
            for_ui: bool) -> float:
    """frame_transform.rs:52-58."""
    v = params.keyframes.value_at_video_timestamp(KeyframeType.Fov, timestamp_ms)
    fov_scale = params.fov_scale if v is None else v
    if params.fov_overview and use_fovs and not for_ui:
        fov_scale += 1.0
    if use_fovs:
        if frame < len(params.fovs):
            base = params.fovs[frame]
        elif len(params.fovs) > 1:
            base = params.fovs[-1]
        else:
            base = 1.0
        fov = base * fov_scale
    else:
        fov = 1.0
    fov = max(fov, 0.001)
    fov *= params.width / max(params.output_width, 1)
    return fov


def focal_length_fov_compensation(params: ComputeParams, frame: int) -> float:
    """frame_transform.rs:71-80."""
    if not params.focal_length_smoothing_enabled:
        return 1.0
    if frame >= len(params.focal_lengths) or frame >= len(params.smoothed_focal_lengths):
        return 1.0
    deq = params.focal_lengths[frame]
    sm = params.smoothed_focal_lengths[frame]
    if deq and sm and deq > 0.0 and sm > 0.0:
        return deq / sm
    return 1.0


def get_lens_data_at_timestamp(params: ComputeParams, timestamp_ms: float,
                               invert_asym_lens: bool):
    """frame_transform.rs:82-163.

    Returns (camera_matrix, distortion_coeffs, radial_distortion_limit,
    input_horizontal_stretch, input_vertical_stretch, focal_length)."""
    fm = params.gyro.file_metadata if params.gyro is not None else None
    lens = params.lens

    interpolated = None
    if fm is not None and fm.lens_positions:
        val = _get_closest(fm.lens_positions, int(round(timestamp_ms * 1000.0)), 100000)
        if val is not None:
            interpolated = lens.get_interpolated_lens_at(val)
    if interpolated is not None:
        lens = interpolated

    focal_length = lens.focal_length
    camera_matrix = lens.get_camera_matrix((params.width, params.height), invert_asym_lens)
    distortion_coeffs = lens.get_distortion_coeffs()
    radial_limit = lens.fisheye_params.radial_distortion_limit or 0.0

    stretch_lens = True
    digital_zoom = (fm.digital_zoom if fm is not None else None) or 0.0

    if fm is not None and fm.lens_params and len(lens.fisheye_params.distortion_coeffs) < 4:
        val = _get_closest(fm.lens_params, int(round(timestamp_ms * 1000.0)), 100000)
        if val is not None:
            pfl = val.pixel_focal_length
            if pfl is None and val.focal_length and val.pixel_pitch and val.capture_area_size:
                fl_mm = val.focal_length
                focal_length = fl_mm
                pp = val.pixel_pitch
                crop = val.capture_area_size
                if pp[0] and pp[1] and crop[0] > 0 and crop[1] > 0:
                    pfl = ((fl_mm / ((pp[0] / 1_000_000.0) * crop[0])) * params.width,
                           (fl_mm / ((pp[1] / 1_000_000.0) * crop[1])) * params.height)
            if pfl is not None:
                camera_matrix[0, 0] = pfl[0]
                camera_matrix[1, 1] = pfl[1]
                if val.principal_point:
                    camera_matrix[0, 2] = val.principal_point[0]
                    camera_matrix[1, 2] = val.principal_point[1]
                stretch_lens = False
                if val.focal_length:
                    focal_length = val.focal_length
            if val.distortion_coefficients and len(val.distortion_coefficients) <= 12:
                for i, x in enumerate(val.distortion_coefficients):
                    distortion_coeffs[i] = x
                from .distortion_models import radial_distortion_limit as rdl
                radial_limit = rdl(params.distortion_model, distortion_coeffs) or 0.0

    if lens.calib_dimension.w > 0 and lens.calib_dimension.h > 0:
        calib_w, calib_h = float(lens.calib_dimension.w), float(lens.calib_dimension.h)
    else:
        calib_w, calib_h = float(max(params.width, 1)), float(max(params.height, 1))

    ihs = lens.input_horizontal_stretch if lens.input_horizontal_stretch > 0.01 else 1.0
    ivs = lens.input_vertical_stretch if lens.input_vertical_stretch > 0.01 else 1.0

    if stretch_lens:
        rx = (params.width / calib_w) * ihs
        ry = (params.height / calib_h) * ivs
        camera_matrix[0, 0] *= rx
        camera_matrix[1, 1] *= ry
        camera_matrix[0, 2] *= rx
        camera_matrix[1, 2] *= ry
    if digital_zoom > 0.0:
        camera_matrix[0, 0] *= digital_zoom
        camera_matrix[1, 1] *= digital_zoom

    return camera_matrix, distortion_coeffs, radial_limit, ihs, ivs, focal_length


def _image_rotation_matrix(deg: float) -> np.ndarray:
    """Matrix3::new_rotation(rad) — 2D rotation embedded in 3x3."""
    r = deg * math.pi / 180.0
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _sign_fixup(r: np.ndarray, framebuffer_inverted: bool) -> np.ndarray:
    """frame_transform.rs:261-267 (vectorized over leading dims)."""
    out = r.copy()
    if framebuffer_inverted:
        out[..., 0, 2] *= -1.0
        out[..., 1, 2] *= -1.0
        out[..., 2, 0] *= -1.0
        out[..., 2, 1] *= -1.0
    else:
        out[..., 0, 1] *= -1.0
        out[..., 0, 2] *= -1.0
        out[..., 1, 0] *= -1.0
        out[..., 2, 0] *= -1.0
    return out


def _inverse_k(new_k: np.ndarray) -> np.ndarray:
    """new_k's inverse, or its pseudo-inverse where new_k is near singular.

    A row's matrix is (new_k @ r)^-1 == r.T @ new_k^-1 (r a rotation): one
    3x3 inverse a frame instead of a per-row SVD (np.linalg.pinv on (2160,
    3, 3) cost 5.4 ms a frame; the two differ by 7e-16 in float64). For a
    near-singular new_k (a degenerate fov or focal keyframe) the reference
    takes (new_k*r).pseudo_inverse(1e-6) (frame_transform.rs:296), which
    drops singular values <= 1e-6: mirrored by an SVD pseudo-inverse
    whenever the plain inverse is not finite or new_k is ill-conditioned."""
    inv_k = None
    try:
        inv_k = np.linalg.inv(new_k)
        if not np.isfinite(inv_k).all() or np.linalg.cond(new_k) > 1e12:
            inv_k = None
    except np.linalg.LinAlgError:
        inv_k = None
    if inv_k is None:
        u, s, vt = np.linalg.svd(new_k)
        s_inv = np.where(s > 1e-6, 1.0 / np.where(s > 1e-6, s, 1.0), 0.0)
        inv_k = (vt.T * s_inv) @ u.T                 # pinv(new_k), eps=1e-6
    return inv_k


def _rows_numpy(params: ComputeParams, gyro, stab, rows: int, ts: float, start_ts: float,
                row_readout_time: float, frame_readout_time: float, image_rotation: np.ndarray,
                inv_k: np.ndarray) -> np.ndarray:
    """The (rows, 14) float32 table: per row the RS matrix (new_k @ r)^-1
    and the IBIS / OIS shifts. The twin of ft_rows.cpp (_rows_native)."""
    quat1 = quat.inverse(gyro.org_quat_at_timestamp(ts))
    smoothed_quat1 = gyro.smoothed_quat_at_timestamp(ts)

    # ---- vectorized per-row matrices (reference: rayon par_iter :249-308) ---
    ys = np.arange(rows, dtype=np.float64)
    quat_times = start_ts + row_readout_time * ys if abs(frame_readout_time) > 0.0 \
        else np.full(rows, start_ts)
    row_quats = gyro.org_quat_at_timestamp(quat_times)          # (rows, 4)
    q = quat.multiply(smoothed_quat1, quat.multiply(quat1, row_quats))
    r = np.einsum("ij,njk->nik", image_rotation, quat.to_rotation_matrix(q))
    r = _sign_fixup(r, params.framebuffer_inverted)

    ibis = np.zeros((rows, 5), dtype=np.float64)
    if stab is not None:
        is_scale = (
            params.width / stab.crop_area[2] / stab.pixel_pitch[0],
            params.height / stab.crop_area[3] / stab.pixel_pitch[1] *
            (-1.0 if params.framebuffer_inverted else 1.0),
        )
        y_sensor = stab.crop_area[1] + (ys / params.height) * stab.crop_area[3]
        if params.framebuffer_inverted:
            y_sensor = stab.sensor_size[1] - y_sensor
        s = stab.ibis_spline.interpolate(y_sensor + stab.offset)
        o = stab.ois_spline.interpolate(y_sensor + stab.offset)
        ibis[:, 0] = s[:, 0] * is_scale[0]
        ibis[:, 1] = s[:, 1] * is_scale[1]
        ibis[:, 2] = np.radians(s[:, 2] / 1000.0 * (-1.0 if params.framebuffer_inverted else 1.0))
        ibis[:, 3] = o[:, 0] * is_scale[0]
        ibis[:, 4] = o[:, 1] * is_scale[1]

    if params.suppress_rotation:
        r = np.broadcast_to(np.eye(3), r.shape).copy()
        if params.frame_readout_time == 0.0:
            ibis[:] = 0.0

    # (new_k @ r)^+ == r.T @ new_k^+ (r orthonormal)
    i_r = np.einsum("nij,jk->nik", r.transpose(0, 2, 1), inv_k)  # (rows,3,3)
    return np.concatenate([i_r.reshape(rows, 9), ibis], axis=1).astype(np.float32)


# what _rows_native passes for no gyro (identity rows) and for no IBIS data
_NO_QUATS = (np.zeros(0, np.int64), np.zeros((0, 4)))
_NO_SPLINE = (np.zeros(0), np.zeros((0, 3)))


def _rows_native(params: ComputeParams, gyro, stab, rows: int, ts: float, start_ts: float,
                 row_readout_time: float, frame_readout_time: float, image_rotation: np.ndarray,
                 inv_k: np.ndarray) -> np.ndarray:
    """_rows_numpy in one pass of native code (native/ft_rows.cpp): the
    same float32 table, the per-frame constants gathered here."""
    inverted = params.framebuffer_inverted
    frame = [ts, start_ts, row_readout_time, abs(frame_readout_time) > 0.0, inverted,
             params.suppress_rotation, params.height]
    if stab is None:
        frame += [0.0] * 9
        ibis = ois = _NO_SPLINE
    else:
        frame += [1.0, params.suppress_rotation and params.frame_readout_time == 0.0,
                  stab.crop_area[1], stab.crop_area[3], stab.sensor_size[1], stab.offset,
                  params.width / stab.crop_area[2] / stab.pixel_pitch[0],
                  params.height / stab.crop_area[3] / stab.pixel_pitch[1] *
                  (-1.0 if inverted else 1.0),
                  -1.0 if inverted else 1.0]
        ibis = (stab.ibis_spline.positions, stab.ibis_spline.values)
        ois = (stab.ois_spline.positions, stab.ois_spline.values)
    offsets = gyro.offsets_adjusted
    keys = sorted(offsets)
    # GyroSource._quat_at reads identity without two samples or a duration
    org, smoothed = ((tq.timestamps_us, tq.quats) if len(tq) >= 2 and gyro.duration_ms > 0.0
                     else _NO_QUATS for tq in (gyro.quaternions, gyro.smoothed_quaternions))
    return _native.ft_rows(rows, frame, np.concatenate([image_rotation.ravel(), inv_k.ravel()]),
                           (keys, [offsets[k] for k in keys]), org, smoothed, ibis, ois)


def frame_transform_at(params: ComputeParams, timestamp_ms: float, frame: int) -> FrameTransform:
    """FrameTransform::at_timestamp (frame_transform.rs:165-350), vectorized."""
    kf = params.keyframes

    def kv(typ, default):
        v = kf.value_at_video_timestamp(typ, timestamp_ms)
        return default if v is None else v

    video_rotation = kv(KeyframeType.VideoRotation, params.video_rotation)
    background_margin = kv(KeyframeType.BackgroundMargin, params.background_margin)
    background_feather = kv(KeyframeType.BackgroundFeather, params.background_margin_feather)
    lens_correction_amount = kv(KeyframeType.LensCorrectionStrength, params.lens_correction_amount)
    az_cx = kv(KeyframeType.ZoomingCenterX, params.adaptive_zoom_center_offset[0])
    az_cy = kv(KeyframeType.ZoomingCenterY, params.adaptive_zoom_center_offset[1])
    lrc = kv(KeyframeType.LightRefractionCoeff, params.light_refraction_coefficient)

    with trace.span("gf.ft.lens"):
        (camera_matrix, distortion_coeffs, radial_limit, ihs, ivs,
         focal_length) = get_lens_data_at_timestamp(params, timestamp_ms, False)

    fl_comp = focal_length_fov_compensation(params, frame)
    fov = get_fov(params, frame, True, timestamp_ms, False) * fl_comp
    ui_fov = get_fov(params, frame, True, timestamp_ms, True)
    if params.lens.optimal_fov is not None:
        if not params.fovs:
            fov *= params.lens.optimal_fov
        else:
            ui_fov /= params.lens.optimal_fov

    reported_fl = focal_length
    if params.focal_length_smoothing_enabled and frame < len(params.smoothed_focal_lengths):
        reported_fl = params.smoothed_focal_lengths[frame] or focal_length

    scaled_k = camera_matrix
    new_k = get_new_k(params, camera_matrix, fov)

    gyro = params.gyro
    fm = gyro.file_metadata

    mesh_data = None
    if frame < len(fm.mesh_correction):
        mesh_data = fm.mesh_correction[frame][1]

    frame_readout_time = get_frame_readout_time(params, True, timestamp_ms, fm)
    row_count = params.width if params.frame_readout_direction.is_horizontal else params.height
    row_readout_time = frame_readout_time / row_count
    ts = timestamp_ms + (fm.per_frame_time_offsets[frame]
                         if frame < len(fm.per_frame_time_offsets) else 0.0)
    start_ts = ts - frame_readout_time / 2.0

    image_rotation = _image_rotation_matrix(video_rotation)

    rows = row_count if abs(frame_readout_time) > 0.0 else 1
    stab = fm.camera_stab_data[frame] if frame < len(fm.camera_stab_data) else None

    with trace.span("gf.ft.rows"):
        inv_k = _inverse_k(new_k)
        table = (params, gyro, stab, rows, ts, start_ts, row_readout_time, frame_readout_time,
                 image_rotation, inv_k)
        if _native.available():
            matrices = _rows_native(*table)
            trace.count("gf.ft.native_rows", rows)
        else:
            matrices = _rows_numpy(*table)

    az_cy_eff = -az_cy if params.framebuffer_inverted else az_cy

    flags = 0
    if params.frame_readout_direction.is_horizontal:
        flags |= HORIZONTAL_RS
    if params.framebuffer_inverted:
        flags |= FRAMEBUFFER_INVERTED
    if params.digital_lens is not None:
        flags |= HAS_DIGITAL_LENS
    if stab is not None:
        flags |= HAS_IBIS_DATA
    if lrc != 1.0 and lrc > 0.0:
        flags |= ANY_UNDERWATER

    # mesh flag semantics from cpu_undistort.rs:169,188
    mesh_grid = None
    if mesh_data is not None and len(mesh_data) > 9:
        o = int(mesh_data[0])
        if mesh_data[0] > 10.0:
            flags |= HAS_MESH_DATA
        if mesh_data[0] > 0.0 and o < len(mesh_data) and mesh_data[o] > 0.0:
            flags |= HAS_FPD_DATA
        if flags & (HAS_MESH_DATA | HAS_FPD_DATA):
            mesh_grid = (int(mesh_data[1]), int(mesh_data[2]))
        else:
            mesh_data = None
    else:
        mesh_data = None

    dl_params = list(params.digital_lens_params or [])

    cfg = KernelConfig(
        width=params.width, height=params.height,
        output_width=params.output_width, output_height=params.output_height,
        background_mode=int(params.background_mode),
        distortion_model=params.distortion_model.id,
        digital_lens=params.digital_lens.id if params.digital_lens is not None else None,
        flags=flags,
        lens_correction=lens_correction_amount < 1.0 or
        kf.is_keyframed(KeyframeType.LensCorrectionStrength),
        input_rotation=0.0,
        mesh_grid=mesh_grid,
    )
    dyn = KernelDynamics.make(
        f=(scaled_k[0, 0], scaled_k[1, 1]), c=(scaled_k[0, 2], scaled_k[1, 2]),
        k=np.asarray(distortion_coeffs, np.float32), fov=fov, r_limit=radial_limit,
        lens_correction_amount=lens_correction_amount,
        input_horizontal_stretch=ihs, input_vertical_stretch=ivs,
        background=params.background,
        background_margin=background_margin, background_margin_feather=background_feather,
        translation2d=(az_cx * params.width / fov, az_cy_eff * params.height / fov),
        digital_lens_params=dl_params,
        light_refraction_coefficient=lrc,
    )

    minimal_fov = params.minimal_fovs[frame] if frame < len(params.minimal_fovs) else 1.0
    mesh_arr = np.asarray(mesh_data, dtype=np.float32) if mesh_data is not None else None
    return FrameTransform(matrices=matrices, kernel_cfg=cfg, kernel_dyn=dyn,
                          fov=ui_fov, minimal_fov=minimal_fov,
                          focal_length=reported_fl, mesh_data=mesh_arr)


def frame_transform_for_points(params: ComputeParams, points: np.ndarray,
                               timestamp_ms: float, frame: Optional[int],
                               use_fovs: bool):
    """FrameTransform::at_timestamp_for_points (frame_transform.rs:352-438).

    Returns (scaled_k, distortion_coeffs, new_k, rotations (P,3,3),
    shifts (P,5)|None, mesh|None, fov)."""
    kf = params.keyframes
    v = kf.value_at_video_timestamp(KeyframeType.VideoRotation, timestamp_ms)
    video_rotation = params.video_rotation if v is None else v

    if frame is None:
        frame = frame_at_timestamp(timestamp_ms, params.scaled_fps)

    camera_matrix, distortion_coeffs, _, _, _, _ = get_lens_data_at_timestamp(
        params, timestamp_ms, params.framebuffer_inverted)

    fl_comp = focal_length_fov_compensation(params, frame)
    fov = get_fov(params, frame, use_fovs, timestamp_ms, False) * fl_comp
    scaled_k = camera_matrix
    new_k = get_new_k(params, camera_matrix, fov)

    gyro = params.gyro
    fm = gyro.file_metadata

    mesh = None
    if frame < len(fm.mesh_correction):
        mesh = fm.mesh_correction[frame][0]  # distorting mesh

    frame_readout_time = get_frame_readout_time(params, False, timestamp_ms, fm)
    row_count = params.width if params.frame_readout_direction.is_horizontal else params.height
    row_readout_time = frame_readout_time / row_count
    ts = timestamp_ms + (fm.per_frame_time_offsets[frame]
                         if frame < len(fm.per_frame_time_offsets) else 0.0)
    start_ts = ts - frame_readout_time / 2.0

    image_rotation = _image_rotation_matrix(video_rotation)
    quat1 = quat.inverse(gyro.org_quat_at_timestamp(ts))
    smoothed_quat1 = gyro.smoothed_quat_at_timestamp(ts)

    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    if abs(frame_readout_time) > 0.0:
        axis = pts[:, 0] if params.frame_readout_direction.is_horizontal else pts[:, 1]
        quat_times = start_ts + row_readout_time * axis
    else:
        pts = np.zeros((1, 2))
        quat_times = np.full(1, start_ts)

    row_quats = gyro.org_quat_at_timestamp(quat_times)
    q = quat.multiply(smoothed_quat1, quat.multiply(quat1, row_quats))
    r = np.einsum("ij,njk->nik", image_rotation, quat.to_rotation_matrix(q))
    # points variant always uses the non-inverted sign fixup (frame_transform.rs:402-403)
    r = _sign_fixup(r, False)
    if params.suppress_rotation:
        r = np.broadcast_to(np.eye(3), r.shape).copy()
    rotations = new_k @ r

    shifts = None
    stab = fm.camera_stab_data[frame] if frame < len(fm.camera_stab_data) else None
    if stab is not None:
        is_scale = (params.width / stab.crop_area[2] / stab.pixel_pitch[0],
                    params.height / stab.crop_area[3] / stab.pixel_pitch[1])
        y = stab.crop_area[1] + (pts[:, 1] / params.height) * stab.crop_area[3]
        s = stab.ibis_spline.interpolate(y + stab.offset)
        o = stab.ois_spline.interpolate(y + stab.offset)
        shifts = np.stack([
            s[:, 0] * is_scale[0], s[:, 1] * is_scale[1],
            np.radians(s[:, 2] / 1000.0),
            o[:, 0] * is_scale[0], o[:, 1] * is_scale[1]], axis=1)
        if params.suppress_rotation and params.frame_readout_time == 0.0:
            shifts = None

    return scaled_k, distortion_coeffs, new_k, rotations, shifts, mesh, fov
