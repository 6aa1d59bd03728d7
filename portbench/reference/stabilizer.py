"""The part of the port's ``StabilizationManager`` that a render of the
benchmark's deployments runs, in plain numpy and torch.

Copied from ``core/manager.py`` of the port when the benchmark was defined:
``init_from_video_data``, the gyro load (the gcsv and Sony parsers called
directly, with the one camera quirk these clips reach: the readout
direction), the lens load, the checksum-free recompute chain (smoothing,
adaptive zoom with its max-zoom iterations, compute params), the frame
transform, the per-plane configuration and the timestamp adjustment. A plane
goes through the plain torch remap (``ops/remap.py``, float32) on whatever
device the stabilizer is given; ``lowp=True`` gives the control, the same
remap with the plane, the coordinates and the sampled values held in
bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.gyro_source import GyroSource
from .core.keyframes import KeyframeManager, KeyframeType
from .core.lens_profile import LensProfile
from .core.params import ComputeParams, ReadoutDirection, StabilizationParams, frame_at_timestamp, \
    timestamp_at_frame
from .core.smoothing import Smoothing
from .core.zooming import ZoomMethod, calculate_fovs
from .ops import remap
from .ops.frame_transform import frame_transform_at
from .ops.kernel_params import HAS_OUTPUT_RECT, HAS_SOURCE_RECT, dyn_to_torch
from .ops.pixel_formats import rgb_to_yuv


class ReferenceStabilizer:
    def __init__(self, device="cpu"):
        self.gyro = GyroSource()
        self.lens = LensProfile()
        self.smoothing = Smoothing()
        self.params = StabilizationParams()
        self.keyframes = KeyframeManager()
        self.device = torch.device(device)
        self.compute_params = None

    def init_from_video_data(self, duration_ms: float, fps: float, frame_count: int, video_size):
        self.params.fps = fps
        self.params.frame_count = frame_count
        self.params.duration_ms = duration_ms
        self.params.size = video_size
        if not self.params.output_size or self.params.output_size == (0, 0):
            self.params.output_size = video_size
        self.gyro.init_from_params(self.params)
        if duration_ms < 10000.0:
            self.gyro.integration_method = 1

    def load_gyro_data(self, path: str, kind: str):
        """kind: "gcsv" or "sony" (an MP4 with an rtmd track)."""
        if kind == "gcsv":
            from .core.telemetry.gcsv import parse_gcsv
            fm = parse_gcsv(path)
        elif kind == "sony":
            from .core.telemetry.sony import parse_sony_mp4
            fm = parse_sony_mp4(path, fps=self.params.fps, size=self.params.size)
        else:
            raise ValueError(f"unknown telemetry kind {kind!r}")
        if fm.frame_readout_direction is not None:
            self.params.frame_readout_direction = ReadoutDirection.from_any(
                fm.frame_readout_direction)
        if fm.imu_orientation:
            self.gyro.imu_transforms.imu_orientation = fm.imu_orientation
        if fm.frame_readout_time is not None and self.params.frame_readout_time == 0.0:
            self.params.frame_readout_time = fm.frame_readout_time
        if self.params.duration_ms <= 0.0 and fm.raw_imu:
            self.params.duration_ms = fm.raw_imu[-1].timestamp_ms
            self.params.fps = self.params.fps or 30.0
            self.params.frame_count = int(self.params.duration_ms / 1000.0 * self.params.fps)
        self.gyro.duration_ms = self.params.get_scaled_duration_ms() or self.gyro.duration_ms
        self.gyro.file_url = path
        self.gyro.load_from_telemetry(fm)
        self.keyframes.update_gyro(self.gyro)
        return fm

    def load_lens_profile(self, text: str):
        self.lens = LensProfile.from_json(text)
        self.lens.resolve_interpolations(None)

    def recompute(self):
        """Smoothing, adaptive zoom (with the max-zoom iterations), then the
        compute params the frame transform reads."""
        params = ComputeParams.from_manager(self)
        params.calculate_camera_fovs()
        self._smooth(params)
        self._adaptive_zoom()
        self.compute_params = ComputeParams.from_manager(self)

    def _smooth(self, params):
        quats, max_angles = self.gyro.recompute_smoothness(
            self.smoothing.current, self.smoothing.horizon_lock, params)
        self.gyro.smoothed_quaternions = quats
        self.gyro.max_angles = max_angles

    def _focal_length_smoothing(self, params):
        if params.focal_length_smoothing_enabled:
            from .core.focal_length_smoothing import apply_focal_length_smoothing
            apply_focal_length_smoothing(params, self.params)

    def _zoom(self, params, lens_fov_adjustment):
        frames = self.params.frame_count
        fps = self.params.get_scaled_fps()
        timestamps = [(i, i * 1000.0 / fps) for i in range(frames)]
        fovs, minimal_fovs, _ = calculate_fovs(params, timestamps,
                                               ZoomMethod(self.params.adaptive_zoom_method))
        params.fovs = fovs
        params.minimal_fovs = minimal_fovs
        self.params.set_fovs(list(fovs), lens_fov_adjustment)
        self.params.minimal_fovs = list(minimal_fovs)

    def _adaptive_zoom(self):
        params = ComputeParams.from_manager(self)
        params.calculate_camera_fovs()
        self._focal_length_smoothing(params)
        lens_fov_adjustment = self.lens.optimal_fov or 1.0
        self._zoom(params, lens_fov_adjustment)

        max_zoom_param = self.params.max_zoom or 0.0
        kfs = self.keyframes.keyframes.get(KeyframeType.MaxZoom)
        max_zoom_max = max((kf.value for kf in kfs.values()), default=max_zoom_param) \
            if kfs else max_zoom_param
        max_zoom_iters = self.params.max_zoom_iterations
        scaling_factor = self.params.size[0] / max(self.params.output_size[0], 1)
        if not (max_zoom_max > 50.0 and max_zoom_iters > 0):
            return
        params.smoothing_fov_limit_per_frame = [1.0] * len(params.fovs)
        thresholds = [0.95, 0.9, 0.85, 0.8]
        for it in range(max_zoom_iters):
            any_above = False
            for i, fov in enumerate(params.fovs):
                ts = timestamp_at_frame(i, params.scaled_fps)
                zl = params.keyframes.value_at_video_timestamp(KeyframeType.MaxZoom, ts)
                zoom_limit = (max_zoom_param if zl is None else zl) / 100.0
                if params.video_speed_affects_zooming_limit and \
                        (params.video_speed != 1.0 or
                         params.keyframes.is_keyframed(KeyframeType.VideoSpeed)):
                    vs = params.keyframes.value_at_video_timestamp(KeyframeType.VideoSpeed, ts)
                    vs = abs(params.video_speed if vs is None else vs)
                    zoom_limit *= min(1.0 + (vs - 1.0) / 4.0, 1.8)
                fov_limit = 1.0 / (zoom_limit * scaling_factor)
                if fov < fov_limit:
                    any_above = True
                    th = thresholds[it] if it < len(thresholds) else thresholds[-1]
                    params.smoothing_fov_limit_per_frame[i] *= min(fov / fov_limit, th)
            if not any_above:
                if it == 0:
                    params.smoothing_fov_limit_per_frame = []
                break
            self._smooth(params)
            self._focal_length_smoothing(params)
            self._zoom(params, lens_fov_adjustment)

    def adjusted_ts_ms(self, timestamp_us: int) -> float:
        ts_ms = timestamp_us / 1000.0
        if self.params.fps_scale:
            ts_ms /= self.params.fps_scale
        if self.params.frame_offset:
            ts_ms += self.params.frame_offset * 1000.0 / max(self.params.get_scaled_fps(), 1e-9)
        return ts_ms

    def frame_transform(self, timestamp_us: int):
        cp = self.compute_params
        ts_ms = self.adjusted_ts_ms(timestamp_us)
        return frame_transform_at(cp, ts_ms, frame_at_timestamp(ts_ms, cp.scaled_fps))

    def plane_cfg_dyn(self, ft, frame_shape, interpolation, plane_index, max_pixel_value,
                      plane_rects, background_override):
        pw, ph = frame_shape[1], frame_shape[0]
        vw, vh = self.params.size
        if plane_rects and (pw, ph) != (vw, vh):
            ow, oh = self.params.output_size
            pow_ = max(int(round(ow * pw / max(vw, 1))), 1)
            poh = max(int(round(oh * ph / max(vh, 1))), 1)
            cfg = ft.kernel_cfg._replace(
                interpolation=interpolation, plane_index=plane_index,
                source_rect=(0, 0, pw, ph), output_rect=(0, 0, pow_, poh),
                out_size=(pow_, poh),
                flags=ft.kernel_cfg.flags | HAS_SOURCE_RECT | HAS_OUTPUT_RECT)
        else:
            cfg = ft.kernel_cfg._replace(interpolation=interpolation, plane_index=plane_index,
                                         width=pw, height=ph)
        dyn = ft.kernel_dyn._replace(max_pixel_value=np.float32(max_pixel_value),
                                     pixel_value_limit=np.float32(max_pixel_value))
        if interpolation > 8:
            ewp, ewq = remap.ewa_coeffs(interpolation)
            dyn = dyn._replace(ewa_coeffs_p=np.asarray(ewp, np.float32),
                               ewa_coeffs_q=np.asarray(ewq, np.float32))
        if background_override is not None:
            bgv = np.zeros(4, np.float32)
            bgo = np.asarray(background_override, np.float32).reshape(-1)
            bgv[:bgo.shape[0]] = bgo
            dyn = dyn._replace(background=bgv)
        return cfg, dyn

    def plane_backgrounds(self):
        """The Y and UV planes' background colours, limited-range YUV 0..1,
        as a render of a YUV clip passes them."""
        yuva = rgb_to_yuv(np.asarray(self.params.background, np.float32), True)
        return [yuva[..., :1], yuva[..., 1:3]]

    def stabilize_plane(self, ft, plane, plane_index: int, interpolation: int,
                        max_pixel_value: float, background_override, lowp: bool = False):
        """One host plane (H, W, C) uint16 through the plain remap on the
        stabilizer's device: the uint16 (oh, ow, C) tensor."""
        img = torch.as_tensor(np.ascontiguousarray(plane)).to(self.device)
        cfg, dyn = self.plane_cfg_dyn(ft, tuple(img.shape), interpolation, plane_index,
                                      max_pixel_value, True, background_override)
        mats = torch.from_numpy(np.ascontiguousarray(ft.matrices, np.float32))
        remap_fn = remap_plane_bf16 if lowp else remap.remap_plane
        return remap_fn(img, mats, cfg, dyn, ft.mesh_data, out_dtype="uint16")


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def remap_plane_bf16(img, matrices, cfg, dyn, mesh=None, out_dtype: str = "f32"):
    """``remap.remap_plane`` (no drawing, no EWA) with the plane, the source
    coordinates and the sampled values rounded to bfloat16: the control,
    the reference one precision below the float32 that the deployments
    state."""
    matrices, mesh = remap._prepare(img, matrices, cfg, mesh)
    imgf = _bf16(img.to(torch.float32))
    dyn_t = dyn_to_torch(dyn, img.device)
    bg = (dyn_t.background * dyn_t.max_pixel_value)[:img.shape[-1]]
    limit = remap._host_scalar(dyn.pixel_value_limit)

    def project(x, y, idx):
        u, v, valid = remap.rotate_and_distort(x, y, idx, matrices, cfg, dyn_t, mesh=mesh)
        return _bf16(u), _bf16(v), valid

    def sample(u, v, valid, evals):
        return _bf16(remap.sample_input(imgf, u, v, bg, cfg.src_rect, cfg.interpolation, limit))

    out = remap._remap(img, matrices, cfg, dyn_t, project, sample, mesh=mesh)
    return remap._cast_out(out, out_dtype, remap._host_scalar(dyn.max_pixel_value))

