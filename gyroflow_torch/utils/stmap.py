"""ST-map export (undistort/redistort UV maps for compositing tools).

Port of gyroflow src/core/stmap.rs `generate_stmaps`: compute params
are CLONED for export with rotation suppressed, static zoom, cleared
keyframes/fovs and zero margin (stmap.rs:24-38); the undistort map's canvas
auto-expands to the undistorted bounding box of the frame rect with
fov_scale = expansion ratio (stmap.rs:56-85); readout time is zeroed for
single-frame export. Files are named
`{video}-{brand}-{model}-{lens}-undistort-{N}.exr` /
`...-redistort-{N}.exr` like render_queue.rs:992-999.

A copy of gyroflow_tpu.utils.stmap whose undistort map runs on the
manager's torch device: the output grid is built there, and the projection
goes through the coords kernel (``cuda_coords.project``; its plain version
on the CPU), for every lens model and digital lens, with the frame's Sony
mesh / focal-plane buffer as the JAX map carries it (stmap.py:102-105).
"""
from __future__ import annotations

import logging
import math
import os
import re

import numpy as np

from ..core.keyframes import KeyframeManager
from ..core.params import ComputeParams
from ..ops.kernel_params import (HAS_DIGITAL_LENS, HAS_FPD_DATA, HAS_MESH_DATA,
                                 HORIZONTAL_RS)

log = logging.getLogger(__name__)

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")


def _export_params(mgr, per_frame: bool) -> ComputeParams:
    """stmap.rs:24-38: suppress rotation, static zoom, no keyframes/fovs."""
    cp = ComputeParams.from_manager(mgr)
    cp.adaptive_zoom_window = -1.0    # static zoom
    if not per_frame:
        cp.frame_count = 1
        cp.frame_readout_time = 0.0
    cp.keyframes = KeyframeManager()
    cp.suppress_rotation = True
    cp.fov_algorithm_margin = 0.0
    cp.fovs = []
    cp.minimal_fovs = []
    return cp


def _stmap_flags(cfg) -> int:
    """stmap.rs:36-38: only digital-lens + RS-direction flags survive (no
    IBIS); mesh/FPD ride along because the reference passes mesh_data in."""
    keep = HAS_DIGITAL_LENS | HORIZONTAL_RS | HAS_MESH_DATA | HAS_FPD_DATA
    return cfg.flags & keep


def _expanded_canvas(cp: ComputeParams, width: int, height: int,
                     timestamp_ms: float, frame: int):
    """stmap.rs:56-73: undistorted bbox of the frame rect -> new canvas."""
    from ..core.zooming.fov_iterative import FovIterative
    from ..ops.undistort_points import undistort_points_with_rolling_shutter

    cp.fov_scale = 1.0
    cp.width = cp.output_width = width
    cp.height = cp.output_height = height
    bbox = FovIterative(cp, (width, height)).points_around_rect(
        float(width), float(height), 31, 31)
    und = np.asarray(undistort_points_with_rolling_shutter(
        bbox, timestamp_ms, frame, cp, 1.0, False), np.float64)
    ok = np.abs(und).max(axis=1) < 1e5
    und = und[ok] if ok.any() else np.zeros((1, 2))
    min_x = min(0.0, float(und[:, 0].min()))
    min_y = min(0.0, float(und[:, 1].min()))
    max_x = max(0.0, float(und[:, 0].max()))
    max_y = max(0.0, float(und[:, 1].max()))
    new_w = int(math.ceil(max_x - min_x))
    new_h = int(math.ceil(max_y - min_y))
    return max(new_w, width), max(new_h, height)


def undistort_inputs(mgr, timestamp_ms: float, per_frame: bool = False,
                     frame: int = 0):
    """What the undistort map projects (stmap.rs:75-101): the expanded
    canvas's output grid (ox, oy) float32 on ``mgr.device``, the frame's
    matrices there, its KernelConfig and host KernelDynamics, out_c, out_f,
    and its mesh buffer there (None without mesh / focal-plane data).
    """
    import torch
    from ..ops import remap
    from ..ops.cuda_coords import kernel_mesh
    from ..ops.frame_transform import frame_transform_at

    cp = _export_params(mgr, per_frame)
    width, height = mgr.params.size
    new_w, new_h = _expanded_canvas(cp, width, height, timestamp_ms, frame)

    cp.fov_scale = max(new_w / width, new_h / height)
    cp.width = cp.output_width = new_w
    cp.height = cp.output_height = new_h
    ft = frame_transform_at(cp, timestamp_ms, frame)
    cfg = ft.kernel_cfg._replace(flags=_stmap_flags(ft.kernel_cfg),
                                 lens_correction=False)
    remap._check_supported(cfg)
    dyn = ft.kernel_dyn

    dev = mgr.device
    oy, ox = remap.out_grid(new_w, new_h, 0, dev)
    mats = torch.from_numpy(np.ascontiguousarray(ft.matrices, np.float32)).to(dev)
    out_f = (dyn.f[0] / dyn.fov, dyn.f[1] / dyn.fov)
    mesh = kernel_mesh(ft.mesh_data, cfg)
    if mesh is not None:
        mesh = torch.from_numpy(mesh).to(dev)
    return ox, oy, mats, cfg, dyn, (new_w / 2.0, new_h / 2.0), out_f, mesh


def undistort_uv(mgr, timestamp_ms: float, per_frame: bool = False, frame: int = 0):
    """Source (u, v, valid) per output pixel of the expanded canvas, tensors
    on ``mgr.device``: coords_pre (its rolling-shutter probe through the
    coords kernel where ``remap.plane_route`` takes it: a mesh frame with
    more than one matrix row), the coords kernel (on the CPU its plain
    version, the plain ``remap.undistort_coord``'s bits) and
    coords_post_uv."""
    from ..ops import cuda_coords, remap
    from ..ops.kernel_params import dyn_to_torch

    ox, oy, mats, cfg, dyn, out_c, out_f, mesh = undistort_inputs(mgr, timestamp_ms,
                                                                  per_frame, frame)
    probe = remap.mesh_probe(mats, cfg, dyn, mesh) if remap.plane_route(cfg, mats).probe else None
    x, y, idx = remap.coords_pre(ox, oy, mats, cfg, dyn_to_torch(dyn, ox.device), out_c, out_f,
                                 mesh=mesh, probe=probe)
    u, v, valid = cuda_coords.project(x, y, idx, mats, cfg, dyn, mesh)
    u, v = remap.coords_post_uv(u, v, cfg)
    return u, v, valid


def compute_undistort_stmap(mgr, timestamp_ms: float, per_frame: bool = False,
                            frame: int = 0) -> np.ndarray:
    """(new_H, new_W, 3) f32: RG = normalized source uv per output pixel of
    the EXPANDED canvas, B = 0 (stmap.rs:75-113)."""
    u, v, valid = (t.cpu().numpy() for t in undistort_uv(mgr, timestamp_ms, per_frame, frame))
    new_h, new_w = u.shape
    out = np.zeros((new_h, new_w, 3), np.float32)
    # normalized by the NEW canvas like parallel_exr(new_width, new_height)
    out[..., 0] = np.where(valid, u / new_w, 0.0)
    # ST maps are bottom-up: v flipped (compositing convention, stmap.rs:139)
    out[..., 1] = np.where(valid, 1.0 - v / new_h, 1.0)
    return out


def compute_redistort_stmap(mgr, timestamp_ms: float, per_frame: bool = False,
                            frame: int = 0) -> np.ndarray:
    """(H, W, 3) f32: per INPUT pixel, its stabilized output position at the
    expanded-canvas fov (stmap.rs:115-121 `dist`, via undistort_points)."""
    from ..ops.undistort_points import undistort_points_with_rolling_shutter

    cp = _export_params(mgr, per_frame)
    width, height = mgr.params.size
    new_w, new_h = _expanded_canvas(cp, width, height, timestamp_ms, frame)
    # fov_scale keeps the expansion ratio; sizes return to the original
    cp.fov_scale = max(new_w / width, new_h / height)
    cp.width = cp.output_width = width
    cp.height = cp.output_height = height

    gx, gy = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    mapped = np.asarray(undistort_points_with_rolling_shutter(
        pts, timestamp_ms, frame, cp, 1.0, True)).reshape(height, width, 2)
    out = np.zeros((height, width, 3), np.float32)
    out[..., 0] = mapped[..., 0] / width
    out[..., 1] = 1.0 - mapped[..., 1] / height
    return out


def write_stmap(path: str, stmap: np.ndarray):
    if path.lower().endswith(".exr"):
        from .exr import write_exr
        write_exr(path, {"R": stmap[..., 0], "G": stmap[..., 1], "B": stmap[..., 2]})
    elif path.lower().endswith(".png"):
        import cv2
        png16 = np.clip(stmap * 65535.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(path, png16[:, :, ::-1])
    else:
        np.save(path, stmap)


def stmap_filename_base(mgr) -> str:
    """stmap.rs:12-22: `{video}-{brand}-{model}-{lens}` sanitized."""
    video = os.path.splitext(os.path.basename(mgr.input_file or "stmap"))[0]
    base = f"{video}-{mgr.lens.camera_brand}-{mgr.lens.camera_model}-" \
           f"{mgr.lens.lens_model}"
    return re.sub(r"[/\\:+'\" ]", "-", base)


def export_stmaps(mgr, folder: str, single_frame: bool = True,
                  frame: int = 0, ext: str = ".exr"):
    """CLI --export-stmap: per frame, BOTH maps (render_queue.rs:992-999):
    `{base}-undistort-{N}` (output→source uv, expanded canvas) and
    `{base}-redistort-{N}` (source→output uv)."""
    os.makedirs(folder, exist_ok=True)
    base = stmap_filename_base(mgr)
    fps = mgr.params.get_scaled_fps() or 30.0
    per_frame = not single_frame
    frames = [frame] if single_frame else range(mgr.params.frame_count)
    for f in frames:
        ts = f * 1000.0 / fps
        und = compute_undistort_stmap(mgr, ts, per_frame, f)
        write_stmap(os.path.join(folder, f"{base}-undistort-{f}{ext}"), und)
        red = compute_redistort_stmap(mgr, ts, per_frame, f)
        write_stmap(os.path.join(folder, f"{base}-redistort-{f}{ext}"), red)
