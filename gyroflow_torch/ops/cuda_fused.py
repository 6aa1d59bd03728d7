"""Fused kernel wrapper: rolling-shutter projection and sampling in one launch.

Replaces ``gyroflow_tpu/ops/pallas_fused.py::_fused_kernel`` with the CUDA
kernel of ``csrc/fused.cu``: per output pixel, from coords_pre's (x, y, idx),
the matrix-row projection, coords_post_uv, the guard and the separable LUT
taps (the split sampler's loop, shared through ``csrc/taps.cuh``), so u, v
and valid never reach device memory; every distortion model and digital
lens (``cuda_coords.lens_ids``). ``remap_fused_plain`` is the same function
in plain torch.

``remap_fused`` checks its inputs, then runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``remap_fused.launches`` counts kernel launches. ``remap.remap_plane_cuda``
calls it for ``fused=True`` on the planes ``remap.use_fused`` admits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import trace
from . import cuda_coords, cuda_sampler, remap
from .interpolation import INTERP_INFO
from .kernel_params import KernelConfig, KernelDynamics, dyn_to_torch

_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def remap_fused_plain(img, x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics, bg,
                      limit: float):
    """Plain torch: (x, y, idx) (oh, ow) -> (oh, ow, C) float32 pixels;
    pixels with valid False get bg. The guard comes before the tap offset, as
    in the JAX fused kernel (pallas_fused.py:123-137)."""
    dyn_t = dyn_to_torch(dyn, x.device)
    u, v, valid = remap.rotate_and_distort(x, y, idx, matrices, cfg, dyn_t)
    u, v = remap.coords_post_uv(u, v, cfg)
    offset = INTERP_INFO[cfg.interpolation]["offset"]
    bg_t = trace.to_device(torch.tensor(bg, dtype=torch.float32), img.device)
    out = remap.sample_taps(img.to(torch.float32), remap._guard_uv(u) - offset,
                            remap._guard_uv(v) - offset, bg_t, cfg.src_rect,
                            cfg.interpolation, limit)
    return torch.where(valid[..., None], out, bg_t)


def fused_args(cfg: KernelConfig, bg, limit: float):
    """The kernel's by-value FusedArgs: coords_post_uv's constants in float32,
    as the torch ops of remap.coords_post_uv round them."""
    from .._build import FusedArgs

    f32 = np.float32
    a = FusedArgs()
    a.s.bg[:] = [float(b) for b in bg] + [0.0] * (4 - len(bg))
    a.s.limit = float(limit)
    a.s.src_rect[:] = [int(r) for r in cfg.src_rect]
    frame_w, frame_h = float(cfg.width), float(cfg.height)
    a.rotate = int(cfg.input_rotation != 0.0)
    if a.rotate:
        rotation = cfg.input_rotation * (math.pi / 180.0)
        fw, fh = remap._rotated_frame_size(cfg)
        a.rot_cos, a.rot_sin = math.cos(rotation), math.sin(rotation)
        a.rot_o[:] = [frame_w / 2.0, frame_h / 2.0]
        a.rot_o2[:] = [fw / 2.0, fh / 2.0]
        frame_w, frame_h = float(fw), float(fh)
    a.bg_mode = int(cfg.background_mode)
    a.frame_w, a.frame_h = frame_w, frame_h
    sx, sy, sw, sh = cfg.src_rect
    # map_coord(u, 0, frame, s, s + size): torch on the card divides by the
    # host scalar as a multiply by its float32 reciprocal
    a.map_x[:] = [float(sx), float(sx + sw) - float(sx), float(f32(1.0) / f32(frame_w))]
    a.map_y[:] = [float(sy), float(sy + sh) - float(sy), float(f32(1.0) / f32(frame_h))]
    return a


def _check(img, x, y, idx, matrices, cfg: KernelConfig, bg):
    if not remap.use_fused(cfg, matrices):
        raise ValueError(
            f"fused kernel: this plane takes the split path (interpolation "
            f"{cfg.interpolation}, background mode {cfg.background_mode}, "
            f"{matrices.shape[0]} matrix rows, flags {cfg.flags:#x}); see remap.use_fused")
    cuda_coords._check(x, y, idx, matrices, cfg)
    if img.dim() != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"fused kernel: plane must be (H, W, C<=4), got {tuple(img.shape)}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"fused kernel: plane dtype {img.dtype} (uint8, uint16 or float32)")
    if img.device != x.device or not img.is_contiguous():
        raise ValueError(f"fused kernel: plane on {img.device} (x on {x.device}), contiguous")
    if len(bg) != img.shape[2]:
        raise ValueError("fused kernel: bg needs one value per channel")


def remap_fused(img, x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics, bg,
                limit: float):
    """Project and sample one plane in one launch.

    img (H, W, C) uint8/uint16/float32; x, y float32 and idx int32 (oh, ow)
    from ``remap.coords_pre``; matrices (rows, 14) float32; dyn with host
    numpy leaves; bg one float per channel; limit: the clamp after
    filtering. Returns (oh, ow, C) float32, background where the projection
    is invalid."""
    _check(img, x, y, idx, matrices, cfg, bg)
    if img.device.type == "cpu":
        return remap_fused_plain(img, x, y, idx, matrices, cfg, dyn, bg, limit)
    if img.device.type != "cuda":
        raise ValueError(f"fused kernel: unsupported device {img.device}")
    from .._build import lib

    H, W, C = img.shape
    oh, ow = x.shape
    out = torch.empty((oh, ow, C), dtype=torch.float32, device=img.device)
    if x.numel() == 0:
        return out
    L = lib()
    lut = cuda_sampler.lut_slice(cfg.interpolation, img.device)
    with torch.cuda.device(img.device):
        err = L.gf_fused(img.data_ptr(), _DTYPES[img.dtype], H, W, C, x.data_ptr(),
                         y.data_ptr(), idx.data_ptr(), matrices.data_ptr(), matrices.shape[0],
                         cuda_coords.coord_params(cfg, dyn), int(cfg.flags),
                         *cuda_coords.lens_ids(cfg), oh, ow,
                         INTERP_INFO[cfg.interpolation]["taps"], lut.data_ptr(),
                         fused_args(cfg, bg, limit), out.data_ptr(),
                         torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused kernel launch failed: error {err}")
    remap_fused.launches += 1
    return out


remap_fused.launches = 0
