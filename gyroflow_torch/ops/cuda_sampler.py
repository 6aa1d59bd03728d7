"""Sampler kernel wrapper: separable bilinear/bicubic/lanczos4 sampling.

Replaces ``gyroflow_tpu/ops/pallas_sampler.py::_sampler_kernel`` with the CUDA
kernel of ``csrc/sampler.cu`` (one thread per output pixel, taps loaded
directly from the plane in its native dtype, weights from the reference
LUT's slice for the interpolation, ``lut_slice``, which each block stages in
shared memory). ``sample_plain`` is the same function in plain torch
(``remap.sample_input``).

``sample`` checks its inputs, then runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises. ``sample.launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from .interpolation import COEFFS, INTER_TAB_SIZE, INTERP_INFO

from .. import trace
from . import remap

_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_lut_slices = {}


def sample_plain(img, u, v, valid, bg, src_rect, interpolation: int, limit: float):
    """Plain torch sampling: (H, W, C) plane at (oh, ow) u/v -> (oh, ow, C)
    float32; pixels with valid False get bg."""
    bg_t = trace.to_device(torch.tensor(bg, dtype=torch.float32), img.device)
    out = remap.sample_input(img.to(torch.float32), u, v, bg_t, src_rect, interpolation, limit)
    return torch.where(valid[..., None], out, bg_t)


def _check(img, u, v, valid, bg, src_rect, interpolation):
    if img.dim() != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"sampler kernel: plane must be (H, W, C<=4), got {tuple(img.shape)}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"sampler kernel: plane dtype {img.dtype} (uint8, uint16 or float32)")
    if interpolation not in INTERP_INFO:
        raise ValueError(f"sampler kernel: interpolation {interpolation} (2, 4 or 8)")
    if len(bg) != img.shape[2] or len(src_rect) != 4:
        raise ValueError("sampler kernel: bg needs one value per channel, src_rect four")
    tensors = [("img", img, None), ("u", u, torch.float32), ("v", v, torch.float32),
               ("valid", valid, torch.bool)]
    for name, t, dt in tensors:
        if t.device != img.device:
            raise ValueError(f"sampler kernel: {name} on {t.device}, plane on {img.device}")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"sampler kernel: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sampler kernel: {name} must be contiguous")
    if u.dim() != 2 or v.shape != u.shape or valid.shape != u.shape:
        raise ValueError("sampler kernel: u, v, valid must share one (oh, ow) shape")


def lut_slice(interpolation: int, device):
    """The interpolation's part of the reference LUT as the kernels index it:
    float32 ``COEFFS[ind : ind + 32 * taps]``, phase p's taps at
    ``[p * taps, (p + 1) * taps)``. One tensor per device and interpolation,
    made at its first use."""
    device = torch.device(device)
    key = (device, interpolation)
    if key not in _lut_slices:
        info = INTERP_INFO[interpolation]
        n = INTER_TAB_SIZE * info["taps"]
        part = np.ascontiguousarray(COEFFS[info["ind"]:info["ind"] + n], np.float32)
        _lut_slices[key] = trace.to_device(torch.from_numpy(part), device)
    return _lut_slices[key]


def sample(img, u, v, valid, bg, src_rect, interpolation: int, limit: float):
    """Sample all channels of ``img`` at (u, v).

    img (H, W, C) uint8/uint16/float32; u, v float32 (oh, ow); valid bool
    (oh, ow); bg one float per channel; src_rect (x, y, w, h) in
    plane pixels; limit: the clamp after filtering. Returns (oh, ow, C)
    float32."""
    _check(img, u, v, valid, bg, src_rect, interpolation)
    if img.device.type == "cpu":
        return sample_plain(img, u, v, valid, bg, src_rect, interpolation, limit)
    if img.device.type != "cuda":
        raise ValueError(f"sampler kernel: unsupported device {img.device}")
    from .._build import SamplerArgs, lib

    H, W, C = img.shape
    oh, ow = u.shape
    out = torch.empty((oh, ow, C), dtype=torch.float32, device=img.device)
    if u.numel() == 0:
        return out
    args = SamplerArgs()
    args.bg[:] = [float(b) for b in bg] + [0.0] * (4 - C)
    args.limit = float(limit)
    args.src_rect[:] = [int(r) for r in src_rect]
    L = lib()
    lut = lut_slice(interpolation, img.device)
    with torch.cuda.device(img.device):
        err = L.gf_sampler(img.data_ptr(), _DTYPES[img.dtype], H, W, C, u.data_ptr(),
                           v.data_ptr(), valid.data_ptr(), oh, ow,
                           INTERP_INFO[interpolation]["taps"], lut.data_ptr(), args,
                           out.data_ptr(), torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sampler kernel launch failed: error {err}")
    sample.launches += 1
    return out


sample.launches = 0
