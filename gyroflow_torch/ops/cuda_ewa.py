"""EWA kernel wrapper: elliptical weighted averaging (interpolation 10-13).

Replaces ``gyroflow_tpu/ops/pallas_sampler.py::_ewa_kernel`` with the CUDA
kernel of ``csrc/ewa.cu``: one thread per output pixel forms the
finite-difference Jacobian from the stacked evals of the one coords launch,
walks the taps of its own bbox inside the 10x10 stencil and reads them
straight from the plane in its native dtype. ``sample_plain`` is the same
function in plain torch (``remap.ewa_jacobian``, then ``remap.sample_ewa``).

``sample`` checks its inputs, then runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises. ``sample.launches``
counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from . import remap

_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
# torch divides a float32 tensor by a Python scalar on the card as a
# multiply by the float32 reciprocal (ATen's div_true_kernel_cuda): the
# kernel scales the Jacobian the same way
_INV_EPS = float(np.float32(1.0) / np.float32(remap.EWA_EPS))


def sample_plain(img, u, v, u3, v3, valid3, bg, src_rect, coeffs, limit: float):
    """Plain torch EWA sampling: the Jacobian of the stacked (3*oh, ow)
    evals (``remap.ewa_jacobian``), then the (H, W, C) plane sampled at the
    (oh, ow) positions u, v -> (oh, ow, C) float32; pixels whose base eval
    is not valid get bg."""
    bg_t = trace.to_device(torch.tensor(bg, dtype=torch.float32), img.device)
    _, _, valid, jac = remap.ewa_jacobian(u3, v3, valid3)
    out = remap.sample_ewa(img.to(torch.float32), u, v, jac, bg_t, src_rect,
                           coeffs[0], coeffs[1], limit)
    return torch.where(valid[..., None], out, bg_t)


def _check(img, u, v, u3, v3, valid3, bg, src_rect, coeffs):
    if img.dim() != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"EWA kernel: plane must be (H, W, C<=4), got {tuple(img.shape)}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"EWA kernel: plane dtype {img.dtype} (uint8, uint16 or float32)")
    if len(bg) != img.shape[2] or len(src_rect) != 4:
        raise ValueError("EWA kernel: bg needs one value per channel, src_rect four")
    if len(coeffs) != 2 or any(len(c) != 4 for c in coeffs):
        raise ValueError("EWA kernel: coeffs must be (p, q) with four floats each")
    tensors = [("img", img, None), ("u", u, torch.float32), ("v", v, torch.float32),
               ("u3", u3, torch.float32), ("v3", v3, torch.float32),
               ("valid3", valid3, torch.bool)]
    for name, t, dt in tensors:
        if t.device != img.device:
            raise ValueError(f"EWA kernel: {name} on {t.device}, plane on {img.device}")
        if dt is not None and t.dtype != dt:
            raise TypeError(f"EWA kernel: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"EWA kernel: {name} must be contiguous")
    if u.dim() != 2 or v.shape != u.shape:
        raise ValueError("EWA kernel: u, v must share one (oh, ow) shape")
    oh, ow = u.shape
    if any(t.shape != (3 * oh, ow) for t in (u3, v3, valid3)):
        raise ValueError(f"EWA kernel: u3, v3, valid3 must be (3*oh, ow) = {(3 * oh, ow)}, got "
                         f"{tuple(u3.shape)}, {tuple(v3.shape)}, {tuple(valid3.shape)}")


def sample(img, u, v, u3, v3, valid3, bg, src_rect, coeffs, limit: float):
    """EWA-sample all channels of ``img`` at (u, v).

    img (H, W, C) uint8/uint16/float32; u, v float32 (oh, ow), the sampling
    positions; u3, v3 float32 and valid3 bool (3*oh, ow): the base eval and
    the +eps evals in x and in y (``remap.ewa_stack`` through the projection
    and ``coords_post_uv``), from which the Jacobian is formed as
    ``remap.ewa_jacobian`` forms it (with background modes 0-2, u and v are
    the first oh rows of u3 and v3); bg one float per channel; src_rect
    (x, y, w, h) in plane pixels; coeffs (p, q) Keys-cubic coefficients
    (``remap.ewa_coeffs``); limit: the clamp after filtering. Returns
    (oh, ow, C) float32; pixels whose base eval is not valid get bg."""
    _check(img, u, v, u3, v3, valid3, bg, src_rect, coeffs)
    if img.device.type == "cpu":
        return sample_plain(img, u, v, u3, v3, valid3, bg, src_rect, coeffs, limit)
    if img.device.type != "cuda":
        raise ValueError(f"EWA kernel: unsupported device {img.device}")
    from .._build import EwaArgs, lib

    H, W, C = img.shape
    oh, ow = u.shape
    out = torch.empty((oh, ow, C), dtype=torch.float32, device=img.device)
    if u.numel() == 0:
        return out
    args = EwaArgs()
    args.p[:] = [float(x) for x in coeffs[0]]
    args.q[:] = [float(x) for x in coeffs[1]]
    args.bg[:] = [float(b) for b in bg] + [0.0] * (4 - C)
    args.limit = float(limit)
    args.inv_eps = _INV_EPS
    args.src_rect[:] = [int(r) for r in src_rect]
    L = lib()
    with torch.cuda.device(img.device):
        err = L.gf_ewa(img.data_ptr(), _DTYPES[img.dtype], H, W, C, u.data_ptr(), v.data_ptr(),
                       u3.data_ptr(), v3.data_ptr(), valid3.data_ptr(), oh, ow, args,
                       out.data_ptr(), torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"EWA kernel launch failed: error {err}")
    sample.launches += 1
    return out


sample.launches = 0
