"""Overlay kernel wrapper: the drawing overlay as the render's epilogue.

``overlay`` replaces the drawing stages of
``gyroflow_tpu/ops/remap.py::remap_plane_pallas`` (``_draw_overlay_tiled``:
the canvas fetches that ride the Pallas sampler ``_sample_call`` through
``_canvas_fetch_t``, then the XLA blend and safe-area dim) with the CUDA
kernel ``gf_overlay`` of ``csrc/overlay.cu``: one thread per output pixel
fetches the canvas bytes under its source and output positions, blends
them and dims outside the safe area; on a band of output rows (``oy0``) the
output positions are absolute rows, as in the JAX band. ``overlay_plain`` is the same function
in plain torch (``remap._draw_overlay``).

The wrapper checks its inputs, then runs the plain version for CPU tensors
only; for CUDA tensors it launches the kernel or raises. ``overlay.launches``
counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.drawing import COLORS
from . import remap


def overlay_plain(pixel, u, v, canvas, scale: float, safe_area_rect, src_rect,
                  max_pixel_value: float, oy0: int = 0):
    """remap._draw_overlay on the output grid of pixel's (oh, ow), whose
    first row is absolute output row oy0."""
    oh, ow = pixel.shape[:2]
    oy, ox = remap.out_grid(ow, oh, oy0, pixel.device)
    scale_t = torch.full((), float(scale), dtype=torch.float32, device=pixel.device)
    return remap._draw_overlay(pixel, u, v, ox, oy, canvas, scale_t, safe_area_rect, src_rect,
                               max_pixel_value)


def overlay_args(scale: float, safe_area_rect, src_rect, max_pixel_value: float,
                 oy0: int = 0):
    """The kernel's by-value OverlayArgs: the colour table, the source rect's
    bounds and the safe area's rect and band, as float32 (as the plain
    version compares them), and the absolute output row oy0 of the first
    row."""
    from .._build import OverlayArgs

    a = OverlayArgs()
    a.colors[:] = np.asarray(COLORS[1:9], np.float32).reshape(-1).tolist()
    a.maxv = float(np.float32(max_pixel_value))
    a.scale = float(np.float32(scale))
    srx, sry, srw, srh = src_rect
    a.src[:] = [float(np.float32(x)) for x in (srx, sry, srx + srw, sry + srh)]
    if safe_area_rect is not None:
        rect, band = remap.safe_area_bounds(safe_area_rect)
        a.safe = 1
        a.rect[:] = rect
        a.band[:] = band
    a.oy0 = int(oy0)
    return a


def _check(pixel, u, v, canvas):
    if pixel.dim() != 3 or not 1 <= pixel.shape[2] <= 4:
        raise ValueError(f"overlay kernel: pixel must be (oh, ow, C <= 4), got "
                         f"{tuple(pixel.shape)}")
    for name, t, dt in (("pixel", pixel, torch.float32), ("u", u, torch.float32),
                        ("v", v, torch.float32), ("canvas", canvas, torch.uint8)):
        if t.device != pixel.device:
            raise ValueError(f"overlay kernel: {name} on {t.device}, pixel on {pixel.device}")
        if t.dtype != dt:
            raise TypeError(f"overlay kernel: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"overlay kernel: {name} must be contiguous")
    if u.shape != pixel.shape[:2] or v.shape != u.shape:
        raise ValueError(f"overlay kernel: u, v must be {tuple(pixel.shape[:2])}, got "
                         f"{tuple(u.shape)}, {tuple(v.shape)}")
    if canvas.dim() != 2:
        raise ValueError(f"overlay kernel: canvas must be (hc, wc), got {tuple(canvas.shape)}")


def overlay(pixel, u, v, canvas, scale: float, safe_area_rect, src_rect,
            max_pixel_value: float, oy0: int = 0):
    """Blend the drawing canvas into (oh, ow, C) float32 pixels.

    u, v: float32 (oh, ow) source positions (after coords_post_uv); canvas:
    (hc, wc) uint8 tensor of packed bytes (core/drawing.py); scale: the
    canvas scale; safe_area_rect: (rx, ry, rz, rw) or None; src_rect: the
    plane's source rect (x, y, w, h); oy0: the absolute output row of
    pixel's first row (a band of output rows starts at oy0 > 0). Returns a
    new (oh, ow, C) float32 tensor."""
    _check(pixel, u, v, canvas)
    if oy0 < 0:
        raise ValueError(f"overlay kernel: oy0 {oy0} < 0")
    if pixel.device.type == "cpu":
        return overlay_plain(pixel, u, v, canvas, scale, safe_area_rect, src_rect,
                             max_pixel_value, oy0)
    if pixel.device.type != "cuda":
        raise ValueError(f"overlay kernel: unsupported device {pixel.device}")
    from .._build import lib

    oh, ow, C = pixel.shape
    out = torch.empty_like(pixel)
    if pixel.numel() == 0:
        return out
    L = lib()
    with torch.cuda.device(pixel.device):
        err = L.gf_overlay(pixel.data_ptr(), u.data_ptr(), v.data_ptr(), canvas.data_ptr(),
                           canvas.shape[0], canvas.shape[1], oh, ow, C,
                           overlay_args(scale, safe_area_rect, src_rect, max_pixel_value, oy0),
                           out.data_ptr(), torch.cuda.current_stream(pixel.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"overlay kernel launch failed: cudaError {err}")
    overlay.launches += 1
    return out


overlay.launches = 0
