"""Fused projection + sampling with per-tile uv bboxes (``csrc/fused_bbox.cu``).

Replaces ``experiments/pallas_fused.py::_fused_kernel`` (:36; ``_fused_call``
:154), the JAX package's earlier fused experiment. Per output pixel, from
coords_pre's (x, y, idx): the matrix-row projection, coords_post_uv, the
guard, then separable LUT sampling where taps outside the source rect weigh
0 and the background enters through one separable weight,
``(1 - rowsum * colsum) * bg``. No pixel_value_limit clamp and no valid
mask on the output, as in the experiment. Per tile of tile_h x tile_w
output pixels, the exact (umin, umax, vmin, vmax) over its valid pixels,
(1e9, -1e9, 1e9, -1e9) where it has none.

The experiment's window plan, matrix window and post-hoc overflow check
(``_posthoc_overflow``) are TPU window machinery and are not ported; the
bbox is an output. The kernel projects through the opencv_fisheye
instantiation of ``csrc/lens.cuh`` (the experiment's lens); another lens
raises ValueError. ``fused_bbox_plain`` is the same function in torch.

``fused_bbox`` checks its inputs, then runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``fused_bbox.launches`` counts kernel launches. The kernel reads the
interpolation's LUT slice from the device (``cuda_sampler.lut_slice``).
``fast_share`` is the share of pixels whose stencil takes the kernel's
fast path. ``run`` is the probe: the
kernel on the 4K Y and UV planes of the JAX package's probes, against the
port's split path.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import cuda_coords, cuda_fused, cuda_sampler, remap
from ..ops.interpolation import INTERP_INFO
from ..ops.kernel_params import KernelConfig, KernelDynamics, dyn_to_torch
from . import perf_probe as pp

# (W, H, plane_index, channels) of the probe planes: 4K YUV420, and a small
# pair for a quick run on the CPU
PLANES = {"Y": (3840, 2160, 0, 1), "UV": (1920, 1080, 1, 2)}
SMALL_PLANES = {"Y": (384, 128, 0, 1), "UV": (256, 64, 1, 2)}
TILE = (16, 128)


def tile_bbox(u, v, valid, tile_h: int, tile_w: int):
    """(ny, nx, 4) float32: per tile of the (oh, ow) maps, (umin, umax,
    vmin, vmax) over its valid pixels, (1e9, -1e9, 1e9, -1e9) for none."""
    oh, ow = u.shape
    ny, nx = -(-oh // tile_h), -(-ow // tile_w)

    def reduce(a, fill, op):
        a = torch.nn.functional.pad(torch.where(valid, a, fill),
                                    (0, nx * tile_w - ow, 0, ny * tile_h - oh), value=fill)
        return op(a.reshape(ny, tile_h, nx, tile_w), dim=(1, 3))

    return torch.stack([reduce(u, 1e9, torch.amin), reduce(u, -1e9, torch.amax),
                        reduce(v, 1e9, torch.amin), reduce(v, -1e9, torch.amax)], dim=-1)


def fused_bbox_plain(img, x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics, bg,
                     tile_h: int = TILE[0], tile_w: int = TILE[1]):
    """Plain torch: (out (oh, ow, C), valid (oh, ow) float32, bbox (ny, nx, 4))."""
    dyn_t = dyn_to_torch(dyn, x.device)
    u, v, valid = remap.rotate_and_distort(x, y, idx, matrices, cfg, dyn_t)
    u, v = remap.coords_post_uv(u, v, cfg)
    u, v = remap._guard_uv(u), remap._guard_uv(v)
    off = INTERP_INFO[cfg.interpolation]["offset"]
    fx, wx = pp.phase_weights(u - off, cfg.interpolation)
    fy, wy = pp.phase_weights(v - off, cfg.interpolation)
    srx, sry, srw, srh = cfg.src_rect
    x_in = [(fx + t >= srx) & (fx + t < srx + srw) for t in range(len(wx))]
    y_in = [(fy + t >= sry) & (fy + t < sry + srh) for t in range(len(wy))]
    wxm = [w * ok.to(torch.float32) for w, ok in zip(wx, x_in)]
    wym = [w * ok.to(torch.float32) for w, ok in zip(wy, y_in)]
    csum, rsum = sum(wxm), sum(wym)
    total = pp.tap_sum(img, fx, fy, wxm, wym, x_in, y_in)
    bg_t = torch.tensor(bg, dtype=torch.float32, device=img.device)
    out = total + (1.0 - rsum * csum)[..., None] * bg_t
    return out, valid.to(torch.float32), tile_bbox(u, v, valid, tile_h, tile_w)


def _check(img, x, y, idx, matrices, cfg: KernelConfig, bg, tile_h: int, tile_w: int):
    cuda_coords._check(x, y, idx, matrices, cfg)
    if cuda_coords.lens_ids(cfg) != (0, -1):
        raise ValueError("fused bbox kernel: the experiment's lens only (opencv_fisheye, no "
                         f"digital lens), got {cfg.distortion_model!r}, {cfg.digital_lens!r}")
    if cfg.interpolation not in INTERP_INFO or cfg.background_mode == 3:
        raise ValueError(f"fused bbox kernel: interpolation {cfg.interpolation} (2, 4 or 8) "
                         f"and background mode {cfg.background_mode} (0-2)")
    if img.dim() != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"fused bbox kernel: plane must be (H, W, C<=4), got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"fused bbox kernel: plane dtype {img.dtype} (float32)")
    if img.device != x.device or not img.is_contiguous():
        raise ValueError(f"fused bbox kernel: plane on {img.device} (x on {x.device}), "
                         f"contiguous")
    if len(bg) != img.shape[2]:
        raise ValueError("fused bbox kernel: bg needs one value per channel")
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"fused bbox kernel: tile {tile_h}x{tile_w}")


def fast_share(u, v, cfg: KernelConfig, shape) -> float:
    """The share of the pixels at (u, v) (after coords_post_uv and the
    guard) whose stencil lies wholly inside the source rect and the (H, W)
    plane: the pixels whose taps the kernel reads with no test (on a plane
    that starts aligned to a pixel, as a torch allocation does)."""
    H, W, _ = shape
    info = INTERP_INFO[cfg.interpolation]
    taps = info["taps"]
    fx, _ = pp.phase_weights(u - info["offset"], cfg.interpolation)
    fy, _ = pp.phase_weights(v - info["offset"], cfg.interpolation)
    srx, sry, srw, srh = cfg.src_rect
    fast = ((fx >= max(srx, 0)) & (fx + taps <= min(srx + srw, W))
            & (fy >= max(sry, 0)) & (fy + taps <= min(sry + srh, H)))
    return float(fast.to(torch.float64).mean()) if fast.numel() else 0.0


def fused_bbox(img, x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics, bg,
               tile_h: int = TILE[0], tile_w: int = TILE[1]):
    """Project and sample one plane, and bound each tile's source coordinates.

    img float32 (H, W, C); x, y float32 and idx int32 (oh, ow)
    from ``remap.coords_pre``; matrices (rows, 14) float32; dyn with host
    numpy leaves; bg one float per channel. Returns out (oh, ow, C) float32,
    valid (oh, ow) float32 (0 or 1) and bbox (ceil(oh / tile_h),
    ceil(ow / tile_w), 4) float32."""
    _check(img, x, y, idx, matrices, cfg, bg, tile_h, tile_w)
    if img.device.type == "cpu":
        return fused_bbox_plain(img, x, y, idx, matrices, cfg, dyn, bg, tile_h, tile_w)
    if img.device.type != "cuda":
        raise ValueError(f"fused bbox kernel: unsupported device {img.device}")
    from .._build import lib

    H, W, C = img.shape
    oh, ow = x.shape
    ny, nx = -(-oh // tile_h), -(-ow // tile_w)
    out = torch.empty((oh, ow, C), dtype=torch.float32, device=img.device)
    valid = torch.empty((oh, ow), dtype=torch.float32, device=img.device)
    bbox = torch.empty((ny, nx, 4), dtype=torch.float32, device=img.device)
    if x.numel() == 0:
        return out, valid, bbox
    lut = cuda_sampler.lut_slice(cfg.interpolation, img.device)
    with torch.cuda.device(img.device):
        # the experiment clamps nothing: the sampler's limit is not read
        err = lib().gf_fused_bbox(img.data_ptr(), H, W, C, x.data_ptr(), y.data_ptr(),
                                  idx.data_ptr(), matrices.data_ptr(), matrices.shape[0],
                                  cuda_coords.coord_params(cfg, dyn), int(cfg.flags), oh, ow,
                                  tile_h, tile_w, INTERP_INFO[cfg.interpolation]["taps"],
                                  lut.data_ptr(), cuda_fused.fused_args(cfg, bg, 0.0),
                                  out.data_ptr(), valid.data_ptr(), bbox.data_ptr(),
                                  torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused bbox kernel launch failed: error {err}")
    fused_bbox.launches += 1
    return out, valid, bbox


fused_bbox.launches = 0


def inputs(device, small: bool = False):
    """Per plane name: (img, x, y, idx, matrices, cfg, dyn, bg) of the probe
    planes (one seeded generator, Y then UV), coords_pre on the full
    (oh, ow) output grid."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (W, H, pi, C) in (SMALL_PLANES if small else PLANES).items():
        cfg, dyn, mats, img = pp.plane_case(W, H, pi, C, rng)
        mats = torch.from_numpy(mats).to(device)
        dyn_t = dyn_to_torch(dyn, device)
        oy, ox = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                                torch.arange(W, dtype=torch.float32, device=device),
                                indexing="ij")
        x, y, idx = remap.coords_pre(ox, oy, mats, cfg, dyn_t, *pp.out_cf(cfg, dyn_t))
        bg = tuple(float(b) for b in np.asarray(dyn.background, np.float32)[:C] * pp.MAXV)
        out[name] = (torch.from_numpy(img).to(device), x, y, idx, mats, cfg, dyn, bg)
    return out


def run(device, small: bool = False) -> dict:
    """The probe: per plane, the kernel's time, and its output and bbox
    against the port's split path on the same coordinates (coords kernel,
    coords_post_uv, the guard, remap.sample_input with no clamp; the bg is
    0, so per-tap and separable background agree)."""
    res, launches = {}, {}
    for name, (img, x, y, idx, mats, cfg, dyn, bg) in inputs(device, small).items():
        with pp.counting(launches, fused_bbox=fused_bbox, coords=cuda_coords.project):
            out, valid, bbox = fused_bbox(img, x, y, idx, mats, cfg, dyn, bg)
            ms = pp.cuda_ms(lambda: fused_bbox(img, x, y, idx, mats, cfg, dyn, bg), device)
            u, v, val = cuda_coords.project(x, y, idx, mats, cfg, dyn)
        u, v = remap.coords_post_uv(u, v, cfg)
        u, v = remap._guard_uv(u), remap._guard_uv(v)
        bg_t = torch.tensor(bg, dtype=torch.float32, device=img.device)
        ref = remap.sample_input(img, u, v, bg_t, cfg.src_rect, cfg.interpolation, float("inf"))
        res[name] = {
            "ms": ms, "shape": list(out.shape), "tiles": list(bbox.shape[:2]),
            "valid_share": float(valid.mean()),
            "valid_mismatches": int(((valid > 0.5) != val).sum()),
            "max_err": pp.max_err_valid(out, ref, val, float("inf")),
            "bbox_err_px": float((bbox - tile_bbox(u, v, val, *TILE)).abs().max()),
            "empty_tiles": int((bbox[..., 0] > bbox[..., 1]).sum()),
        }
    res["launches"] = launches
    return res


if __name__ == "__main__":
    print(json.dumps(run("cuda:0"), indent=1))
