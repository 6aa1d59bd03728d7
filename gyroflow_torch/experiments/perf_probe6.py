"""Probe 6: the precision of the kernels' products, and what it costs.

The counterpart of ``experiments/perf_probe6.py`` on the 4K Y plane:

a) the coords kernel (``cuda_coords.project``) against
   ``remap.rotate_and_distort`` at tile 16 x 128: max |du|, |dv| over pixels
   valid in both (the TPU kernel's one-hot matrix gather ran on the bf16
   MXU; the CUDA kernel reads the row in float32);
b) the rolled sampler of probe 5 (tile 16 x 96, window 48 x 256, K = 128)
   with its column mix in ``bf16`` (the TPU's default pass: both operands
   rounded to bf16), ``bf16x3`` (the "high" / "manual3" fix: hi*hi + lo*hi
   + hi*lo) and ``fp32`` ("highest"): each one's time and its error against
   ``remap.sample_input`` over all valid pixels of the plane.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import cuda_coords, remap
from ..ops.kernel_params import dyn_to_torch
from . import perf_probe as pp
from . import probe_sampler as ps

COORDS_TILE = (16, 128)
TILE = (16, 96)
WINDOW = (48, 256, 128)
PRECISIONS = ("bf16", "bf16x3", "fp32")
FULL = (3840, 2160)
SMALL = (384, 128)


def inputs(device, small: bool = False):
    """(img, cfg, dyn, matrices, (u, v, valid, y0, x0, xoff, overflow)) of
    the Y plane; the sampler's inputs at tile 16 x 96."""
    W, H = SMALL if small else FULL
    cfg, dyn, mats, img = pp.plane_case(W, H, 0, 1, np.random.default_rng(0))
    mats = torch.from_numpy(mats).to(device)
    u, v, valid = pp.tiled_uv(cfg, dyn, mats, *TILE)
    plan = pp.plan_origins(u, v, valid, W, H, WINDOW[0], WINDOW[1], WINDOW[2])
    return torch.from_numpy(img).to(device), cfg, dyn, mats, (u, v, valid, *plan)


def run(device, small: bool = False) -> dict:
    img, cfg, dyn, mats, (u, v, valid, y0, x0, xoff, overflow) = inputs(device, small)
    res, launches = {"rolled overflow": overflow}, {}

    x, y, idx, _ = pp.tiled_coords_pre(cfg, dyn, mats, *COORDS_TILE)
    with pp.counting(launches, coords=cuda_coords.project):
        uk, vk, valk = cuda_coords.project(x, y, idx, mats, cfg, dyn)
    ur, vr, valr = remap.rotate_and_distort(x, y, idx, mats, cfg, dyn_to_torch(dyn, device))
    both = valk & valr
    res["coords kernel err px"] = [float(torch.where(both, (uk - ur).abs(), 0.0).max()),
                                   float(torch.where(both, (vk - vr).abs(), 0.0).max())]
    res["coords valid mismatches"] = int((valk != valr).sum())

    ref = remap.sample_input(img, u, v, torch.zeros(1, device=img.device), cfg.src_rect, 8,
                             pp.MAXV)
    for prec in PRECISIONS:
        with pp.counting(launches, probe_sampler=ps.sample):
            out = ps.sample(img, u, v, y0, x0, xoff, WINDOW, "full", prec)
            ms = pp.cuda_ms(lambda: ps.sample(img, u, v, y0, x0, xoff, WINDOW, "full", prec),
                            device)
        res[f"sampler {prec}"] = {"ms": ms, "err": pp.max_err_valid(out, ref, valid)}
    res["launches"] = launches
    return res


if __name__ == "__main__":
    print(json.dumps(run("cuda:0"), indent=1))
