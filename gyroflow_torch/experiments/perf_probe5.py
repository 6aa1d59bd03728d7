"""Probe 5: the rolled-window lanczos4 sampler on 4K YUV420 planes.

The counterpart of ``experiments/perf_probe5.py``: tiles of 16 x 96 output
pixels, a 256-column window whose tile band (at most 128 columns from the
8-aligned xoff) is mixed, 48 window rows for Y (3840 x 2160) and 40 for UV
(1920 x 1080 x 2), taps bounded by the frame, the background through the
separable weight. ``probe_sampler.sample`` in mode ``full`` computes it; the
window origins come from ``perf_probe.plan_origins`` (perf_probe5.py
:86-108). Each plane's output is held against ``remap.sample_input`` over
all its valid pixels (perf_probe5.py:218-231), at the full plane.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import remap
from . import perf_probe as pp
from . import probe_sampler as ps

TILE = (16, 96)
WIN_W, WIN_K = 256, 128
PLANES = {"Y": (3840, 2160, 0, 1, 48), "UV": (1920, 1080, 1, 2, 40)}   # W, H, index, C, win_h
SMALL_PLANES = {"Y": (384, 128, 0, 1, 48), "UV": (256, 64, 1, 2, 40)}


def inputs(device, small: bool = False):
    """Per plane: (img, u, v, valid, y0, x0, xoff, overflow, cfg, window),
    the images drawn from one generator (seed 0), Y then UV."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (W, H, pi, C, win_h) in (SMALL_PLANES if small else PLANES).items():
        cfg, dyn, mats, img = pp.plane_case(W, H, pi, C, rng)
        mats = torch.from_numpy(mats).to(device)
        u, v, valid = pp.tiled_uv(cfg, dyn, mats, *TILE)
        y0, x0, xoff, overflow = pp.plan_origins(u, v, valid, W, H, win_h, WIN_W, WIN_K)
        out[name] = (torch.from_numpy(img).to(device), u, v, valid, y0, x0, xoff, overflow,
                     cfg, (win_h, WIN_W, WIN_K))
    return out


def run(device, small: bool = False) -> dict:
    res, launches = {}, {}
    for name, (img, u, v, valid, y0, x0, xoff, overflow, cfg, window) in \
            inputs(device, small).items():
        with pp.counting(launches, probe_sampler=ps.sample):
            out = ps.sample(img, u, v, y0, x0, xoff, window, "full")
            ms = pp.cuda_ms(lambda: ps.sample(img, u, v, y0, x0, xoff, window, "full"), device)
        ref = remap.sample_input(img, u, v, torch.zeros(img.shape[2], device=img.device),
                                 cfg.src_rect, 8, pp.MAXV)
        res[name] = {"rolled-plan overflow": overflow, "max_err": pp.max_err_valid(out, ref, valid),
                     "rolled": ms, "tiles": u.shape[0]}
    res["launches"] = launches
    return res


if __name__ == "__main__":
    print(json.dumps(run("cuda:0"), indent=1))
