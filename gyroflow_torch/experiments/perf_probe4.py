"""Probe 4: the 4K Y lanczos4 sampler's cost split.

The counterpart of ``experiments/perf_probe4.py``: on the Y plane (3840 x
2160, tile 16 x 128, window 48 x 256), ``probe_sampler.sample`` on the
tiled u/v in the modes ``noop`` (fixed traffic and launch), ``nobuild``
(the window mix without the weight build), ``nomatmul`` (the weight build
without the mix) and ``full`` (the whole sampler; the probe's
double-buffered ``dbuf``), beside the production sampler (``base``: the
port's ``cuda_sampler.sample``) on the same u/v laid out as the frame, as
the render path gives them to it.

``base`` computes ``full``'s function: the plane's source rect is the
frame, so its per-tap background (0) and tap bounds are ``full``'s, every
pixel is sampled (valid all true, as ``full`` has no valid mask) and
nothing is clamped (limit inf); over the valid pixels, whose taps all lie
in their tile's window, the two agree (``base vs full max_err``). ``full``
is held against ``remap.sample_input`` over all valid pixels
(perf_probe5.py:218-231).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import cuda_sampler, remap
from . import perf_probe as pp
from . import probe_sampler as ps

TILE = (16, 128)
WINDOW = (48, 256, 256)          # (Sr, Sc, K): no roll
FULL = (3840, 2160)
SMALL = (384, 128)
MODES = ("noop", "nobuild", "nomatmul", "full")


def inputs(device, small: bool = False):
    """(img (H, W, 1) float32, u, v, valid (ntiles, P), y0, x0, xoff,
    overflow, cfg) of the probe."""
    W, H = SMALL if small else FULL
    cfg, dyn, mats, img = pp.plane_case(W, H, 0, 1, np.random.default_rng(0))
    mats = torch.from_numpy(mats).to(device)
    u, v, valid = pp.tiled_uv(cfg, dyn, mats, *TILE)
    y0, x0, xoff, overflow = pp.plan_origins(u, v, valid, W, H, WINDOW[0], WINDOW[1])
    return torch.from_numpy(img).to(device), u, v, valid, y0, x0, xoff, overflow, cfg


def run(device, small: bool = False) -> dict:
    img, u, v, valid, y0, x0, xoff, overflow, cfg = inputs(device, small)
    res, launches = {"window overflow": overflow}, {}
    bg = (0.0,)
    H, W, _ = img.shape
    uf, vf = (pp.untile(t, W, H, *TILE) for t in (u, v))
    every = torch.ones_like(uf, dtype=torch.bool)
    with pp.counting(launches, probe_sampler=ps.sample, sampler=cuda_sampler.sample):
        base = cuda_sampler.sample(img, uf, vf, every, bg, cfg.src_rect, 8, float("inf"))
        res["base"] = pp.cuda_ms(
            lambda: cuda_sampler.sample(img, uf, vf, every, bg, cfg.src_rect, 8, float("inf")),
            device)
        for mode in MODES:
            res[mode] = pp.cuda_ms(lambda: ps.sample(img, u, v, y0, x0, xoff, WINDOW, mode),
                                   device)
        full = ps.sample(img, u, v, y0, x0, xoff, WINDOW, "full")
    ref = remap.sample_input(img, u, v, torch.zeros(1, device=img.device), cfg.src_rect, 8,
                             pp.MAXV)
    res["full max_err"] = pp.max_err_valid(full, ref, valid)
    res["base vs full max_err"] = pp.max_err_valid(pp.untile(full, W, H, *TILE), base,
                                                   pp.untile(valid, W, H, *TILE), float("inf"))
    res["tiles"] = u.shape[0]
    res["launches"] = launches
    return res


if __name__ == "__main__":
    print(json.dumps(run("cuda:0"), indent=1))
