"""Probe 3: window column sums at misaligned origins (``csrc/probe_window.cu``).

The counterpart of ``experiments/perf_probe3.py``. Part 1 there times a
Pallas kernel (``make_win_kernel`` :30) that DMAs a 48 x Sc window of a
(1, 2176, 3840) float32 plane per tile at 128-, 32- or 8-column aligned
origins and writes its column sums; ``window_colsum`` is that function,
``out[t, c] = sum over r < 48 of img[y0_t + r, x0_t + c]``, on the card.
The four (align, Sc) cases and the seeded origins are the probe's own
(:42-48). ``window_colsum_plain`` is the same function in torch.

Part 2 there ("what windows does the bench pick") walks the TPU's window
ladder until a rung does not overflow. The port has no window ladder (one
thread per output pixel reads its taps where they lie), so it reads None.

``window_colsum`` checks its inputs, then runs the plain version for CPU
tensors only; for CUDA tensors it launches the kernel or raises.
``window_colsum.launches`` counts kernel launches. The kernel takes one of
two designs by shape alone (``window_path``): "tma", each tile's window
copied into shared memory by TMA, for a 16-byte aligned plane with W % 4 ==
0, Sr and Sc <= 256 and a window that fits shared memory (every probe case;
a tile whose origin column is not a multiple of 4 sums with the checked
loop), else "checked", a thread a column with a bounds test a row. Both are
bit-identical to ``window_colsum_plain``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import perf_probe as pp

SR = 48
CASES = ((128, 256), (32, 256), (32, 160), (8, 160))     # (align, Sc)
FULL = {"H": 2176, "W": 3840, "ntiles": 512}
SMALL = {"H": 128, "W": 512, "ntiles": 16}
PATHS = ("checked", "tma")      # gf_window_colsum_path's codes
NO_ENCODE = -1000000            # gf_window_colsum: cuTensorMapEncodeTiled not found
NO_LADDER = ("the port has no window ladder: each output pixel reads its taps where they "
             "lie, so no window is picked")


def window_colsum_plain(img, y0, x0, Sr: int, Sc: int):
    """Plain torch: (ntiles, Sc) column sums of the Sr x Sc windows of img
    (H, W) at (y0, x0); reads past the plane's edge are 0."""
    H, W = img.shape
    rows = y0[:, None] + torch.arange(Sr, device=img.device, dtype=torch.int32)
    cols = x0[:, None] + torch.arange(Sc, device=img.device, dtype=torch.int32)
    inside = (((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :])
    flat = (rows.clamp(0, H - 1) * W)[:, :, None] + cols.clamp(0, W - 1)[:, None, :]
    win = torch.where(inside, img.reshape(-1)[flat.long()], 0.0)
    out = win[:, 0]
    for r in range(1, Sr):          # row order, as the kernel sums
        out = out + win[:, r]
    return out


def _check(img, y0, x0, Sr: int, Sc: int):
    if img.dim() != 2 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(f"window kernel: plane must be contiguous float32 (H, W), got "
                         f"{img.dtype} {tuple(img.shape)}")
    for name, t in (("y0", y0), ("x0", x0)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != y0.shape \
                or t.device != img.device or not t.is_contiguous():
            raise ValueError(f"window kernel: {name} must be contiguous int32 (ntiles,) on "
                             f"{img.device}")
    if Sr < 1 or Sc < 1:
        raise ValueError(f"window kernel: window {Sr}x{Sc}")


def window_path(img, Sr: int = SR, Sc: int = 256) -> str:
    """What ``window_colsum`` runs for this plane and window: on a card the
    kernel's design, by shape alone, "tma" or "checked" (``PATHS``); on the
    CPU "plain"."""
    if img.device.type == "cpu":
        return "plain"
    if img.device.type != "cuda":
        raise ValueError(f"window kernel: unsupported device {img.device}")
    from .._build import lib

    return PATHS[lib().gf_window_colsum_path(img.data_ptr(), img.shape[1], Sr, Sc)]


def window_colsum(img, y0, x0, Sr: int = SR, Sc: int = 256):
    """Column sums of each tile's Sr x Sc window: img float32 (H, W), y0, x0
    int32 (ntiles,). Returns (ntiles, Sc) float32."""
    _check(img, y0, x0, Sr, Sc)
    if img.device.type == "cpu":
        return window_colsum_plain(img, y0, x0, Sr, Sc)
    if img.device.type != "cuda":
        raise ValueError(f"window kernel: unsupported device {img.device}")
    from .._build import lib

    out = torch.empty((y0.shape[0], Sc), dtype=torch.float32, device=img.device)
    if y0.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        err = lib().gf_window_colsum(img.data_ptr(), img.shape[0], img.shape[1], y0.data_ptr(),
                                     x0.data_ptr(), y0.shape[0], Sr, Sc, out.data_ptr(),
                                     torch.cuda.current_stream(img.device).cuda_stream)
    if err == NO_ENCODE:
        raise RuntimeError("window kernel: cuTensorMapEncodeTiled not found")
    if err < 0:
        raise RuntimeError(f"window kernel: cuTensorMapEncodeTiled failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"window kernel launch failed: cudaError {err}")
    window_colsum.launches += 1
    return out


window_colsum.launches = 0


def inputs(device, small: bool = False):
    """(img, [(align, Sc, y0, x0)]): the probe's plane (seed 0) and, per
    case, its origins, drawn in turn from one generator (seed 1)."""
    g = SMALL if small else FULL
    H, W, n = g["H"], g["W"], g["ntiles"]
    img = np.random.default_rng(0).uniform(0, 1023, (1, H, W)).astype(np.float32)
    rng = np.random.default_rng(1)
    cases = []
    for align, Sc in CASES:
        y0 = (rng.integers(0, (H - SR) // 8, n) * 8).astype(np.int32)
        x0 = (rng.integers(0, (W - Sc) // align, n) * align).astype(np.int32)
        cases.append((align, Sc, torch.from_numpy(y0).to(device), torch.from_numpy(x0).to(device)))
    return torch.from_numpy(img[0]).to(device), cases


def run(device, small: bool = False) -> dict:
    img, cases = inputs(device, small)
    res, launches = {}, {}
    with pp.counting(launches, window_colsum=window_colsum):
        for align, Sc, y0, x0 in cases:
            out = window_colsum(img, y0, x0, SR, Sc)
            res[f"window align{align} Sc{Sc}"] = {
                "ms": pp.cuda_ms(lambda: window_colsum(img, y0, x0, SR, Sc), device),
                "finite": bool(torch.isfinite(out).all())}
    for plane in ("Y", "UV"):
        res[f"picked window {plane}"] = None
    res["picked window"] = NO_LADDER
    res["launches"] = launches
    return res


if __name__ == "__main__":
    print(json.dumps(run("cuda:0"), indent=1))
