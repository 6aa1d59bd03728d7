"""The sampler probes' kernel (``csrc/probe_sampler.cu``).

Replaces the Pallas kernels of ``experiments/perf_probe4.py`` (``k_noop``
:132, ``k_nobuild`` :141, ``k_nomatmul`` :155, ``k_dbuf`` :210),
``perf_probe5.py`` (``kern`` :118) and ``perf_probe6.py`` (``make_kern``
:143): the 8-tap lanczos4 sampler on tiled u/v (``coords_post_uv``-mapped
and guarded) with per-tile window origins y0, x0 and column offset xoff
(``perf_probe.plan_origins``), in the probes' modes:

- ``full``: the taps that lie inside the window (rows y0 .. y0 + Sr,
  columns x0 + xoff .. x0 + xoff + K), each weight zeroed outside the frame
  (0 <= fx + t < W), plus ``(1 - rowsum * colsum) * bg``; the column
  products in ``fp32``, ``bf16`` (both operands rounded to bf16, the TPU's
  default MXU pass) or ``bf16x3`` (hi*hi + lo*hi + hi*lo, hi = bf16(x),
  lo = bf16(x - hi));
- ``noop``: ``img[y0, x0] + u``;
- ``nomatmul``: ``C0 * 1e-6 + R0 + img[y0, x0] + colsum + rowsum``, C0 and
  R0 the weights of the taps at window column and row 0 (perf_probe4.py
  :182-207);
- ``nobuild``: ``sum_r (r * 1e-6) * sum_c win[r, c] * (c * 1e-6 + u * 1e-9)``
  over the Sr x Sc window at (y0, x0); the kernel computes it through its
  factorisation, the plain version as the dense product.

``window`` is (Sr, Sc, K): the window's rows and columns and the compute
width (K = Sc, or 128 in the rolled probes 5 and 6). ``sample`` checks its
inputs, then runs ``sample_plain`` for CPU tensors only; for CUDA tensors it
launches the kernel or raises. ``sample.launches`` counts kernel launches.
The kernel reads the lanczos4 slice of the LUT from the device
(``cuda_sampler.lut_slice``). ``fast_share`` is the share of pixels whose
stencil takes the kernel's fast path in ``full``.
"""
from __future__ import annotations

import torch

from ..ops import cuda_sampler
from . import perf_probe as pp

MODES = {"noop": 0, "nobuild": 1, "nomatmul": 2, "full": 3}
PRECISIONS = {"fp32": 0, "bf16": 1, "bf16x3": 2}
NOBUILD_MAX_ROWS = 64


def _corner(img, y0, x0):
    """(ntiles, C): img[y0, x0], 0 outside the frame."""
    H, W, _ = img.shape
    ok = ((y0 >= 0) & (y0 < H) & (x0 >= 0) & (x0 < W))[:, None]
    return torch.where(ok, img[y0.clamp(0, H - 1).long(), x0.clamp(0, W - 1).long()], 0.0)


def _weights(u, v, W: int, H: int):
    """fx, fy and the frame-masked weights with their sums (perf_probe4.py
    :119-130, :164-170, :197-202)."""
    fx, wx = pp.phase_weights(u - pp.OFFSET)
    fy, wy = pp.phase_weights(v - pp.OFFSET)
    wxm = [w * ((fx + t >= 0) & (fx + t < W)).to(torch.float32) for t, w in enumerate(wx)]
    wym = [w * ((fy + t >= 0) & (fy + t < H)).to(torch.float32) for t, w in enumerate(wy)]
    return fx, fy, wxm, wym, sum(wxm), sum(wym)


def _nobuild_dense(img, u, y0, x0, Sr: int, Sc: int):
    """The literal dense product of k_nobuild (perf_probe4.py:147-153), 64
    tiles at a time: (ntiles, P, C)."""
    chunk = 64
    H, W, C = img.shape
    dev = img.device
    rows = torch.arange(Sr, dtype=torch.int32, device=dev)
    cols = torch.arange(Sc, dtype=torch.int32, device=dev)
    ci = torch.arange(Sc, dtype=torch.float32, device=dev) * 1e-6     # iota * 1e-6
    R = torch.arange(Sr, dtype=torch.float32, device=dev) * 1e-6
    outs = []
    for s in range(0, u.shape[0], chunk):
        yy = y0[s:s + chunk, None] + rows                                # (n, Sr)
        xx = x0[s:s + chunk, None] + cols                                # (n, Sc)
        inside = (((yy >= 0) & (yy < H))[:, :, None] & ((xx >= 0) & (xx < W))[:, None, :])
        win = img[yy.clamp(0, H - 1).long()[:, :, None], xx.clamp(0, W - 1).long()[:, None, :]]
        win = torch.where(inside[..., None], win, 0.0).permute(0, 3, 1, 2)   # (n, C, Sr, Sc)
        Cm = ci[None, :, None] + u[s:s + chunk, None, :] * 1e-9           # (n, Sc, P)
        colmix = torch.matmul(win, Cm[:, None])                          # (n, C, Sr, P)
        outs.append((R[:, None] * colmix).sum(dim=2).permute(0, 2, 1))
    return torch.cat(outs)


def sample_plain(img, u, v, y0, x0, xoff, window, mode: str = "full",
                 precision: str = "fp32", bg=None):
    """Plain torch: (ntiles, P, C) float32."""
    H, W, C = img.shape
    Sr, Sc, K = window
    y0c, x0c = y0[:, None], x0[:, None]
    if mode == "noop":
        return _corner(img, y0, x0)[:, None, :] + u[..., None]
    if mode == "nobuild":
        return _nobuild_dense(img, u, y0, x0, Sr, Sc)
    fx, fy, wxm, wym, csum, rsum = _weights(u, v, W, H)
    fx_rel = fx - x0c - xoff[:, None]
    fy_rel = fy - y0c
    if mode == "nomatmul":
        c0 = torch.zeros_like(u)
        r0 = torch.zeros_like(u)
        for t in range(pp.TAPS):
            c0 = torch.where(fx_rel == -t, wxm[t], c0)
            r0 = torch.where(fy_rel == -t, wym[t], r0)
        return ((((c0 * 1e-6 + r0)[..., None] + _corner(img, y0, x0)[:, None, :])
                 + csum[..., None]) + rsum[..., None])
    x_in = [(fx_rel + t >= 0) & (fx_rel + t < K) & (fx + t >= 0) & (fx + t < W)
            for t in range(pp.TAPS)]
    y_in = [(fy_rel + t >= 0) & (fy_rel + t < Sr) & (fy + t >= 0) & (fy + t < H)
            for t in range(pp.TAPS)]
    total = pp.tap_sum(img, fx, fy, wxm, wym, x_in, y_in, precision)
    bg_t = torch.tensor(bg if bg is not None else (0.0,) * C, dtype=torch.float32,
                        device=img.device)
    return total + (1.0 - rsum * csum)[..., None] * bg_t


def _check(img, u, v, y0, x0, xoff, window, mode, precision, bg):
    if mode not in MODES or precision not in PRECISIONS:
        raise ValueError(f"probe sampler: mode {mode!r} ({', '.join(MODES)}), precision "
                         f"{precision!r} ({', '.join(PRECISIONS)})")
    if mode != "full" and precision != "fp32":
        raise ValueError(f"probe sampler: precision {precision!r} applies to mode 'full' only")
    if img.dim() != 3 or img.shape[2] not in (1, 2) or img.dtype != torch.float32:
        raise ValueError(f"probe sampler: plane must be float32 (H, W, 1 or 2), got "
                         f"{img.dtype} {tuple(img.shape)}")
    Sr, Sc, K = window
    if not (1 <= K <= Sc and Sr >= 1) or (mode == "nobuild" and Sr > NOBUILD_MAX_ROWS):
        raise ValueError(f"probe sampler: window {window} (Sr <= {NOBUILD_MAX_ROWS} for nobuild)")
    if bg is not None and len(bg) != img.shape[2]:
        raise ValueError("probe sampler: bg needs one value per channel")
    for name, t, dt, shape in (("u", u, torch.float32, u.shape), ("v", v, torch.float32, u.shape),
                               ("y0", y0, torch.int32, u.shape[:1]),
                               ("x0", x0, torch.int32, u.shape[:1]),
                               ("xoff", xoff, torch.int32, u.shape[:1])):
        if t.device != img.device or t.dtype != dt or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"probe sampler: {name} must be contiguous {dt} {tuple(shape)} on "
                             f"{img.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if u.dim() != 2 or not img.is_contiguous():
        raise ValueError("probe sampler: u, v must be (ntiles, P), the plane contiguous")


def fast_share(shape, u, v, y0, x0, xoff, window) -> float:
    """The share of the (ntiles, P) pixels whose 8 x 8 stencil lies wholly
    inside its tile's window (rows y0 .. y0 + Sr, columns x0 + xoff .. x0 +
    xoff + K) and inside the (H, W) frame: the pixels whose full mode reads
    every tap with no test (on a plane that starts aligned to a pixel, as a
    torch allocation does)."""
    H, W, _ = shape
    Sr, _, K = window
    fx, _ = pp.phase_weights(u - pp.OFFSET)
    fy, _ = pp.phase_weights(v - pp.OFFSET)
    fx_rel = fx - (x0 + xoff)[:, None]
    fy_rel = fy - y0[:, None]
    fast = ((fy_rel >= 0) & (fy_rel + pp.TAPS <= Sr) & (fx_rel >= 0) & (fx_rel + pp.TAPS <= K)
            & (fx >= 0) & (fx + pp.TAPS <= W) & (fy >= 0) & (fy + pp.TAPS <= H))
    return float(fast.to(torch.float64).mean()) if fast.numel() else 0.0


def sample(img, u, v, y0, x0, xoff, window, mode: str = "full", precision: str = "fp32",
           bg=None):
    """One probe sampler launch: img float32 (H, W, C) with C 1 or 2; u, v
    float32 (ntiles, P); y0, x0, xoff int32 (ntiles,); window (Sr, Sc, K);
    bg one float per channel (default 0). Returns (ntiles, P, C) float32."""
    _check(img, u, v, y0, x0, xoff, window, mode, precision, bg)
    if img.device.type == "cpu":
        return sample_plain(img, u, v, y0, x0, xoff, window, mode, precision, bg)
    if img.device.type != "cuda":
        raise ValueError(f"probe sampler: unsupported device {img.device}")
    from .._build import ProbeArgs, lib

    H, W, C = img.shape
    ntiles, P = u.shape
    out = torch.empty((ntiles, P, C), dtype=torch.float32, device=img.device)
    if u.numel() == 0:
        return out
    a = ProbeArgs()
    a.H, a.W = H, W
    a.Sr, a.Sc, a.K = (int(w) for w in window)
    a.P = P
    a.bg[:] = [float(b) for b in (bg or (0.0,) * C)] + [0.0] * (4 - C)
    lut = cuda_sampler.lut_slice(pp.TAPS, img.device)
    with torch.cuda.device(img.device):
        err = lib().gf_probe_sampler(img.data_ptr(), C, u.data_ptr(), v.data_ptr(),
                                     y0.data_ptr(), x0.data_ptr(), xoff.data_ptr(), ntiles,
                                     lut.data_ptr(), a, MODES[mode], PRECISIONS[precision],
                                     out.data_ptr(),
                                     torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe sampler launch failed: error {err}")
    sample.launches += 1
    return out


sample.launches = 0
