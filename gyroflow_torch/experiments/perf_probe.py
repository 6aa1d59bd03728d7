"""Shared set-up of the port's experiment probes, and ``run_all``.

The counterpart of ``experiments/perf_probe.py`` and of the set-up the JAX
package's probes share:

- ``make_matrices``: a copy of ``experiments/perf_probe.py:16-30``;
- ``cuda_ms``: the median device time of a call (CUDA events after
  warm-up, L2 flushed before each call), in place of the TPU queue timer
  (``perf_probe.py:33-44``);
- ``plane_case``, ``tiled_grid`` and ``tiled_uv``: the probes' 4K planes,
  the tiled output grid (``pallas_sampler.tiled_grid``) and the u/v/valid
  maps on it (``coords_pre``, the coords kernel, ``coords_post_uv``, the
  guard), as ``perf_probe4.py:52-73`` and ``perf_probe5.py:54-80`` build them;
  ``untile`` lays such a map out as the frame again;
- ``plan_origins``: the per-tile window origins of
  ``perf_probe5.py:86-108``, plain math on u/v;
- ``phase_weights`` and ``tap_sum``: the plain torch pieces of the
  separable sampling that the new kernels' plain versions share.

``run_all(device)`` runs every probe (``fused_bbox``, ``perf_probe3``, 4, 5,
6 and 8) and returns their readings. Each probe module also runs alone:
``python -m gyroflow_torch.experiments.perf_probe4``. On the CPU (``small=True``
for a quick run) the kernels' plain versions run and no time is read.
"""
from __future__ import annotations

import contextlib
import importlib
import math
import statistics

import numpy as np
import torch

from ..ops import cuda_coords, remap
from ..ops.interpolation import COEFFS, INTER_BITS, INTER_TAB_SIZE, INTERP_INFO
from ..ops.kernel_params import FIX_COLOR_RANGE, KernelConfig, KernelDynamics, dyn_to_torch

SUBLANE, LANE = 8, 128
MAXV = 1023.0
TAPS, OFFSET = 8, 3.0              # lanczos4, the probes' interpolation
WARM, REPS = 2, 10                 # cuda_ms: untimed calls, timed calls
FLUSH_BYTES = 256 << 20            # read before each timed call: 5x the H100's 50 MB L2
SPIN_CYCLES = 1_000_000            # ~0.5 ms of device spin ahead of each timed call
_flush_buffers = {}
_LUT = torch.from_numpy(np.asarray(COEFFS, np.float32))

PROBES = ("fused_bbox", "perf_probe3", "perf_probe4", "perf_probe5", "perf_probe6",
          "perf_probe8")


def make_matrices(W, H, f, fov, n_rows):
    def rotm(rx, ry, rz):
        cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                                  math.sin(ry), math.cos(rz), math.sin(rz))
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return Rz @ Ry @ Rx
    new_k = np.array([[f[0] / fov, 0, W / 2], [0, f[1] / fov, H / 2], [0, 0, 1.0]])
    rows = []
    for i in range(n_rows):
        r = rotm(0.012 + 1.5e-5 * i, -0.018, 0.006)
        r[0, 1] *= -1; r[0, 2] *= -1; r[1, 0] *= -1; r[2, 0] *= -1
        rows.append(list(np.linalg.pinv(new_k @ r).flatten()) + [0.0] * 5)
    return np.asarray(rows, np.float32)


def cuda_ms(fn, device):
    """Median device time of one ``fn()`` call in ms, its inputs read from
    HBM.

    After WARM untimed calls, each of REPS calls is timed with CUDA events.
    Ahead of its first event go a read of a FLUSH_BYTES buffer, which evicts
    the inputs from L2 (the bounds count HBM bytes), and a spin of
    SPIN_CYCLES, which keeps the card busy while the host enqueues the call
    (Python, ctypes, Triton's launcher: tens of microseconds). The span
    between the events then holds the call's device work alone, not the
    host's launch work that a microsecond-scale kernel would otherwise show.
    The launch counters count every call, warm-up included. On the CPU,
    which has no device time to read, ``fn`` runs once and the reading is
    None."""
    device = torch.device(device)
    if device.type != "cuda":
        fn()
        return None
    if device not in _flush_buffers:
        _flush_buffers[device] = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32,
                                             device=device)
    flush = _flush_buffers[device]
    for _ in range(WARM):
        fn()
    times = []
    with torch.cuda.device(device):
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            flush.sum()
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def counting(launches: dict, **wrappers):
    """Adds to ``launches[name]`` the kernel launches that each wrapper made
    inside the block."""
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        yield
    finally:
        for k, w in wrappers.items():
            launches[k] = launches.get(k, 0) + w.launches - before[k]


def plane_case(W: int, H: int, plane_index: int, C: int, rng):
    """(cfg, dyn, matrices, image) of one probe plane (perf_probe.py:55-68):
    opencv_fisheye with f = 0.62 W and fov 0.92, one rolling-shutter matrix
    per row, lanczos4, 10-bit limited range, zero background, and uniform
    random content in [0, 1023) from ``rng``, as float32 (H, W, C)."""
    f = (W * 0.62, W * 0.62)
    fov = 0.92
    cfg = KernelConfig(width=W, height=H, output_width=W, output_height=H, interpolation=8,
                       distortion_model="opencv_fisheye", plane_index=plane_index,
                       flags=FIX_COLOR_RANGE)
    dyn = KernelDynamics.make(f=f, c=(W / 2, H / 2), k=[0.25, -0.07, 0.02, -0.003], fov=fov,
                              max_pixel_value=MAXV, pixel_value_limit=MAXV,
                              background=(0, 0, 0, 1))
    img = rng.uniform(0, 1023, (H, W, C)).astype(np.float32)
    return cfg, dyn, make_matrices(W, H, f, fov, H), img


def tiled_grid(W: int, H: int, tile_h: int, tile_w: int, device):
    """ox, oy float32 and pad_ok bool, each (ntiles, tile_h * tile_w): the
    output position of every pixel of every tile, tiles row-major, and
    whether it lies inside the W x H output (pallas_sampler.tiled_grid)."""
    ny, nx = -(-H // tile_h), -(-W // tile_w)
    t = torch.arange(ny * nx, dtype=torch.int32, device=device)[:, None]
    p = torch.arange(tile_h * tile_w, dtype=torch.int32, device=device)[None, :]
    oy = (t // nx) * tile_h + p // tile_w
    ox = (t % nx) * tile_w + p % tile_w
    return ox.to(torch.float32), oy.to(torch.float32), (ox < W) & (oy < H)


def out_cf(cfg: KernelConfig, dyn_t: KernelDynamics):
    """(out_c, out_f) as the probes and remap build them."""
    factor = torch.clamp_min(1.0 - dyn_t.lens_correction_amount, 0.001)
    return ((cfg.output_width / 2.0, cfg.output_height / 2.0),
            (dyn_t.f[0] / dyn_t.fov / factor, dyn_t.f[1] / dyn_t.fov / factor))


def tiled_coords_pre(cfg: KernelConfig, dyn: KernelDynamics, mats, tile_h: int, tile_w: int):
    """x, y, idx and pad_ok on the tiled layout (ntiles, P)."""
    dyn_t = dyn_to_torch(dyn, mats.device)
    W, H = cfg.out_buffer
    ox, oy, pad_ok = tiled_grid(W, H, tile_h, tile_w, mats.device)
    return (*remap.coords_pre(ox, oy, mats, cfg, dyn_t, *out_cf(cfg, dyn_t)), pad_ok)


def tiled_uv(cfg: KernelConfig, dyn: KernelDynamics, mats, tile_h: int, tile_w: int):
    """u, v (after coords_post_uv, guarded) and valid (& pad_ok) on the
    tiled layout (perf_probe4.py:52-73): coords_pre, the coords kernel
    (``cuda_coords.project``), coords_post_uv and the guard."""
    x, y, idx, pad_ok = tiled_coords_pre(cfg, dyn, mats, tile_h, tile_w)
    u, v, valid = cuda_coords.project(x, y, idx, mats, cfg, dyn)
    u, v = remap.coords_post_uv(u, v, cfg)
    return remap._guard_uv(u), remap._guard_uv(v), valid & pad_ok


def untile(t, W: int, H: int, tile_h: int, tile_w: int):
    """(ntiles, tile_h * tile_w, ...) on the tiled layout of a W x H output
    that the tiles cover exactly -> (H, W, ...), contiguous."""
    if H % tile_h or W % tile_w:
        raise ValueError(f"untile: {W}x{H} is not a whole number of {tile_h}x{tile_w} tiles")
    a = t.reshape(H // tile_h, W // tile_w, tile_h, tile_w, *t.shape[2:]).transpose(1, 2)
    return a.reshape(H, W, *t.shape[2:]).contiguous()


def plan_origins(u, v, valid, W: int, H: int, win_h: int, win_w: int, win_k: int = 0):
    """Per-tile window origins (perf_probe5.py:86-108) on (ntiles, P) maps.

    Returns y0, x0, xoff int32 (ntiles,) and whether any tile's taps
    overflow the window. The origins are 8-row and 128-column aligned and
    clipped to the plane padded to (8, 128); with 0 < win_k < win_w (the
    rolled probes) xoff is the 8-aligned start of the tile's column band
    inside the window, else 0 (pallas_sampler.plan_windows_t)."""
    big = 1e9
    any_valid = valid.any(dim=1)
    umin = torch.where(any_valid, torch.where(valid, u, big).amin(dim=1), 0.0)
    umax = torch.where(any_valid, torch.where(valid, u, -big).amax(dim=1), 0.0)
    vmin = torch.where(any_valid, torch.where(valid, v, big).amin(dim=1), 0.0)
    vmax = torch.where(any_valid, torch.where(valid, v, -big).amax(dim=1), 0.0)
    pheight = -(-H // SUBLANE) * SUBLANE
    pwidth = -(-W // LANE) * LANE
    rolled = 0 < win_k < win_w
    xf = (torch.floor(umin - OFFSET).to(torch.int32) - 1) & ~(SUBLANE - 1)
    x0 = xf & ~(LANE - 1)
    y0 = (torch.floor(vmin - OFFSET).to(torch.int32) - 1) & ~(SUBLANE - 1)
    x0 = torch.clamp(x0, 0, max(pwidth - win_w, 0))
    y0 = torch.clamp(y0, 0, max(pheight - win_h, 0))
    xf = torch.minimum(torch.maximum(xf, x0), x0 + (win_w - SUBLANE))
    xoff = xf - x0 if rolled else torch.zeros_like(x0)
    xband = xf if rolled else x0
    xlast = torch.clamp_max(torch.floor(umax - OFFSET).to(torch.int32) + TAPS, W - 1)
    ylast = torch.clamp_max(torch.floor(vmax - OFFSET).to(torch.int32) + TAPS, H - 1)
    overflow = (((xlast - xband >= (win_k if rolled else win_w)) | (ylast - y0 >= win_h))
                & any_valid).any()
    return y0.contiguous(), x0.contiguous(), xoff.contiguous(), bool(overflow)


def phase_weights(u, interpolation: int = 8):
    """(f, [w_t]): the first tap and the reference-LUT tap weights at the
    phase rint(u * 32), for u already shifted by the tap offset."""
    info = INTERP_INFO[interpolation]
    s0 = torch.round(u * INTER_TAB_SIZE).to(torch.int32)
    base = info["ind"] + ((s0 & (INTER_TAB_SIZE - 1)) << info["shift"])
    lut = _LUT.to(u.device)
    return s0 >> INTER_BITS, [lut[(base + t).long()] for t in range(info["taps"])]


def bf16(x):
    """x rounded to bfloat16 (half to even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def tap_sum(img, fx, fy, wxm, wym, x_in, y_in, precision: str = "fp32"):
    """Sum over rows of wym[ty] * (sum over columns of pixel * wxm[tx]) over
    the taps whose x_in[tx] & y_in[ty] hold; other taps add 0 (the kernels
    skip them). img float32 (H, W, C); fx, fy int32; wxm, wym, x_in, y_in
    one tensor per tap. Returns (..., C).

    precision: the column products in float32, with both operands rounded
    to bf16 ("bf16"), or as hi*hi + lo*hi + hi*lo with hi = bf16(x) and
    lo = bf16(x - hi), summed as three column sums ("bf16x3")."""
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    total = torch.zeros(fx.shape + (C,), dtype=torch.float32, device=img.device)
    for ty, (wy, yin) in enumerate(zip(wym, y_in)):
        yy = torch.clamp(fy + ty, 0, H - 1)
        s = s_lh = s_hl = torch.zeros_like(total)
        for tx, (wx, xin) in enumerate(zip(wxm, x_in)):
            xx = torch.clamp(fx + tx, 0, W - 1)
            px = torch.where((xin & yin)[..., None], flat[(yy * W + xx).long()], 0.0)
            w = wx[..., None]
            if precision == "fp32":
                s = s + px * w
            elif precision == "bf16":
                s = s + bf16(px) * bf16(w)
            else:
                ph, wh = bf16(px), bf16(w)
                s = s + ph * wh
                s_lh = s_lh + bf16(px - ph) * wh
                s_hl = s_hl + ph * bf16(w - wh)
        colmix = (s + s_lh) + s_hl if precision == "bf16x3" else s
        total = total + wy[..., None] * colmix
    return total


def max_err_valid(got, ref, valid, limit: float = MAXV):
    """max |min(got, limit) - min(ref, limit)| over valid pixels, as
    perf_probe5.py:226-229 reads a sampler's error."""
    d = (torch.clamp_max(got, limit) - torch.clamp_max(ref, limit)).abs()
    return float(torch.where(valid[..., None], d, 0.0).max())


def run_all(device, small: bool = False) -> dict:
    """Run every probe on ``device`` and return their readings by probe."""
    return {name: importlib.import_module(f"{__package__}.{name}").run(device, small=small)
            for name in PROBES}
