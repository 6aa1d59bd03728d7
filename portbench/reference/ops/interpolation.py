"""Fixed-point interpolation coefficient tables (OpenCV-compatible).

The reference samples with 32-phase fixed-point LUTs shared byte-for-byte across
its CPU/OpenCL/WGSL kernels (cpu_undistort.rs:11-75, COEFFS). Those tables are
OpenCV's ``initInterTab1D`` outputs; we REGENERATE them from the defining
formulas (bilinear, Keys bicubic A=-0.75, Lanczos4) rather than hardcoding —
tests assert equality with the published table values.

Layout matches the reference for index math parity:
  bilinear  -> offset 0,   stride 2 (shift 1), 32 phases
  bicubic   -> offset 64,  stride 4 (shift 2), tap offset (1,1)
  lanczos4  -> offset 192, stride 8 (shift 3), tap offset (3,3)
"""
from __future__ import annotations

import math

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS  # 32

# (taps, lut offset, per-phase shift, sample offset) per interpolation enum value
# enum values from stabilization/mod.rs:24-33
INTERP_INFO = {
    2: dict(taps=2, ind=0, shift=1, offset=0.0),     # Bilinear
    4: dict(taps=4, ind=64, shift=2, offset=1.0),    # Bicubic
    8: dict(taps=8, ind=64 + 128, shift=3, offset=3.0),  # Lanczos4
}


def _bilinear_row(x: float) -> list[float]:
    return [1.0 - x, x]


def _bicubic_row(x: float, A: float = -0.75) -> list[float]:
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    return [c0, c1, c2, 1.0 - c0 - c1 - c2]


def _lanczos4_row(x: float) -> list[float]:
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45)]
    if x < 1.1920929e-7:  # FLT_EPSILON
        out = [0.0] * 8
        out[3] = 1.0
        return out
    y0 = -(x + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    out = []
    for i in range(8):
        y = -(x + 3 - i) * math.pi * 0.25
        out.append((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
    total = sum(out)
    return [float(np.float32(np.float32(v) * np.float32(1.0 / total))) for v in out]


def build_coeffs() -> np.ndarray:
    """Full 448-float coefficient table, f32, layout-compatible with COEFFS."""
    vals: list[float] = []
    for i in range(INTER_TAB_SIZE):
        vals += _bilinear_row(i / INTER_TAB_SIZE)
    for i in range(INTER_TAB_SIZE):
        vals += _bicubic_row(i / INTER_TAB_SIZE)
    for i in range(INTER_TAB_SIZE):
        vals += _lanczos4_row(i / INTER_TAB_SIZE)
    return np.asarray(vals, dtype=np.float32)


COEFFS = build_coeffs()
