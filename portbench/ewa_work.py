"""The least time an NVIDIA H100 needs for a frame's EWA sampling, from its
shapes alone: the bound that ``ewa_roofline_pct.preview`` divides by.

As in ``roofline.py`` (whose peaks are used here), the count is of the work
a frame needs, whatever implements it: each plane read once and written
once (uint16), and per output pixel the FP32 operations of
``csrc/ewa.cu``'s ``ewa_pixel``: the finite-difference Jacobian, the guard
of u and v, the reference bbox, the clamped ellipse and the normalisation,
then the tap loop. Operations are adds, multiplies, divisions, square roots,
compares and min/max; index arithmetic, conversions, selects, negations and
absolute values are not counted. The tap loop is data-dependent, so it is
counted at the fewest taps its bbox can take: the bbox reaches at least 2
pixels either side of floor(u) (its half-width ``tx`` is at least 2) and the
10-tap stencil at floor(u) - 4 holds that, so 5 rows of 5 taps, each tap at
its distance test alone (the weight, taken only where dr < 4, is counted at
no taps). Every output pixel is counted, as ``roofline.py`` counts its
projections and taps. So the bound is never above the work.
"""
from __future__ import annotations

from . import roofline

JACOBIAN_OPS = 8        # four subtractions, four multiplies by 1 / EWA_EPS
GUARD_OPS = 6           # u and v: a compare, a max and a min each
BBOX_OPS = 14           # tx, ty: an add, a subtract, a max, a clamp, a multiply; u +- tx, v +- ty
# clamped ellipse: f0 and f 5; ea, eb, ec 13; vx 1; lv 4; v0 3; cc and s 8;
# a0 and c0 16; bt1 and bt2 8; b0, b0v2 and the flip test 3; the clamps of
# a0 and c0 2; abc_x 8, abc_y 13, abc_z 8
ELLIPSE_OPS = 92
ROW_OPS = 4             # fy, fy * abc_y, fy * fy * abc_z
TAP_OPS = 7             # fx, dr (three multiplies, two adds), the test dr < 4
MIN_SIDE = 5            # taps a row and rows of the smallest clipped bbox


def pixel_ops(channels: int) -> int:
    """FP32 operations of one output pixel of a plane of `channels`: the
    set-up, the normalisation (the zero test, a division and a clamp per
    channel) and the tap loop at its smallest bbox."""
    setup = JACOBIAN_OPS + GUARD_OPS + BBOX_OPS + ELLIPSE_OPS
    normalise = 1 + 2 * channels
    taps = MIN_SIDE * ROW_OPS + MIN_SIDE * MIN_SIDE * TAP_OPS
    return setup + normalise + taps


def frame_work(width: int, height: int):
    """(bytes, FP32 operations) of one YUV420 frame's EWA sampling."""
    bytes_ = sum(px * c * roofline.SAMPLE_BYTES * 2 for px, c in roofline.planes(width, height))
    ops = sum(px * pixel_ops(c) for px, c in roofline.planes(width, height))
    return bytes_, ops


def frame_size(work: dict):
    """(width, height) of the frame whose ``roofline.frame_work`` is `work`,
    the only account of the frame's size a reader gets; None where `work`
    is not one of a YUV420 frame of even sides."""
    try:
        sample_bytes = work["sampler"][0]
        rows_bytes = work["remap"][0] - sample_bytes
    except (KeyError, TypeError, IndexError):
        return None
    if rows_bytes <= 0 or rows_bytes % roofline.MATRIX_ROW_BYTES or sample_bytes % 6:
        return None
    height = rows_bytes // roofline.MATRIX_ROW_BYTES
    pixels = sample_bytes // 6          # 4 bytes a Y pixel, 2 more for its share of UV
    if pixels % height:
        return None
    width = pixels // height
    if width % 2 or height % 2:
        return None
    return width, height


def bound_s(width: int, height: int) -> float:
    return roofline.bound_s(*frame_work(width, height))
