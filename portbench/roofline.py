"""The least time an NVIDIA H100 needs for a stabilized frame, from its
shapes and lens alone.

The published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W
limit) stand here and nowhere else. The counts are of the work a frame
needs, whatever implements it (eager stages, split kernels or one fused
kernel): each plane's input read once and output written once, the frame's
rolling-shutter matrices read once, and per output pixel of each plane the
FP32 operations of two projections (the rolling-shutter probe through the
centre matrix row, then the projection through the pixel's own row) and of
the lanczos4 tap loop. Operations are counted from the port's CUDA sources
as adds, multiplies, divisions, square roots, compares and min/max; index
arithmetic is not counted, and a data-dependent loop (the focal-plane
shears) is counted at no steps, so the bound is never above the work.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12          # HBM3 bandwidth
PEAK_FP32_S = 67e12             # FP32 outside the tensor cores

# csrc/lens.cuh project_point for the fisheye: 3x3 projection 15, validity 8,
# x/z y/z r 6, arctangent 19, theta powers 4, theta_d 9, scale selects 5,
# scale/f/c/stretch 11; of it 46 are the fisheye's distort_xy
PROJECT_OPS_FISHEYE = 77
DISTORT_OPS = {"opencv_fisheye": 46, "sony": 49}
IBIS_OPS = 15                   # the IBIS test 5, cos and sin 2, rotation and shifts 8
MATRIX_ROW_BYTES = 14 * 4       # one float32 (rows, 14) matrix row
SAMPLE_BYTES = 2                # uint16 planes in and out


def project_ops(model: str, mesh_grid=None, fpd: bool = False, ibis: bool = False) -> int:
    """FP32 operations of one projection of one pixel."""
    ops = PROJECT_OPS_FISHEYE - DISTORT_OPS["opencv_fisheye"] + DISTORT_OPS[model]
    if mesh_grid:
        gh = mesh_grid
        spline = 7 * (gh - 2) + 2 * (gh - 1) + 8 + 12
        ops += 30 + 2 * (8 * gh + spline)
    if fpd:
        ops += 29 + 7
    if ibis:
        ops += IBIS_OPS
    return ops


def sampler_ops(channels: int, taps: int = 8) -> int:
    """FP32 operations of one pixel's separable tap loop (csrc/taps.cuh): a
    multiply and an add per tap and channel, two per row and channel, the
    clamp, the guard and offset (8) and the phase (2)."""
    return taps * taps * 2 * channels + taps * 2 * channels + channels + 10


def planes(width: int, height: int):
    """(pixels, channels) of the Y and interleaved UV planes of a YUV420 frame."""
    return ((width * height, 1), ((width // 2) * (height // 2), 2))


def frame_work(cfg: dict) -> dict:
    """Bytes and FP32 operations of one frame of the configuration: the
    whole remap, and the sampling alone."""
    w, h = cfg["width"], cfg["height"]
    tel = cfg["telemetry"]
    sony = tel["kind"] == "sony"
    proj = project_ops(cfg["lens_model"], mesh_grid=tel.get("mesh_grid") if sony else None,
                       fpd=sony, ibis=sony)
    sample_bytes = sum(px * c * SAMPLE_BYTES * 2 for px, c in planes(w, h))
    sample_ops = sum(px * sampler_ops(c) for px, c in planes(w, h))
    coords_ops = sum(px * 2 * proj for px, _ in planes(w, h))
    return {"remap": (sample_bytes + h * MATRIX_ROW_BYTES, sample_ops + coords_ops),
            "sampler": (sample_bytes, sample_ops)}


def bound_s(bytes_, ops) -> float:
    """Seconds of the larger of the bytes bound and the operations bound."""
    return max(bytes_ / PEAK_BYTES_S, ops / PEAK_FP32_S)
