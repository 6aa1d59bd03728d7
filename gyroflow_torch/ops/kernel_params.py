"""Kernel parameter split: static specialization config vs dynamic f32 operands.

A jax-free copy of ``gyroflow_tpu.ops.kernel_params`` (flags, KernelConfig,
KernelDynamics unchanged, so configs compare equal across the two packages),
plus the two functions that carry them into the port:

- ``from_reference(cfg, dyn)``: the JAX package's KernelConfig/KernelDynamics
  (numpy leaves) -> this module's.
- ``dyn_to_torch(dyn, device)``: numpy leaves -> float32 tensors on ``device``,
  uploaded as ONE host->device copy.

Static fields (interpolation, model, background mode, flags, sizes) select
code paths; per-frame numbers (focal length, fov, translations) are dynamic.
Flag bits match KernelParamsFlags (stabilization/mod.rs:84-99).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

# KernelParamsFlags (stabilization/mod.rs:84-99)
FIX_COLOR_RANGE = 1
HAS_DIGITAL_LENS = 2
FILL_WITH_BACKGROUND = 4
DRAWING_ENABLED = 8
HORIZONTAL_RS = 16
HAS_SOURCE_RECT = 32
HAS_OUTPUT_RECT = 64
FRAMEBUFFER_INVERTED = 128
HAS_IBIS_DATA = 256
HAS_MESH_DATA = 512
HAS_FPD_DATA = 1024
ANY_UNDERWATER = 2048


class KernelConfig(NamedTuple):
    """Hashable static kernel specialization (code paths and sizes)."""
    width: int
    height: int
    output_width: int
    output_height: int
    interpolation: int = 2               # 2=bilinear 4=bicubic 8=lanczos4 (10-13 EWA)
    background_mode: int = 0             # BackgroundMode (stabilization_params.rs:10-17)
    distortion_model: str = "opencv_fisheye"
    digital_lens: Optional[str] = None
    flags: int = 0
    plane_index: int = 0
    input_rotation: float = 0.0          # degrees
    # static gate for the lens-correction blend block (reference branches on
    # lens_correction_amount < 1.0 per pixel; host sets this when amount can be <1)
    lens_correction: bool = False
    source_rect: Optional[Tuple[int, int, int, int]] = None  # x, y, w, h
    output_rect: Optional[Tuple[int, int, int, int]] = None
    mesh_grid: Optional[Tuple[int, int]] = None  # (gw, gh) when HAS_MESH_DATA
    # actual output buffer size (w, h) when it differs from the logical
    # output size — e.g. chroma planes: width/height/output_* stay in LUMA
    # coordinates (geometry space) while the buffer is the plane size, and
    # source_rect/output_rect map between the two (the reference's
    # HAS_SOURCE_RECT/HAS_OUTPUT_RECT mechanism, stabilization/mod.rs:230-231)
    out_size: Optional[Tuple[int, int]] = None
    # EWA jacobian mode. False (default): the ±eps finite-difference evals
    # reuse the base eval's rolling-shutter matrix row, yielding the true
    # within-row local derivative. True: literal reference semantics
    # (cpu_undistort.rs:566-571) where each eval re-probes its own RS row —
    # at ~1% of pixels the re-probed rint(source_y) crosses a row boundary
    # and the row-to-row matrix delta is amplified by 1/eps = 100x, spiking
    # the ellipse radius to 5-12 px (measured, experiments/perf_probe30.py).
    # Those spiked pixels are ALREADY truncated at radius 4 by the top
    # ladder rung (documented deviation, STATUS.md); the same-row mode
    # renders them with the artifact-free local ellipse instead and lets
    # real content run the cap-2 rungs (4K EWA 51 -> ~30 ms/frame).
    ewa_ref_jac: bool = False

    @property
    def src_rect(self) -> Tuple[int, int, int, int]:
        return self.source_rect or (0, 0, self.width, self.height)

    @property
    def out_rect(self) -> Tuple[int, int, int, int]:
        return self.output_rect or (0, 0, self.output_width, self.output_height)

    @property
    def out_buffer(self) -> Tuple[int, int]:
        """(w, h) of the actual output plane buffer."""
        return self.out_size or (self.output_width, self.output_height)

    def has(self, flag: int) -> bool:
        return (self.flags & flag) != 0


class KernelDynamics(NamedTuple):
    """Per-call f32 operands. Leaves are host numpy arrays by construction
    (`make`); ``dyn_to_torch`` moves them to a device in one copy."""
    f: np.ndarray                        # (2,) focal length px
    c: np.ndarray                        # (2,) lens center px
    k: np.ndarray                        # (12,) distortion coefficients
    fov: np.ndarray                      # scalar
    r_limit: np.ndarray                  # scalar (0 = disabled)
    lens_correction_amount: np.ndarray   # scalar
    input_horizontal_stretch: np.ndarray
    input_vertical_stretch: np.ndarray
    background: np.ndarray               # (4,) rgba 0..1 (pre-scale)
    background_margin: np.ndarray
    background_margin_feather: np.ndarray
    translation2d: np.ndarray            # (2,)
    translation3d: np.ndarray            # (4,)
    digital_lens_params: np.ndarray      # (16,)
    light_refraction_coefficient: np.ndarray
    max_pixel_value: np.ndarray          # scalar: 255/65535/1.0 per dtype
    pixel_value_limit: np.ndarray        # per-channel clamp after filtering
    ewa_coeffs_p: np.ndarray             # (4,)
    ewa_coeffs_q: np.ndarray             # (4,)

    @classmethod
    def make(cls, f=(1.0, 1.0), c=(0.0, 0.0), k=None, fov=1.0, r_limit=0.0,
             lens_correction_amount=1.0, input_horizontal_stretch=1.0,
             input_vertical_stretch=1.0, background=(0.0, 0.0, 0.0, 0.0),
             background_margin=0.0, background_margin_feather=0.0,
             translation2d=(0.0, 0.0), translation3d=(0.0, 0.0, 0.0, 0.0),
             digital_lens_params=None, light_refraction_coefficient=1.0,
             max_pixel_value=255.0, pixel_value_limit=255.0,
             ewa_coeffs_p=(0.0,) * 4, ewa_coeffs_q=(0.0,) * 4) -> "KernelDynamics":
        a = lambda v, n=None: np.asarray(v, np.float32)

        def vec(v, n):
            arr = np.zeros(n, np.float32) if v is None else \
                np.asarray(v, np.float32).reshape(-1)
            if arr.shape[0] < n:
                arr = np.concatenate([arr, np.zeros(n - arr.shape[0], np.float32)])
            return np.ascontiguousarray(arr[:n])

        return cls(
            f=vec(f, 2), c=vec(c, 2), k=vec(k, 12), fov=a(fov), r_limit=a(r_limit),
            lens_correction_amount=a(lens_correction_amount),
            input_horizontal_stretch=a(input_horizontal_stretch),
            input_vertical_stretch=a(input_vertical_stretch),
            background=vec(background, 4), background_margin=a(background_margin),
            background_margin_feather=a(background_margin_feather),
            translation2d=vec(translation2d, 2), translation3d=vec(translation3d, 4),
            digital_lens_params=vec(digital_lens_params, 16),
            light_refraction_coefficient=a(light_refraction_coefficient),
            max_pixel_value=a(max_pixel_value), pixel_value_limit=a(pixel_value_limit),
            ewa_coeffs_p=vec(ewa_coeffs_p, 4), ewa_coeffs_q=vec(ewa_coeffs_q, 4),
        )


def from_reference(cfg, dyn):
    """The JAX package's (KernelConfig, KernelDynamics) -> this module's.

    Field order is identical, so the conversion is positional; leaves become
    float32 numpy arrays."""
    return (KernelConfig(*cfg),
            KernelDynamics(*[np.asarray(v, np.float32) for v in dyn]))


def dyn_to_torch(dyn: KernelDynamics, device) -> KernelDynamics:
    """KernelDynamics with float32 tensor leaves on ``device``.

    All leaves are packed into one buffer, uploaded once, and split back into
    views of their original shapes."""
    import torch

    from .. import trace

    leaves = [np.asarray(v, np.float32) for v in dyn]
    flat = np.concatenate([v.reshape(-1) for v in leaves])
    buf = trace.to_device(torch.from_numpy(flat), device)
    out, o = [], 0
    for v in leaves:
        out.append(buf[o:o + v.size].reshape(v.shape))
        o += v.size
    return KernelDynamics(*out)
