"""Lens distortion models on torch tensors (twin of gyroflow_tpu.ops.distortion_models).

``get_model`` resolves every reference model id to a descriptor with the
reference's id, name and ``is_digital``, so the host layers (lens profiles,
ComputeParams, the frame transform, zooming) run for every model. Only
``opencv_fisheye`` has torch math so far: the other descriptors carry
``None`` for ``undistort``, ``distort`` and ``distort_xy``, and
``torch_model`` raises NotImplementedError for them where a remap needs the
math (ROADMAP queue 1, item 3). The same fisheye math is written once more
as ``__device__`` functions in ``csrc/lens.cuh`` for the coords kernel; the
three versions (JAX, this file, CUDA) use the same Cephes arctangent so they
round alike.

``radial_distortion_limit`` is host numpy and is copied verbatim: the frame
transform and the lens-profile init call it.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["LensParams", "MODELS", "get_model", "torch_model", "DistortionModel",
           "radial_distortion_limit"]

PI = math.pi
EPS = 1e-6

# every model of the reference (DistortionModel::from_name) as (id, name,
# is_digital), in the JAX registry's order (distortion_models.py:674-689)
_REFERENCE_MODELS = (
    ("opencv_fisheye", "OpenCV Fisheye", False),
    ("opencv_standard", "OpenCV Standard", False),
    ("poly3", "Poly3", False),
    ("poly5", "Poly5", False),
    ("ptlens", "PTLens", False),
    ("insta360", "Insta360", False),
    ("sony", "Sony", False),
    ("generic_polynomial", "Generic polynomial", False),
    ("gopro", "GoPro", False),
    ("gopro_superview", "GoPro Superview", True),
    ("gopro6_superview", "GoPro6 Superview", True),
    ("gopro_hyperview", "GoPro Hyperview", True),
    ("gopro_warp", "GoPro warp", True),
    ("digital_stretch", "Digital stretch", True),
)
REFERENCE_MODEL_IDS = tuple(m[0] for m in _REFERENCE_MODELS)


class LensParams(NamedTuple):
    """Subset of kernel params the distortion models need (tensors or floats)."""
    k: torch.Tensor                    # (12,) distortion coefficients
    digital_lens_params: torch.Tensor  # (16,)
    width: float
    height: float
    output_width: float
    output_height: float


def _atanf(x):
    """Cephes-style f32 arctangent, the same polynomial as the JAX package's
    ``_atanf`` (distortion_models.py:64) and ``lens.cuh``'s ``atanf_cephes``."""
    sign = torch.where(x < 0.0, -1.0, 1.0)
    ax = torch.abs(x)
    t3p8 = 2.414213562373095   # tan(3*pi/8)
    tp8 = 0.4142135623730950   # tan(pi/8)
    big = ax > t3p8
    mid = (ax > tp8) & ~big
    z_big = -1.0 / torch.where(ax == 0.0, 1.0, ax)
    z_mid = (ax - 1.0) / (ax + 1.0)
    z = torch.where(big, z_big, torch.where(mid, z_mid, ax))
    y0 = torch.where(big, PI / 2.0, torch.where(mid, PI / 4.0, 0.0))
    z2 = z * z
    p = ((8.05374449538e-2 * z2 - 1.38776856032e-1) * z2 + 1.99777106478e-1) * z2 - 3.33329491539e-1
    return sign * (y0 + (p * z2 * z + z))


def _safe_div(a, b, fallback=0.0):
    bz = b == 0.0
    return torch.where(bz, fallback, a / torch.where(bz, 1.0, b))


def _k_zero(k):
    return (k[0] == 0.0) & (k[1] == 0.0) & (k[2] == 0.0) & (k[3] == 0.0)


# --------------------------------------------------------------------------
# OpenCV fisheye (opencv_fisheye.rs:12-113; OpenCV fisheye.cpp L257-460)
# --------------------------------------------------------------------------

def fisheye_undistort(pt, p: LensParams):
    k = p.k
    x, y = pt[..., 0], pt[..., 1]
    theta_d = torch.sqrt(x * x + y * y)
    theta_d = torch.clamp(theta_d, -PI, PI)

    need_iter = torch.abs(theta_d) > EPS
    theta = torch.zeros_like(theta_d)
    converged = torch.zeros_like(theta_d, dtype=torch.bool)
    for _ in range(10):
        theta2 = theta * theta
        theta4 = theta2 * theta2
        theta6 = theta4 * theta2
        theta8 = theta6 * theta2
        k0t2 = k[0] * theta2
        k1t4 = k[1] * theta4
        k2t6 = k[2] * theta6
        k3t8 = k[3] * theta8
        theta_fix = (theta * (1.0 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d) / \
                    (1.0 + 3.0 * k0t2 + 5.0 * k1t4 + 7.0 * k2t6 + 9.0 * k3t8)
        theta_fix = torch.clamp(theta_fix, -0.9, 0.9)
        theta = torch.where(converged, theta, theta - theta_fix)
        converged = converged | (torch.abs(theta_fix) < EPS)

    scale = torch.where(need_iter, _safe_div(torch.tan(theta), theta_d), 0.0)
    converged = converged | ~need_iter
    theta_flipped = ((theta_d < 0.0) & (theta > 0.0)) | ((theta_d > 0.0) & (theta < 0.0))
    valid = converged & ~theta_flipped

    k_zero = _k_zero(k)
    out = torch.where(k_zero, pt, torch.stack([x * scale, y * scale], dim=-1))
    valid = torch.where(k_zero, True, valid)
    return out, valid


def fisheye_distort_xy(x, y, z, p: LensParams):
    k = p.k
    x = x / z
    y = y / z
    r = torch.sqrt(x * x + y * y)
    theta = _atanf(r)
    theta2 = theta * theta
    theta4 = theta2 * theta2
    theta6 = theta4 * theta2
    theta8 = theta4 * theta4
    theta_d = theta * (1.0 + k[0] * theta2 + k[1] * theta4 + k[2] * theta6 + k[3] * theta8)
    scale = torch.where(r == 0.0, 1.0, _safe_div(theta_d, r, 1.0))
    scale = torch.where(_k_zero(k), 1.0, scale)
    return (x * scale, y * scale)


def fisheye_distort(x, y, z, p):
    return torch.stack(fisheye_distort_xy(x, y, z, p), dim=-1)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

class DistortionModel(NamedTuple):
    id: str
    name: str
    undistort: Callable    # (pt(...,2), LensParams) -> (pt(...,2), valid(...)); None: not ported
    distort: Callable      # (x, y, z, LensParams) -> pt(...,2); None: not ported
    distort_xy: Callable = None  # tuple core: (x, y, z, p) -> (u, v); None: not ported
    is_digital: bool = False


_TORCH_MATH = {"opencv_fisheye": (fisheye_undistort, fisheye_distort, fisheye_distort_xy)}

MODELS = {mid: DistortionModel(mid, name, *_TORCH_MATH.get(mid, (None, None, None)), is_digital)
          for mid, name, is_digital in _REFERENCE_MODELS}


def get_model(name: str | None) -> DistortionModel:
    """Resolve by id, defaulting to opencv_fisheye like the reference."""
    if not name:
        return MODELS["opencv_fisheye"]
    return MODELS.get(name, MODELS["opencv_fisheye"])


def torch_model(name: str | None) -> DistortionModel:
    """``get_model``, for a caller that needs the model's torch math: raises
    NotImplementedError for a model that has none yet."""
    model = get_model(name)
    if model.distort_xy is None:
        raise NotImplementedError(
            f"distortion model {model.id!r} is not ported to gyroflow_torch yet "
            "(ROADMAP queue 1, item 3)")
    return model


def radial_distortion_limit(model: DistortionModel, k) -> float | None:
    """Bisection on the distortion derivative (distortion_models/mod.rs:51-75).

    Host-side (runs once per lens); returns tan(theta_max) or None.
    """
    import numpy as np
    k = np.asarray(k, dtype=np.float64)

    def deriv(theta):
        if model.id == "opencv_fisheye":
            if len(k) < 4: return None
            t2 = theta * theta
            return 1.0 + 3*k[0]*t2 + 5*k[1]*t2*t2 + 7*k[2]*t2**3 + 9*k[3]*t2**4
        if model.id == "opencv_standard":
            if len(k) < 8: return None
            r2 = theta * theta
            return (1.0 + ((k[7]*r2 + k[6])*r2 + k[5])*r2) / (1.0 + ((k[4]*r2 + k[1])*r2 + k[0])*r2)
        if model.id == "poly3":
            if len(k) < 1 or k[0] == 0: return None
            return 3.0*theta*theta + 1.0/k[0]
        if model.id == "poly5":
            if len(k) < 2: return None
            r2 = theta * theta
            return 1.0 + 3.0*k[0]*r2 + 5.0*k[1]*r2*r2
        if model.id == "ptlens":
            if len(k) < 3: return None
            return 4.0*k[0]*theta**3 + 3.0*k[1]*theta*theta + 2.0*k[2]*theta + 1.0
        if model.id == "sony":
            if len(k) < 6: return None
            return k[0] + 2*k[1]*theta + 3*k[2]*theta**2 + 4*k[3]*theta**3 + 5*k[4]*theta**4 + 6*k[5]*theta**5
        if model.id == "generic_polynomial":
            if len(k) == 0: return None
            n = min(len(k), 12)
            return sum((i + 1.0) * k[i] * theta**i for i in range(n))
        if model.id == "gopro":
            if len(k) < 2 or k[1] == 0: return None
            ev = lambda pp: sum(k[i] * pp**i for i in range(len(k)))
            dv = lambda pp: sum(i * k[i] * pp**(i-1) for i in range(1, len(k)))
            pp = (theta - k[0]) / k[1]
            for _ in range(10):
                d = dv(pp)
                if abs(d) < 1e-12: break
                fix = (ev(pp) - theta) / d
                pp -= fix
                if abs(fix) < 1e-9: break
            return k[1] * dv(pp)
        return None

    max_theta = math.pi / 2.0
    low, high = 0.0, max_theta
    while high - low > 1e-4:
        mid = (low + high) / 2.0
        d = deriv(mid)
        if d is None:
            return None
        if d > 0.0:
            low = mid
        else:
            high = mid
    theta_max = (low + high) / 2.0
    if abs(theta_max - max_theta) > 0.001:
        return math.tan(theta_max)
    return None
