"""Lens distortion models on torch tensors (twin of gyroflow_tpu.ops.distortion_models).

Every reference model (``DistortionModel::from_name``) has torch math here,
in the JAX package's float32 op order, each function citing the JAX line it
mirrors: ``undistort(pt, p) -> (pt, valid)``, ``distort(x, y, z, p) -> pt``
and the tuple core ``distort_xy(x, y, z, p) -> (u, v)``. Data-dependent
loops stay masked fixed-count loops, as in JAX (insta360's undistort is 200
masked steps): an early exit would read a device value back to the host.
The ``distort_xy`` cores are written once more as ``__device__`` functions
in ``csrc/lens.cuh`` for the coords and fused kernels; the three versions
(JAX, this file, CUDA) use the same Cephes arctangent so they round alike.

``get_model`` resolves every id to its descriptor (an unknown id to
opencv_fisheye, as the reference does); ``MODEL_IDS`` numbers them in the
registry's order, the ids the kernels are specialised on.
``radial_distortion_limit`` is host numpy and is copied verbatim: the frame
transform and the lens-profile init call it.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["LensParams", "MODELS", "MODEL_IDS", "get_model", "torch_model",
           "DistortionModel", "radial_distortion_limit"]

PI = math.pi
EPS = 1e-6


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


def _pack(x, y):
    return torch.stack([x, y], dim=-1)


def _ones(x):
    return torch.ones_like(x, dtype=torch.bool)


# --------------------------------------------------------------------------
# OpenCV standard (distortion_models.py:150-181)
# --------------------------------------------------------------------------

def opencv_standard_undistort(pt, p: LensParams):
    k = p.k
    x0, y0 = pt[..., 0], pt[..., 1]
    x, y = x0, y0
    valid = _ones(x0)
    for _ in range(20):
        r2 = x * x + y * y
        icdist = (1.0 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / \
                 (1.0 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        valid = valid & (icdist >= 0.0)
        delta_x = 2.0 * k[2] * x * y + k[3] * (r2 + 2.0 * x * x) + k[8] * r2 + k[9] * r2 * r2
        delta_y = k[2] * (r2 + 2.0 * y * y) + 2.0 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = torch.where(valid, (x0 - delta_x) * icdist, x)
        y = torch.where(valid, (y0 - delta_y) * icdist, y)
    return _pack(x, y), valid


def opencv_standard_distort_xy(x, y, z, p: LensParams):
    k = p.k
    x = x / z
    y = y / z
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    a1 = 2.0 * x * y
    a2 = r2 + 2.0 * x * x
    a3 = r2 + 2.0 * y * y
    cdist = 1.0 + k[0] * r2 + k[1] * r4 + k[4] * r6
    icdist2 = 1.0 / (1.0 + k[5] * r2 + k[6] * r4 + k[7] * r6)
    xd0 = x * cdist * icdist2 + k[2] * a1 + k[3] * a2 + k[8] * r2 + k[9] * r4
    yd0 = y * cdist * icdist2 + k[2] * a3 + k[3] * a1 + k[10] * r2 + k[11] * r4
    return (xd0, yd0)


# --------------------------------------------------------------------------
# LensFun radial family: poly3 / poly5 / ptlens (distortion_models.py:189-277)
# --------------------------------------------------------------------------

NEWTON_EPS = 1e-5


def _lensfun_newton(rd, f, fprime):
    """7 reference iterations, masked; valid iff converged by the last."""
    ru = rd
    converged = torch.zeros_like(rd, dtype=torch.bool)
    for _ in range(7):
        fru = f(ru)
        converged = converged | ((fru >= -NEWTON_EPS) & (fru < NEWTON_EPS))
        ru = torch.where(converged, ru, ru - fru / fprime(ru))
    fru = f(ru)
    converged = converged | ((fru >= -NEWTON_EPS) & (fru < NEWTON_EPS))
    return ru, converged


def _lensfun_undistort(pt, f, fprime):
    """Newton on |pt| (the three LensFun models' shared frame): ru from
    rd, scaled back onto the point; invalid at the centre, unconverged or
    ru < 0."""
    x, y = pt[..., 0], pt[..., 1]
    rd = torch.sqrt(x * x + y * y)
    rd_nz = rd != 0.0
    rd_s = torch.where(rd_nz, rd, 1.0)
    ru, converged = _lensfun_newton(rd_s, lambda ru: f(ru, rd_s), fprime)
    valid = rd_nz & converged & (ru >= 0.0)
    s = ru / rd_s
    return _pack(x * s, y * s), valid


def poly3_undistort(pt, p: LensParams):
    inv_k1 = 1.0 / p.k[0]
    return _lensfun_undistort(pt, lambda ru, rd: ru * ru * ru + ru * inv_k1 - rd * inv_k1,
                              lambda ru: 3.0 * ru * ru + inv_k1)


def poly3_distort_xy(x, y, z, p: LensParams):
    x = x / z
    y = y / z
    poly2 = p.k[0] * (x * x + y * y) + 1.0
    return (x * poly2, y * poly2)


def poly5_undistort(pt, p: LensParams):
    k = p.k
    return _lensfun_undistort(
        pt, lambda ru, rd: ru * (1.0 + k[0] * ru * ru + k[1] * (ru * ru) * (ru * ru)) - rd,
        lambda ru: 1.0 + 3.0 * k[0] * ru * ru + 5.0 * k[1] * (ru * ru) * (ru * ru))


def poly5_distort_xy(x, y, z, p: LensParams):
    x = x / z
    y = y / z
    ru2 = x * x + y * y
    poly4 = 1.0 + p.k[0] * ru2 + p.k[1] * ru2 * ru2
    return (x * poly4, y * poly4)


def ptlens_undistort(pt, p: LensParams):
    k = p.k
    return _lensfun_undistort(
        pt, lambda ru, rd: ru * (k[0] * ru * ru * ru + k[1] * ru * ru + k[2] * ru + 1.0) - rd,
        lambda ru: 4.0 * k[0] * ru * ru * ru + 3.0 * k[1] * ru * ru + 2.0 * k[2] * ru + 1.0)


def ptlens_distort_xy(x, y, z, p: LensParams):
    k = p.k
    x = x / z
    y = y / z
    ru2 = x * x + y * y
    r = torch.sqrt(ru2)
    poly3 = k[0] * ru2 * r + k[1] * ru2 + k[2] * r + 1.0
    return (x * poly3, y * poly3)


# --------------------------------------------------------------------------
# Insta360 unified-sphere model (distortion_models.py:284-316)
# --------------------------------------------------------------------------

def insta360_distort_xy(x, y, z, p: LensParams):
    k = p.k
    k1, k2, k3, p1, p2, xi = k[0], k[1], k[2], k[3], k[4], k[5]
    ln = torch.sqrt(x * x + y * y + z * z)
    d = (z / ln) + xi
    xs = (x / ln) / d
    ys = (y / ln) / d
    r2 = xs * xs + ys * ys
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    return (xs * radial + 2.0 * p1 * xs * ys + p2 * (r2 + 2.0 * xs * xs),
            ys * radial + 2.0 * p2 * xs * ys + p1 * (r2 + 2.0 * ys * ys))


def insta360_undistort(pt, p: LensParams):
    """200 masked fixed-point steps (the JAX fori_loop): no early exit, which
    would read a device value back every step."""
    x0, y0 = pt[..., 0], pt[..., 1]
    px, py = x0, y0
    done = torch.zeros_like(x0, dtype=torch.bool)
    one = torch.ones_like(x0)
    for _ in range(200):
        dpx, dpy = insta360_distort_xy(px, py, one, p)
        dx = dpx - x0
        dy = dpy - y0
        done = done | ((torch.abs(dx) < 1e-6) & (torch.abs(dy) < 1e-6))
        px = torch.where(done, px, px - dx)
        py = torch.where(done, py, py - dy)
    return _pack(px, py), _ones(x0)


# --------------------------------------------------------------------------
# Sony (distortion_models.py:323-368)
# --------------------------------------------------------------------------

def _theta_undistort(pt, k, k_zero, fix):
    """The angle Newton shared by sony and generic_polynomial: 10 masked
    steps of theta -= fix(theta, theta_d), then tan(theta) / theta_d."""
    x, y = pt[..., 0], pt[..., 1]
    theta_d = torch.sqrt(x * x + y * y)
    need_iter = torch.abs(theta_d) > EPS
    theta = torch.zeros_like(theta_d)
    converged = torch.zeros_like(theta_d, dtype=torch.bool)
    for _ in range(10):
        theta_fix = fix(theta, theta_d)
        theta = torch.where(converged, theta, theta - theta_fix)
        converged = converged | (torch.abs(theta_fix) < EPS)
    scale = torch.where(need_iter, _safe_div(torch.tan(theta), theta_d), 0.0)
    converged = converged | ~need_iter
    theta_flipped = ((theta_d < 0.0) & (theta > 0.0)) | ((theta_d > 0.0) & (theta < 0.0))
    valid = converged & ~theta_flipped
    out = torch.where(k_zero, pt, _pack(x * scale, y * scale))
    return out, torch.where(k_zero, True, valid)


def sony_undistort(pt, p: LensParams):
    k = p.k

    def fix(theta, theta_d):
        t2 = theta * theta
        t3 = t2 * theta
        t4 = t2 * t2
        t5 = t2 * t3
        k1t = k[1] * theta
        k2t = k[2] * t2
        k3t = k[3] * t3
        k4t = k[4] * t4
        k5t = k[5] * t5
        return (theta * (k[0] + k1t + k2t + k3t + k4t + k5t) - theta_d) / \
               (k[0] + 2.0 * k1t + 3.0 * k2t + 4.0 * k3t + 5.0 * k4t + 6.0 * k5t)

    return _theta_undistort(pt, k, _k_zero(k), fix)


def sony_distort_xy(x, y, z, p: LensParams):
    k = p.k
    x = x / z
    y = y / z
    r = torch.sqrt(x * x + y * y)
    t = _atanf(r)
    t2 = t * t
    t3 = t2 * t
    t4 = t2 * t2
    t5 = t2 * t3
    t6 = t3 * t3
    theta_d = t * k[0] + t2 * k[1] + t3 * k[2] + t4 * k[3] + t5 * k[4] + t6 * k[5]
    scale = torch.where(r == 0.0, 1.0, _safe_div(theta_d, r, 1.0))
    scale = torch.where(_k_zero(k), 1.0, scale)
    return (x * scale, y * scale)


# --------------------------------------------------------------------------
# Generic polynomial, theta^1..theta^12 (distortion_models.py:375-417)
# --------------------------------------------------------------------------

def generic_poly_undistort(pt, p: LensParams):
    k = p.k

    def fix(theta, theta_d):
        num = torch.zeros_like(theta)
        den = torch.zeros_like(theta)
        tp = torch.ones_like(theta)
        for i in range(12):
            term = k[i] * tp
            num = num + term
            den = den + (i + 1.0) * term
            tp = tp * theta
        return (theta * num - theta_d) / den

    return _theta_undistort(pt, k, torch.all(k == 0.0), fix)


def generic_poly_distort_xy(x, y, z, p: LensParams):
    k = p.k
    x = x / z
    y = y / z
    r = torch.sqrt(x * x + y * y)
    t = _atanf(r)
    theta_d = torch.zeros_like(t)
    tp = t
    for i in range(12):
        theta_d = theta_d + tp * k[i]
        tp = tp * t
    scale = torch.where(r == 0.0, 1.0, _safe_div(theta_d, r, 1.0))
    scale = torch.where(torch.all(k == 0.0), 1.0, scale)
    return (x * scale, y * scale)


# --------------------------------------------------------------------------
# GoPro native POLY model (distortion_models.py:424-475)
# --------------------------------------------------------------------------

_GOPRO_TMAX = 1.5533  # ~89 deg


def _gopro_poly_eval(pp, k):
    return k[0] + pp * (k[1] + pp * (k[2] + pp * (k[3] + pp * (k[4] + pp * (k[5] + pp * k[6])))))


def _gopro_poly_deriv(pp, k):
    return k[1] + pp * (2.0 * k[2] + pp * (3.0 * k[3] + pp * (4.0 * k[4] + pp * (5.0 * k[5]
                                                                              + pp * (6.0 * k[6])))))


def _gopro_poly_invert(theta, k, live=None):
    """10 masked Newton steps; live (a list), when given, gets each step's
    count of lanes not yet done at its start: the steps the function needs."""
    pp = (theta - k[0]) / k[1]
    done = torch.zeros_like(theta, dtype=torch.bool)
    for _ in range(10):
        if live is not None:
            live.append((~done).sum())
        d = _gopro_poly_deriv(pp, k)
        flat = torch.abs(d) < 1e-12
        done = done | flat
        fix = (_gopro_poly_eval(pp, k) - theta) / torch.where(flat, 1.0, d)
        pp = torch.where(done, pp, pp - fix)
        done = done | (torch.abs(fix) < 1e-7)
    return pp


def gopro_undistort(pt, p: LensParams):
    k = p.k
    x, y = pt[..., 0], pt[..., 1]
    r_norm = torch.sqrt(x * x + y * y)
    trivial = (k[1] == 0.0) | (r_norm < 1e-9)
    r_safe = torch.where(r_norm < 1e-9, 1.0, r_norm)
    pp = r_safe / k[1]
    theta = _gopro_poly_eval(pp, k)
    tt = math.tan(_GOPRO_TMAX)
    rr = torch.where(theta < _GOPRO_TMAX, torch.tan(torch.clamp_max(theta, _GOPRO_TMAX)),
                     tt + (theta - _GOPRO_TMAX) * (1.0 + tt * tt))
    scale = rr / r_safe
    out = torch.where(trivial[..., None], pt, _pack(x * scale, y * scale))
    return out, _ones(x)


def gopro_distort_xy(x, y, z, p: LensParams):
    k = p.k
    x = x / z
    y = y / z
    r = torch.sqrt(x * x + y * y)
    tt = math.tan(_GOPRO_TMAX)
    theta = torch.where(r < tt, _atanf(torch.clamp_max(r, tt)),
                        _GOPRO_TMAX + (r - tt) / (1.0 + tt * tt))
    pp = _gopro_poly_invert(theta, k)
    r_norm = k[1] * pp
    scale = torch.where(r < 1e-9, 1.0, r_norm / torch.where(r < 1e-9, 1.0, r))
    scale = torch.where(k[1] == 0.0, 1.0, scale)
    return (x * scale, y * scale)


# --------------------------------------------------------------------------
# Digital lenses, in pixel coordinates (distortion_models.py:483-613)
# --------------------------------------------------------------------------

def _fixed_point_invert(fn, tx, ty, iters=12, live=None):
    """iters masked steps of p -= fn(p) - t; live as in _gopro_poly_invert."""
    px, py = tx, ty
    done = torch.zeros_like(tx, dtype=torch.bool)
    for _ in range(iters):
        if live is not None:
            live.append((~done).sum())
        fx, fy = fn(px, py)
        dx = fx - tx
        dy = fy - ty
        done = done | ((torch.abs(dx) < 1e-6) & (torch.abs(dy) < 1e-6))
        px = torch.where(done, px, px - dx)
        py = torch.where(done, py, py - dy)
    return px, py


def _digital_undistort(pt, p: LensParams, fn, x_div=None):
    """Output pixels -> centred unit coordinates -> fn -> pixels."""
    u = pt[..., 0] / p.output_width - 0.5
    v = pt[..., 1] / p.output_height - 0.5
    x, y = fn(u, v)
    if x_div is not None:
        x = x / x_div
    return _pack((x + 0.5) * p.output_width, (y + 0.5) * p.output_height), _ones(u)


def _digital_distort(x, y, p: LensParams, fn, x_mul=None):
    """Input pixels -> centred unit coordinates -> fn inverted by the fixed
    point -> pixels."""
    u = x / p.width - 0.5
    v = y / p.height - 0.5
    if x_mul is not None:
        u = u * x_mul
    px, py = _fixed_point_invert(fn, u, v)
    return ((px + 0.5) * p.width, (py + 0.5) * p.height)


def _superview_fn(x, y):
    x2 = x * x
    y2 = y * y
    return (x * (1.2100393 + x2 * (-1.2758402 + x2 * 1.7751845)),
            y * (0.9364505 + (0.4465308 - 0.7683315 * y2) * y2
                 + (-0.3574087 + 1.1584653 * y2 + 0.3529348 * x2) * x2))


def superview_undistort(pt, p: LensParams):
    return _digital_undistort(pt, p, _superview_fn, x_div=1.333333333)


def superview_distort_xy(x, y, z, p: LensParams):
    return _digital_distort(x, y, p, _superview_fn, x_mul=1.333333333)


def _superview6_fn(x, y):
    x = x * (1.0 - 0.48 * torch.abs(x))
    x = x * (0.943396 * (1.0 + 0.157895 * torch.abs(x)))
    y = y * (0.943396 * (1.0 + 0.060000 * torch.abs(y * 2.0)))
    return x, y


def superview6_undistort(pt, p: LensParams):
    return _digital_undistort(pt, p, _superview6_fn)


def superview6_distort_xy(x, y, z, p: LensParams):
    return _digital_distort(x, y, p, _superview6_fn)


def _hyperview_fn(x, y):
    x2 = x * x
    y2 = y * y
    return (x * (1.5805143 + x2 * (-8.1668825 + x2 * (74.5198746 + x2 * (-451.5002441 + x2 * (
        1551.2922363 + x2 * (-2735.5422363 + x2 * 1923.1572266))))) + y2 * -0.1086027),
            y * (1.0238225 + y2 * -0.1025671 + x2 * (-0.2639930 + x2 * 0.2979266)))


def hyperview_undistort(pt, p: LensParams):
    return _digital_undistort(pt, p, _hyperview_fn, x_div=1.555555555)


def hyperview_distort_xy(x, y, z, p: LensParams):
    return _digital_distort(x, y, p, _hyperview_fn, x_mul=1.555555555)


def _gopro_warp_fn(dl):
    def fn(u, v):
        x = torch.clamp(u, -0.5, 0.5)
        y = torch.clamp(v, -0.5, 0.5)
        x2 = x * x
        y2 = y * y
        poly_x = dl[0] + x2 * (dl[1] + x2 * (dl[2] + x2 * (dl[3] + x2 * (dl[4] + x2 * (
            dl[5] + x2 * dl[6])))))
        return (x * (poly_x + dl[7] * y2) + (u - x),
                y * (dl[8] + dl[9] * y2 + dl[10] * y2 * y2 + x2 * (dl[11] + dl[12] * y2
                                                                   + dl[13] * x2)) + (v - y))
    return fn


def _gopro_warp_factor(dl):
    return torch.where(dl[14] != 0.0, dl[14], 1.0)


def gopro_warp_undistort(pt, p: LensParams):
    dl = p.digital_lens_params
    return _digital_undistort(pt, p, _gopro_warp_fn(dl), x_div=_gopro_warp_factor(dl))


def gopro_warp_distort_xy(x, y, z, p: LensParams):
    """The fixed point from (u * factor, v), then a residual check: a point
    whose inverse misses by more than 0.02 gets the reference's -99999
    sentinel, which samples as background."""
    dl = p.digital_lens_params
    u = x / p.width - 0.5
    v = y / p.height - 0.5
    fn = _gopro_warp_fn(dl)
    tx = u * _gopro_warp_factor(dl)
    px, py = _fixed_point_invert(fn, tx, v)
    rx, ry = fn(px, py)
    bad = (torch.abs(rx - tx) > 0.02) | (torch.abs(ry - v) > 0.02)
    ox = (px + 0.5) * p.width
    oy = (py + 0.5) * p.height
    return (torch.where(bad, -99999.0, ox), torch.where(bad, -99999.0, oy))


def digital_stretch_undistort(pt, p: LensParams):
    dl = p.digital_lens_params
    return _pack(pt[..., 0] / dl[0], pt[..., 1] / dl[1]), _ones(pt[..., 0])


def digital_stretch_distort_xy(x, y, z, p: LensParams):
    dl = p.digital_lens_params
    return (x * dl[0], y * dl[1])


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

class DistortionModel(NamedTuple):
    id: str
    name: str
    undistort: Callable    # (pt(...,2), LensParams) -> (pt(...,2), valid(...))
    distort: Callable      # (x, y, z, LensParams) -> pt(...,2)
    distort_xy: Callable = None  # tuple core: (x, y, z, p) -> (u, v)
    is_digital: bool = False


def _model(mid, name, undistort, distort_xy, is_digital=False):
    def distort(x, y, z, p):
        return _pack(*distort_xy(x, y, z, p))
    return mid, DistortionModel(mid, name, undistort, distort, distort_xy, is_digital)


# every model of the reference, in the JAX registry's order
# (distortion_models.py:674-689)
MODELS = dict([
    _model("opencv_fisheye", "OpenCV Fisheye", fisheye_undistort, fisheye_distort_xy),
    _model("opencv_standard", "OpenCV Standard", opencv_standard_undistort,
           opencv_standard_distort_xy),
    _model("poly3", "Poly3", poly3_undistort, poly3_distort_xy),
    _model("poly5", "Poly5", poly5_undistort, poly5_distort_xy),
    _model("ptlens", "PTLens", ptlens_undistort, ptlens_distort_xy),
    _model("insta360", "Insta360", insta360_undistort, insta360_distort_xy),
    _model("sony", "Sony", sony_undistort, sony_distort_xy),
    _model("generic_polynomial", "Generic polynomial", generic_poly_undistort,
           generic_poly_distort_xy),
    _model("gopro", "GoPro", gopro_undistort, gopro_distort_xy),
    _model("gopro_superview", "GoPro Superview", superview_undistort, superview_distort_xy,
           True),
    _model("gopro6_superview", "GoPro6 Superview", superview6_undistort,
           superview6_distort_xy, True),
    _model("gopro_hyperview", "GoPro Hyperview", hyperview_undistort, hyperview_distort_xy,
           True),
    _model("gopro_warp", "GoPro warp", gopro_warp_undistort, gopro_warp_distort_xy, True),
    _model("digital_stretch", "Digital stretch", digital_stretch_undistort,
           digital_stretch_distort_xy, True),
])
# the kernels' model ids (csrc/lens.cuh ModelId), in the registry's order
MODEL_IDS = {name: i for i, name in enumerate(MODELS)}


def get_model(name: str | None) -> DistortionModel:
    """Resolve by id, defaulting to opencv_fisheye like the reference."""
    if not name:
        return MODELS["opencv_fisheye"]
    return MODELS.get(name, MODELS["opencv_fisheye"])


# every model has torch math; the name a remap once used to ask for it
torch_model = get_model


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
