"""Vectorized numpy mirrors of the distortion models for HOST-side paths.

The zoom solver / autosync / stmap evaluate a few hundred points per frame on
the host; dispatching jnp ops there costs more than the math. These mirrors
implement the same formulas as distortion_models.py (single source of spec:
the reference files cited there) in plain numpy f32, and are cross-tested
against the jnp versions (tests/test_np_models.py).

API: undistort(pts (N,2), k, p) -> (pts, valid); distort(x, y, z, k, p) -> (N,2).
``p`` is a dict with digital_lens_params/width/height/output_width/output_height.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PI = math.pi
EPS = 1e-6
NEWTON_EPS = 1e-5


def _safe_div(a, b, fallback=0.0):
    bz = b == 0.0
    return np.where(bz, fallback, a / np.where(bz, 1.0, b))


# ---- opencv fisheye --------------------------------------------------------

def fisheye_undistort(pts, k, p):
    x, y = pts[..., 0], pts[..., 1]
    theta_d = np.clip(np.sqrt(x * x + y * y), -PI, PI)
    need = np.abs(theta_d) > EPS
    theta = np.zeros_like(theta_d)
    conv = np.zeros_like(theta_d, dtype=bool)
    for _ in range(10):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t6 * t2
        k0, k1, k2, k3 = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
        fix = (theta * (1 + k0 + k1 + k2 + k3) - theta_d) / \
              (1 + 3 * k0 + 5 * k1 + 7 * k2 + 9 * k3)
        fix = np.clip(fix, -0.9, 0.9)
        theta = np.where(conv, theta, theta - fix)
        conv = conv | (np.abs(fix) < EPS)
    scale = np.where(need, _safe_div(np.tan(theta), theta_d), 0.0)
    conv = conv | ~need
    flipped = ((theta_d < 0) & (theta > 0)) | ((theta_d > 0) & (theta < 0))
    valid = conv & ~flipped
    if k[0] == 0 and k[1] == 0 and k[2] == 0 and k[3] == 0:
        return pts.copy(), np.ones_like(valid)
    return np.stack([x * scale, y * scale], -1), valid


def fisheye_distort(x, y, z, k, p):
    x = x / z
    y = y / z
    if k[0] == 0 and k[1] == 0 and k[2] == 0 and k[3] == 0:
        return np.stack([x, y], -1)
    r = np.sqrt(x * x + y * y)
    t = np.arctan(r)
    t2 = t * t
    td = t * (1 + k[0] * t2 + k[1] * t2**2 + k[2] * t2**3 + k[3] * t2**4)
    scale = np.where(r == 0, 1.0, _safe_div(td, r, 1.0))
    return np.stack([x * scale, y * scale], -1)


# ---- opencv standard -------------------------------------------------------

def standard_undistort(pts, k, p):
    x0, y0 = pts[..., 0], pts[..., 1]
    x, y = x0.copy(), y0.copy()
    valid = np.ones_like(x0, dtype=bool)
    for _ in range(20):
        r2 = x * x + y * y
        icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / \
                 (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        valid = valid & (icdist >= 0)
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = np.where(valid, (x0 - dx) * icdist, x)
        y = np.where(valid, (y0 - dy) * icdist, y)
    return np.stack([x, y], -1), valid


def standard_distort(x, y, z, k, p):
    x = x / z
    y = y / z
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    a1, a2, a3 = 2 * x * y, r2 + 2 * x * x, r2 + 2 * y * y
    cdist = 1 + k[0] * r2 + k[1] * r4 + k[4] * r6
    icdist2 = 1.0 / (1 + k[5] * r2 + k[6] * r4 + k[7] * r6)
    return np.stack([x * cdist * icdist2 + k[2] * a1 + k[3] * a2 + k[8] * r2 + k[9] * r4,
                     y * cdist * icdist2 + k[2] * a3 + k[3] * a1 + k[10] * r2 + k[11] * r4], -1)


# ---- lensfun family --------------------------------------------------------

def _lensfun_newton(rd, f, fp):
    ru = rd.copy()
    conv = np.zeros_like(rd, dtype=bool)
    for _ in range(7):
        fru = f(ru)
        conv = conv | ((fru >= -NEWTON_EPS) & (fru < NEWTON_EPS))
        ru = np.where(conv, ru, ru - fru / fp(ru))
    fru = f(ru)
    conv = conv | ((fru >= -NEWTON_EPS) & (fru < NEWTON_EPS))
    return ru, conv


def _radial_undistort(pts, f, fp):
    x, y = pts[..., 0], pts[..., 1]
    rd = np.sqrt(x * x + y * y)
    nz = rd != 0
    rds = np.where(nz, rd, 1.0)
    ru, conv = _lensfun_newton(rds, lambda r: f(r, rds), lambda r: fp(r))
    valid = nz & conv & (ru >= 0)
    s = ru / rds
    return np.stack([x * s, y * s], -1), valid


def poly3_undistort(pts, k, p):
    ik = 1.0 / k[0]
    return _radial_undistort(pts,
                             lambda ru, rd: ru**3 + ru * ik - rd * ik,
                             lambda ru: 3 * ru * ru + ik)


def poly3_distort(x, y, z, k, p):
    x, y = x / z, y / z
    s = k[0] * (x * x + y * y) + 1.0
    return np.stack([x * s, y * s], -1)


def poly5_undistort(pts, k, p):
    return _radial_undistort(pts,
                             lambda ru, rd: ru * (1 + k[0] * ru**2 + k[1] * ru**4) - rd,
                             lambda ru: 1 + 3 * k[0] * ru**2 + 5 * k[1] * ru**4)


def poly5_distort(x, y, z, k, p):
    x, y = x / z, y / z
    r2 = x * x + y * y
    s = 1 + k[0] * r2 + k[1] * r2 * r2
    return np.stack([x * s, y * s], -1)


def ptlens_undistort(pts, k, p):
    return _radial_undistort(pts,
                             lambda ru, rd: ru * (k[0] * ru**3 + k[1] * ru**2 + k[2] * ru + 1) - rd,
                             lambda ru: 4 * k[0] * ru**3 + 3 * k[1] * ru**2 + 2 * k[2] * ru + 1)


def ptlens_distort(x, y, z, k, p):
    x, y = x / z, y / z
    r2 = x * x + y * y
    r = np.sqrt(r2)
    s = k[0] * r2 * r + k[1] * r2 + k[2] * r + 1.0
    return np.stack([x * s, y * s], -1)


# ---- insta360 --------------------------------------------------------------

def insta360_distort(x, y, z, k, p):
    k1, k2, k3, p1, p2, xi = k[0], k[1], k[2], k[3], k[4], k[5]
    ln = np.sqrt(x * x + y * y + z * z)
    d = z / ln + xi
    xs = (x / ln) / d
    ys = (y / ln) / d
    r2 = xs * xs + ys * ys
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    return np.stack([xs * radial + 2 * p1 * xs * ys + p2 * (r2 + 2 * xs * xs),
                     ys * radial + 2 * p2 * xs * ys + p1 * (r2 + 2 * ys * ys)], -1)


def insta360_undistort(pts, k, p):
    px = pts[..., 0].copy()
    py = pts[..., 1].copy()
    done = np.zeros_like(px, dtype=bool)
    for _ in range(200):
        dp = insta360_distort(px, py, np.ones_like(px), k, p)
        dx = dp[..., 0] - pts[..., 0]
        dy = dp[..., 1] - pts[..., 1]
        done = done | ((np.abs(dx) < 1e-6) & (np.abs(dy) < 1e-6))
        if done.all():
            break
        px = np.where(done, px, px - dx)
        py = np.where(done, py, py - dy)
    return np.stack([px, py], -1), np.ones_like(px, dtype=bool)


# ---- sony ------------------------------------------------------------------

def sony_undistort(pts, k, p):
    x, y = pts[..., 0], pts[..., 1]
    theta_d = np.sqrt(x * x + y * y)
    need = np.abs(theta_d) > EPS
    theta = np.zeros_like(theta_d)
    conv = np.zeros_like(theta_d, dtype=bool)
    for _ in range(10):
        t = theta
        num = t * (k[0] + k[1] * t + k[2] * t**2 + k[3] * t**3 + k[4] * t**4 + k[5] * t**5) - theta_d
        den = k[0] + 2 * k[1] * t + 3 * k[2] * t**2 + 4 * k[3] * t**3 + 5 * k[4] * t**4 + 6 * k[5] * t**5
        fix = num / den
        theta = np.where(conv, theta, theta - fix)
        conv = conv | (np.abs(fix) < EPS)
    scale = np.where(need, _safe_div(np.tan(theta), theta_d), 0.0)
    conv = conv | ~need
    flipped = ((theta_d < 0) & (theta > 0)) | ((theta_d > 0) & (theta < 0))
    valid = conv & ~flipped
    if k[0] == 0 and k[1] == 0 and k[2] == 0 and k[3] == 0:
        return pts.copy(), np.ones_like(valid)
    return np.stack([x * scale, y * scale], -1), valid


def sony_distort(x, y, z, k, p):
    x, y = x / z, y / z
    if k[0] == 0 and k[1] == 0 and k[2] == 0 and k[3] == 0:
        return np.stack([x, y], -1)
    r = np.sqrt(x * x + y * y)
    t = np.arctan(r)
    td = (t * k[0] + t**2 * k[1] + t**3 * k[2] + t**4 * k[3] + t**5 * k[4] + t**6 * k[5])
    scale = np.where(r == 0, 1.0, _safe_div(td, r, 1.0))
    return np.stack([x * scale, y * scale], -1)


# ---- generic polynomial ----------------------------------------------------

def generic_undistort(pts, k, p):
    x, y = pts[..., 0], pts[..., 1]
    theta_d = np.sqrt(x * x + y * y)
    need = np.abs(theta_d) > EPS
    theta = np.zeros_like(theta_d)
    conv = np.zeros_like(theta_d, dtype=bool)
    for _ in range(10):
        num = np.zeros_like(theta)
        den = np.zeros_like(theta)
        tp = np.ones_like(theta)
        for i in range(12):
            term = k[i] * tp
            num = num + term
            den = den + (i + 1.0) * term
            tp = tp * theta
        fix = (theta * num - theta_d) / den
        theta = np.where(conv, theta, theta - fix)
        conv = conv | (np.abs(fix) < EPS)
    scale = np.where(need, _safe_div(np.tan(theta), theta_d), 0.0)
    conv = conv | ~need
    flipped = ((theta_d < 0) & (theta > 0)) | ((theta_d > 0) & (theta < 0))
    valid = conv & ~flipped
    if not np.any(k):
        return pts.copy(), np.ones_like(valid)
    return np.stack([x * scale, y * scale], -1), valid


def generic_distort(x, y, z, k, p):
    x, y = x / z, y / z
    if not np.any(k):
        return np.stack([x, y], -1)
    r = np.sqrt(x * x + y * y)
    t = np.arctan(r)
    td = np.zeros_like(t)
    tp = t.copy()
    for i in range(12):
        td = td + tp * k[i]
        tp = tp * t
    scale = np.where(r == 0, 1.0, _safe_div(td, r, 1.0))
    return np.stack([x * scale, y * scale], -1)


# ---- gopro POLY ------------------------------------------------------------

_GOPRO_TMAX = 1.5533


def _gp_eval(pp, k):
    return k[0] + pp * (k[1] + pp * (k[2] + pp * (k[3] + pp * (k[4] + pp * (k[5] + pp * k[6])))))


def _gp_deriv(pp, k):
    return k[1] + pp * (2 * k[2] + pp * (3 * k[3] + pp * (4 * k[4] + pp * (5 * k[5] + pp * 6 * k[6]))))


def gopro_undistort(pts, k, p):
    x, y = pts[..., 0], pts[..., 1]
    r = np.sqrt(x * x + y * y)
    trivial = (k[1] == 0) | (r < 1e-9)
    rs = np.where(r < 1e-9, 1.0, r)
    theta = _gp_eval(rs / k[1] if k[1] != 0 else rs, k)
    tt = math.tan(_GOPRO_TMAX)
    rr = np.where(theta < _GOPRO_TMAX, np.tan(np.minimum(theta, _GOPRO_TMAX)),
                  tt + (theta - _GOPRO_TMAX) * (1 + tt * tt))
    s = rr / rs
    out = np.where(np.broadcast_to(np.atleast_1d(trivial)[..., None], pts.shape), pts,
                   np.stack([x * s, y * s], -1))
    return out, np.ones_like(x, dtype=bool)


def gopro_distort(x, y, z, k, p):
    x, y = x / z, y / z
    if k[1] == 0:
        return np.stack([x, y], -1)
    r = np.sqrt(x * x + y * y)
    tt = math.tan(_GOPRO_TMAX)
    theta = np.where(r < tt, np.arctan(np.minimum(r, tt)), _GOPRO_TMAX + (r - tt) / (1 + tt * tt))
    pp = (theta - k[0]) / k[1]
    done = np.zeros_like(theta, dtype=bool)
    for _ in range(10):
        d = _gp_deriv(pp, k)
        done = done | (np.abs(d) < 1e-12)
        fix = (_gp_eval(pp, k) - theta) / np.where(np.abs(d) < 1e-12, 1.0, d)
        pp = np.where(done, pp, pp - fix)
        done = done | (np.abs(fix) < 1e-7)
    rn = k[1] * pp
    s = np.where(r < 1e-9, 1.0, rn / np.where(r < 1e-9, 1.0, r))
    return np.stack([x * s, y * s], -1)


# ---- digital lenses --------------------------------------------------------

def _fp_invert(fn, tx, ty, iters=12):
    px, py = tx.copy(), ty.copy()
    done = np.zeros_like(tx, dtype=bool)
    for _ in range(iters):
        fx, fy = fn(px, py)
        dx, dy = fx - tx, fy - ty
        done = done | ((np.abs(dx) < 1e-6) & (np.abs(dy) < 1e-6))
        if done.all():
            break
        px = np.where(done, px, px - dx)
        py = np.where(done, py, py - dy)
    return px, py


def _superview(x, y):
    x2, y2 = x * x, y * y
    return (x * (1.2100393 + x2 * (-1.2758402 + x2 * 1.7751845)),
            y * (0.9364505 + (0.4465308 - 0.7683315 * y2) * y2 + (-0.3574087 + 1.1584653 * y2 + 0.3529348 * x2) * x2))


def superview_undistort(pts, k, p):
    u = pts[..., 0] / p["output_width"] - 0.5
    v = pts[..., 1] / p["output_height"] - 0.5
    x, y = _superview(u, v)
    x = x / 1.333333333
    return np.stack([(x + 0.5) * p["output_width"], (y + 0.5) * p["output_height"]], -1), \
        np.ones_like(u, dtype=bool)


def superview_distort(x, y, z, k, p):
    u = x / p["width"] - 0.5
    v = y / p["height"] - 0.5
    px, py = _fp_invert(_superview, u * 1.333333333, v)
    return np.stack([(px + 0.5) * p["width"], (py + 0.5) * p["height"]], -1)


def _superview6(x, y):
    x = x * (1.0 - 0.48 * np.abs(x))
    x = x * (0.943396 * (1.0 + 0.157895 * np.abs(x)))
    y = y * (0.943396 * (1.0 + 0.06 * np.abs(y * 2.0)))
    return x, y


def superview6_undistort(pts, k, p):
    u = pts[..., 0] / p["output_width"] - 0.5
    v = pts[..., 1] / p["output_height"] - 0.5
    x, y = _superview6(u, v)
    return np.stack([(x + 0.5) * p["output_width"], (y + 0.5) * p["output_height"]], -1), \
        np.ones_like(u, dtype=bool)


def superview6_distort(x, y, z, k, p):
    u = x / p["width"] - 0.5
    v = y / p["height"] - 0.5
    px, py = _fp_invert(_superview6, u, v)
    return np.stack([(px + 0.5) * p["width"], (py + 0.5) * p["height"]], -1)


def _hyperview(x, y):
    x2, y2 = x * x, y * y
    return (x * (1.5805143 + x2 * (-8.1668825 + x2 * (74.5198746 + x2 * (-451.5002441 + x2 * (1551.2922363 + x2 * (-2735.5422363 + x2 * 1923.1572266))))) + y2 * -0.1086027),
            y * (1.0238225 + y2 * -0.1025671 + x2 * (-0.2639930 + x2 * 0.2979266)))


def hyperview_undistort(pts, k, p):
    u = pts[..., 0] / p["output_width"] - 0.5
    v = pts[..., 1] / p["output_height"] - 0.5
    x, y = _hyperview(u, v)
    x = x / 1.555555555
    return np.stack([(x + 0.5) * p["output_width"], (y + 0.5) * p["output_height"]], -1), \
        np.ones_like(u, dtype=bool)


def hyperview_distort(x, y, z, k, p):
    u = x / p["width"] - 0.5
    v = y / p["height"] - 0.5
    px, py = _fp_invert(_hyperview, u * 1.555555555, v)
    return np.stack([(px + 0.5) * p["width"], (py + 0.5) * p["height"]], -1)


def _gopro_warp_fn(dl):
    def fn(u, v):
        x = np.clip(u, -0.5, 0.5)
        y = np.clip(v, -0.5, 0.5)
        x2, y2 = x * x, y * y
        poly_x = dl[0] + x2 * (dl[1] + x2 * (dl[2] + x2 * (dl[3] + x2 * (dl[4] + x2 * (dl[5] + x2 * dl[6])))))
        return (x * (poly_x + dl[7] * y2) + (u - x),
                y * (dl[8] + dl[9] * y2 + dl[10] * y2**2 + x2 * (dl[11] + dl[12] * y2 + dl[13] * x2)) + (v - y))
    return fn


def gopro_warp_undistort(pts, k, p):
    dl = p["digital_lens_params"]
    factor = dl[14] if dl[14] != 0 else 1.0
    u = pts[..., 0] / p["output_width"] - 0.5
    v = pts[..., 1] / p["output_height"] - 0.5
    x, y = _gopro_warp_fn(dl)(u, v)
    x = x / factor
    return np.stack([(x + 0.5) * p["output_width"], (y + 0.5) * p["output_height"]], -1), \
        np.ones_like(u, dtype=bool)


def gopro_warp_distort(x, y, z, k, p):
    dl = p["digital_lens_params"]
    factor = dl[14] if dl[14] != 0 else 1.0
    u = x / p["width"] - 0.5
    v = y / p["height"] - 0.5
    fn = _gopro_warp_fn(dl)
    tx = u * factor
    px, py = _fp_invert(fn, tx, v)
    rx, ry = fn(px, py)
    bad = (np.abs(rx - tx) > 0.02) | (np.abs(ry - v) > 0.02)
    ox = (px + 0.5) * p["width"]
    oy = (py + 0.5) * p["height"]
    return np.stack([np.where(bad, -99999.0, ox), np.where(bad, -99999.0, oy)], -1)


def stretch_undistort(pts, k, p):
    dl = p["digital_lens_params"]
    return np.stack([pts[..., 0] / dl[0], pts[..., 1] / dl[1]], -1), \
        np.ones_like(pts[..., 0], dtype=bool)


def stretch_distort(x, y, z, k, p):
    dl = p["digital_lens_params"]
    return np.stack([x * dl[0], y * dl[1]], -1)


NP_MODELS = {
    "opencv_fisheye": (fisheye_undistort, fisheye_distort),
    "opencv_standard": (standard_undistort, standard_distort),
    "poly3": (poly3_undistort, poly3_distort),
    "poly5": (poly5_undistort, poly5_distort),
    "ptlens": (ptlens_undistort, ptlens_distort),
    "insta360": (insta360_undistort, insta360_distort),
    "sony": (sony_undistort, sony_distort),
    "generic_polynomial": (generic_undistort, generic_distort),
    "gopro": (gopro_undistort, gopro_distort),
    "gopro_superview": (superview_undistort, superview_distort),
    "gopro6_superview": (superview6_undistort, superview6_distort),
    "gopro_hyperview": (hyperview_undistort, hyperview_distort),
    "gopro_warp": (gopro_warp_undistort, gopro_warp_distort),
    "digital_stretch": (stretch_undistort, stretch_distort),
}


def get_np_model(name: str) -> Tuple:
    return NP_MODELS.get(name or "opencv_fisheye", NP_MODELS["opencv_fisheye"])
