"""Catmull-Rom and bivariate cubic splines (Sony IBIS/OIS + lens mesh).

Port of gyroflow src/core/gyro_source/splines.rs. The mesh buffer
layout matches the reference exactly (shared with the GPU kernels):
  [0]  offset to focal-plane-distortion data (o); 0 = none
  [1]  grid width, [2] grid height
  [3,4] mesh size, [5,6] origin, [7,8] crop size
  [9 .. 9+gw*gh*2] grid points (x,y interleaved)
  then per-channel precomputed x-spline coefficients: channel c at
  9 + gw*gh*2 + c*gh*36, row j holds a[9] b[9] c[9] d[9]
  [o ..] focal plane distortion: [o]=enabled, [o+4 + row*2 + {0,1}] shears
"""
from __future__ import annotations

from typing import Optional

import numpy as np

MAX_GRID_SIZE = 9


class CatmullRom:
    """Keyed Catmull-Rom spline over (position, value[N]) points (splines.rs:8-88)."""

    def __init__(self, positions=None, values=None):
        self.positions = np.asarray(positions if positions is not None else [], dtype=np.float64)
        self.values = np.asarray(values if values is not None else [], dtype=np.float64)
        if self.values.ndim == 1:
            self.values = self.values[:, None]

    def add_point(self, position: float, value):
        self.positions = np.append(self.positions, position)
        v = np.atleast_1d(np.asarray(value, dtype=np.float64))[None, :]
        self.values = np.concatenate([self.values, v]) if self.values.size else v

    def interpolate(self, t) -> np.ndarray:
        """Vectorized over t; out-of-range or <2 points -> zeros (reference
        returns None and callers use unwrap_or_default)."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        n = len(self.positions)
        out = np.zeros((len(t), self.values.shape[1] if self.values.size else 3))
        if n < 2:
            return out
        pos = self.positions
        vals = self.values
        lower = np.searchsorted(pos, t, side="right") - 1
        # exact hits at interior points: searchsorted 'right' gives i, matching
        # the reference's Ok(i) branch
        exact = np.isin(t, pos) & (lower >= 0)
        lower = np.where(exact & (t == pos[np.clip(lower, 0, n - 1)]), lower, lower)
        valid = (lower >= 0) & (lower + 1 < n)
        li = np.clip(lower, 0, n - 2)
        p0 = pos[li]
        p1 = pos[li + 1]
        k = (t - p0) / np.where(p1 == p0, 1.0, p1 - p0)
        a = vals[li]
        b = vals[li + 1]
        lower2 = np.where(li <= 0, 0, li - 1)
        x = np.where((li <= 0)[:, None], a * 2.0 - b, vals[lower2])
        next2 = np.where(li + 2 >= n, n - 1, li + 2)
        y = np.where((li + 2 >= n)[:, None], b * 2.0 - a, vals[next2])
        kk = k[:, None]
        res = ((((a * 3.0 - x) - b * 3.0) + y) * 0.5) * kk**3 \
            + ((b - x) * 0.5) * kk \
            + a \
            + (((b * 4.0 + a * -5.0 + x + x) - y) * 0.5) * kk**2
        out[valid] = res[valid]
        return out


def cubic_spline_coefficients(values: np.ndarray, size: float):
    """Natural cubic spline coefficients (splines.rs:96-124); values (..., n)."""
    v = np.asarray(values, dtype=np.float64)
    n = v.shape[-1]
    h = size / (n - 1)
    inv_h = 1.0 / h
    a = v.copy()
    alpha = np.zeros_like(v)
    alpha[..., 1:n - 1] = 3.0 * inv_h * (v[..., 2:] - 2.0 * v[..., 1:n - 1] + v[..., :n - 2])
    mu = np.zeros_like(v)
    z = np.zeros_like(v)
    for i in range(1, n - 1):
        mu[..., i] = 1.0 / (4.0 - mu[..., i - 1])
        z[..., i] = (alpha[..., i] * inv_h - z[..., i - 1]) * mu[..., i]
    c = np.zeros_like(v)
    b = np.zeros_like(v)
    d = np.zeros_like(v)
    for j in range(n - 2, -1, -1):
        c[..., j] = z[..., j] - mu[..., j] * c[..., j + 1]
        b[..., j] = (v[..., j + 1] - v[..., j]) * inv_h - (h / 3.0) * (c[..., j + 1] + 2.0 * c[..., j])
        d[..., j] = (c[..., j + 1] - c[..., j]) / (3.0 * h)
    return a, b, c, d


def cubic_spline_interpolate(a, b, c, d, x, size: float):
    """splines.rs:126-141; vectorized over leading dims of x and coeffs."""
    n = a.shape[-1]
    h = size / (n - 1)
    i = np.clip(((n - 1) * np.asarray(x) / size).astype(int), 0, n - 2)
    dx = x - size * i / (n - 1)
    take = lambda arr: np.take_along_axis(arr, i[..., None], axis=-1)[..., 0] \
        if arr.ndim > 1 else arr[i]
    res = take(a) + take(b) * dx + take(c) * dx**2 + take(d) * dx**3
    # linear extrapolation at the ends
    below = x <= 0.0
    res = np.where(below, a[..., 0] + b[..., 0] * x, res)
    above = x >= size
    slope = b[..., n - 2] + 2.0 * c[..., n - 2] * h + 3.0 * d[..., n - 2] * h * h
    res = np.where(above, a[..., n - 1] + slope * (x - size), res)
    return res


def build_mesh_buffer(grid_points: np.ndarray, mesh_size, origin=(0.0, 0.0),
                      crop_size=None, focal_plane_shears: Optional[np.ndarray] = None,
                      fpd_enabled: bool = False) -> np.ndarray:
    """Build a reference-layout mesh buffer from (gh, gw, 2) grid points."""
    gh, gw, _ = grid_points.shape
    assert gw <= MAX_GRID_SIZE and gh <= MAX_GRID_SIZE
    crop_size = crop_size or mesh_size
    raw_len = gw * gh * 2
    coeff_len = 2 * gh * (MAX_GRID_SIZE * 4)
    o = 9 + raw_len + coeff_len
    buf = np.zeros(o + 24, dtype=np.float64)
    buf[0] = o
    buf[1] = gw
    buf[2] = gh
    buf[3], buf[4] = mesh_size
    buf[5], buf[6] = origin
    buf[7], buf[8] = crop_size
    buf[9:9 + raw_len] = grid_points.reshape(-1)
    # per-channel, per-row x-spline coefficients
    for ch in range(2):
        rows = grid_points[..., ch]                       # (gh, gw)
        a, b, c, d = cubic_spline_coefficients(rows, mesh_size[0])
        base = 9 + raw_len + ch * gh * (MAX_GRID_SIZE * 4)
        for j in range(gh):
            rb = base + j * MAX_GRID_SIZE * 4
            buf[rb:rb + gw] = a[j]
            buf[rb + MAX_GRID_SIZE:rb + MAX_GRID_SIZE + gw] = b[j]
            buf[rb + 2 * MAX_GRID_SIZE:rb + 2 * MAX_GRID_SIZE + gw] = c[j]
            buf[rb + 3 * MAX_GRID_SIZE:rb + 3 * MAX_GRID_SIZE + gw] = d[j]
    if fpd_enabled and focal_plane_shears is not None:
        buf[int(buf[0])] = 1.0
        buf[int(buf[0]) + 4:int(buf[0]) + 4 + 16] = np.asarray(focal_plane_shears).reshape(-1)[:16]
    return buf


def bivariate_interpolate(mesh: np.ndarray, mesh_offset: int, x, y,
                          size_x: float, size_y: float):
    """BivariateSpline::interpolate (splines.rs:143-172), vectorized over x/y."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    y = np.atleast_1d(np.asarray(y, dtype=np.float64))
    n_x = int(mesh[1])
    n_y = int(mesh[2])
    grid = MAX_GRID_SIZE
    raw_len = n_x * n_y * 2
    block = grid * 4

    i = np.clip(((n_x - 1) * x / size_x).astype(int), 0, n_x - 2)
    dx = x - size_x * i / (n_x - 1)
    dx2 = dx * dx
    coeff_base = 9 + raw_len + mesh_offset * n_y * block

    inter = np.empty((len(x), n_y))
    for j in range(n_y):
        rb = coeff_base + i + j * block
        inter[:, j] = (mesh[rb] + mesh[rb + grid] * dx +
                       mesh[rb + 2 * grid] * dx2 + mesh[rb + 3 * grid] * dx2 * dx)
    a, b, c, d = cubic_spline_coefficients(inter, size_y)
    return cubic_spline_interpolate(a, b, c, d, y, size_y)


def interpolate_mesh(x, y, size, mesh: np.ndarray):
    """sony.rs:557-563: (x, y) through the 2-channel mesh."""
    return np.stack([
        bivariate_interpolate(mesh, 0, x, y, size[0], size[1]),
        bivariate_interpolate(mesh, 1, x, y, size[0], size[1]),
    ], axis=-1)
