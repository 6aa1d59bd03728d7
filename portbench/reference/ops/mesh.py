"""Sony lens mesh correction and focal-plane distortion on torch tensors.

Torch twin of ``gyroflow_tpu.ops.mesh``: the per-pixel mesh stage of
rotate_and_distort (cpu_undistort.rs:169-214) on the reference's mesh buffer
layout (``core/splines.py``), with the same float32 operations in the same
order, the one-hot segment sums included (``where(fi == i, seg, 0)``). It is
the plain version of the mesh stage of the coords kernel
(``csrc/lens.cuh``, ``mesh_correction`` and ``focal_plane_distortion``),
which indexes segment ``fi`` directly and adds ``+0.0`` once, the value the
one-hot sum gives.

The mesh buffer is a float32 tensor on the plane's device; its header
entries are read as 0-d tensors, so no value goes back to the host. The grid
size is ``cfg.mesh_grid``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.splines import MAX_GRID_SIZE
from .kernel_params import FRAMEBUFFER_INVERTED, KernelConfig

_I32_MAX_F = 2147483520.0   # largest float32 below 2**31


def _map_coord(x, in_min, in_max, out_min, out_max):
    return (x - in_min) * (out_max - out_min) / (in_max - in_min) + out_min


def _segment(t, n: int):
    """clip(floor(t).astype(int32), 0, n - 2), the float -> int cast
    saturating as XLA's and CUDA's (NaN -> 0 after the clip)."""
    fi = torch.clamp(torch.floor(t), -2147483648.0, _I32_MAX_F).to(torch.int32)
    return torch.clamp(fi, 0, n - 2)


def fpd_offset(cfg: KernelConfig) -> int:
    """Index of the focal-plane block in the mesh buffer (remap.py:142-145)."""
    gw, gh = cfg.mesh_grid
    return 9 + gw * gh * 2 + 2 * gh * (MAX_GRID_SIZE * 4)


def spline_mus(n: int):
    """The natural-spline recurrence's mus (mesh.py:28-32): they depend only
    on n, so the coords kernel takes them from the host. float32, the same
    operations as _solve_spline's (1 / (4 - mus[i - 1]))."""
    mus = [np.float32(0.0)] * MAX_GRID_SIZE
    for i in range(1, n - 1):
        mus[i] = np.float32(1.0) / (np.float32(4.0) - mus[i - 1])
    return mus


def _solve_spline(vals, size, n):
    """Natural cubic spline coefficients (splines.rs:96-124), unrolled."""
    h = size / (n - 1)
    inv_h = 1.0 / h
    a = vals
    mus = [torch.zeros_like(a[0])] * n
    zs = [torch.zeros_like(a[0])] * n
    for i in range(1, n - 1):
        alpha_i = 3.0 * inv_h * (a[i + 1] - 2.0 * a[i] + a[i - 1])
        mus[i] = 1.0 / (4.0 - mus[i - 1])
        zs[i] = (alpha_i * inv_h - zs[i - 1]) * mus[i]
    c = [None] * n
    b = [None] * n
    d = [None] * n
    c[n - 1] = torch.zeros_like(a[0])
    for j in range(n - 2, -1, -1):
        c[j] = zs[j] - mus[j] * c[j + 1]
        b[j] = (a[j + 1] - a[j]) * inv_h - (h / 3.0) * (c[j + 1] + 2.0 * c[j])
        d[j] = (c[j + 1] - c[j]) / (3.0 * h)
    b[n - 1] = torch.zeros_like(a[0])
    d[n - 1] = torch.zeros_like(a[0])
    return a, b, c, d


def _spline_eval(a, b, c, d, n, x, size):
    """splines.rs:126-141 with the one-hot segment select (mesh.py:48)."""
    h = size / (n - 1)
    fi = _segment((n - 1) * x / size, n)
    res = torch.zeros_like(x)
    for i in range(n - 1):
        dx = x - size * i / (n - 1)
        seg = a[i] + b[i] * dx + c[i] * dx * dx + d[i] * dx * dx * dx
        res = res + torch.where(fi == i, seg, 0.0)
    below = a[0] + b[0] * x
    slope = b[n - 2] + 2.0 * c[n - 2] * h + 3.0 * d[n - 2] * h * h
    above = a[n - 1] + slope * (x - size)
    res = torch.where(x <= 0.0, below, res)
    res = torch.where(x >= size, above, res)
    return res


def _bivariate(mesh, mesh_offset, gx, gy, size_x, size_y, n_x, n_y):
    """BivariateSpline::interpolate (splines.rs:143-172) per pixel."""
    grid = MAX_GRID_SIZE
    raw_len = n_x * n_y * 2
    block = grid * 4
    coeff_base = 9 + raw_len + mesh_offset * n_y * block

    fi = _segment((n_x - 1) * gx / size_x, n_x)
    dx = gx - size_x * fi.to(torch.float32) / (n_x - 1)
    dx2 = dx * dx
    inter = []
    for j in range(n_y):
        val = torch.zeros_like(gx)
        for i in range(n_x - 1):
            rb = coeff_base + i + j * block
            seg = (mesh[rb] + mesh[rb + grid] * dx +
                   mesh[rb + 2 * grid] * dx2 + mesh[rb + 3 * grid] * dx2 * dx)
            val = val + torch.where(fi == i, seg, 0.0)
        inter.append(val)

    a, b, c, d = _solve_spline(inter, size_y, n_y)
    return _spline_eval(a, b, c, d, n_y, gy, size_y)


def apply_mesh_correction(u, v, mesh, cfg: KernelConfig):
    """Mesh stage of rotate_and_distort (cpu_undistort.rs:169-185)."""
    n_x, n_y = cfg.mesh_grid
    width = float(cfg.width)
    height = float(cfg.height)
    size_x = mesh[3]
    size_y = mesh[4]
    ox, oy = mesh[5], mesh[6]
    cw, ch = mesh[7], mesh[8]

    inv = cfg.has(FRAMEBUFFER_INVERTED)
    if inv:
        v = height - v
    mu = _map_coord(u, 0.0, width, ox, ox + cw)
    mv = _map_coord(v, 0.0, height, oy, oy + ch)
    nx = _bivariate(mesh, 0, mu, mv, size_x, size_y, n_x, n_y)
    ny = _bivariate(mesh, 1, mu, mv, size_x, size_y, n_x, n_y)
    u = _map_coord(nx, ox, ox + cw, 0.0, width)
    v = _map_coord(ny, oy, oy + ch, 0.0, height)
    if inv:
        v = height - v
    return u, v


def apply_focal_plane_distortion(u, v, mesh, fpd_offset: int, cfg: KernelConfig,
                                 sign: float = -1.0):
    """FPD stage (cpu_undistort.rs:188-214). ``sign`` = +1 for the points
    path. The row index's NaN goes to row 0, as the float -> int cast of XLA
    and of CUDA takes it."""
    width = float(cfg.width)
    height = float(cfg.height)
    size_y = mesh[4]
    ox, oy = mesh[5], mesh[6]
    cw, ch = mesh[7], mesh[8]
    stblz_grid = size_y / 8.0
    o = fpd_offset

    inv = cfg.has(FRAMEBUFFER_INVERTED)
    if inv:
        v = height - v
    mu = _map_coord(u, 0.0, width, ox, ox + cw)
    mv = _map_coord(v, 0.0, height, oy, oy + ch)

    idx = torch.nan_to_num(torch.clamp(torch.floor(mv / stblz_grid), 0.0, 7.0),
                           nan=0.0).to(torch.int32)
    delta = mv - stblz_grid * idx.to(torch.float32)
    dx_total = torch.zeros_like(mu)
    dy_total = torch.zeros_like(mv)
    for i in range(8):
        sel = idx == i
        dx_total = dx_total + torch.where(sel, mesh[o + 4 + i * 2] * delta, 0.0)
        dy_total = dy_total + torch.where(sel, mesh[o + 4 + i * 2 + 1] * delta, 0.0)
    for j in range(7):
        m = idx > j
        dx_total = dx_total + torch.where(m, mesh[o + 4 + j * 2] * stblz_grid, 0.0)
        dy_total = dy_total + torch.where(m, mesh[o + 4 + j * 2 + 1] * stblz_grid, 0.0)

    mu = mu + sign * dx_total
    mv = mv + sign * dy_total

    u = _map_coord(mu, ox, ox + cw, 0.0, width)
    v = _map_coord(mv, oy, oy + ch, 0.0, height)
    if inv:
        v = height - v
    return u, v
