"""The per-pixel undistort/rotate/redistort remap on torch tensors.

Twin of ``gyroflow_tpu.ops.remap``: the same steps in the same float32 order
(each function cites the JAX line it mirrors), on (oh, ow) full-frame maps.

Two entry points share one body (``_remap``), which runs a plane along its
route (``plane_route``: "fused", "gen" or "pre") through one of two tables
of stages:

- ``remap_plane``: every stage in plain torch (``PLAIN``: per-pixel
  matrix-row gather, 64-tap gather sampling), always on the "pre" route.
  It is the port's CPU path and the reference the kernels are held against.
- ``remap_plane_cuda``: the stages on the kernels (``kernels()``), with
  torch ``coords_post_uv`` and the finish in torch, along the route
  ``plane_route`` decides. It is the counterpart of ``remap_plane_pallas``
  without the TPU's window ladder: one thread per output pixel reads its
  matrix row and its taps directly, so there is no window to overflow.

Sony mesh correction and focal-plane distortion (``ops/mesh.py``) run inside
the projection, after the lens centre and before the digital lens, as in
remap.py:137-147: in the plain projection, in the coords kernel's mesh
form, and so in the rolling-shutter probe of ``coords_pre`` (on a card the
coords kernel's: ``mesh_probe``). The drawing overlay (tracking points, calibration corners, the safe-area dim)
is the epilogue after the colour-range step: ``_draw_overlay`` in plain
torch, ``cuda_overlay.overlay`` on a card.

EWA (interpolation 10-13) needs the finite-difference Jacobian of the
source coordinates: both entry points stack the base eval and the two
+eps evals into one (3*oh, ow) projection call (``ewa_stack``), as
remap_plane_pallas does (remap.py:783-802); on the "gen" route the coords
kernel computes the stacked evals itself. Both sample with the EWA stencil
at the JAX package's top cap, ``EWA_CAP = 4`` (a 10x10 stencil). The plain
path forms the Jacobian with ``ewa_jacobian``, the spec; the EWA kernel
forms it from the same stacked evals in the same order.

``dyn`` is a KernelDynamics with host numpy leaves, as the manager builds it;
the functions move it to the image's device themselves.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.splines import MAX_GRID_SIZE
from .interpolation import COEFFS, INTER_BITS, INTER_TAB_SIZE, INTERP_INFO

from .. import trace
from . import distortion_models as dm
from .kernel_params import (
    ANY_UNDERWATER, DRAWING_ENABLED, FILL_WITH_BACKGROUND, FIX_COLOR_RANGE,
    HAS_DIGITAL_LENS, HAS_FPD_DATA, HAS_IBIS_DATA, HAS_MESH_DATA, HORIZONTAL_RS,
    KernelConfig, KernelDynamics, dyn_to_torch,
)

_COEFFS_T = torch.from_numpy(np.asarray(COEFFS, np.float32))


def map_coord(x, in_min, in_max, out_min, out_max):
    """Linear range remap (util.rs:144-147)."""
    return (x - in_min) * (out_max - out_min) / (in_max - in_min) + out_min


def out_grid(ow: int, rows: int, oy0: int, device):
    """(oy, ox) float32 (rows, ow): the positions of output rows oy0 .. oy0 +
    rows."""
    return torch.meshgrid(torch.arange(oy0, oy0 + rows, dtype=torch.float32, device=device),
                          torch.arange(ow, dtype=torch.float32, device=device), indexing="ij")


def _lens_params(cfg: KernelConfig, dyn: KernelDynamics) -> dm.LensParams:
    return dm.LensParams(
        k=dyn.k, digital_lens_params=dyn.digital_lens_params,
        width=float(cfg.width), height=float(cfg.height),
        output_width=float(cfg.output_width), output_height=float(cfg.output_height))


def _forward_refraction(x, y, w, lrc):
    """Underwater forward refraction scaling of w (remap.py:70)."""
    do = (lrc != 1.0) & (lrc > 0.0) & (w != 0.0)
    w_safe = torch.where(w == 0.0, 1.0, w)
    r = torch.sqrt(x * x + y * y) / w_safe
    sin_theta_d = (r / torch.sqrt(1.0 + r * r)) * lrc
    denom = torch.sqrt(torch.clamp_min(1.0 - sin_theta_d * sin_theta_d, 1e-12))
    r_d = sin_theta_d / denom
    scale = torch.where((r_d != 0.0) & do, r / torch.where(r_d == 0.0, 1.0, r_d), 1.0)
    return w * scale


def _inverse_refraction(nx, ny, lrc):
    """Inverse refraction after the radial undistort (remap.py:82)."""
    do = (lrc != 1.0) & (lrc > 0.0)
    r = torch.sqrt(nx * nx + ny * ny)
    nz = r != 0.0
    r_safe = torch.where(nz, r, 1.0)
    sin_theta_d = (r_safe / torch.sqrt(1.0 + r_safe * r_safe)) / lrc
    denom = torch.sqrt(torch.clamp_min(1.0 - sin_theta_d * sin_theta_d, 1e-12))
    r_d = sin_theta_d / denom
    factor = torch.where(do & nz, r_d / r_safe, 1.0)
    return nx * factor, ny * factor


def has_mesh(cfg: KernelConfig) -> bool:
    """Whether the projection runs the mesh or the focal-plane stage."""
    return cfg.has(HAS_MESH_DATA) or cfg.has(HAS_FPD_DATA)


def mesh_len(cfg: KernelConfig) -> int:
    """The fewest floats a mesh buffer of cfg's grid holds: the coefficient
    blocks of both channels for the mesh, the 8 row shears for FPD."""
    from .mesh import fpd_offset
    return fpd_offset(cfg) + (20 if cfg.has(HAS_FPD_DATA) else 0)


def _check_supported(cfg: KernelConfig):
    if cfg.interpolation not in INTERP_INFO and cfg.interpolation not in EWA_BC:
        raise ValueError(f"unknown interpolation {cfg.interpolation}")
    if has_mesh(cfg):
        grid = cfg.mesh_grid
        if grid is None or len(grid) != 2:
            raise ValueError("mesh / focal-plane flags need cfg.mesh_grid (gw, gh)")
        if cfg.has(HAS_MESH_DATA) and not all(2 <= g <= MAX_GRID_SIZE for g in grid):
            raise ValueError(f"mesh grid {grid}: each side must be 2..{MAX_GRID_SIZE}")


def digital_lens(cfg: KernelConfig):
    """The digital lens the remap applies, or None: HAS_DIGITAL_LENS with a
    named lens (remap.py:104, :146, :210). Any id resolves, as get_model does."""
    if cfg.has(HAS_DIGITAL_LENS) and cfg.digital_lens:
        return dm.get_model(cfg.digital_lens)
    return None


def rotate_and_distort_core(px, py, m, cfg: KernelConfig, dyn: KernelDynamics,
                            lp: dm.LensParams, mesh=None):
    """Project output-space points through matrix row(s) ``m`` (remap.py:95).

    ``m``: 14 broadcastable tensors (one per matrix column); ``mesh``: the
    float32 mesh buffer on the points' device, read when cfg has the mesh or
    focal-plane flag. Returns (u, v, valid)."""
    model = dm.get_model(cfg.distortion_model)
    digital = digital_lens(cfg)

    _x = px * m[0] + py * m[1] + m[2] + dyn.translation3d[0]
    _y = px * m[3] + py * m[4] + m[5] + dyn.translation3d[1]
    _w = px * m[6] + py * m[7] + m[8] + dyn.translation3d[2]

    valid = _w > 0.0
    r_limit_sq = dyn.r_limit * dyn.r_limit
    valid = valid & ~((r_limit_sq > 0.0) & ((_x * _x + _y * _y) > r_limit_sq * _w))

    if cfg.has(ANY_UNDERWATER):
        _w = _forward_refraction(_x, _y, _w, dyn.light_refraction_coefficient)

    w_safe = torch.where(valid, _w, 1.0)
    u, v = model.distort_xy(_x, _y, w_safe, lp)
    u = u * dyn.f[0]
    v = v * dyn.f[1]

    # IBIS/OIS shift + rotation from matrix cols 9-13 (remap.py:122-132)
    if cfg.has(HAS_IBIS_DATA):
        any_is = (m[9] != 0.0) | (m[10] != 0.0) | (m[11] != 0.0) | \
                 (m[12] != 0.0) | (m[13] != 0.0)
        ang = m[11]
        cos_a = torch.cos(-ang)
        sin_a = torch.sin(-ang)
        u2 = cos_a * u - sin_a * v - m[9] + m[12]
        v2 = sin_a * u + cos_a * v - m[10] + m[13]
        u = torch.where(any_is, u2, u)
        v = torch.where(any_is, v2, v)

    u = u + dyn.c[0]
    v = v + dyn.c[1]

    if has_mesh(cfg):           # remap.py:137-145
        if mesh is None:
            raise ValueError("mesh / focal-plane flags set but no mesh buffer given")
        from .mesh import apply_focal_plane_distortion, apply_mesh_correction, fpd_offset
        if cfg.has(HAS_MESH_DATA):
            u, v = apply_mesh_correction(u, v, mesh, cfg)
        if cfg.has(HAS_FPD_DATA):
            u, v = apply_focal_plane_distortion(u, v, mesh, fpd_offset(cfg), cfg)

    if digital is not None:     # remap.py:146-147
        u, v = digital.distort_xy(u, v, torch.ones_like(u), lp)

    sh = dyn.input_horizontal_stretch
    sv = dyn.input_vertical_stretch
    u = torch.where(sh > 0.001, u / torch.where(sh > 0.001, sh, 1.0), u)
    v = torch.where(sv > 0.001, v / torch.where(sv > 0.001, sv, 1.0), v)
    return u, v, valid


def rotate_and_distort(x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics,
                       mesh=None):
    """Per-pixel row-matrix gather + projection (remap.py:156). This is the
    plain version of the coords kernel."""
    lp = _lens_params(cfg, dyn)
    if matrices.shape[0] == 1:
        m = [matrices[0, i] for i in range(14)]
    else:
        mg = matrices[idx.long()]                    # (..., 14)
        m = [mg[..., i] for i in range(14)]
    return rotate_and_distort_core(x, y, m, cfg, dyn, lp, mesh=mesh)


def _rotate_point(px, py, angle, origin, origin2):
    """cpu_undistort.rs:262-265."""
    ca, sa = math.cos(angle), math.sin(angle)
    return (ca * (px - origin[0]) - sa * (py - origin[1]) + origin2[0],
            sa * (px - origin[0]) + ca * (py - origin[1]) + origin2[1])


def _rotated_frame_size(cfg: KernelConfig) -> Tuple[float, float]:
    rotation = cfg.input_rotation * (math.pi / 180.0)
    fx, fy = _rotate_point(float(cfg.width), float(cfg.height), rotation, (0.0, 0.0), (0.0, 0.0))
    return (round(abs(fx)), round(abs(fy)))


def _rint_index(a, lim: int):
    """clip(rint(a).astype(int32), 0, lim) with non-finite values saturated
    (NaN -> 0) before the cast, so the int conversion is always defined."""
    r = torch.nan_to_num(torch.round(a), nan=0.0, posinf=float(lim), neginf=0.0)
    return torch.clamp(r, 0.0, float(lim)).to(torch.int32)


def coords_pre(ox, oy, matrices, cfg: KernelConfig, dyn: KernelDynamics, out_c, out_f,
               rs_idx=None, mesh=None, probe=None):
    """Output-rect map, translation2d, lens-correction blend and the RS row
    select (remap.py:187). Returns (x, y, idx).

    ``rs_idx`` overrides the row select and skips the centre-matrix probe:
    the EWA same-row Jacobian evaluates the +eps evals on the base pixel's
    row (KernelConfig.ewa_ref_jac). ``probe(x, y)`` -> (u, v, valid), if
    given, projects every point through the centre matrix row in place of
    the plain projection (the coords kernel for mesh frames on a card: the
    same float32 operations, so the same rows)."""
    lp = _lens_params(cfg, dyn)
    orx, ory, orw, orh = cfg.out_rect

    x = map_coord(ox, float(orx), float(orx + orw), 0.0, float(cfg.output_width))
    y = map_coord(oy, float(ory), float(ory + orh), 0.0, float(cfg.output_height))
    x = x + dyn.translation2d[0]
    y = y + dyn.translation2d[1]

    # ---- lens correction blend (remap.py:208-229) ----
    if cfg.lens_correction:
        nx, ny = x, y
        digital = digital_lens(cfg)
        if digital is not None:
            # the digital warp FOV-independently: un-zoom, warp, re-zoom
            uzx = (nx - out_c[0]) * dyn.fov + out_c[0]
            uzy = (ny - out_c[1]) * dyn.fov + out_c[1]
            dpt, dvalid = digital.undistort(torch.stack([uzx, uzy], dim=-1), lp)
            nx = torch.where(dvalid, (dpt[..., 0] - out_c[0]) / dyn.fov + out_c[0], nx)
            ny = torch.where(dvalid, (dpt[..., 1] - out_c[1]) / dyn.fov + out_c[1], ny)
        nx = (nx - out_c[0]) / out_f[0]
        ny = (ny - out_c[1]) / out_f[1]
        model = dm.get_model(cfg.distortion_model)
        upt, uvalid = model.undistort(torch.stack([nx, ny], dim=-1), lp)
        nx = torch.where(uvalid, upt[..., 0], nx)
        ny = torch.where(uvalid, upt[..., 1], ny)
        if cfg.has(ANY_UNDERWATER):
            nx, ny = _inverse_refraction(nx, ny, dyn.light_refraction_coefficient)
        nx = nx * out_f[0] + out_c[0]
        ny = ny * out_f[1] + out_c[1]
        amount = dyn.lens_correction_amount
        x = nx * (1.0 - amount) + x * amount
        y = ny * (1.0 - amount) + y * amount

    # ---- rolling shutter row select (remap.py:231-252) ----
    if rs_idx is not None:
        return x, y, rs_idx
    matrix_count = matrices.shape[0]
    horizontal_rs = cfg.has(HORIZONTAL_RS)
    lim = cfg.width if horizontal_rs else cfg.height
    sy = _rint_index(x if horizontal_rs else y, lim)
    if matrix_count > 1:
        # the probe projects every pixel through the centre matrix
        if probe is not None:
            pu, pv, probe_valid = probe(x, y)
        else:
            mc = [matrices[matrix_count // 2, i] for i in range(14)]
            pu, pv, probe_valid = rotate_and_distort_core(x, y, mc, cfg, dyn, lp, mesh=mesh)
        sy = torch.where(probe_valid, _rint_index(pu if horizontal_rs else pv, lim), sy)
    idx = torch.clamp_max(sy, matrix_count - 1)
    return x, y, idx


def coords_post_uv(u, v, cfg: KernelConfig):
    """Input rotation, edge background modes and the source-rect map
    (remap.py:255)."""
    frame_w, frame_h = float(cfg.width), float(cfg.height)
    if cfg.input_rotation != 0.0:
        rotation = cfg.input_rotation * (math.pi / 180.0)
        fw, fh = _rotated_frame_size(cfg)
        u, v = _rotate_point(u, v, rotation, (frame_w / 2.0, frame_h / 2.0), (fw / 2.0, fh / 2.0))
        frame_w, frame_h = fw, fh

    if cfg.background_mode == 1:  # repeat (clamp 3px inside, matching CPU ref)
        u = torch.clamp(u, 3.0, frame_w - 3.0)
        v = torch.clamp(v, 3.0, frame_h - 3.0)
    elif cfg.background_mode == 2:  # mirror
        rx = torch.round(u)
        ry = torch.round(v)
        w3 = frame_w - 3.0
        h3 = frame_h - 3.0
        u = torch.where(rx > w3, w3 - (rx - w3), u)
        u = torch.where(rx < 3.0, 3.0 + frame_w - (w3 + rx), u)
        v = torch.where(ry > h3, h3 - (ry - h3), v)
        v = torch.where(ry < 3.0, 3.0 + frame_h - (h3 + ry), v)

    if cfg.background_mode != 3:
        sx, sy_, sw, sh = cfg.src_rect
        u = map_coord(u, 0.0, frame_w, float(sx), float(sx + sw))
        v = map_coord(v, 0.0, frame_h, float(sy_), float(sy_ + sh))
    return u, v


def undistort_coord(ox, oy, matrices, cfg: KernelConfig, dyn: KernelDynamics, out_c, out_f,
                    rs_idx=None, mesh=None):
    """Output pixel -> source (u, v, valid) with the plain projection
    (remap.py:294); ``rs_idx`` as in coords_pre."""
    x, y, idx = coords_pre(ox, oy, matrices, cfg, dyn, out_c, out_f, rs_idx=rs_idx, mesh=mesh)
    u, v, valid = rotate_and_distort(x, y, idx, matrices, cfg, dyn, mesh=mesh)
    u, v = coords_post_uv(u, v, cfg)
    return u, v, valid


def _guard_uv(a):
    """Non-finite -> 0, then clip to +-32768 (pallas_sampler.py:1067)."""
    return torch.clamp(torch.where(torch.isfinite(a), a, 0.0), -32768.0, 32768.0)


def sample_input(img, u, v, bg, src_rect, interpolation: int, pixel_value_limit):
    """N-tap LUT separable sampling (remap.py:309): the plain version of the
    sampler kernel.

    img (H, W, C) float32; u, v (...) source coordinates; bg (C,) tensor.
    Taps outside ``src_rect`` (x, y, w, h) read bg. Returns (..., C) float32.
    The tap offset is subtracted before the guard, as in remap.py:320-326."""
    offset = INTERP_INFO[interpolation]["offset"]
    return sample_taps(img, _guard_uv(u - offset), _guard_uv(v - offset), bg, src_rect,
                       interpolation, pixel_value_limit)


def sample_taps(img, u, v, bg, src_rect, interpolation: int, pixel_value_limit):
    """The separable LUT tap loop (remap.py:328-352) at (u, v) that the
    caller has already guarded and shifted by the tap offset: the plain
    version of csrc/taps.cuh's sample_taps, then the clamp."""
    info = INTERP_INFO[interpolation]
    taps, ind, shift = info["taps"], info["ind"], info["shift"]
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    srx, sry, srw, srh = src_rect

    sx0 = torch.round(u * INTER_TAB_SIZE).to(torch.int32)
    sy0 = torch.round(v * INTER_TAB_SIZE).to(torch.int32)
    sx = sx0 >> INTER_BITS
    sy = sy0 >> INTER_BITS
    base_x = ind + ((sx0 & (INTER_TAB_SIZE - 1)) << shift)
    base_y = ind + ((sy0 & (INTER_TAB_SIZE - 1)) << shift)
    lut = _COEFFS_T if img.device == _COEFFS_T.device else trace.to_device(_COEFFS_T, img.device)

    total = torch.zeros(u.shape + (C,), dtype=torch.float32, device=img.device)
    for yp in range(taps):
        yy = sy + yp
        row_ok = (yy >= sry) & (yy < sry + srh)
        yy_c = torch.clamp(yy, 0, H - 1)
        cy = lut[(base_y + yp).long()]
        xsum = torch.zeros_like(total)
        for xp in range(taps):
            xx = sx + xp
            col_ok = (xx >= srx) & (xx < srx + srw)
            xx_c = torch.clamp(xx, 0, W - 1)
            px = flat[(yy_c * W + xx_c).long()]
            px = torch.where((row_ok & col_ok)[..., None], px, bg)
            xsum = xsum + px * lut[(base_x + xp).long()][..., None]
        total = total + xsum * cy[..., None]
    return torch.clamp_max(total, pixel_value_limit)


EWA_BC = {
    10: (0.2620145, 0.3689927),   # RobidouxSharp (stabilization/mod.rs:281-285)
    11: (0.3782157, 0.3108921),   # Robidoux
    12: (0.3333333, 0.3333333),   # Mitchell
    13: (0.0, 0.5),               # CatmullRom
}


def ewa_coeffs(interpolation: int):
    """Keys cubic BC coefficients (stabilization/mod.rs:279-295); the manager
    attaches them to KernelDynamics for interpolation 10-13."""
    b, c = EWA_BC[interpolation]
    p = ((6.0 - 2.0 * b) / 6.0, 0.0, (-18.0 + 12.0 * b + 6.0 * c) / 6.0,
         (12.0 - 9.0 * b - 6.0 * c) / 6.0)
    q = ((8.0 * b + 24.0 * c) / 6.0, (-12.0 * b - 48.0 * c) / 6.0,
         (6.0 * b + 30.0 * c) / 6.0, (-1.0 * b - 6.0 * c) / 6.0)
    return p, q


EWA_CAP = 4         # tap radius: the JAX package's top rung, (2*4+2)^2 taps
EWA_EPS = 0.01      # finite-difference step of the Jacobian (remap.py:546)
_I32_MAX_F = 2147483520.0   # largest float32 below 2**31


def _floor_i32(a):
    """floor(a) as int32, saturating like the float->int conversion of XLA and
    CUDA (torch's CPU cast of an out-of-range float is undefined)."""
    return torch.clamp(torch.floor(a), -2147483648.0, _I32_MAX_F).to(torch.int32)


def _ceil_i32(a):
    return torch.clamp(torch.ceil(a), -2147483648.0, _I32_MAX_F).to(torch.int32)


def ewa_footprint(u, v, jac):
    """What sample_ewa derives from each pixel's position and Jacobian
    before its tap loop: the guarded u, v, the reference bbox (x0, x1, y0,
    y1) int32 and the clamped ellipse's (abc_x, abc_y, abc_z); a tap at
    (in_x, in_y) of the bbox weighs bc2(sqrt(dr)) with fx = in_x - u,
    fy = in_y - v and dr = fx * fx * abc_x + fx * (fy * abc_y) + fy * fy * abc_z."""
    u = _guard_uv(u)
    v = _guard_uv(v)
    jx, jy, jz, jw = jac[..., 0], jac[..., 1], jac[..., 2], jac[..., 3]

    # affine_bbox (remap.py:387-393)
    tx = 2.0 * torch.clamp_min(torch.maximum(torch.abs(jx + jy), torch.abs(jx - jy)), 1.0)
    ty = 2.0 * torch.clamp_min(torch.maximum(torch.abs(jz + jw), torch.abs(jz - jw)), 1.0)
    x0 = _floor_i32(u - tx)
    x1 = _ceil_i32(u + tx)
    y0 = _floor_i32(v - ty)
    y1 = _ceil_i32(v + ty)

    # clamped_ellipse (remap.py:395-421)
    f0 = torch.abs(jx * jw - jy * jz)
    f = torch.clamp_min(f0 * f0, 0.1)
    a = (jz * jz + jw * jw) / f
    b = -2.0 * (jx * jz + jy * jw) / f
    c = (jx * jx + jy * jy) / f
    vx = c - a
    vy = -b
    lv = torch.sqrt(vx * vx + vy * vy)
    v0 = torch.where(lv > 0.01, vx / torch.where(lv == 0.0, 1.0, lv), 1.0)
    cc = torch.sqrt(torch.clamp_min(1.0 + v0, 0.0) / 2.0)
    s_ = torch.sqrt(torch.clamp_min(1.0 - v0, 0.0) / 2.0)
    a0 = a * cc * cc - b * cc * s_ + c * s_ * s_
    c0 = a * s_ * s_ + b * cc * s_ + c * cc * cc
    bt1 = b * (cc * cc - s_ * s_)
    bt2 = 2.0 * (a - c) * cc * s_
    b0 = bt1 + bt2
    b0v2 = bt1 - bt2
    flip = torch.abs(b0) > torch.abs(b0v2)
    s_ = torch.where(flip, -s_, s_)
    b0 = torch.where(flip, b0v2, b0)
    a0 = torch.clamp_max(a0, 1.0)
    c0 = torch.clamp_max(c0, 1.0)
    sn = -s_
    abc_x = a0 * cc * cc - b0 * cc * sn + c0 * sn * sn
    abc_y = 2.0 * a0 * cc * sn + b0 * cc * cc - b0 * sn * sn - 2.0 * c0 * cc * sn
    abc_z = a0 * sn * sn + b0 * cc * sn + c0 * cc * cc
    return u, v, (x0, x1, y0, y1), (abc_x, abc_y, abc_z)


def sample_ewa(img, u, v, jac, bg, src_rect, coeffs_p, coeffs_q, pixel_value_limit):
    """EWA elliptical sampling (remap.py:374): the plain version of the EWA
    kernel, and its spec.

    img (H, W, C) float32; u, v (...) source coordinates; jac (..., 4) the
    finite-difference Jacobian (du/dx, du/dy, dv/dx, dv/dy); bg (C,) tensor;
    coeffs_p, coeffs_q the four float32 Keys-cubic coefficients of each
    piece (``ewa_coeffs``). The reference bbox (affine_bbox) is masked inside
    a fixed (2*EWA_CAP+2)^2 stencil; taps outside ``src_rect`` read bg.
    Returns (..., C) float32."""
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    srx, sry, srw, srh = src_rect
    u, v, (x0, x1, y0, y1), (abc_x, abc_y, abc_z) = ewa_footprint(u, v, jac)

    pw, qw = [float(x) for x in coeffs_p], [float(x) for x in coeffs_q]

    def bc2(x):
        x2 = x * x
        pr = pw[0] + pw[1] * x + pw[2] * x2 + pw[3] * x2 * x
        qr = qw[0] + qw[1] * x + qw[2] * x2 + qw[3] * x2 * x
        return torch.where(x < 1.0, pr, torch.where(x < 2.0, qr, 0.0))

    base_x = _floor_i32(u) - EWA_CAP
    base_y = _floor_i32(v) - EWA_CAP
    taps = 2 * EWA_CAP + 2

    # row of taps major, column minor (remap.py:439-463)
    total = torch.zeros(u.shape + (C,), dtype=torch.float32, device=img.device)
    sum_div = torch.zeros_like(u)
    for typ in range(taps):
        in_y = base_y + typ
        fy = in_y.to(torch.float32) - v
        fy2 = fy * abc_y
        fy3 = fy * fy * abc_z
        y_in_bbox = (in_y >= y0) & (in_y <= y1)
        row_ok = (in_y >= sry) & (in_y < sry + srh)
        row = torch.clamp(in_y, 0, H - 1) * W
        for txp in range(taps):
            in_x = base_x + txp
            fx = in_x.to(torch.float32) - u
            dr = fx * fx * abc_x + fx * fy2 + fy3
            k = bc2(torch.sqrt(torch.clamp_min(dr, 0.0)))
            k = torch.where(y_in_bbox & (in_x >= x0) & (in_x <= x1), k, 0.0)
            in_rect = row_ok & (in_x >= srx) & (in_x < srx + srw)
            px = flat[(row + torch.clamp(in_x, 0, W - 1)).long()]
            px = torch.where(in_rect[..., None], px, bg)
            total = total + k[..., None] * px
            sum_div = sum_div + k
    total = total / torch.where(sum_div == 0.0, 1.0, sum_div)[..., None]
    return torch.clamp_max(total, pixel_value_limit)


def ewa_stack(ox, oy, matrices, cfg: KernelConfig, dyn: KernelDynamics, out_c, out_f,
              mesh=None, probe=None):
    """coords_pre of the base eval and the +eps evals in x and in y, stacked
    along rows into (3*oh, ow) x, y, idx for ONE projection call
    (remap.py:783-794). By default the +eps evals reuse the base row (the
    mesh path's rs_idx too, remap.py:830-840); ``cfg.ewa_ref_jac`` makes each
    re-probe its own. ``mesh`` and ``probe`` as in coords_pre."""
    kw = dict(mesh=mesh, probe=probe)
    x0, y0, idx0 = coords_pre(ox, oy, matrices, cfg, dyn, out_c, out_f, **kw)
    rs_idx = None if cfg.ewa_ref_jac else idx0
    x1, y1, idx1 = coords_pre(ox + EWA_EPS, oy, matrices, cfg, dyn, out_c, out_f,
                              rs_idx=rs_idx, **kw)
    x2, y2, idx2 = coords_pre(ox, oy + EWA_EPS, matrices, cfg, dyn, out_c, out_f,
                              rs_idx=rs_idx, **kw)
    return torch.cat([x0, x1, x2]), torch.cat([y0, y1, y2]), torch.cat([idx0, idx1, idx2])


def ewa_jacobian(u3, v3, valid3):
    """Split the stacked evals (after coords_post_uv) into the base (u, v,
    valid) and the Jacobian (oh, ow, 4) = (du/dx, du/dy, dv/dx, dv/dy); an
    invalid +eps eval counts as source point 0 (remap.py:842-845)."""
    u, ux, uy = u3.chunk(3)
    v, vx, vy = v3.chunk(3)
    valid, valid_x, valid_y = valid3.chunk(3)
    dxu = torch.where(valid_x, ux, 0.0) - u
    dxv = torch.where(valid_x, vx, 0.0) - v
    dyu = torch.where(valid_y, uy, 0.0) - u
    dyv = torch.where(valid_y, vy, 0.0) - v
    jac = torch.stack([dxu / EWA_EPS, dyu / EWA_EPS, dxv / EWA_EPS, dyv / EWA_EPS], dim=-1)
    return u, v, valid, jac


def _remap_colorrange(px, is_y: bool, max_pixel_value):
    """Full->limited range (remap.py:468; stabilize_spirv drawing.rs:71-74)."""
    px = px * (0.85882352 if is_y else 0.87843137)
    return px + (16.0 / 255.0) * max_pixel_value


def _canvas_fetch(canvas, x, y, scale):
    """The overlay canvas's byte under each point, as int32: the exact
    gather canvas[floor(y / scale), floor(x / scale)], 0 outside the canvas
    (NaN included): the function of _canvas_fetch_t's phase-0 sampler call
    (remap.py:1014). ``scale`` is a 0-d float32 tensor, so the division is
    IEEE on every device."""
    hc, wc = canvas.shape
    xi = torch.floor(x / scale)
    yi = torch.floor(y / scale)
    inb = (xi >= 0) & (yi >= 0) & (xi < wc) & (yi < hc)
    flat = (torch.where(inb, yi, 0.0).to(torch.int64) * wc
            + torch.where(inb, xi, 0.0).to(torch.int64))
    data = canvas.reshape(-1)[flat].to(torch.int32)
    return torch.where(inb, data, 0)


def _blend_overlay(pixel, data, active_extra, max_pixel_value):
    """draw_pixel's blend (remap.py:1033, _blend_overlay_t; spirv
    drawing.rs:37-49) of (..., C) float32 pixels with the packed canvas
    bytes ``data`` (color << 3 | alpha << 1 | stage) where ``active_extra``
    holds: COLORS[color][:C] * max_pixel_value at alpha 1 - 0.25 * alpha."""
    from ..core.drawing import COLORS
    color = (data & 0xF8) >> 3
    alpha_i = (data & 0x06) >> 1
    active = (data > 0) & (color < 9) & active_extra
    alphaf = (1.0 - 0.25 * alpha_i.to(torch.float32))[..., None]
    C = pixel.shape[-1]
    colors = trace.to_device(torch.from_numpy(np.ascontiguousarray(COLORS[:, :C])), pixel.device)
    colorf = torch.zeros_like(pixel)
    for ci in range(1, 9):
        colorf = torch.where((color == ci)[..., None], colors[ci], colorf)
    colorf = colorf * max_pixel_value
    blended = colorf * alphaf + pixel * (1.0 - alphaf)
    return torch.where(active[..., None], blended, pixel)


def safe_area_bounds(rect):
    """The safe-area rect (rx, ry, rz, rw) and its 5-px border band's
    bounds, each rounded to float32 and the band's offsets taken in float32,
    as remap.py:1068-1071 takes them."""
    r = np.asarray(rect, np.float32).reshape(4)
    five = np.float32(5.0)
    return ([float(x) for x in r],
            [float(r[0] - five), float(r[1] - five), float(r[2] + five), float(r[3] + five)])


def _draw_safe_area(pixel, ox, oy, rect):
    """draw_safe_area (remap.py:1067-1075; spirv drawing.rs:52-69): pixels
    outside the rect dim to 0.5, its 5-px border band to 0.25."""
    (rx, ry, rz, rw), (bx0, by0, bx1, by1) = safe_area_bounds(rect)
    safe = (ox >= rx) & (ox <= rz) & (oy >= ry) & (oy <= rw)
    border = (ox > bx0) & (ox < bx1) & (oy > by0) & (oy < by1)
    dim = torch.where(safe, 1.0, torch.where(border, 0.25, 0.5))
    return pixel * dim[..., None]


def _draw_overlay(pixel, u, v, ox, oy, canvas, scale, safe_area_rect, src_rect,
                  max_pixel_value):
    """process_final_pixel's drawing stages (remap.py:1054; spirv
    drawing.rs:78-99) on the (oh, ow, C) float32 pixels: the input-stage
    canvas bytes at the source position (u, v), where it lies inside
    src_rect and the byte's stage bit is 0; the output-stage bytes at the
    output pixel (ox, oy) whose stage bit is 1; then the safe-area dim.
    canvas: (hc, wc) uint8 tensor; scale: 0-d float32 tensor. The plain
    version of the overlay kernel (csrc/overlay.cu)."""
    srx, sry, srw, srh = src_rect
    src_in = (v >= float(sry)) & (v < float(sry + srh)) & \
             (u >= float(srx)) & (u < float(srx + srw))
    d_in = _canvas_fetch(canvas, u, v, scale)
    pixel = _blend_overlay(pixel, d_in, src_in & ((d_in & 1) == 0), max_pixel_value)
    d_out = _canvas_fetch(canvas, ox, oy, scale)
    pixel = _blend_overlay(pixel, d_out, (d_out & 1) == 1, max_pixel_value)
    if safe_area_rect is not None:
        pixel = _draw_safe_area(pixel, ox, oy, safe_area_rect)
    return pixel


def _cast_out(out, out_dtype: str, max_pixel_value: float):
    """Output cast (remap.py:625). uint16 rounds half to even (torch.round ==
    jnp.rint) and clamps in float32 before the cast: torch has no uint16
    arithmetic."""
    if out_dtype == "uint8":
        return torch.clamp(out, 0, 255).to(torch.uint8)
    if out_dtype == "uint16":
        return torch.round(out).clamp_(0, float(max_pixel_value)).to(torch.uint16)
    return out


def _host_scalar(a) -> float:
    return float(np.asarray(a, np.float32).reshape(-1)[0])


def _ewa_coeffs_of(dyn: KernelDynamics):
    """(p, q): the float32 EWA coefficients of host dynamics as Python floats."""
    return tuple(tuple(float(x) for x in np.asarray(c, np.float32).reshape(4))
                 for c in (dyn.ewa_coeffs_p, dyn.ewa_coeffs_q))


def use_fused(cfg: KernelConfig, matrices, drawing=None) -> bool:
    """Whether remap_plane_pallas(fused=True) takes the fused kernel for this
    plane (remap.py:716-719): more than one matrix row, no mesh/FPD, no EWA,
    background mode 0-2, no drawing, interpolation 2, 4 or 8. Everywhere
    else fused=True takes the split path, as in the JAX package."""
    return (matrices.shape[0] > 1 and not has_mesh(cfg) and cfg.interpolation in (2, 4, 8)
            and cfg.background_mode != 3
            and not (drawing is not None and cfg.has(DRAWING_ENABLED)))


class Route(NamedTuple):
    """How a plane is remapped (``plane_route``)."""
    name: str       # "fused", "gen" or "pre"
    probe: bool     # the "pre" route's rolling-shutter probe on the coords kernel


def plane_route(cfg: KernelConfig, matrices, drawing=None, fused: bool = False) -> Route:
    """The one place that decides a plane's route through the kernels
    (remap_plane, the plain reference, takes "pre" without the probe):
    "fused" with ``fused=True`` where the fused kernel takes the plane
    (``use_fused``): coords_pre, then one fused launch; "gen" where the
    self-contained coords kernel computes it (``cuda_coords.gen_admits``,
    EWA included): one ``cuda_coords.project_gen`` launch in place of the
    output grid's coords_pre (ewa_stack) and the projection; "pre" for
    every other plane: coords_pre (ewa_stack), then the coords kernel, and
    with ``probe`` (a mesh or focal-plane plane with more than one matrix
    row) coords_pre's rolling-shutter probe on the coords kernel too
    (``mesh_probe``)."""
    from .cuda_coords import gen_admits
    if fused and use_fused(cfg, matrices, drawing):
        return Route("fused", False)
    if gen_admits(cfg):
        return Route("gen", False)
    return Route("pre", has_mesh(cfg) and matrices.shape[0] > 1)


class _Plane(NamedTuple):
    """A plane's inputs as the stages read them (``_plane``)."""
    img: torch.Tensor           # float32 for PLAIN; as given for KERNELS, which read its dtype
    matrices: torch.Tensor      # (rows, 14) float32 on img's device
    mesh: Optional[torch.Tensor]
    cfg: KernelConfig
    dyn: KernelDynamics         # host leaves
    dyn_t: KernelDynamics       # tensor leaves on img's device
    bg_t: torch.Tensor          # the background (C,) on img's device
    bg: tuple                   # the same as one float a channel, for the kernels
    limit: float
    coeffs: tuple               # EWA's (p, q)
    canvas: Optional[torch.Tensor]   # the drawing's canvas; None without the overlay
    drawing: object
    rows: int                   # the band: output rows oy0 .. oy0 + rows
    oy0: int


def _plane(img, matrices, cfg: KernelConfig, dyn: KernelDynamics, mesh, drawing,
           rows=None, oy0: int = 0) -> _Plane:
    """Checks, then the plane's inputs on img's device: the matrices and the
    mesh buffer float32 and contiguous (the buffer None unless cfg has the
    mesh or focal-plane flag: the JAX remap reads it only then), the
    dynamics in one copy, the drawing's canvas where the overlay is on
    (remap.py:1004)."""
    _check_supported(cfg)
    if img.dim() != 3:
        raise ValueError(f"plane must be (H, W, C), got {tuple(img.shape)}")
    oh = cfg.out_buffer[1]
    rows = oh if rows is None else int(rows)
    oy0 = int(oy0)
    if rows < 0 or oy0 < 0 or oy0 + rows > oh:
        raise ValueError(f"output band of {rows} rows at {oy0}: the plane has {oh} rows")
    if not has_mesh(cfg):
        mesh = None
    elif mesh is None:
        raise ValueError("mesh / focal-plane flags set but no mesh buffer given")
    else:
        mesh = _on(mesh, img.device).reshape(-1)
        if mesh.numel() < mesh_len(cfg):
            raise ValueError(f"mesh buffer of {mesh.numel()} floats, grid {cfg.mesh_grid} "
                             f"needs {mesh_len(cfg)}")
    matrices = _on(matrices, img.device)
    C = img.shape[-1]
    dyn_t = dyn_to_torch(dyn, img.device)
    canvas = None
    if drawing is not None and cfg.has(DRAWING_ENABLED):
        canvas = trace.to_device(torch.from_numpy(np.ascontiguousarray(drawing.canvas, np.uint8)),
                                 img.device)
    bg = (np.asarray(dyn.background, np.float32) * np.float32(dyn.max_pixel_value))[:C]
    return _Plane(img, matrices, mesh, cfg, dyn, dyn_t,
                  (dyn_t.background * dyn_t.max_pixel_value)[:C], tuple(float(b) for b in bg),
                  _host_scalar(dyn.pixel_value_limit), _ewa_coeffs_of(dyn), canvas, drawing,
                  rows, oy0)


def _plain_project(p: _Plane, x, y, idx):
    return rotate_and_distort(x, y, idx, p.matrices, p.cfg, p.dyn_t, mesh=p.mesh)


def _plain_sample(p: _Plane, u, v, valid, evals):
    if evals is not None:
        jac = ewa_jacobian(*evals)[3]
        return sample_ewa(p.img, u, v, jac, p.bg_t, p.cfg.src_rect, *p.coeffs, p.limit)
    return sample_input(p.img, u, v, p.bg_t, p.cfg.src_rect, p.cfg.interpolation, p.limit)


def _plain_overlay(p: _Plane, pixel, u, v, ox, oy):
    scale = torch.full((), float(p.drawing.scale), dtype=torch.float32, device=pixel.device)
    return _draw_overlay(pixel, u, v, ox, oy, p.canvas, scale, p.drawing.safe_area_rect,
                         p.cfg.src_rect, _host_scalar(p.dyn.max_pixel_value))


class Stages(NamedTuple):
    """One implementation of each stage of ``_remap``, each taking the
    plane's inputs (``_Plane``) first: PLAIN in plain torch, KERNELS
    (``kernels()``) through the kernel wrappers."""
    project: Callable               # (p, x, y, idx) -> (u, v, valid)
    gen: Optional[Callable]         # (p) -> (u, v, valid) of the whole band ("gen")
    fused: Optional[Callable]       # (p, x, y, idx) -> pixels ("fused")
    sample: Callable                # (p, u, v, valid, evals) -> pixels
    overlay: Callable               # (p, pixel, u, v, ox, oy) -> pixels


# the plain reference takes neither the "gen" nor the "fused" route
PLAIN = Stages(_plain_project, None, None, _plain_sample, _plain_overlay)


@functools.cache
def kernels() -> Stages:
    """The stages on the kernels, built at the first call, since the
    wrappers' modules import this one. Each stage looks its wrapper up on
    the wrapper's module when it runs, so a stand-in set there takes
    effect."""
    from . import cuda_coords, cuda_ewa, cuda_fused, cuda_overlay, cuda_sampler

    def project(p, x, y, idx):
        return cuda_coords.project(x, y, idx, p.matrices, p.cfg, p.dyn, p.mesh)

    def gen(p):
        # out_c, out_f: read only by the lens-correction blend, which
        # gen_admits rules out
        return cuda_coords.project_gen(p.cfg, p.dyn, p.matrices, p.rows, p.oy0, None, None)

    def fused(p, x, y, idx):
        return cuda_fused.remap_fused(p.img, x, y, idx, p.matrices, p.cfg, p.dyn, p.bg, p.limit)

    def sample(p, u, v, valid, evals):
        if evals is not None:
            with trace.span("gf.ewa.sample"):
                return cuda_ewa.sample(p.img, u, v, *evals, p.bg, p.cfg.src_rect, p.coeffs,
                                       p.limit)
        return cuda_sampler.sample(p.img, u, v, valid, p.bg, p.cfg.src_rect,
                                   p.cfg.interpolation, p.limit)

    def overlay(p, pixel, u, v, ox, oy):
        return cuda_overlay.overlay(pixel, u.contiguous(), v.contiguous(), p.canvas,
                                    float(p.drawing.scale), p.drawing.safe_area_rect,
                                    p.cfg.src_rect, _host_scalar(p.dyn.max_pixel_value), p.oy0)

    return Stages(project, gen, fused, sample, overlay)


def _remap(route: Route, stages: Stages, p: _Plane):
    """Shared body of remap_plane / remap_plane_cuda (remap.py:511, :662):
    the plane p along route through stages, output rows p.oy0 .. p.oy0 +
    p.rows in absolute output space, so the bands of a plane assemble into
    the plane (remap.py:678). The first gf.eager span notes the route, "gen"
    or "pre" (a fused plane's too); on an EWA plane its span gf.ewa.stack
    holds ewa_stack, or on the "gen" route the gen call."""
    cfg, dyn_t, bg = p.cfg, p.dyn_t, p.bg_t
    ow = cfg.out_buffer[0]
    if cfg.has(FILL_WITH_BACKGROUND):
        # the reference writes bg directly, skipping fix_range (remap.py:533-535)
        return bg.expand(p.rows, ow, p.img.shape[-1]).clone()

    is_ewa = cfg.interpolation in EWA_BC
    with trace.span("gf.eager") as span:
        # the finish's grid; coords_pre's input off the "gen" route
        oy, ox = out_grid(ow, p.rows, p.oy0, p.img.device)
        span.note("gen" if route.name == "gen" else "pre")
        if route.name == "gen":
            with trace.span("gf.ewa.stack") if is_ewa else contextlib.nullcontext():
                u, v, valid = stages.gen(p)
        else:
            factor = torch.clamp_min(1.0 - dyn_t.lens_correction_amount, 0.001)
            out_c = (float(cfg.output_width) / 2.0, float(cfg.output_height) / 2.0)
            out_f = (dyn_t.f[0] / dyn_t.fov / factor, dyn_t.f[1] / dyn_t.fov / factor)
            probe = mesh_probe(p.matrices, cfg, p.dyn, p.mesh) if route.probe else None
            # for EWA, the enqueue of the three eager coords_pre passes
            with trace.span("gf.ewa.stack") if is_ewa else contextlib.nullcontext():
                x, y, idx = (ewa_stack if is_ewa else coords_pre)(
                    ox, oy, p.matrices, cfg, dyn_t, out_c, out_f, mesh=p.mesh, probe=probe)
    if route.name == "fused":
        pixel = stages.fused(p, x, y, idx)
    else:
        if route.name == "pre":
            u, v, valid = stages.project(p, x, y, idx)
        # rebinding u, v frees the projection's raw positions before sampling,
        # and nothing holds the mask past it: a plane's peak memory is one
        # full-size (u, v) pair and one mask less
        u, v = coords_post_uv(u, v, cfg)
        pixel, u, v = _sample(stages, p, u, v, valid)
        del valid

    with trace.span("gf.eager"):
        # pixels whose mapped out_pos is beyond the logical output get background
        orx, ory, orw, orh = cfg.out_rect
        lx = map_coord(ox, float(orx), float(orx + orw), 0.0, float(cfg.output_width))
        ly = map_coord(oy, float(ory), float(ory + orh), 0.0, float(cfg.output_height))
        in_bounds = (lx >= 0.0) & (ly >= 0.0) & (lx < cfg.output_width) & \
            (ly < cfg.output_height)
        pixel = torch.where(in_bounds[..., None], pixel, bg)

        if cfg.has(FIX_COLOR_RANGE):
            pixel = _remap_colorrange(pixel, cfg.plane_index == 0, dyn_t.max_pixel_value)
    if p.canvas is not None:
        pixel = stages.overlay(p, pixel, u, v, ox, oy)
    return pixel


def _sample(stages: Stages, p: _Plane, u, v, valid):
    """The split path after coords_post_uv: one sample (two in background
    mode 3) and the validity mask. For EWA the stacked evals go to the
    sampler with the base eval's rows as u, v, valid. Returns the pixels and
    the base eval's u, v (the overlay's input-stage positions)."""
    cfg, dyn_t = p.cfg, p.dyn_t
    evals = None
    if cfg.interpolation in EWA_BC:
        evals = (u, v, valid)
        u, v, valid = u.chunk(3)[0], v.chunk(3)[0], valid.chunk(3)[0]

    if cfg.background_mode == 3:
        # margin with feather (remap.py:968-987): two samples, blended
        fw, fh = float(cfg.width), float(cfg.height)
        widthf, heightf = fw - 1.0, fh - 1.0
        feather = torch.clamp_min(dyn_t.background_margin_feather * heightf, 0.0001)
        near_edge = (u > widthf - feather) | (u < feather) | (v > heightf - feather) | (v < feather)
        alpha = torch.where(
            near_edge,
            torch.clamp(torch.minimum(torch.minimum(widthf - u, heightf - v),
                                      torch.minimum(u, v)) / feather, 0.0, 1.0),
            1.0)
        margin = dyn_t.background_margin
        pt2u = torch.where(near_edge, ((u / fw - 0.5) * (1.0 - margin) + 0.5) * fw, u)
        pt2v = torch.where(near_edge, ((v / fh - 0.5) * (1.0 - margin) + 0.5) * fh, v)
        frame_w, frame_h = (fw, fh) if cfg.input_rotation == 0.0 else _rotated_frame_size(cfg)
        srx, sry, srw, srh = cfg.src_rect
        c1 = stages.sample(p, map_coord(u, 0.0, frame_w, float(srx), float(srx + srw)),
                           map_coord(v, 0.0, frame_h, float(sry), float(sry + srh)), valid, evals)
        c2 = stages.sample(p, map_coord(pt2u, 0.0, frame_w, float(srx), float(srx + srw)),
                           map_coord(pt2v, 0.0, frame_h, float(sry), float(sry + srh)), valid,
                           evals)
        pixel = c1 * alpha[..., None] + c2 * (1.0 - alpha[..., None])
    else:
        pixel = stages.sample(p, u, v, valid, evals)
    return torch.where(valid[..., None], pixel, p.bg_t), u, v


def _on(t, device):
    """t float32 and contiguous on device: a tensor there already as it is,
    anything else through trace.to_device."""
    if not (isinstance(t, torch.Tensor) and t.device == device):
        t = trace.to_device(torch.as_tensor(t), device, dtype=torch.float32)
    return t.to(torch.float32).contiguous()


def remap_plane(img, matrices, cfg: KernelConfig, dyn: KernelDynamics, mesh=None,
                drawing=None, out_dtype: str = "f32"):
    """Remap one plane in plain torch: (H, W, C) -> (oh, ow, C).

    The port's CPU path (remap.py:511 + the fused cast of remap_plane_jit).
    Runs on whatever device ``img`` lies on. ``mesh``: the frame's Sony mesh
    / focal-plane buffer (read when cfg has either flag); ``drawing``: a
    core.drawing.DrawingState, blended when cfg has DRAWING_ENABLED."""
    p = _plane(img.to(torch.float32), matrices, cfg, dyn, mesh, drawing)
    out = _remap(Route("pre", False), PLAIN, p)
    with trace.span("gf.eager"):
        return _cast_out(out, out_dtype, _host_scalar(dyn.max_pixel_value))


def remap_plane_cuda(img, matrices, cfg: KernelConfig, dyn: KernelDynamics, mesh=None,
                     drawing=None, out_dtype: str = "f32", fused: bool = False,
                     out_rows=None, oy0: int = 0):
    """Remap one plane through the kernels along ``plane_route`` (remap.py:662):
    one coords launch per plane (EWA stacks its three evals into it), one
    sampling launch per sample (two in background mode 3), one more coords
    launch for a mesh plane's probe and one overlay launch for a drawing;
    ``fused=True`` merges the coords and sampling launches where the fused
    kernel takes the plane. ``mesh``: the frame's buffer packed on img's
    device, or on the host in the reference or packed layout
    (``cuda_coords.kernel_mesh`` packs it); a card buffer that is not packed
    raises. ``img`` keeps its native dtype (uint8, uint16 or float32): the
    kernels read it directly. On CPU tensors the kernel wrappers run their
    plain versions.

    ``out_rows``, ``oy0``: compute only the band of output rows oy0 .. oy0 +
    out_rows (remap_plane_pallas's row band, remap.py:678-709), with every
    coordinate in absolute output space, so the bands give the bits of the
    same rows of the whole plane; the drawing overlay too, at the band's
    absolute rows (remap.py:709, 1005)."""
    from .cuda_coords import kernel_mesh
    p = _plane(img, matrices, cfg, dyn, kernel_mesh(mesh, cfg), drawing, out_rows, oy0)
    out = _remap(plane_route(cfg, p.matrices, drawing, fused), kernels(), p)
    with trace.span("gf.eager"):
        return _cast_out(out, out_dtype, _host_scalar(dyn.max_pixel_value))


def mesh_probe(matrices, cfg: KernelConfig, dyn: KernelDynamics, mesh):
    """coords_pre's rolling-shutter probe through the coords kernel, for a
    mesh plane with more than one matrix row (``plane_route``'s probe): one
    launch with every point on the centre row, in place of the plain
    projection's hundreds of eager launches. The kernel gives the plain
    version's bits, so the selected rows are the same."""
    from . import cuda_coords
    c = matrices.shape[0] // 2
    center = matrices[c:c + 1]

    def probe(x, y):
        zero = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        return cuda_coords.project(x, y, zero, center, cfg, dyn, mesh)
    return probe
