"""Coords kernel wrappers: per-pixel rolling-shutter matrix projection.

``project`` replaces ``gyroflow_tpu/ops/pallas_coords.py::_coords_kernel``
with the CUDA kernel ``gf_coords`` of ``csrc/coords.cu`` (one thread per
output pixel, its matrix row read straight from the (rows, 14) table), for
every distortion model and digital lens (``lens_ids``: the kernel is
specialised on the main model, the digital lens is chosen at run time), and
with Sony mesh correction and focal-plane distortion in the kernel's mesh
form, which also carries the digital lens. The mesh form reads the frame's
packed mesh buffer (``pack_mesh``: the reference buffer, then a 16-byte
aligned block of the launch-uniform constants, the focal-plane shears and
each x segment's grid rows as (a, b, c, d)), which ``kernel_mesh`` packs on
the host before it goes up; ``mesh_args`` passes it by device pointer with
the grid and the host-side spline constants.
``project_plain`` is the same function in plain torch
(``remap.rotate_and_distort`` with ``ops/mesh.py``).

``project_gen`` replaces ``pallas_coords.py::_coords_kernel_gen`` (the
self-contained form behind ``project_tiles_gen``) with ``gf_coords_gen``:
no x/y/idx input, the kernel builds each pixel's output position, runs
coords_pre's out-rect map and translation2d, the rolling-shutter probe and
row select, then the projection. For an EWA configuration (interpolation
10-13) it computes EWA's stacked evals (``gf_coords_gen_ewa``): the base
eval and both +eps evals of ``remap.ewa_stack`` in one launch, one probe and
one row load serving the three projections. ``project_gen_plain`` is
``remap.coords_pre`` (or ``remap.ewa_stack``) plus ``project_plain`` on the
same grid. It takes every main model; as in the JAX package it refuses lens
correction, mesh and digital lenses (``gen_admits``, which
``remap.plane_route`` reads for the "gen" route).

Each wrapper checks its inputs, then runs its plain version for CPU tensors
only; for CUDA tensors it launches its kernel or raises. ``project.launches``
and ``project_gen.launches`` count kernel launches (either form of the gen
kernel); both wrappers add the positions they project to the tracer's
``gf.coords.points``, on any device, and ``project_gen`` adds each EWA
plane to ``gf.coords.gen_ewa_planes``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
from . import distortion_models as dm
from . import remap
from .kernel_params import (HAS_DIGITAL_LENS, HAS_FPD_DATA, HAS_MESH_DATA, HORIZONTAL_RS,
                            KernelConfig, KernelDynamics, dyn_to_torch)
from ..core.splines import MAX_GRID_SIZE
from .mesh import fpd_offset, spline_mus

# the packed block (csrc/lens.cuh MeshArgs), in float4s: three of
# constants, four of focal-plane shears, then the coefficient rows
_BLOCK_CONSTS = 7
# the reference layout's focal-plane block as core/splines.build_mesh_buffer
# sizes it: its flag, three more floats, 8 row shears (x, y), 4 spare
_REF_FPD_FLOATS = 24


def project_plain(x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics, mesh=None):
    """(x, y, idx) -> (u, v, valid) in plain torch on x's device."""
    return remap.rotate_and_distort(x, y, idx, matrices, cfg, dyn_to_torch(dyn, x.device),
                                    mesh=mesh)


def coord_params(cfg: KernelConfig, dyn: KernelDynamics):
    """The kernel's by-value parameter struct: pallas_coords.pack_params'
    fields (k .. stretch, digital_lens_params) from host dynamics, then the
    plane sizes of remap._lens_params."""
    from .._build import CoordParams

    def h(a):
        return np.asarray(a, np.float32).reshape(-1)

    p = CoordParams()
    p.k[:] = h(dyn.k)[:12].tolist()
    p.f[:] = h(dyn.f)[:2].tolist()
    p.c[:] = h(dyn.c)[:2].tolist()
    p.t3d[:] = h(dyn.translation3d)[:3].tolist()
    p.r_limit = float(h(dyn.r_limit)[0])
    p.lrc = float(h(dyn.light_refraction_coefficient)[0])
    p.stretch_h = float(h(dyn.input_horizontal_stretch)[0])
    p.stretch_v = float(h(dyn.input_vertical_stretch)[0])
    p.dlp[:] = h(dyn.digital_lens_params)[:16].tolist()
    p.width, p.height = float(cfg.width), float(cfg.height)
    p.output_width, p.output_height = float(cfg.output_width), float(cfg.output_height)
    return p


def mesh_block_offset(cfg: KernelConfig) -> int:
    """Where the packed block starts in a packed mesh buffer of cfg's grid:
    after the room of the reference layout (header, grid points, both
    channels' coefficient blocks, the focal-plane block), rounded up to a
    multiple of 4 floats (16 bytes)."""
    return -(-(fpd_offset(cfg) + _REF_FPD_FLOATS) // 4) * 4


def packed_len(cfg: KernelConfig) -> int:
    """The floats of a packed mesh buffer of cfg's grid and flags."""
    gw, gh = cfg.mesh_grid
    rows = 2 * (gw - 1) * gh if cfg.has(HAS_MESH_DATA) else 0
    return mesh_block_offset(cfg) + 4 * (_BLOCK_CONSTS + rows)


def mesh_consts(mesh, cfg: KernelConfig):
    """The block's launch-uniform constants, float32 (csrc/lens.cuh
    MeshConsts): the header (size_x, size_y, ox, oy), (span_x, span_y, band,
    h) and (inv_h, alpha_h, h_3, three_h), computed with the float32
    operations the plain mesh stage runs on the card, where torch divides by
    a Python number as a multiply by its float32 reciprocal (size_y / 8.0,
    size_y / (gh - 1), h / 3.0)."""
    f32 = np.float32
    m = np.asarray(mesh, np.float32).reshape(-1)
    size_x, size_y, ox, oy, cw, ch = (f32(v) for v in m[3:9])
    gh = cfg.mesh_grid[1]
    with np.errstate(all="ignore"):
        h = size_y * (f32(1.0) / f32(max(gh - 1, 1)))
        inv_h = f32(1.0) / h
        return np.array([size_x, size_y, ox, oy,
                         (ox + cw) - ox, (oy + ch) - oy, size_y * f32(1.0 / 8.0), h,
                         inv_h, f32(3.0) * inv_h, h * f32(1.0 / 3.0), f32(3.0) * h], np.float32)


def kernel_mesh(mesh, cfg: KernelConfig):
    """The frame's mesh buffer as the coords kernel reads it, packed here
    alone: None without a buffer or without the mesh and focal-plane flags;
    a host buffer (numpy or a CPU tensor, in either layout) packed on the
    host (``pack_mesh``); a card buffer as it is, if packed: none is
    downloaded to be packed."""
    if mesh is None or not remap.has_mesh(cfg):
        return None
    remap._check_supported(cfg)
    if isinstance(mesh, torch.Tensor) and mesh.device.type != "cpu":
        if mesh.numel() != packed_len(cfg):
            raise ValueError(f"mesh buffer of {mesh.numel()} floats on {mesh.device}, grid "
                             f"{cfg.mesh_grid} packed needs {packed_len(cfg)}: pack it on the host "
                             f"(cuda_coords.pack_mesh)")
        return mesh
    return pack_mesh(mesh, cfg)


def pack_mesh(mesh, cfg: KernelConfig) -> np.ndarray:
    """The mesh buffer the coords kernel's mesh form reads: the reference
    buffer (numpy or a CPU tensor; the plain stage reads only this part)
    zero-padded to ``mesh_block_offset(cfg)``, then the block of
    csrc/lens.cuh MeshArgs: the constants (``mesh_consts``), the 8
    focal-plane shears and, with the mesh flag, channel c's grid row j on x
    segment fi as (a, b, c, d) at float4 7 + (c * (gw - 1) + fi) * gh + j.
    ``packed_len(cfg)`` float32s; a buffer of that length is taken as packed
    already. cfg has the mesh or the focal-plane flag. A host buffer only:
    a tensor on a card raises."""
    if isinstance(mesh, torch.Tensor) and mesh.device.type != "cpu":
        raise ValueError(f"pack_mesh packs a host buffer, got one on {mesh.device}")
    ref = np.asarray(mesh, np.float32).reshape(-1)
    n = packed_len(cfg)
    if ref.size == n:
        return ref
    if ref.size < remap.mesh_len(cfg):
        raise ValueError(f"mesh buffer of {ref.size} floats, grid {cfg.mesh_grid} needs "
                         f"{remap.mesh_len(cfg)}")
    off = mesh_block_offset(cfg)
    if ref.size > off:
        raise ValueError(f"mesh buffer of {ref.size} floats: the reference layout of grid "
                         f"{cfg.mesh_grid} has at most {off}")
    out = np.zeros(n, np.float32)
    out[:ref.size] = ref
    out[off:off + 12] = mesh_consts(ref, cfg)
    if cfg.has(HAS_FPD_DATA):
        o = fpd_offset(cfg)
        out[off + 12:off + 28] = ref[o + 4:o + 20]
    if cfg.has(HAS_MESH_DATA):
        gw, gh = cfg.mesh_grid
        g = MAX_GRID_SIZE
        # reference: channel c, row j, coefficient q, segment fi at
        # 9 + gw * gh * 2 + c * gh * 4g + j * 4g + q * g + fi
        coef = ref[9 + gw * gh * 2:9 + gw * gh * 2 + 2 * gh * 4 * g].reshape(2, gh, 4, g)
        rows = coef[..., :gw - 1].transpose(0, 3, 1, 2)          # (c, fi, j, q)
        out[off + 4 * _BLOCK_CONSTS:] = rows.reshape(-1)
    return out


def mesh_args(cfg: KernelConfig, mesh):
    """The kernel's by-value MeshArgs: the packed mesh buffer's device
    pointer (0 without mesh or focal-plane flags) and its block's offset,
    the grid, and what the plain mesh stage computes from Python numbers, as
    torch on the card computes it: the spline recurrence's mus (they depend
    only on the grid's height) and the float32 reciprocals torch multiplies
    by when it divides by a Python number."""
    from .._build import MeshArgs

    f32 = np.float32
    a = MeshArgs()
    if not remap.has_mesh(cfg):
        return a
    gw, gh = cfg.mesh_grid
    a.data = mesh.data_ptr()
    a.block_offset = mesh_block_offset(cfg)
    a.gw, a.gh = int(gw), int(gh)
    a.mus[:] = [float(m) for m in spline_mus(gh)]
    a.inv_gw1 = float(f32(1.0) / f32(max(gw - 1, 1)))
    a.inv_gh1 = float(f32(1.0) / f32(max(gh - 1, 1)))
    a.inv_width = float(f32(1.0) / f32(cfg.width))
    a.inv_height = float(f32(1.0) / f32(cfg.height))
    return a


def lens_ids(cfg: KernelConfig):
    """(model, digital): the kernels' ids (csrc/lens.cuh ModelId, the order
    of distortion_models.MODEL_IDS) of the main model and of the digital
    lens the remap applies, -1 for none. Any name resolves, as get_model
    resolves it."""
    digital = remap.digital_lens(cfg)
    return (dm.MODEL_IDS[dm.get_model(cfg.distortion_model).id],
            -1 if digital is None else dm.MODEL_IDS[digital.id])


def _check(x, y, idx, matrices, cfg: KernelConfig, mesh=None):
    if remap.has_mesh(cfg):
        remap._check_supported(cfg)
        if mesh is None:
            raise ValueError("coords kernel: mesh / focal-plane flags set but no mesh buffer")
        if mesh.device != x.device or mesh.dtype != torch.float32 or mesh.dim() != 1 \
                or not mesh.is_contiguous():
            raise TypeError(f"coords kernel: mesh must be a contiguous 1-D float32 tensor on "
                            f"{x.device}, got {mesh.dtype} {tuple(mesh.shape)} on {mesh.device}")
        if mesh.numel() != packed_len(cfg):
            raise ValueError(f"coords kernel: mesh buffer of {mesh.numel()} floats, grid "
                             f"{cfg.mesh_grid} packed needs {packed_len(cfg)} "
                             f"(cuda_coords.pack_mesh)")
        if mesh.data_ptr() % 16:
            raise ValueError("coords kernel: the packed mesh buffer must start on 16 bytes")
    for name, t, dt in (("x", x, torch.float32), ("y", y, torch.float32),
                        ("idx", idx, torch.int32), ("matrices", matrices, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"coords kernel: {name} on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"coords kernel: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"coords kernel: {name} must be contiguous")
    if x.dim() != 2 or y.shape != x.shape or idx.shape != x.shape:
        raise ValueError(f"coords kernel: x, y, idx must share one (oh, ow) shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(idx.shape)}")
    if matrices.dim() != 2 or matrices.shape[1] != 14 or matrices.shape[0] < 1:
        raise ValueError(f"coords kernel: matrices must be (rows, 14), got {tuple(matrices.shape)}")


def project(x, y, idx, matrices, cfg: KernelConfig, dyn: KernelDynamics, mesh=None):
    """Project (oh, ow) output-space points through their RS matrix rows.

    x, y float32, idx int32 (from ``remap.coords_pre``); matrices (rows, 14)
    float32; dyn with host numpy leaves; mesh the frame's mesh buffer, a 1-D
    float32 tensor on x's device, packed (``pack_mesh``), read when cfg has
    the mesh or focal-plane flag. Returns u, v float32 and valid bool."""
    _check(x, y, idx, matrices, cfg, mesh)
    trace.count("gf.coords.points", x.numel())
    if x.device.type == "cpu":
        return project_plain(x, y, idx, matrices, cfg, dyn, mesh)
    if x.device.type != "cuda":
        raise ValueError(f"coords kernel: unsupported device {x.device}")
    from .._build import lib

    oh, ow = x.shape
    u = torch.empty_like(x)
    v = torch.empty_like(x)
    valid = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if x.numel() == 0:
        return u, v, valid
    L = lib()
    with torch.cuda.device(x.device):
        err = L.gf_coords(x.data_ptr(), y.data_ptr(), idx.data_ptr(), matrices.data_ptr(),
                          matrices.shape[0], coord_params(cfg, dyn), int(cfg.flags),
                          *lens_ids(cfg), oh, ow, u.data_ptr(), v.data_ptr(), valid.data_ptr(),
                          torch.cuda.current_stream(x.device).cuda_stream,
                          mesh_args(cfg, mesh))
    if err != 0:
        raise RuntimeError(f"coords kernel launch failed: cudaError {err}")
    project.launches += 1
    return u, v, valid


project.launches = 0


def project_gen_plain(cfg: KernelConfig, dyn: KernelDynamics, matrices, out_rows: int,
                      oy0: int, out_c, out_f, pos_dx: float = 0.0, pos_dy: float = 0.0):
    """Plain torch: remap.coords_pre (for EWA, remap.ewa_stack) on the
    (out_rows, ow) band's output positions (+ pos_dx, pos_dy), then the
    projection. Returns u, v float32 and valid bool, before coords_post_uv:
    (out_rows, ow), or (3 * out_rows, ow) for EWA."""
    dyn_t = dyn_to_torch(dyn, matrices.device)
    oy, ox = remap.out_grid(cfg.out_buffer[0], out_rows, oy0, matrices.device)
    pre = remap.ewa_stack if cfg.interpolation in remap.EWA_BC else remap.coords_pre
    x, y, idx = pre(ox + pos_dx, oy + pos_dy, matrices, cfg, dyn_t, out_c, out_f)
    return remap.rotate_and_distort(x, y, idx, matrices, cfg, dyn_t)


def gen_admits(cfg: KernelConfig) -> bool:
    """Whether ``project_gen`` computes cfg's planes: no lens-correction
    blend, no mesh or focal-plane stage and no digital lens. The kernel
    refuses every other configuration, and ``remap.remap_plane_cuda`` routes
    a plane through it by this test."""
    return not (cfg.lens_correction or cfg.digital_lens
                or cfg.flags & (HAS_MESH_DATA | HAS_FPD_DATA | HAS_DIGITAL_LENS))


def _check_gen(cfg: KernelConfig, matrices, out_rows: int, oy0: int):
    if not gen_admits(cfg):
        raise ValueError(
            "coords gen kernel: no lens-correction blend, mesh or digital lens (the JAX "
            "package gates project_tiles_gen off for them, pallas_coords.py:234-236); "
            "use remap.coords_pre with project")
    if matrices.dtype != torch.float32 or not matrices.is_contiguous():
        raise TypeError("coords gen kernel: matrices must be contiguous float32")
    if matrices.dim() != 2 or matrices.shape[1] != 14 or matrices.shape[0] < 1:
        raise ValueError(f"coords gen kernel: matrices must be (rows, 14), got "
                         f"{tuple(matrices.shape)}")
    if out_rows < 0 or oy0 < 0:
        raise ValueError(f"coords gen kernel: out_rows {out_rows}, oy0 {oy0}")


def gen_args(cfg: KernelConfig, dyn: KernelDynamics, oy0: int, pos_dx: float, pos_dy: float):
    """The kernel's by-value GenArgs. The out-rect map's division is a
    multiply by the float32 reciprocal, as torch divides by a host scalar on
    the card; its out_min is 0, which the kernel leaves out (so translation2d
    goes up with a -0 made +0)."""
    from .._build import GenArgs

    f32 = np.float32
    orx, ory, orw, orh = cfg.out_rect
    g = GenArgs()
    g.oy0 = int(oy0)
    g.pos_d[:] = [pos_dx, pos_dy]
    g.map_x[:] = [float(orx), float(cfg.output_width) - 0.0,
                  float(f32(1.0) / f32(float(orx + orw) - float(orx)))]
    g.map_y[:] = [float(ory), float(cfg.output_height) - 0.0,
                  float(f32(1.0) / f32(float(ory + orh) - float(ory)))]
    # + 0 turns a -0 into +0: the kernel adds t2d to the map without the
    # map's + out_min (0), and (a + 0) + t == a + (t + 0) for every a and t
    g.t2d[:] = (np.asarray(dyn.translation2d, np.float32).reshape(-1)[:2]
                + np.float32(0.0)).tolist()
    g.lim = float(cfg.width if cfg.has(HORIZONTAL_RS) else cfg.height)
    return g


def project_gen(cfg: KernelConfig, dyn: KernelDynamics, matrices, out_rows: int, oy0: int,
                out_c, out_f, pos_dx: float = 0.0, pos_dy: float = 0.0):
    """Self-contained projection of output rows oy0 .. oy0 + out_rows (the
    counterpart of pallas_coords.project_tiles_gen on the (out_rows, ow)
    layout). matrices (rows, 14) float32 on the target device; dyn with host
    numpy leaves; out_c, out_f as remap builds them, read only by the plain
    version's lens-correction blend, which the kernel refuses (so None will
    do). Returns u, v float32 and valid bool, before coords_post_uv.

    For EWA (interpolation 10-13), the stacked evals
    (``gf_coords_gen_ewa``): the base eval and the +eps evals in x and in y
    of ``remap.ewa_stack``, stacked along rows as (3 * out_rows, ow), with
    the bits of ewa_stack and ``project``; each such call adds 1 to the
    tracer's ``gf.coords.gen_ewa_planes``.

    Raises ValueError for lens correction, mesh and digital lenses, which
    the kernel does not compute."""
    _check_gen(cfg, matrices, out_rows, oy0)
    evals = 3 if cfg.interpolation in remap.EWA_BC else 1
    trace.count("gf.coords.points", evals * out_rows * cfg.out_buffer[0])
    if evals == 3:
        trace.count("gf.coords.gen_ewa_planes", 1)
    if matrices.device.type == "cpu":
        return project_gen_plain(cfg, dyn, matrices, out_rows, oy0, out_c, out_f, pos_dx, pos_dy)
    if matrices.device.type != "cuda":
        raise ValueError(f"coords gen kernel: unsupported device {matrices.device}")
    from .._build import lib

    ow = cfg.out_buffer[0]
    u = torch.empty((evals * out_rows, ow), dtype=torch.float32, device=matrices.device)
    v = torch.empty_like(u)
    valid = torch.empty(u.shape, dtype=torch.bool, device=u.device)
    if u.numel() == 0:
        return u, v, valid
    L = lib()
    args = (matrices.data_ptr(), matrices.shape[0], coord_params(cfg, dyn), int(cfg.flags),
            lens_ids(cfg)[0], gen_args(cfg, dyn, oy0, pos_dx, pos_dy))
    outs = (out_rows, ow, u.data_ptr(), v.data_ptr(), valid.data_ptr())
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if evals == 3:
            err = L.gf_coords_gen_ewa(*args, float(np.float32(remap.EWA_EPS)),
                                      int(bool(cfg.ewa_ref_jac)), *outs, stream)
        else:
            err = L.gf_coords_gen(*args, *outs, stream)
    if err != 0:
        raise RuntimeError(f"coords gen kernel launch failed: cudaError {err}")
    project_gen.launches += 1
    return u, v, valid


project_gen.launches = 0
