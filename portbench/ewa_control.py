"""The control of the EWA deployments: the plain reference's EWA remap with
the plane, the coordinates (the base eval and the two +eps evals of the
stacked projection, so the Jacobian formed from them too) and the sampled
values rounded to bfloat16, one precision below the float32 the
deployments state. ``reference.stabilizer.remap_plane_bf16``, the control
of the lanczos4 cells, takes no EWA.

``installed()`` puts it in the reference stabilizer's control slot for EWA
planes (interpolation 10-13), leaving every other plane to
``remap_plane_bf16``; ``calibrate_ewa.py`` runs the calibration under it.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from .reference import stabilizer
from .reference.ops import remap
from .reference.ops.kernel_params import dyn_to_torch


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def remap_plane_ewa_bf16(img, matrices, cfg, dyn, mesh=None, out_dtype: str = "f32"):
    """``remap.remap_plane`` of an EWA plane (no drawing) in bfloat16: the
    plane, the three stacked evals after the projection and the samples."""
    matrices, mesh = remap._prepare(img, matrices, cfg, mesh)
    imgf = _bf16(img.to(torch.float32))
    dyn_t = dyn_to_torch(dyn, img.device)
    bg = (dyn_t.background * dyn_t.max_pixel_value)[:img.shape[-1]]
    limit = remap._host_scalar(dyn.pixel_value_limit)
    coeffs_p, coeffs_q = remap._ewa_coeffs_of(dyn)

    def project(x, y, idx):
        u, v, valid = remap.rotate_and_distort(x, y, idx, matrices, cfg, dyn_t, mesh=mesh)
        return _bf16(u), _bf16(v), valid

    def sample(u, v, valid, evals):
        jac = remap.ewa_jacobian(*evals)[3]
        return _bf16(remap.sample_ewa(imgf, u, v, jac, bg, cfg.src_rect, coeffs_p, coeffs_q,
                                      limit))

    out = remap._remap(img, matrices, cfg, dyn_t, project, sample, mesh=mesh)
    return remap._cast_out(out, out_dtype, remap._host_scalar(dyn.max_pixel_value))


@contextmanager
def installed():
    """The reference stabilizer's control takes EWA planes through
    ``remap_plane_ewa_bf16`` while this holds."""
    lanczos = stabilizer.remap_plane_bf16

    def control(img, matrices, cfg, dyn, mesh=None, out_dtype: str = "f32"):
        fn = remap_plane_ewa_bf16 if cfg.interpolation in remap.EWA_BC else lanczos
        return fn(img, matrices, cfg, dyn, mesh, out_dtype)

    stabilizer.remap_plane_bf16 = control
    try:
        yield
    finally:
        stabilizer.remap_plane_bf16 = lanczos
