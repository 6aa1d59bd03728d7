"""gyroflow_torch remap vs the JAX package's remap, on the CPU.

The same inputs (cfg/dyn/matrices built with the JAX package's KernelConfig
and KernelDynamics, content from a numpy seed) go through
``gyroflow_tpu.ops.remap.remap_plane_jit`` (XLA), ``remap_plane_pallas_jit``
(the Pallas kernels in interpret mode, as the JAX tests run them) and the
port's ``remap_plane`` / ``remap_plane_cuda`` (whose kernel wrappers run their
plain torch versions on CPU tensors).

Tolerances: 0.25 of a 10-bit code in float32 (the ROADMAP's pixel tolerance:
the Pallas sampler's Taylor-pair lanczos weights and its separable
background weight differ from the LUT/per-tap form by float rounding), and
1 code after the uint16 cast (a float difference of ~1e-4 can cross a
rounding boundary). Content is smooth (sin*cos + small noise), so a 1-ulp
coordinate difference that flips one 1/32 phase costs less than 0.25 code.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import distortion_models as jdm
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import (ANY_UNDERWATER, FIX_COLOR_RANGE, HAS_DIGITAL_LENS,
                                            HAS_IBIS_DATA, HAS_OUTPUT_RECT, HAS_SOURCE_RECT,
                                            KernelConfig, KernelDynamics)
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from test_distortion_models import DIGITAL, make_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H = 96, 64               # luma plane
K = [0.25, -0.07, 0.02, -0.003]
F = (W * 0.62, W * 0.62)
MAXV = 1023.0
F32_TOL = 0.25              # 10-bit codes, float32 output
U16_TOL = 1                 # codes, uint16 output


def _rot(rx, ry, rz):
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                              math.sin(ry), math.cos(rz), math.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def rs_matrices(fov=0.9, rows=H, ibis=False):
    """Per-row rolling-shutter matrices: inv(new_k @ R(row)) (frame_transform.rs:296),
    with a rotation that drifts across rows so the row select matters."""
    new_k = np.array([[F[0] / fov, 0, W / 2], [0, F[1] / fov, H / 2], [0, 0, 1.0]])
    out = []
    for i in range(rows):
        r = _rot(0.012 + 4e-4 * i, -0.018 + 2e-4 * i, 0.006)
        r[0, 1] *= -1; r[0, 2] *= -1; r[1, 0] *= -1; r[2, 0] *= -1
        tail = [0.3 + 0.01 * i, -0.2, 0.002, 0.1, 0.05] if ibis else [0.0] * 5
        out.append(list(np.linalg.inv(new_k @ r).flatten()) + tail)
    return np.asarray(out, np.float32)


def smooth_image(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # experiments/tpu_parity.py's content: at most ~6.5 codes per pixel, so a
    # flipped 1/32 phase (an ulp of jit-vs-eager coordinate rounding lands
    # rint(u*32) on the other side of a tie) moves a pixel by < 0.25 code
    base = (np.sin(xx * 0.013) * np.cos(yy * 0.011) * 0.5 + 0.5) * 1000.0
    img = np.stack([base + 10.0 * i for i in range(c)], axis=-1)
    return (img + rng.uniform(0, 0.5, img.shape)).astype(np.float32)


# every lens of the reference: each model as the main model, then each
# digital lens on a fisheye base
LENS_CASES = [(m, None) for m in jdm.MODELS] + [("opencv_fisheye", d) for d in DIGITAL]


def lens_kw(model, digital=None):
    """make_case's lens keywords: ``model`` with the coefficients of
    test_distortion_models.make_params, or the fisheye base with the digital
    lens ``digital`` and its parameters."""
    if digital:
        return dict(digital_lens=digital,
                    digital_lens_params=np.array(make_params(digital).digital_lens_params))
    p = make_params(model)
    return dict(distortion_model=model, k=np.array(p.k),
                digital_lens_params=np.array(p.digital_lens_params))


def make_case(plane="Y", interpolation=8, background_mode=0, flags=0, fov=0.9,
              lens_correction_amount=1.0, lrc=1.0, translation2d=(0.0, 0.0),
              distortion_model="opencv_fisheye", k=K, digital_lens=None,
              digital_lens_params=None):
    """(JAX cfg, JAX dyn, port cfg, port dyn, matrices, image) for one plane.

    plane "UV" is the half-size 2-channel chroma plane of YUV420 with luma
    geometry and source/output rects, as the manager builds it. A digital
    lens sets HAS_DIGITAL_LENS, as frame_transform does."""
    if lrc != 1.0:
        flags |= ANY_UNDERWATER          # as frame_transform sets it
    if digital_lens:
        flags |= HAS_DIGITAL_LENS
    cfg = KernelConfig(width=W, height=H, output_width=W, output_height=H,
                       interpolation=interpolation, background_mode=background_mode,
                       distortion_model=distortion_model, digital_lens=digital_lens,
                       flags=flags, lens_correction=lens_correction_amount < 1.0)
    if plane == "UV":
        pw, ph = W // 2, H // 2
        cfg = cfg._replace(plane_index=1, source_rect=(0, 0, pw, ph),
                           output_rect=(0, 0, pw, ph), out_size=(pw, ph),
                           flags=cfg.flags | HAS_SOURCE_RECT | HAS_OUTPUT_RECT)
        img = smooth_image(ph, pw, 2, seed=1)
    else:
        img = smooth_image(H, W, 1)
    dyn = KernelDynamics.make(
        f=F, c=(W / 2, H / 2), k=k, fov=fov, lens_correction_amount=lens_correction_amount,
        background=(0.1, 0.5, 0.2, 1.0), background_margin=0.1,
        background_margin_feather=0.05, translation2d=translation2d,
        digital_lens_params=digital_lens_params, light_refraction_coefficient=lrc,
        max_pixel_value=MAXV, pixel_value_limit=MAXV)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    return cfg, dyn, pcfg, pdyn, rs_matrices(fov, ibis=bool(flags & HAS_IBIS_DATA)), img


def port_remap(pcfg, pdyn, mats, img, out_dtype="f32", cuda_path=False):
    fn = tremap.remap_plane_cuda if cuda_path else tremap.remap_plane
    return fn(torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn,
              out_dtype=out_dtype).numpy()


def jax_xla(cfg, dyn, mats, img):
    return np.asarray(jremap.remap_plane_jit(jnp.asarray(img), jnp.asarray(mats), cfg, dyn))


def jax_pallas(cfg, dyn, mats, img):
    # windows as large as the plane: the ladder's first rung always fits
    out, ov = jremap.remap_plane_pallas_jit(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                            win_h=256, win_w=256)
    assert not bool(ov), "Pallas window overflow at test size"
    return np.asarray(out)


# each background mode on both planes; limited range (FIX_COLOR_RANGE) rides
# along with one mode per plane (every distinct cfg is one XLA compile)
CASES = [
    ("Y", 0, 0), ("Y", 1, FIX_COLOR_RANGE), ("Y", 2, 0), ("Y", 3, 0),
    ("UV", 0, 0), ("UV", 1, 0), ("UV", 2, FIX_COLOR_RANGE), ("UV", 3, 0),
]


class TestRemapPlane:
    @pytest.mark.parametrize("plane,bg_mode,flags", CASES)
    def test_vs_xla(self, plane, bg_mode, flags):
        cfg, dyn, pcfg, pdyn, mats, img = make_case(plane, background_mode=bg_mode,
                                                    flags=flags, fov=1.1)
        want = jax_xla(cfg, dyn, mats, img)
        got = port_remap(pcfg, pdyn, mats, img)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_TOL

    @pytest.mark.parametrize("plane,bg_mode,flags", [
        ("Y", 0, FIX_COLOR_RANGE), ("Y", 2, 0), ("UV", 1, 0), ("UV", 3, 0)])
    def test_vs_pallas(self, plane, bg_mode, flags):
        cfg, dyn, pcfg, pdyn, mats, img = make_case(plane, background_mode=bg_mode,
                                                    flags=flags, fov=1.1)
        want = jax_pallas(cfg, dyn, mats, img)
        got = port_remap(pcfg, pdyn, mats, img, cuda_path=True)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_TOL

    @pytest.mark.parametrize("plane", ["Y", "UV"])
    def test_uint16_vs_xla(self, plane):
        """uint16 in and out. The JAX side gets the same codes as float32
        (remap casts on entry) and its cast (remap.py:625) is applied after."""
        cfg, dyn, pcfg, pdyn, mats, img = make_case(plane)
        img16 = np.rint(img).astype(np.uint16)
        want = np.asarray(jremap._cast_out(
            jnp.asarray(jax_xla(cfg, dyn, mats, img16.astype(np.float32))), "uint16", dyn))
        got = port_remap(pcfg, pdyn, mats, img16, out_dtype="uint16")
        assert got.dtype == np.uint16 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= U16_TOL

    @pytest.mark.parametrize("interpolation", [2, 4, 8, 11])
    @pytest.mark.parametrize("plane", ["Y", "UV"])
    def test_cuda_path_matches_plain_on_cpu(self, plane, interpolation):
        """remap_plane_cuda on CPU tensors (wrappers' plain versions) is the
        same computation as remap_plane: bit-identical. For EWA the cuda path
        stacks its three coordinate evals into one projection call."""
        _, _, pcfg, pdyn, mats, img = make_case(plane, interpolation=interpolation)
        if interpolation in tremap.EWA_BC:
            p, q = tremap.ewa_coeffs(interpolation)
            pdyn = pdyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                                 ewa_coeffs_q=np.asarray(q, np.float32))
        img16 = np.rint(img).astype(np.uint16)
        a = port_remap(pcfg, pdyn, mats, img16, out_dtype="uint16")
        b = port_remap(pcfg, pdyn, mats, img16, out_dtype="uint16", cuda_path=True)
        np.testing.assert_array_equal(a, b)

    # bilinear/bicubic sampling is held against XLA and Pallas in
    # test_torch_sampler.py
    @pytest.mark.parametrize("kw", [
        dict(flags=HAS_IBIS_DATA), dict(lens_correction_amount=0.6),
        dict(lrc=1.33), dict(translation2d=(3.0, -2.0))])
    def test_options_vs_xla(self, kw):
        cfg, dyn, pcfg, pdyn, mats, img = make_case("Y", **kw)
        want = jax_xla(cfg, dyn, mats, img)
        got = port_remap(pcfg, pdyn, mats, img)
        assert np.abs(got - want).max() <= F32_TOL

    def test_uint8_cast(self):
        cfg, dyn, pcfg, pdyn, mats, img = make_case("Y")
        img8 = np.clip(img / 4.0, 0, 255).astype(np.uint8)
        dyn = dyn._replace(max_pixel_value=np.float32(255.0), pixel_value_limit=np.float32(255.0))
        pcfg, pdyn = tkp.from_reference(cfg, dyn)
        want = np.asarray(jremap._cast_out(
            jnp.asarray(jax_xla(cfg, dyn, mats, img8.astype(np.float32))), "uint8", dyn))
        got = port_remap(pcfg, pdyn, mats, img8, out_dtype="uint8")
        assert got.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1

    def test_single_matrix(self):
        cfg, dyn, pcfg, pdyn, mats, img = make_case("Y")
        want = jax_xla(cfg, dyn, mats[:1], img)
        got = port_remap(pcfg, pdyn, mats[:1], img)
        assert np.abs(got - want).max() <= F32_TOL


class TestNotPorted:
    def test_mesh_raises(self):
        """Mesh correction is ported (tests/test_torch_mesh.py); what still
        raises is a mesh flag without its buffer or with a buffer too short
        for its grid."""
        _, _, pcfg, pdyn, mats, img = make_case("Y")
        mcfg = pcfg._replace(flags=pcfg.flags | 512, mesh_grid=(9, 9))     # HAS_MESH_DATA
        args = (torch.from_numpy(img), torch.from_numpy(mats))
        with pytest.raises(ValueError, match="no mesh buffer"):
            tremap.remap_plane(*args, mcfg, pdyn)
        with pytest.raises(ValueError, match="needs"):
            tremap.remap_plane(*args, mcfg, pdyn, mesh=torch.zeros(16))


def test_kernel_params_roundtrip():
    cfg, dyn, pcfg, pdyn, _, _ = make_case("UV", flags=FIX_COLOR_RANGE)
    assert pcfg == cfg and hash(pcfg) == hash(cfg)
    dt = tkp.dyn_to_torch(pdyn, torch.device("cpu"))
    for a, b in zip(dt, dyn):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))
