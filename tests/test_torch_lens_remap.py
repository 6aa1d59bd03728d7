"""gyroflow_torch's remap with the lenses cameras hand it, vs the JAX package
and the scalar oracle, on the CPU.

- The remap of three clips' lenses, the port's ``remap_plane`` against the
  JAX ``remap_plane`` (op by op, the order the port follows) on the Y and UV
  planes of ``make_case``, in float32 and through the uint16 cast:
  (a) Sony: ``distortion_model="sony"``, the coefficient shape of
      tests/test_distortion_models.py (``COEFFS["sony"]``);
  (b) a GoPro HERO 4K SuperView clip: opencv_fisheye with the coefficients
      of resources/camera_presets/GoPro_HERO11_Black_wide_3840x2160_59940.json,
      the digital lens gopro_superview with HAS_DIGITAL_LENS, and
      lens_correction_amount 0.5 (the digital un-zoom, warp and re-zoom of
      coords_pre, then the fisheye undistort);
  (c) Canon: ``distortion_model="opencv_standard"``.
  Tolerances: 0.25 of a 10-bit code in float32 and 1 code in uint16, as
  tests/test_torch_remap.py. Against the jitted ``remap_plane_jit`` a tap
  phase can flip: XLA fuses the chain and rounds a few positions an ulp
  apart, and where a stencil straddles the source rect's edge (the step to
  the background) one flipped 1/32 phase moves a pixel by tens of codes.
- The digital cases of tests/test_remap_golden.py ``TestGoldenRemap``
  (digital_stretch; gopro_superview with lens correction) through the port
  against ``tests/oracle.py``, with that file's ``compare`` bounds: pixels
  within max(0.75, 2% of 255), valid masks agreeing on 99.9% of pixels, and
  source coordinates within 0.05 px where both are valid.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import test_remap_golden as golden
from gyroflow_tpu.ops import remap as jremap
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from test_distortion_models import COEFFS
from test_torch_remap import F32_TOL, U16_TOL, make_case, port_remap
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOPRO_HERO11_K = [0.262, -0.0587, 0.0222, -0.0034]
CLIPS = {
    "sony": dict(distortion_model="sony", k=COEFFS["sony"]),
    "gopro_superview": dict(k=GOPRO_HERO11_K, digital_lens="gopro_superview",
                            lens_correction_amount=0.5),
    "canon": dict(distortion_model="opencv_standard", k=COEFFS["opencv_standard"]),
}


def jax_eager(cfg, dyn, mats, img):
    return np.asarray(jremap.remap_plane(jnp.asarray(img), jnp.asarray(mats), cfg, dyn))


@pytest.mark.parametrize("plane", ["Y", "UV"])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_remap_plane_vs_jax(clip, plane):
    cfg, dyn, pcfg, pdyn, mats, img = make_case(plane, fov=1.1, **CLIPS[clip])
    want = jax_eager(cfg, dyn, mats, img)
    got = port_remap(pcfg, pdyn, mats, img)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL
    # the lens moves the picture: not the fisheye render of the same plane
    fisheye = port_remap(*make_case(plane, fov=1.1)[2:4], mats, img)
    assert np.abs(got - fisheye).max() > 1.0


@pytest.mark.parametrize("clip", list(CLIPS))
def test_remap_plane_uint16_vs_jax(clip):
    cfg, dyn, pcfg, pdyn, mats, img = make_case("Y", fov=1.1, **CLIPS[clip])
    img16 = np.rint(img).astype(np.uint16)
    want = np.asarray(jremap._cast_out(
        jnp.asarray(jax_eager(cfg, dyn, mats, img16.astype(np.float32))), "uint16", dyn))
    got = port_remap(pcfg, pdyn, mats, img16, out_dtype="uint16")
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= U16_TOL


@pytest.mark.parametrize("clip", list(CLIPS))
def test_cuda_path_matches_plain_on_cpu(clip):
    """remap_plane_cuda on CPU tensors (the wrappers' plain versions), split
    and fused, is remap_plane bit for bit."""
    _, _, pcfg, pdyn, mats, img = make_case("UV", fov=1.1, **CLIPS[clip])
    img16 = np.rint(img).astype(np.uint16)
    a = port_remap(pcfg, pdyn, mats, img16, out_dtype="uint16")
    b = port_remap(pcfg, pdyn, mats, img16, out_dtype="uint16", cuda_path=True)
    c = tremap.remap_plane_cuda(torch.from_numpy(img16), torch.from_numpy(mats), pcfg, pdyn,
                                out_dtype="uint16", fused=True).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


# the digital cases of test_remap_golden.TestGoldenRemap (:181-188)
GOLDEN = {
    "digital_stretch": dict(digital_lens="digital_stretch", digital_lens_params=[1.3333, 1.0]),
    "superview_with_lens_correction": dict(digital_lens="gopro_superview",
                                           lens_correction_amount=0.4),
}


@pytest.mark.parametrize("case", list(GOLDEN))
def test_golden_digital_vs_oracle(case):
    img = golden.make_image()
    cfg, dyn, p, mats = golden.make_pair(**GOLDEN[case])
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    got = tremap.remap_plane(torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn).numpy()
    want = oracle.undistort_image(img, p, mats)
    assert np.abs(got - want).max() < max(0.75, 255 * 0.02)      # test_remap_golden.py:105

    factor = max(1.0 - p["lens_correction_amount"], 0.001)
    out_f = (p["f"][0] / p["fov"] / factor, p["f"][1] / p["fov"] / factor)
    oy, ox = torch.meshgrid(torch.arange(golden.OH, dtype=torch.float32),
                            torch.arange(golden.OW, dtype=torch.float32), indexing="ij")
    u, v, valid = tremap.undistort_coord(ox, oy, torch.from_numpy(mats), pcfg,
                                         tkp.dyn_to_torch(pdyn, torch.device("cpu")),
                                         (golden.OW / 2.0, golden.OH / 2.0), out_f)
    want_uv = oracle.undistort_coord_map(p, mats)
    want_valid = ~np.isnan(want_uv[..., 0])
    valid = valid.numpy()
    assert (valid == want_valid).mean() > 0.999                      # :122
    both = valid & want_valid
    assert both.any()
    got_uv = np.stack([u.numpy(), v.numpy()], -1)
    assert np.abs(got_uv[both] - want_uv[both]).max() < 0.05         # :126
