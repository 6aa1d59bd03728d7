"""gyroflow_torch sampler vs the JAX package's samplers, on the CPU.

``cuda_sampler.sample`` (on CPU tensors: its plain version) against
``pallas_sampler.sample_planes_t`` (the Pallas sampler kernel in interpret
mode) and XLA ``remap.sample_input``, all given the same u/v maps. Noise
content and coordinates spread past a source rect that is smaller than the
plane, so out-of-rect taps read the background.

Tolerance: 0.01 of a 10-bit code. Against XLA (same LUT, same per-tap
background reads) the only difference is summation rounding; against Pallas
its Taylor-pair lanczos weights (within 3e-7 of the LUT) and separable
background weight (1 - rowsum*colsum) add a few 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import interpolation as jinterp
from gyroflow_tpu.ops import pallas_sampler
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import KernelConfig, KernelDynamics
from gyroflow_torch.ops import cuda_sampler
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 0.01
PH, PW = 40, 56                 # plane
OH, OW = 24, 40                 # output map
SRC_RECT = (3, 2, PW - 9, PH - 6)
LIMIT = 1000.0


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1023, (PH, PW, c)).astype(np.float32)
    u = rng.uniform(-6, PW + 6, (OH, OW)).astype(np.float32)
    v = rng.uniform(-6, PH + 6, (OH, OW)).astype(np.float32)
    bg = rng.uniform(0, 1023, c).astype(np.float32)
    return img, u, v, bg


def _port(img, u, v, bg, interpolation, valid=None):
    valid = np.ones(u.shape, bool) if valid is None else valid
    return cuda_sampler.sample(
        torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v),
        torch.from_numpy(valid), tuple(float(b) for b in bg), SRC_RECT, interpolation,
        LIMIT).numpy()


@pytest.mark.parametrize("interpolation", [2, 4, 8])
@pytest.mark.parametrize("c", [1, 2])
def test_vs_pallas_sampler(interpolation, c):
    img, u, v, bg = _inputs(c, seed=interpolation * 10 + c)
    spec = pallas_sampler.SamplerSpec.create(
        height=PH, width=PW, out_height=OH, out_width=OW, interpolation=interpolation,
        win_h=PH, win_w=PW, source_rect=SRC_RECT)
    ox, oy, pad_ok = pallas_sampler.tiled_grid(spec)
    ox_i = np.asarray(ox).astype(np.int64)
    oy_i = np.asarray(oy).astype(np.int64)
    inside = np.asarray(pad_ok)
    u_t = jnp.asarray(np.where(inside, u[np.minimum(oy_i, OH - 1), np.minimum(ox_i, OW - 1)], 0))
    v_t = jnp.asarray(np.where(inside, v[np.minimum(oy_i, OH - 1), np.minimum(ox_i, OW - 1)], 0))
    out_t, ov = pallas_sampler.sample_planes_t(
        spec, jnp.moveaxis(jnp.asarray(img), -1, 0), u_t, v_t, jnp.asarray(inside), bg)
    assert not bool(ov)
    want = np.moveaxis(np.asarray(pallas_sampler.out_untileize_c(
        spec, jnp.minimum(out_t, LIMIT))), 0, -1)
    got = _port(img, u, v, bg, interpolation)
    assert got.shape == (OH, OW, c)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("interpolation", [2, 4, 8])
@pytest.mark.parametrize("c", [1, 2])
def test_vs_xla_sample_input(interpolation, c):
    img, u, v, bg = _inputs(c, seed=interpolation * 10 + c + 1)
    cfg = KernelConfig(width=PW, height=PH, output_width=OW, output_height=OH,
                       interpolation=interpolation, source_rect=SRC_RECT)
    dyn = KernelDynamics.make(pixel_value_limit=LIMIT)
    want = np.asarray(jremap.sample_input(jnp.asarray(img), jnp.stack([u, v], -1),
                                          jnp.asarray(bg), cfg, dyn))
    got = _port(img, u, v, bg, interpolation)
    assert np.abs(got - want).max() <= TOL


def test_invalid_pixels_get_background_and_native_dtypes_agree():
    img, u, v, bg = _inputs(2, seed=7)
    valid = np.random.default_rng(8).uniform(size=(OH, OW)) > 0.3
    got = _port(img, u, v, bg, 8, valid=valid)
    np.testing.assert_array_equal(got[~valid], np.broadcast_to(bg, got[~valid].shape))
    # the wrapper takes the plane in its native dtype; uint16 and its float
    # image give the same samples
    img16 = np.rint(img).astype(np.uint16)
    np.testing.assert_array_equal(_port(img16, u, v, bg, 8, valid=valid),
                                  _port(img16.astype(np.float32), u, v, bg, 8, valid=valid))


def test_non_finite_coordinates_are_guarded():
    img, u, v, bg = _inputs(1, seed=9)
    u[0, :3] = [np.nan, np.inf, -np.inf]
    got = _port(img, u, v, bg, 8)
    assert np.isfinite(got).all()


def test_wrapper_checks():
    img = torch.zeros(8, 8, 5)
    u = torch.zeros(4, 4)
    ok = torch.ones(4, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_sampler._check(img, u, u, ok, (0.0,) * 5, (0, 0, 8, 8), 8)
    with pytest.raises(TypeError):
        cuda_sampler._check(torch.zeros(8, 8, 1, dtype=torch.int32), u, u, ok, (0.0,),
                            (0, 0, 8, 8), 8)
    with pytest.raises(ValueError):
        cuda_sampler._check(torch.zeros(8, 8, 1), u, u, ok, (0.0,), (0, 0, 8, 8), 11)
    with pytest.raises(TypeError):
        cuda_sampler._check(torch.zeros(8, 8, 1), u, u, ok.float(), (0.0,), (0, 0, 8, 8), 8)
    cuda_sampler._check(torch.zeros(8, 8, 1, dtype=torch.uint16), u, u,
                        torch.ones(4, 4, dtype=torch.bool), (0.0,), (0, 0, 8, 8), 8)


@pytest.mark.parametrize("interpolation", [2, 4, 8])
def test_lut_slice_is_the_interpolations_part_of_coeffs(interpolation):
    """The LUT slice the sampler and fused kernels stage: exactly
    COEFFS[ind : ind + 32 * taps] of the reference table, phase p's taps at
    [p * taps, (p + 1) * taps), where the reference reads them at
    ind + (p << shift) + t."""
    info = jinterp.INTERP_INFO[interpolation]
    taps, ind, shift = info["taps"], info["ind"], info["shift"]
    coeffs = np.asarray(jinterp.COEFFS, np.float32)
    got = cuda_sampler.lut_slice(interpolation, "cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == (jinterp.INTER_TAB_SIZE * taps,) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), coeffs[ind:ind + jinterp.INTER_TAB_SIZE * taps])
    for phase in range(jinterp.INTER_TAB_SIZE):
        for t in range(taps):
            assert got[phase * taps + t] == coeffs[ind + (phase << shift) + t]
    # one tensor per device and interpolation, made once
    assert cuda_sampler.lut_slice(interpolation, "cpu") is got
