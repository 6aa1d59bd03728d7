"""gyroflow_torch's fused route (``remap_plane_cuda(fused=True)``) vs the JAX
package's ``remap_plane_pallas(fused=True)``, on the CPU.

- On CPU tensors the fused wrapper runs its plain version
  (``cuda_fused.remap_fused_plain``). It is held against the JAX fused path
  with the Pallas fused kernel in interpret mode, over Y and UV,
  interpolation 2, 4 and 8, background modes 0, 1 and 2, horizontal rolling
  shutter, IBIS, an input rotation and limited range.
- The plain fused route equals the port's plain split route bit for bit.
- EWA, background mode 3 and a single matrix row take the split path, as in
  the JAX package.
- The two guard orders (offset then guard in the split sampler, as XLA's
  sample_input; guard then offset in the fused kernel, as the Pallas
  kernels) give the same samples wherever |u|, |v| stay inside the guard's
  +-32768 clip; they differ only for non-finite or clipped coordinates,
  whose taps all lie outside the source.

Tolerances: 0.25 of a 10-bit code in float32 and 1 code in uint16, as
test_torch_remap.py (the Pallas kernels' Taylor-pair weights and separable
background weight differ from the LUT/per-tap form by float rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import (FIX_COLOR_RANGE, HAS_IBIS_DATA, HORIZONTAL_RS)
from gyroflow_torch.ops import cuda_fused
from gyroflow_torch.ops import remap as tremap

from test_torch_remap import F32_TOL, MAXV, U16_TOL, lens_kw, make_case
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _port(pcfg, pdyn, mats, img, fused, out_dtype="f32"):
    return tremap.remap_plane_cuda(torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn,
                                   out_dtype=out_dtype, fused=fused).numpy()


def _jax_fused(cfg, dyn, mats, img, out_dtype="f32"):
    out, ov = jremap.remap_plane_pallas_jit(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                            win_h=256, win_w=256, fused=True,
                                            out_dtype=out_dtype)
    assert not bool(ov), "Pallas window overflow at test size"
    return np.asarray(out)


def _case(plane, interpolation, bg_mode, flags, rotation=0.0, **lens):
    cfg, dyn, pcfg, pdyn, mats, img = make_case(plane, interpolation=interpolation,
                                                background_mode=bg_mode, flags=flags, fov=1.1,
                                                **lens)
    if rotation:
        cfg, pcfg = cfg._replace(input_rotation=rotation), pcfg._replace(input_rotation=rotation)
    return cfg, dyn, pcfg, pdyn, mats, img


# (plane, interpolation, background mode, flags, input rotation in degrees)
JAX_CASES = [
    ("Y", 8, 0, HORIZONTAL_RS | FIX_COLOR_RANGE, 0.0),
    ("UV", 4, 1, HAS_IBIS_DATA, 0.0),
    ("Y", 2, 2, 0, 3.0),
]


@pytest.mark.parametrize("plane,interpolation,bg_mode,flags,rotation", JAX_CASES)
def test_fused_vs_pallas_fused(plane, interpolation, bg_mode, flags, rotation):
    cfg, dyn, pcfg, pdyn, mats, img = _case(plane, interpolation, bg_mode, flags, rotation)
    assert tremap.use_fused(pcfg, torch.from_numpy(mats))
    want = _jax_fused(cfg, dyn, mats, img)
    got = _port(pcfg, pdyn, mats, img, fused=True)
    assert got.shape == want.shape == (cfg.out_buffer[1], cfg.out_buffer[0], img.shape[2])
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("model,digital", [("sony", None), ("opencv_fisheye", "gopro_superview")])
def test_fused_vs_pallas_fused_other_lens(model, digital):
    """A main model other than fisheye, and a digital lens on a fisheye base:
    the fused kernel's any-lens instantiation (csrc/fused.cu)."""
    cfg, dyn, pcfg, pdyn, mats, img = _case("Y", 8, 0, 0, **lens_kw(model, digital))
    assert tremap.use_fused(pcfg, torch.from_numpy(mats))
    want = _jax_fused(cfg, dyn, mats, img)
    got = _port(pcfg, pdyn, mats, img, fused=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL
    np.testing.assert_array_equal(got, _port(pcfg, pdyn, mats, img, fused=False))


def test_fused_uint16_vs_pallas_fused():
    """uint16 in and out on the UV plane with lanczos4 and mirror edges. The
    JAX side gets the same codes as float32 (its remap casts on entry)."""
    cfg, dyn, pcfg, pdyn, mats, img = _case("UV", 8, 2, FIX_COLOR_RANGE)
    img16 = np.rint(img).astype(np.uint16)
    want = _jax_fused(cfg, dyn, mats, img16.astype(np.float32), out_dtype="uint16")
    got = _port(pcfg, pdyn, mats, img16, fused=True, out_dtype="uint16")
    assert got.dtype == np.uint16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= U16_TOL


@pytest.mark.parametrize("plane,interpolation,bg_mode,flags,rotation", [
    ("Y", 8, 0, 0, 0.0), ("UV", 8, 0, 0, 0.0), ("Y", 2, 1, 0, 0.0), ("UV", 4, 2, 0, 0.0),
    ("Y", 4, 2, HORIZONTAL_RS, 0.0), ("UV", 2, 1, HAS_IBIS_DATA, 0.0),
    ("Y", 8, 1, FIX_COLOR_RANGE, -5.0), ("UV", 8, 2, 0, 90.0)])
def test_fused_equals_split_on_cpu(plane, interpolation, bg_mode, flags, rotation):
    """The plain fused route and the plain split route give the same bits,
    in float32 and through the uint16 cast."""
    _, _, pcfg, pdyn, mats, img = _case(plane, interpolation, bg_mode, flags, rotation)
    img16 = np.rint(img).astype(np.uint16)
    for src, out_dtype in ((img, "f32"), (img16, "uint16")):
        a = _port(pcfg, pdyn, mats, src, fused=True, out_dtype=out_dtype)
        b = _port(pcfg, pdyn, mats, src, fused=False, out_dtype=out_dtype)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("interpolation,bg_mode,rows", [(11, 0, None), (8, 3, None), (8, 0, 1)])
def test_gated_planes_take_the_split_path(monkeypatch, interpolation, bg_mode, rows):
    """EWA, background mode 3 and a single matrix row: use_fused says no and
    remap_plane_cuda(fused=True) never reaches the fused wrapper."""
    _, _, pcfg, pdyn, mats, img = _case("Y", interpolation, bg_mode, 0)
    if interpolation in tremap.EWA_BC:
        p, q = tremap.ewa_coeffs(interpolation)
        pdyn = pdyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                             ewa_coeffs_q=np.asarray(q, np.float32))
    mats = mats[:rows] if rows else mats
    assert not tremap.use_fused(pcfg, torch.from_numpy(mats))

    def refuse(*a, **k):
        raise AssertionError("the fused kernel was called for a gated plane")

    monkeypatch.setattr(cuda_fused, "remap_fused", refuse)
    a = _port(pcfg, pdyn, mats, img, fused=True)
    b = _port(pcfg, pdyn, mats, img, fused=False)
    np.testing.assert_array_equal(a, b)


def test_fused_wrapper_refuses_gated_planes():
    _, dyn, pcfg, pdyn, mats, img = _case("Y", 8, 3, 0)
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="split path"):
        cuda_fused.remap_fused(torch.from_numpy(img), x, x, torch.zeros(4, 4, dtype=torch.int32),
                               torch.from_numpy(mats), pcfg, pdyn, (0.0,), MAXV)


def test_guard_orders():
    """sample_taps after guard(u - offset) (split) and after guard(u) - offset
    (fused): equal for coordinates inside the clip, different only outside
    it or for non-finite values."""
    img = torch.from_numpy(make_case("Y")[5])
    H, W = img.shape[:2]
    bg = torch.tensor([102.3])
    inside = torch.tensor([-40.0, -3.2, 0.0, 5.51, 37.25, W + 10.4, 32768.0, -32765.0])
    outside = torch.tensor([float("nan"), float("inf"), -float("inf"), 32770.5, -40000.0])
    for interpolation in (2, 4, 8):
        off = tremap.INTERP_INFO[interpolation]["offset"]

        def both(u):
            v = torch.full_like(u, H / 2.0)
            split = tremap.sample_taps(img, tremap._guard_uv(u - off), tremap._guard_uv(v - off),
                                       bg, (0, 0, W, H), interpolation, MAXV)
            fused = tremap.sample_taps(img, tremap._guard_uv(u) - off, tremap._guard_uv(v) - off,
                                       bg, (0, 0, W, H), interpolation, MAXV)
            return split, fused

        np.testing.assert_array_equal(*[t.numpy() for t in both(inside)])
        cu_split = tremap._guard_uv(outside - off)
        cu_fused = tremap._guard_uv(outside) - off
        assert not torch.equal(cu_split, cu_fused) or off == 0.0
