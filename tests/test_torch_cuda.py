"""gyroflow_torch's CUDA kernels against their plain torch versions, on a card.

Every test here needs a CUDA card and nvcc (the kernels build from
gyroflow_torch/csrc at first use); each skips where torch sees no card. The
file imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version get the same inputs on the card. Both are built to
round op by op (nvcc --fmad=false, IEEE division and sqrt), so the limits
are tight: 1e-4 px for coordinates, 1e-3 of a code for samples (summation of
the same products in the same order), and 0 codes after the uint16 cast.
"""
import math

import numpy as np
import pytest
import torch

from chip_smoke import LENS_DLP, LENS_K, lenses   # chip_smoke.py phase 8's lenses
from chip_smoke import make_sony_manager          # chip_smoke.py phase 9's Sony clip
from gyroflow_torch.ops import cuda_coords, cuda_ewa, cuda_fused, cuda_overlay, cuda_sampler
from gyroflow_torch.ops import distortion_models as tdm
from gyroflow_torch.ops import remap
from gyroflow_torch.ops.kernel_params import (ANY_UNDERWATER, DRAWING_ENABLED, FIX_COLOR_RANGE,
                                              FRAMEBUFFER_INVERTED, HAS_DIGITAL_LENS,
                                              HAS_FPD_DATA, HAS_IBIS_DATA, HAS_MESH_DATA,
                                              HAS_OUTPUT_RECT, HAS_SOURCE_RECT, HORIZONTAL_RS,
                                              KernelConfig, KernelDynamics, dyn_to_torch)

pytestmark = pytest.mark.cuda

W, H = 160, 96
F = (W * 0.62, W * 0.62)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mats(fov, ibis=False, w=W, h=H):
    f = w * 0.62
    new_k = np.array([[f / fov, 0, w / 2], [0, f / fov, h / 2], [0, 0, 1.0]])
    rows = []
    for i in range(h):
        rx, ry, rz = 0.012 + 4e-4 * i, -0.018, 0.006
        cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                                  math.sin(ry), math.cos(rz), math.sin(rz))
        r = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
             @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
             @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
        r[0, 1] *= -1; r[0, 2] *= -1; r[1, 0] *= -1; r[2, 0] *= -1
        tail = [0.3, -0.2, 0.002, 0.1, 0.05] if ibis else [0.0] * 5
        rows.append(list(np.linalg.inv(new_k @ r).flatten()) + tail)
    return np.asarray(rows, np.float32)


def _case(plane="Y", flags=0, background_mode=0, fov=1.05, interpolation=8, lrc=1.0,
          ewa_ref_jac=False, w=W, h=H):
    cfg = KernelConfig(width=w, height=h, output_width=w, output_height=h,
                       interpolation=interpolation, background_mode=background_mode,
                       flags=flags | (ANY_UNDERWATER if lrc != 1.0 else 0),
                       ewa_ref_jac=ewa_ref_jac)
    c = 1
    if plane == "UV":
        cfg = cfg._replace(plane_index=1, source_rect=(0, 0, w // 2, h // 2),
                           output_rect=(0, 0, w // 2, h // 2), out_size=(w // 2, h // 2),
                           flags=cfg.flags | HAS_SOURCE_RECT | HAS_OUTPUT_RECT)
        c = 2
    dyn = KernelDynamics.make(f=(w * 0.62, w * 0.62), c=(w / 2, h / 2),
                              k=[0.25, -0.07, 0.02, -0.003], fov=fov,
                              background=(0.1, 0.5, 0.2, 1.0), background_margin=0.1,
                              background_margin_feather=0.05, light_refraction_coefficient=lrc,
                              max_pixel_value=1023.0, pixel_value_limit=1023.0)
    if interpolation in remap.EWA_BC:
        p, q = remap.ewa_coeffs(interpolation)
        dyn = dyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                           ewa_coeffs_q=np.asarray(q, np.float32))
    ow, oh = cfg.out_buffer
    rng = np.random.default_rng(0)
    img = rng.integers(0, 1024, (oh, ow, c)).astype(np.uint16)
    return cfg, dyn, _mats(fov, ibis=bool(flags & HAS_IBIS_DATA), w=w, h=h), img


def _coords_inputs(cfg, dyn, mats, dev):
    dt = dyn_to_torch(dyn, dev)
    ow, oh = cfg.out_buffer
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    factor = torch.clamp_min(1.0 - dt.lens_correction_amount, 0.001)
    out_f = (dt.f[0] / dt.fov / factor, dt.f[1] / dt.fov / factor)
    m = torch.from_numpy(mats).to(dev)
    x, y, idx = remap.coords_pre(ox, oy, m, cfg, dt, (W / 2.0, H / 2.0), out_f)
    return x, y, idx, m


@pytest.mark.parametrize("plane,flags,lrc", [("Y", 0, 1.0), ("UV", 0, 1.0),
                                             ("Y", HAS_IBIS_DATA, 1.0), ("Y", 0, 1.33)])
def test_coords_kernel_vs_plain(dev, plane, flags, lrc):
    cfg, dyn, mats, _ = _case(plane, flags=flags, lrc=lrc)
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    n0 = cuda_coords.project.launches
    uk, vk, valk = cuda_coords.project(x, y, idx, m, cfg, dyn)
    up, vp, valp = cuda_coords.project_plain(x, y, idx, m, cfg, dyn)
    torch.cuda.synchronize()
    assert cuda_coords.project.launches == n0 + 1
    assert torch.equal(valk, valp)
    assert float((uk - up).abs()[valk].max()) <= 1e-4
    assert float((vk - vp).abs()[valk].max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("interpolation", [2, 4, 8])
def test_sampler_kernel_vs_plain(dev, dtype, c, interpolation):
    rng = np.random.default_rng(c * 10 + interpolation)
    img = torch.from_numpy(rng.uniform(0, 250, (70, 90, c)).astype(np.float32)).to(dtype).to(dev)
    u = torch.from_numpy(rng.uniform(-6, 96, (40, 64)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(-6, 76, (40, 64)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(size=(40, 64)) > 0.2).to(dev)
    bg = tuple(float(b) for b in rng.uniform(0, 250, c))
    rect = (3, 2, 81, 64)
    n0 = cuda_sampler.sample.launches
    k = cuda_sampler.sample(img, u, v, valid, bg, rect, interpolation, 240.0)
    p = cuda_sampler.sample_plain(img, u, v, valid, bg, rect, interpolation, 240.0)
    torch.cuda.synchronize()
    assert cuda_sampler.sample.launches == n0 + 1
    assert k.shape == (40, 64, c) and k.dtype == torch.float32
    assert float((k - p).abs().max()) <= 1e-3


# ---- the tap loop's two paths (taps.cuh): aligned row loads for stencils
# inside the plane and the source rect, the checked loop for the others ----

# planes whose rows are not a whole number of 16-byte chunks
TAP_PLANES = [(torch.uint16, 1, 8), (torch.uint16, 2, 8), (torch.float32, 1, 8),
              (torch.uint8, 4, 8), (torch.uint16, 2, 4)]
PW, PH = 203, 61


def _warp_uv(oh, ow, rotation, zoom, w, h):
    """u, v of an output grid rotated by `rotation` rad and zoomed by `zoom`
    about the plane's centre (0.5: the output covers twice the plane)."""
    oy, ox = np.mgrid[0:oh, 0:ow].astype(np.float64)
    dx, dy = (ox - ow / 2.0) / zoom, (oy - oh / 2.0) / zoom
    c, s = math.cos(rotation), math.sin(rotation)
    return ((c * dx - s * dy + w / 2.0).astype(np.float32),
            (s * dx + c * dy + h / 2.0).astype(np.float32))


def _plane(dev, dtype, c, h, w, seed, offset=0):
    """A (h, w, c) plane of random codes; with offset > 0, a contiguous view
    that starts `offset` elements into its buffer."""
    rng = np.random.default_rng(seed)
    n = h * w * c
    buf = rng.uniform(0, 250, offset + n).astype(np.float32)
    return torch.from_numpy(buf).to(dtype).to(dev)[offset:].view(h, w, c)


def _hold_to_plain(img, u, v, valid, bg, rect, taps):
    n0 = cuda_sampler.sample.launches
    k = cuda_sampler.sample(img, u, v, valid, bg, rect, taps, 240.0)
    p = cuda_sampler.sample_plain(img, u, v, valid, bg, rect, taps, 240.0)
    torch.cuda.synchronize()
    assert cuda_sampler.sample.launches == n0 + 1
    assert k.shape == u.shape + (img.shape[2],) and bool(torch.isfinite(k).all())
    # the same arithmetic in the same order: 0 codes apart (ceiling 1e-3)
    assert float((k - p).abs().max()) == 0.0


@pytest.mark.parametrize("zoom", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("rotation", [-0.3, 0.3])
@pytest.mark.parametrize("dtype,c,taps", TAP_PLANES)
def test_sampler_tap_paths_warp_maps(dev, dtype, c, taps, rotation, zoom):
    """Rotated and zoomed maps over a plane whose row is not a multiple of
    16 bytes: interior stencils at every alignment, edge stencils around."""
    img = _plane(dev, dtype, c, PH, PW, seed=c * 100 + taps)
    u, v = (torch.from_numpy(a).to(dev) for a in _warp_uv(57, 190, rotation, zoom, PW, PH))
    valid = torch.ones(u.shape, dtype=torch.bool, device=dev)
    bg = tuple(float(b) for b in np.linspace(20.0, 200.0, c))
    _hold_to_plain(img, u, v, valid, bg, (4, 3, PW - 9, PH - 7), taps)


@pytest.mark.parametrize("case", ["odd_offset", "rect_outside", "left", "right", "top",
                                  "bottom", "non_finite", "narrow"])
@pytest.mark.parametrize("dtype,c,taps", TAP_PLANES)
def test_sampler_tap_paths_edges(dev, dtype, c, taps, case):
    """The edge between the two paths: a plane that is a view at an odd
    element offset, a source rect partly outside the plane, stencils that
    straddle each of the plane's four edges, non-finite u/v, and a plane
    narrower than 8 px."""
    rng = np.random.default_rng(7)
    h, w, offset = PH, PW, 0
    rect = (0, 0, PW, PH)
    oh, ow = 40, 64
    u = rng.uniform(-6, w + 6, (oh, ow))
    v = rng.uniform(-6, h + 6, (oh, ow))
    if case == "odd_offset":
        offset = 1
        u, v = _warp_uv(oh, ow, 0.1, 0.8, w, h)
    elif case == "rect_outside":
        rect = (-5, -3, w - 10, h + 10)
        u, v = _warp_uv(oh, ow, 0.2, 0.6, w, h)
    elif case == "left":
        u = rng.uniform(-9, 9, (oh, ow))
    elif case == "right":
        u = rng.uniform(w - 9, w + 9, (oh, ow))
    elif case == "top":
        v = rng.uniform(-9, 9, (oh, ow))
    elif case == "bottom":
        v = rng.uniform(h - 9, h + 9, (oh, ow))
    elif case == "non_finite":
        u, v = _warp_uv(oh, ow, 0.1, 1.0, w, h)
        u[0, :4] = [np.nan, np.inf, -np.inf, 1e30]
        v[1, :4] = [np.inf, np.nan, -1e30, -np.inf]
        u[2, :2] = [40000.0, -40000.0]
    elif case == "narrow":
        w, rect = 5, (0, 0, 5, PH)
        u = rng.uniform(-6, 11, (oh, ow))
    img = _plane(dev, dtype, c, h, w, seed=c * 100 + taps + 1, offset=offset)
    assert img.storage_offset() == offset and img.is_contiguous()
    u, v = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (u, v))
    valid = torch.from_numpy(rng.uniform(size=(oh, ow)) > 0.1).to(dev)
    bg = tuple(float(b) for b in np.linspace(20.0, 200.0, c))
    _hold_to_plain(img, u, v, valid, bg, rect, taps)


def _warp_fused_case(plane, rotation, zoom):
    """A PW x PH frame (rows not a multiple of 16 bytes) whose RS matrices
    roll the camera by `rotation` rad about its axis, with fov = 1 / zoom."""
    f = (PW * 0.62, PW * 0.62)
    fov = 1.0 / zoom
    new_k = np.array([[f[0] / fov, 0, PW / 2], [0, f[1] / fov, PH / 2], [0, 0, 1.0]])
    c, s = math.cos(rotation), math.sin(rotation)
    rows = []
    for i in range(PH):
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ np.array(
            [[1, 0, 0], [0, math.cos(2e-4 * i), -math.sin(2e-4 * i)],
             [0, math.sin(2e-4 * i), math.cos(2e-4 * i)]])
        rows.append(list(np.linalg.inv(new_k @ r).flatten()) + [0.0] * 5)
    cfg = KernelConfig(width=PW, height=PH, output_width=PW, output_height=PH, interpolation=8)
    ch = 1
    if plane == "UV":
        half = (PW // 2, PH // 2)
        cfg = cfg._replace(plane_index=1, source_rect=(0, 0, *half), output_rect=(0, 0, *half),
                           out_size=half, flags=HAS_SOURCE_RECT | HAS_OUTPUT_RECT)
        ch = 2
    dyn = KernelDynamics.make(f=f, c=(PW / 2, PH / 2), k=[0.25, -0.07, 0.02, -0.003], fov=fov,
                              background=(0.1, 0.5, 0.2, 1.0), max_pixel_value=1023.0,
                              pixel_value_limit=1023.0)
    ow, oh = cfg.out_buffer
    img = np.random.default_rng(3).integers(0, 1024, (oh, ow, ch)).astype(np.uint16)
    return cfg, dyn, np.asarray(rows, np.float32), img


@pytest.mark.parametrize("zoom", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("rotation", [-0.3, 0.3])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_fused_tap_paths_warp_maps(dev, plane, rotation, zoom):
    """The same warp maps through the fused kernel: one fused launch and the
    split kernels' uint16 output, 0 codes apart."""
    cfg, dyn, mats, img = _warp_fused_case(plane, rotation, zoom)
    timg = torch.from_numpy(img).to(dev)
    m = torch.from_numpy(mats).to(dev)
    assert remap.use_fused(cfg, m)
    n = cuda_fused.remap_fused.launches
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16", fused=True)
    assert cuda_fused.remap_fused.launches == n + 1
    split = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    assert got.dtype == torch.uint16 and torch.equal(got, split)


@pytest.mark.parametrize("bg_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_remap_plane_cuda_vs_plain(dev, plane, bg_mode):
    cfg, dyn, mats, img = _case(plane, background_mode=bg_mode)
    timg = torch.from_numpy(img).to(dev)
    m = torch.from_numpy(mats).to(dev)
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    want = remap.remap_plane(timg, m, cfg, dyn, out_dtype="uint16")
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    assert torch.equal(got, want)


def test_kernels_raise_instead_of_falling_back(dev):
    cfg, dyn, mats, img = _case("Y")
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    with pytest.raises(ValueError, match="no mesh buffer"):
        cuda_coords.project(x, y, idx, m, cfg._replace(flags=HAS_MESH_DATA, mesh_grid=(9, 9)),
                            dyn)
    with pytest.raises(TypeError):
        cuda_sampler.sample(torch.zeros(8, 8, 1, dtype=torch.int32, device=dev), x, y,
                            x > 0, (0.0,), (0, 0, 8, 8), 8, 1.0)
    x3 = torch.cat([x, x, x])
    with pytest.raises(TypeError):
        cuda_ewa.sample(torch.zeros(8, 8, 1, dtype=torch.int32, device=dev), x, y, x3, x3,
                        x3 > 0, (0.0,), (0, 0, 8, 8), remap.ewa_coeffs(11), 1.0)


# ---- the EWA kernel: stacked evals in, the Jacobian formed in the kernel ----

EWA_EPS = np.float32(remap.EWA_EPS)


def _stacked_evals(rng, u, v, jac, p_invalid=0.05):
    """(u3, v3, valid3) as numpy (3*oh, ow): the base eval (u, v) and +eps
    evals whose differences make the Jacobian jac (du/dx, du/dy, dv/dx,
    dv/dy); a share p_invalid of the +eps evals is not valid, which the
    Jacobian reads as source point 0 (a spike of ~100x the coordinates)."""
    u3 = np.concatenate([u, u + EWA_EPS * jac[..., 0], u + EWA_EPS * jac[..., 1]])
    v3 = np.concatenate([v, v + EWA_EPS * jac[..., 2], v + EWA_EPS * jac[..., 3]])
    valid3 = rng.uniform(size=u3.shape) > p_invalid
    return u3.astype(np.float32), v3.astype(np.float32), valid3


def _ewa_inputs(dev, dtype, c, seed, h=70, w=90, offset=0, oh=40, ow=64, margin=6.0):
    """Noisy content, u/v across the plane's edges (margin px beyond them),
    and Jacobians that mix magnification, |J| ~ 3 minification and
    near-singular matrices, as stacked evals. Returns img, u, v, u3, v3,
    valid3 (the sampling positions u, v are the base eval's rows) and bg."""
    rng = np.random.default_rng(seed)
    img = _plane(dev, dtype, c, h, w, seed, offset)
    u = rng.uniform(-margin, w + margin, (oh, ow)).astype(np.float32)
    v = rng.uniform(-margin, h + margin, (oh, ow)).astype(np.float32)
    jac = np.asarray([1.0, 0.0, 0.0, 1.0]) + rng.normal(0.0, 0.35, (oh, ow, 4))
    jac[:oh // 4] *= 3.0
    a, b = rng.normal(0.0, 1.5, (2, oh // 4, ow))
    jac[oh // 4:oh // 2] = np.stack([a, b, 0.7 * a, 0.7 * b], -1) + \
        rng.normal(0.0, 1e-3, (oh // 4, ow, 4))
    u3, v3, valid3 = _stacked_evals(rng, u, v, jac)
    valid3[:oh] = rng.uniform(size=(oh, ow)) > 0.2
    bg = tuple(float(b) for b in rng.uniform(0, 250, c))
    t = [torch.from_numpy(a).to(dev) for a in (u3, v3, valid3)]
    return (img, t[0][:oh], t[1][:oh], *t, bg)


def _hold_ewa_to_plain(img, u, v, u3, v3, valid3, bg, rect, interpolation=11, mask=None):
    """The kernel against sample_plain on the same inputs: one launch, and
    the same bits (over ``mask`` where given)."""
    coeffs = tuple(tuple(float(x) for x in np.asarray(k, np.float32))
                   for k in remap.ewa_coeffs(interpolation))
    n0 = cuda_ewa.sample.launches
    k = cuda_ewa.sample(img, u, v, u3, v3, valid3, bg, rect, coeffs, 240.0)
    p = cuda_ewa.sample_plain(img, u, v, u3, v3, valid3, bg, rect, coeffs, 240.0)
    torch.cuda.synchronize()
    assert cuda_ewa.sample.launches == n0 + 1
    assert k.shape == u.shape + (img.shape[2],) and k.dtype == torch.float32
    if mask is not None:
        k, p = k[mask], p[mask]
    assert bool(torch.isfinite(k).all())
    assert torch.equal(k, p)


@pytest.mark.parametrize("dtype,c,interpolation", [
    *[(dt, c, 11) for dt in (torch.uint8, torch.uint16, torch.float32) for c in (1, 2, 3, 4)],
    (torch.uint16, 1, 10), (torch.uint16, 1, 12), (torch.uint16, 1, 13)])
def test_ewa_kernel_vs_plain(dev, dtype, c, interpolation):
    img, u, v, u3, v3, valid3, bg = _ewa_inputs(dev, dtype, c, seed=c * 10 + interpolation)
    _hold_ewa_to_plain(img, u, v, u3, v3, valid3, bg, (3, 2, 81, 64), interpolation)


EWA_PLANES = [(torch.uint16, 1), (torch.uint16, 2), (torch.uint8, 4), (torch.float32, 1),
              (torch.uint8, 3)]


@pytest.mark.parametrize("case", ["interior", "left", "right", "top", "bottom",
                                  "rect_inside", "rect_outside", "odd_offset", "narrow"])
@pytest.mark.parametrize("dtype,c", EWA_PLANES)
def test_ewa_kernel_stencil_paths(dev, dtype, c, case):
    """The interior path (every clipped tap inside the plane and the source
    rect: no clamps, no background) and the checked path: stencils wholly
    inside, across each of the plane's edges, across a source rect inside
    the plane and one partly outside it, a plane that is a view at an odd
    element offset, and a plane narrower than the stencil."""
    rng = np.random.default_rng(11)
    h, w, offset, oh, ow = PH, PW, 0, 40, 64
    rect = (0, 0, PW, PH)
    u, v = _warp_uv(oh, ow, 0.2, 0.7, w, h)
    if case == "left":
        u = rng.uniform(-9, 9, (oh, ow))
    elif case == "right":
        u = rng.uniform(w - 9, w + 9, (oh, ow))
    elif case == "top":
        v = rng.uniform(-9, 9, (oh, ow))
    elif case == "bottom":
        v = rng.uniform(h - 9, h + 9, (oh, ow))
    elif case == "rect_inside":
        rect = (17, 9, w - 40, h - 25)
    elif case == "rect_outside":
        rect = (-5, -3, w - 10, h + 10)
    elif case == "odd_offset":
        offset = 1
    elif case == "narrow":
        w, rect = 5, (0, 0, 5, PH)
        u = rng.uniform(-6, 11, (oh, ow))
    img = _plane(dev, dtype, c, h, w, seed=c * 100 + 7, offset=offset)
    assert img.storage_offset() == offset and img.is_contiguous()
    u, v = np.asarray(u, np.float32), np.asarray(v, np.float32)
    # near-identity Jacobians of the warp's scale, so most stencils are small
    jac = np.asarray([1.0 / 0.7, 0.0, 0.0, 1.0 / 0.7]) + rng.normal(0.0, 0.1, (oh, ow, 4))
    u3, v3, valid3 = (torch.from_numpy(a).to(dev) for a in _stacked_evals(rng, u, v, jac, 0.02))
    bg = tuple(float(b) for b in np.linspace(20.0, 200.0, c))
    _hold_ewa_to_plain(img, u3[:oh], v3[:oh], u3, v3, valid3, bg, rect)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewa_kernel_extreme_evals(dev, seed):
    """Random stacked evals: +eps evals scattered up to 40 px from the base
    (Jacobians up to ~4000), a fifth of them not valid, and base evals on
    integer and half-integer positions: elongated, degenerate and huge
    ellipses, all clipped to the 10x10 stencil."""
    rng = np.random.default_rng(seed)
    oh, ow = 48, 64
    img = _plane(dev, torch.uint16, 2, PH, PW, seed=seed)
    u = rng.uniform(-12, PW + 12, (oh, ow)).astype(np.float32)
    v = rng.uniform(-12, PH + 12, (oh, ow)).astype(np.float32)
    u[:4], v[:4] = np.round(u[:4]), np.round(v[:4]) + 0.5
    u3 = np.concatenate([u] + [u + rng.normal(0, s, u.shape) for s in (0.02, 40.0)])
    v3 = np.concatenate([v] + [v + rng.normal(0, s, v.shape) for s in (40.0, 0.02)])
    valid3 = rng.uniform(size=u3.shape) > 0.2
    u3, v3, valid3 = (torch.from_numpy(np.asarray(a)).to(dev)
                      for a in (u3.astype(np.float32), v3.astype(np.float32), valid3))
    _hold_ewa_to_plain(img, u3[:oh], v3[:oh], u3, v3, valid3, (30.0, 90.0), (2, 3, PW - 6, PH - 4),
                       interpolation=10 + seed)


def _nan_bbox(u3, v3, valid3):
    """Pixels whose reference bbox has a NaN edge: remap._floor_i32 casts
    that NaN to int32, which torch leaves undefined."""
    jx, jy, jz, jw = remap.ewa_jacobian(u3, v3, valid3)[3].unbind(-1)
    tx = torch.maximum((jx + jy).abs(), (jx - jy).abs())
    ty = torch.maximum((jz + jw).abs(), (jz - jw).abs())
    return tx.isnan() | ty.isnan()


def test_ewa_kernel_non_finite_evals(dev):
    """inf, -inf, NaN and +-1e30 in the evals of valid pixels: in the +eps
    evals' u and v, in the base eval, and in pairs that make inf - inf. The
    kernel's clamps keep NaN as torch's do (fmaxf alone would turn a NaN dr
    into the weight p[0]). Pixels whose bbox edge is NaN are left out: the
    plain version casts that NaN to int32, which torch leaves undefined."""
    rng = np.random.default_rng(5)
    oh, ow = 24, 32
    img = _plane(dev, torch.uint16, 1, PH, PW, seed=5)
    u, v = (a[:oh, :ow] for a in _warp_uv(oh, ow, 0.1, 0.9, PW, PH))
    jac = np.asarray([1.1, 0.0, 0.0, 1.1]) + rng.normal(0.0, 0.05, (oh, ow, 4))
    u3, v3, valid3 = _stacked_evals(rng, u, v, jac, 0.0)
    bad = [np.inf, -np.inf, np.nan, 1e30, -1e30]
    for j, x in enumerate(bad):
        u3[oh + j, :8] = x             # +eps in x, u
        v3[2 * oh + j, 8:16] = x       # +eps in y, v
        u3[2 * oh + j, 16:24] = x      # +eps in y, u
        u3[j + 5, 24:] = x             # the base eval
    u3[oh + 10, :8], u3[2 * oh + 10, :8] = np.inf, -np.inf      # jx + jy = inf - inf
    v3[oh + 11, :8], v3[2 * oh + 11, :8] = 1e30, -1e30
    u3, v3, valid3 = (torch.from_numpy(a).to(dev) for a in (u3, v3, valid3))
    keep = ~_nan_bbox(u3, v3, valid3)
    assert int((~keep).sum()) > 0 and int(keep.sum()) > oh * ow // 2
    _hold_ewa_to_plain(img, u3[:oh], v3[:oh], u3, v3, valid3, (50.0,), (0, 0, PW, PH),
                       mask=keep)


def test_ewa_kernel_positions_apart_from_the_base_eval(dev):
    """Background mode 3 samples at positions that are not the base eval's
    (the feather's second sample), with the base eval's Jacobian."""
    img, _, _, u3, v3, valid3, bg = _ewa_inputs(dev, torch.uint16, 2, seed=21)
    oh = u3.shape[0] // 3
    u = ((u3[:oh] / 90.0 - 0.5) * 0.8 + 0.5) * 90.0
    v = ((v3[:oh] / 70.0 - 0.5) * 0.8 + 0.5) * 70.0
    _hold_ewa_to_plain(img, u.contiguous(), v.contiguous(), u3, v3, valid3, bg, (3, 2, 81, 64))


@pytest.mark.parametrize("ref_jac", [False, True])
@pytest.mark.parametrize("bg_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_remap_plane_cuda_ewa_vs_plain(dev, plane, bg_mode, ref_jac):
    cfg, dyn, mats, img = _case(plane, background_mode=bg_mode, interpolation=11,
                                ewa_ref_jac=ref_jac)
    timg = torch.from_numpy(img).to(dev)
    m = torch.from_numpy(mats).to(dev)
    n_coords = (cuda_coords.project_gen.launches, cuda_coords.project.launches)
    n_ewa = cuda_ewa.sample.launches
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    # one launch of the stacked evals per plane (the fisheye: the gen
    # kernel's EWA form); one EWA launch per sample
    assert (cuda_coords.project_gen.launches, cuda_coords.project.launches) == \
        (n_coords[0] + 1, n_coords[1])
    assert cuda_ewa.sample.launches == n_ewa + (2 if bg_mode == 3 else 1)
    want = remap.remap_plane(timg, m, cfg, dyn, out_dtype="uint16")
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    assert torch.equal(got, want)


def test_ewa_jacobian_scale_is_torchs(dev):
    """The kernel scales the Jacobian by 1 / EWA_EPS as torch divides by a
    Python scalar on the card (a multiply by the float32 reciprocal):
    checked on differences across the float range."""
    rng = np.random.default_rng(9)
    d = torch.from_numpy(np.concatenate([rng.normal(0, s, 4096) for s in (1e-3, 1.0, 1e3)])
                         .astype(np.float32)).to(dev)
    assert torch.equal(d / remap.EWA_EPS, d * cuda_ewa._INV_EPS)


FUSED_CASES = [("Y", 8, 0, 0, 0.0), ("UV", 8, 0, 0, 0.0), ("Y", 4, 1, HAS_IBIS_DATA, 0.0),
               ("UV", 2, 2, HORIZONTAL_RS, 0.0), ("Y", 8, 2, FIX_COLOR_RANGE, 3.0),
               ("UV", 8, 1, 0, -90.0)]


def _fused_case(plane, interpolation, bg_mode, flags, rotation):
    cfg, dyn, mats, img = _case(plane, flags=flags, background_mode=bg_mode,
                                interpolation=interpolation)
    return cfg._replace(input_rotation=rotation), dyn, mats, img


@pytest.mark.parametrize("plane,interpolation,bg_mode,flags,rotation", FUSED_CASES)
def test_fused_kernel_vs_plain(dev, plane, interpolation, bg_mode, flags, rotation):
    cfg, dyn, mats, img = _fused_case(plane, interpolation, bg_mode, flags, rotation)
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    timg = torch.from_numpy(img).to(dev)
    bg = tuple(float(b) * 1023.0 for b in np.asarray(dyn.background)[:img.shape[2]])
    n0 = cuda_fused.remap_fused.launches
    k = cuda_fused.remap_fused(timg, x, y, idx, m, cfg, dyn, bg, 1023.0)
    p = cuda_fused.remap_fused_plain(timg, x, y, idx, m, cfg, dyn, bg, 1023.0)
    torch.cuda.synchronize()
    assert cuda_fused.remap_fused.launches == n0 + 1
    assert k.shape == p.shape == idx.shape + (img.shape[2],)
    assert float((k - p).abs().max()) <= 1e-3


@pytest.mark.parametrize("plane,interpolation,bg_mode,flags,rotation", FUSED_CASES)
def test_remap_plane_cuda_fused_vs_split(dev, plane, interpolation, bg_mode, flags, rotation):
    """fused=True: one fused launch and no coords or sampler launch; the
    same uint16 output as the split kernels and as the plain path."""
    cfg, dyn, mats, img = _fused_case(plane, interpolation, bg_mode, flags, rotation)
    timg = torch.from_numpy(img).to(dev)
    m = torch.from_numpy(mats).to(dev)
    n = (cuda_fused.remap_fused.launches, cuda_coords.project.launches,
         cuda_sampler.sample.launches)
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16", fused=True)
    assert (cuda_fused.remap_fused.launches, cuda_coords.project.launches,
            cuda_sampler.sample.launches) == (n[0] + 1, n[1], n[2])
    split = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    plain = remap.remap_plane(timg, m, cfg, dyn, out_dtype="uint16")
    assert got.dtype == torch.uint16 and got.device.type == "cuda"
    assert torch.equal(got, split) and torch.equal(got, plain)


@pytest.mark.parametrize("plane,flags,out_rows,oy0,pos_dx", [
    ("Y", 0, None, 0, 0.0), ("UV", 0, None, 0, 0.01), ("Y", HORIZONTAL_RS, 40, 24, 0.0),
    ("Y", HAS_IBIS_DATA, 17, 3, 0.01)])
def test_coords_gen_kernel_vs_plain(dev, plane, flags, out_rows, oy0, pos_dx):
    cfg, dyn, mats, _ = _case(plane, flags=flags)
    m = torch.from_numpy(mats).to(dev)
    rows = out_rows or cfg.out_buffer[1]
    out_c = (W / 2.0, H / 2.0)
    out_f = (F[0] / 1.05, F[1] / 1.05)
    n0 = cuda_coords.project_gen.launches
    uk, vk, valk = cuda_coords.project_gen(cfg, dyn, m, rows, oy0, out_c, out_f, pos_dx=pos_dx)
    up, vp, valp = cuda_coords.project_gen_plain(cfg, dyn, m, rows, oy0, out_c, out_f,
                                                 pos_dx=pos_dx)
    torch.cuda.synchronize()
    assert cuda_coords.project_gen.launches == n0 + 1
    assert uk.shape == (rows, cfg.out_buffer[0])
    assert torch.equal(valk, valp) and bool(valk.any())
    assert float((uk - up).abs()[valk].max()) <= 1e-4
    assert float((vk - vp).abs()[valk].max()) <= 1e-4


# ---- every lens model and digital lens (csrc/lens.cuh) -----------------------

# each model as the main model, then each digital lens on the fisheye base
LENSES = lenses()


def _lens_case(plane, model, digital, lens_correction_amount=1.0, **kw):
    """_case with the lens (model, digital) and its coefficients."""
    cfg, dyn, mats, img = _case(plane, **kw)
    cfg = cfg._replace(distortion_model=model, digital_lens=digital,
                       flags=cfg.flags | (HAS_DIGITAL_LENS if digital else 0),
                       lens_correction=lens_correction_amount < 1.0)
    lens = KernelDynamics.make(k=LENS_K.get(model), digital_lens_params=LENS_DLP.get(digital or model),
                               lens_correction_amount=lens_correction_amount)
    dyn = dyn._replace(k=lens.k, digital_lens_params=lens.digital_lens_params,
                       lens_correction_amount=lens.lens_correction_amount)
    return cfg, dyn, mats, img


def _same_coords(k, p):
    """Valid masks identical, the same non-finite values, finite u and v
    within 0.01 px (the same float32 ops in the same order: 0 expected)."""
    (uk, vk, valk), (up, vp, valp) = k, p
    assert torch.equal(valk, valp)
    for a, b in ((uk, up), (vk, vp)):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.equal(a[~fin].isnan(), b[~fin].isnan())
        ok = valk & fin
        if bool(ok.any()):
            assert float((a - b).abs()[ok].max()) <= 0.01


@pytest.mark.parametrize("model,digital", LENSES)
def test_coords_kernel_every_lens_vs_plain(dev, model, digital):
    cfg, dyn, mats, _ = _lens_case("Y", model, digital)
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    n0 = cuda_coords.project.launches
    k = cuda_coords.project(x, y, idx, m, cfg, dyn)
    p = cuda_coords.project_plain(x, y, idx, m, cfg, dyn)
    torch.cuda.synchronize()
    assert cuda_coords.project.launches == n0 + 1
    _same_coords(k, p)


@pytest.mark.parametrize("model", list(tdm.MODEL_IDS))
def test_coords_gen_kernel_every_model_vs_plain(dev, model):
    cfg, dyn, mats, _ = _lens_case("Y", model, None, flags=HAS_IBIS_DATA)
    m = torch.from_numpy(mats).to(dev)
    out_c, out_f = (W / 2.0, H / 2.0), (F[0] / 1.05, F[1] / 1.05)
    n0 = cuda_coords.project_gen.launches
    k = cuda_coords.project_gen(cfg, dyn, m, 40, 20, out_c, out_f, pos_dx=0.01)
    p = cuda_coords.project_gen_plain(cfg, dyn, m, 40, 20, out_c, out_f, pos_dx=0.01)
    torch.cuda.synchronize()
    assert cuda_coords.project_gen.launches == n0 + 1
    _same_coords(k, p)


@pytest.mark.parametrize("model,digital", LENSES)
def test_remap_plane_cuda_fused_every_lens_vs_plain(dev, monkeypatch, model, digital):
    """fused=True: one fused launch (the any-lens instantiation for every
    lens but the plain fisheye), the uint16 frame within 1 code of the same
    route with the fused kernel's plain version (0 expected). Not the split
    path: where a lens's fixed point diverges (hyperview) the positions are
    non-finite, and the fused guard-then-offset order samples them apart
    from the split order (test_torch_fused.py::test_guard_orders)."""
    cfg, dyn, mats, img = _lens_case("UV", model, digital)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    n0 = cuda_fused.remap_fused.launches
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16", fused=True)
    assert cuda_fused.remap_fused.launches == n0 + 1
    monkeypatch.setattr(cuda_fused, "remap_fused", cuda_fused.remap_fused_plain)
    want = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16", fused=True)
    assert int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) <= 1


@pytest.mark.parametrize("model,digital,interpolation,lc", [
    *[(m, d, 8, 1.0) for m, d in LENSES],
    ("opencv_fisheye", "gopro_superview", 8, 0.5), ("sony", None, 11, 1.0),
    ("opencv_fisheye", "gopro_superview", 11, 0.5)])
def test_remap_plane_cuda_every_lens_vs_plain(dev, model, digital, interpolation, lc):
    """The split path (the coords kernel, then the sampler or EWA kernel),
    with the digital lens's un-zoom, warp and re-zoom in coords_pre where
    lens correction is on: the uint16 frame within 1 code of the plain path
    (0 expected)."""
    cfg, dyn, mats, img = _lens_case("Y", model, digital, lens_correction_amount=lc,
                                     interpolation=interpolation)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    want = remap.remap_plane(timg, m, cfg, dyn, out_dtype="uint16")
    assert int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) <= 1


def test_new_kernels_raise_instead_of_falling_back(dev):
    cfg, dyn, mats, img = _case("Y")
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    with pytest.raises(ValueError):
        cuda_coords.project_gen(cfg._replace(lens_correction=True), dyn, m, 8, 0, (0, 0), (1, 1))
    with pytest.raises(TypeError):
        cuda_fused.remap_fused(torch.zeros(8, 8, 1, dtype=torch.int32, device=dev), x, y, idx,
                               m, cfg, dyn, (0.0,), 1.0)


def test_cuda_tensors_never_reach_a_plain_version(dev, monkeypatch):
    """Every path on CUDA tensors (split, fused, EWA, the gen kernel) runs
    with the plain versions replaced by functions that raise."""
    def refuse(*a, **k):
        raise AssertionError("a plain version was called on the card")

    for mod, name in ((cuda_coords, "project_plain"), (cuda_coords, "project_gen_plain"),
                      (cuda_sampler, "sample_plain"), (cuda_ewa, "sample_plain"),
                      (cuda_fused, "remap_fused_plain"), (cuda_overlay, "overlay_plain")):
        monkeypatch.setattr(mod, name, refuse)
    for interpolation, fused in ((8, False), (8, True), (11, False)):
        cfg, dyn, mats, img = _case("UV", interpolation=interpolation)
        out = remap.remap_plane_cuda(torch.from_numpy(img).to(dev),
                                     torch.from_numpy(mats).to(dev), cfg, dyn,
                                     out_dtype="uint16", fused=fused)
        assert out.device.type == "cuda"
    for interpolation in (8, 11):     # mesh + FPD and the overlay
        cfg, dyn, mats, img, mesh = _mesh_case("Y", HAS_FPD_DATA, interpolation=interpolation)
        out = remap.remap_plane_cuda(torch.from_numpy(img).to(dev),
                                     torch.from_numpy(mats).to(dev),
                                     cfg._replace(flags=cfg.flags | DRAWING_ENABLED), dyn,
                                     mesh.to(dev), drawing=_drawing(), out_dtype="uint16")
        assert out.device.type == "cuda"
    cfg, dyn, mats, _ = _case("Y")
    u, _, _ = cuda_coords.project_gen(cfg, dyn, torch.from_numpy(mats).to(dev), H, 0,
                                      (W / 2.0, H / 2.0), (F[0], F[1]))
    torch.cuda.synchronize()
    assert u.device.type == "cuda"


# ---- the experiments' kernels (gyroflow_torch/experiments) -------------------

FUSED_BBOX_CASES = [("Y", 8, 0, 0, (16, 128)), ("UV", 4, 1, HAS_IBIS_DATA, (8, 32)),
                    ("Y", 2, 2, HORIZONTAL_RS, (16, 96))]


@pytest.mark.parametrize("plane,interpolation,bg_mode,flags,tile", FUSED_BBOX_CASES)
def test_fused_bbox_kernel_vs_plain(dev, plane, interpolation, bg_mode, flags, tile):
    from gyroflow_torch.experiments import fused_bbox as fb

    cfg, dyn, mats, img = _case(plane, flags=flags, background_mode=bg_mode,
                                interpolation=interpolation)
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    timg = torch.from_numpy(img.astype(np.float32)).to(dev)
    bg = tuple(float(b) * 1023.0 for b in np.asarray(dyn.background)[:img.shape[2]])
    n0 = fb.fused_bbox.launches
    k = fb.fused_bbox(timg, x, y, idx, m, cfg, dyn, bg, *tile)
    p = fb.fused_bbox_plain(timg, x, y, idx, m, cfg, dyn, bg, *tile)
    torch.cuda.synchronize()
    assert fb.fused_bbox.launches == n0 + 1
    assert k[0].shape == p[0].shape == idx.shape + (img.shape[2],)
    assert k[2].shape == (-(-idx.shape[0] // tile[0]), -(-idx.shape[1] // tile[1]), 4)
    assert torch.equal(k[0], p[0])
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[2], p[2])


def _ragged(t, oh, ow):
    """The top-left (oh, ow) of a map, contiguous."""
    return t[:oh, :ow].contiguous()


# (plane, output rows, output columns): no tile shape below divides them
FUSED_BBOX_RAGGED = [("Y", 90, 150), ("UV", 45, 75)]


@pytest.mark.parametrize("tile", [(16, 128), (8, 32), (16, 96)])
@pytest.mark.parametrize("plane,oh,ow", FUSED_BBOX_RAGGED)
def test_fused_bbox_paths_vs_plain(dev, plane, oh, ow, tile):
    """Ragged tiles at each of the three tile shapes, with stencils both
    wholly inside the source rect (the fast path) and across its edges (the
    checked loop): output, valid and bbox equal to the plain version's, and
    a second launch gives the same bits."""
    from gyroflow_torch.experiments import fused_bbox as fb

    cfg, dyn, mats, img = _case(plane, fov=1.2)
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    x, y, idx = (_ragged(t, oh, ow) for t in (x, y, idx))
    timg = torch.from_numpy(img.astype(np.float32)).to(dev)
    bg = tuple(float(b) * 1023.0 for b in np.asarray(dyn.background)[:img.shape[2]])
    k = fb.fused_bbox(timg, x, y, idx, m, cfg, dyn, bg, *tile)
    again = fb.fused_bbox(timg, x, y, idx, m, cfg, dyn, bg, *tile)
    p = fb.fused_bbox_plain(timg, x, y, idx, m, cfg, dyn, bg, *tile)
    torch.cuda.synchronize()
    u, v, valid = cuda_coords.project_plain(x, y, idx, m, cfg, dyn)
    u, v = remap.coords_post_uv(u, v, cfg)
    share = fb.fast_share(remap._guard_uv(u), remap._guard_uv(v), cfg, timg.shape)
    assert 0.0 < share < 1.0
    assert k[2].shape == (-(-oh // tile[0]), -(-ow // tile[1]), 4)
    for a, b, c in zip(k, p, again):
        assert torch.equal(a, b)
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert bool(valid.any())


def test_window_colsum_kernel_vs_plain(dev):
    from gyroflow_torch.experiments import perf_probe3 as p3

    img, cases = p3.inputs(dev, small=True)
    for align, Sc, y0, x0 in cases:
        n0 = p3.window_colsum.launches
        k = p3.window_colsum(img, y0, x0, p3.SR, Sc)
        p = p3.window_colsum_plain(img, y0, x0, p3.SR, Sc)
        torch.cuda.synchronize()
        assert p3.window_colsum.launches == n0 + 1
        assert k.shape == (y0.shape[0], Sc)
        assert torch.equal(k, p)


def _window_plane(H, W, dev, offset=0):
    """A seeded float32 (H, W) plane on dev whose first and last 3 rows and
    first 2 columns hold -0.0 (the sign of a zero sum is checked too);
    offset floats ahead of it in its allocation (a plane not 16-byte
    aligned)."""
    a = np.random.default_rng(5).uniform(-1023, 1023, (H, W)).astype(np.float32)
    a[:3] = a[-3:] = a[:, :2] = -0.0
    flat = torch.zeros(offset + H * W, dtype=torch.float32, device=dev)
    flat[offset:] = torch.from_numpy(a.reshape(-1)).to(dev)
    return flat[offset:].view(H, W)


# id: (H, W, Sr, Sc, y0s, x0s, plane offset in floats, design); tiles straddle
# every edge, lie wholly outside, start at negative origins, run past the
# bottom and the right
WINDOW_PATH_CASES = {
    "edges": (96, 160, 48, 64, [-47, -48, -5, 0, 40, 48, 90, 96, -200, 10, 50],
              [-63, -64, -3, 0, 100, 96, 150, 160, 10, 500, -1], 0, "tma"),
    "x0 % 4 != 0": (96, 512, 48, 160, [0, 7, 13, 48, 50, -9, 90, 1],
                    [1, 2, 3, 5, 333, 351, -1, -3], 0, "tma"),
    "W % 4 != 0": (96, 510, 48, 256, [0, -8, 60, 20, 5], [0, 255, 300, -5, 254], 0,
                   "checked"),
    "plane not 16-byte aligned": (96, 512, 48, 256, [0, -8, 60, 20], [0, 256, 300, -5], 1,
                                  "checked"),
    "Sr 1": (96, 512, 1, 256, [0, -1, 95, 96, 40], [0, 256, 300, -5, 7], 0, "tma"),
    "Sr 47": (96, 512, 47, 256, [0, -46, 49, 50, 40], [0, 256, 300, -5, 7], 0, "tma"),
    "Sr 48": (96, 512, 48, 256, [0, -47, 48, 49, 40], [0, 256, 300, -5, 7], 0, "tma"),
    "Sr 300, past TMA's box": (400, 128, 300, 32, [0, -200, 100, 101, 399],
                               [0, 96, -31, 5, 100], 0, "checked"),
    "Sr 256 x Sc 256, past shared memory": (300, 512, 256, 256, [0, -100, 44, 60],
                                            [0, 256, 300, -5], 0, "checked"),
    "Sc 1": (96, 512, 48, 1, [0, -8, 60, 20, 5], [0, 511, 512, -1, 7], 0, "tma"),
    "Sc 160": (96, 512, 48, 160, [0, -8, 60, 20, 5], [0, 352, 400, -5, 7], 0, "tma"),
    "Sc 256": (96, 512, 48, 256, [0, -8, 60, 20, 5], [0, 256, 300, -5, 7], 0, "tma"),
    "Sc 300": (96, 512, 48, 300, [0, -8, 60, 20, 5], [0, 212, 300, -5, 7], 0, "checked"),
}


def _window_check(p3, img, y0, x0, Sr, Sc, design):
    assert p3.window_path(img, Sr, Sc) == design
    n0 = p3.window_colsum.launches
    k = p3.window_colsum(img, y0, x0, Sr, Sc)
    p = p3.window_colsum_plain(img, y0, x0, Sr, Sc)
    torch.cuda.synchronize()
    assert p3.window_colsum.launches == n0 + 1
    assert k.shape == (y0.shape[0], Sc)
    assert torch.equal(k, p)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))     # the sign of 0 too


@pytest.mark.parametrize("case", [f"probe {s} align{a} Sc{sc}" for s in ("full", "small")
                                  for a, sc in ((128, 256), (32, 256), (32, 160), (8, 160))]
                         + list(WINDOW_PATH_CASES) + ["ntiles 0"])
def test_window_colsum_paths_vs_plain(dev, case):
    """Each design of csrc/probe_window.cu, picked by shape, bit-identical to
    the plain version: the probe's four cases at full and small size, edge
    and outside tiles, unaligned origins and planes, odd window shapes."""
    from gyroflow_torch.experiments import perf_probe3 as p3

    if case.startswith("probe"):
        _, size, name = case.split(" ", 2)
        img, cases = p3.inputs(dev, small=size == "small")
        align, Sc, y0, x0 = next(c for c in cases if f"align{c[0]} Sc{c[1]}" == name)
        _window_check(p3, img, y0, x0, p3.SR, Sc, "tma")
    elif case == "ntiles 0":
        img = _window_plane(96, 512, dev)
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        n0 = p3.window_colsum.launches
        k = p3.window_colsum(img, none, none, p3.SR, 160)
        assert k.shape == (0, 160) and k.device == img.device
        assert p3.window_colsum.launches == n0
    else:
        H, W, Sr, Sc, y0, x0, offset, design = WINDOW_PATH_CASES[case]
        img = _window_plane(H, W, dev, offset)
        y0 = torch.tensor(y0, dtype=torch.int32, device=dev)
        x0 = torch.tensor(x0, dtype=torch.int32, device=dev)
        _window_check(p3, img, y0, x0, Sr, Sc, design)


def _probe_sampler_cases(dev):
    from gyroflow_torch.experiments import perf_probe4 as p4, perf_probe5 as p5

    img, u, v, valid, y0, x0, xoff, _, _ = p4.inputs(dev, small=True)
    yield img, u, v, y0, x0, xoff, p4.WINDOW
    for img, u, v, valid, y0, x0, xoff, _, _, window in p5.inputs(dev, small=True).values():
        yield img, u, v, y0, x0, xoff, window


@pytest.mark.parametrize("mode,precision", [("noop", "fp32"), ("nobuild", "fp32"),
                                            ("nomatmul", "fp32"), ("full", "fp32"),
                                            ("full", "bf16"), ("full", "bf16x3")])
def test_probe_sampler_kernel_vs_plain(dev, mode, precision):
    from gyroflow_torch.experiments import probe_sampler as ps

    for img, u, v, y0, x0, xoff, window in _probe_sampler_cases(dev):
        bg = tuple(float(b) for b in (17.0, 3.5)[:img.shape[2]])
        n0 = ps.sample.launches
        k = ps.sample(img, u, v, y0, x0, xoff, window, mode, precision, bg)
        p = ps.sample_plain(img, u, v, y0, x0, xoff, window, mode, precision, bg)
        torch.cuda.synchronize()
        assert ps.sample.launches == n0 + 1
        assert k.shape == u.shape + (img.shape[2],) and bool(torch.isfinite(k).all())
        d = float((k - p).abs().max())
        if mode == "nobuild":
            assert d <= 1e-4 * float(p.abs().max())
        else:
            assert d == 0.0


def _probe_inputs(dev, C, inside, seed, H=40, W=72, offset=False):
    """A small plane and tiled u/v for the probe sampler: with inside,
    every stencil lies wholly inside its tile's window (24 x 64, K 40) and
    the frame; else u, v spread over the frame and 8 px past it, so stencils
    straddle the window's rows, the compute width and the frame's edges.
    offset: the plane starts 4 bytes past a 16-byte boundary (for C=2 not
    on a pixel's 8 bytes, so every stencil takes the checked loop)."""
    from gyroflow_torch.experiments import probe_sampler as ps

    rng = np.random.default_rng(seed)
    ntiles, P, window = 6, 320, (24, 64, 40)
    Sr, _, K = window
    y0 = rng.integers(0, (H - Sr) // 8 + 1, ntiles) * 8
    x0 = rng.integers(0, 3, ntiles) * 8
    xoff = rng.integers(0, 3, ntiles) * 8
    if inside:
        fx = (x0 + xoff)[:, None] + rng.integers(0, K - 8 + 1, (ntiles, P))
        fy = y0[:, None] + rng.integers(0, Sr - 8 + 1, (ntiles, P))
        ph = rng.integers(0, 32, (2, ntiles, P)) + rng.uniform(-0.4, 0.4, (2, ntiles, P))
        u = 3.0 + (fx * 32 + ph[0]) / 32.0
        v = 3.0 + (fy * 32 + ph[1]) / 32.0
    else:
        u = rng.uniform(-8.0, W + 8.0, (ntiles, P))
        v = rng.uniform(-8.0, H + 8.0, (ntiles, P))
    host = rng.uniform(0, 1023, H * W * C + 1).astype(np.float32)
    flat = torch.from_numpy(host).to(dev)
    img = (flat[1:] if offset else flat[:-1]).view(H, W, C)
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (u, v)]
    o = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (y0, x0, xoff)]
    share = ps.fast_share(img.shape, *t, *o, window)
    assert (share == 1.0) if inside else (0.05 < share < 0.95)
    return img, *t, *o, window


PROBE_FORMS = [("noop", "fp32"), ("nobuild", "fp32"), ("nomatmul", "fp32"), ("full", "fp32"),
               ("full", "bf16"), ("full", "bf16x3")]


@pytest.mark.parametrize("mode,precision", PROBE_FORMS)
@pytest.mark.parametrize("C,inside,offset", [(1, False, False), (1, True, False),
                                             (2, False, False), (2, True, False),
                                             (1, False, True), (2, True, True)])
def test_probe_sampler_paths_vs_plain(dev, C, inside, offset, mode, precision):
    """Every mode and precision on stencils that straddle the window's rows,
    the compute width and the frame's edges (the checked loop), and on
    stencils wholly inside (the fast path; C=2 is probe 5's UV plane), also
    on a plane that does not start on 16 bytes: equal to the plain version."""
    from gyroflow_torch.experiments import probe_sampler as ps

    img, u, v, y0, x0, xoff, window = _probe_inputs(dev, C, inside, 7 + C, offset=offset)
    bg = (17.0, 3.5)[:C]
    k = ps.sample(img, u, v, y0, x0, xoff, window, mode, precision, bg)
    p = ps.sample_plain(img, u, v, y0, x0, xoff, window, mode, precision, bg)
    torch.cuda.synchronize()
    assert k.shape == u.shape + (C,) and bool(torch.isfinite(k).all())
    if mode == "nobuild":
        assert float((k - p).abs().max()) <= 1e-4 * float(p.abs().max())
    else:
        assert torch.equal(k, p)


@pytest.mark.parametrize("variant", ["chain", "chain_plus1", "sum10"])
def test_elementwise_triton_vs_plain(dev, variant):
    from gyroflow_torch.experiments import perf_probe8 as p8

    for x in p8.inputs(dev, small=True):
        n0 = p8.elementwise.launches
        k = p8.elementwise(x, variant)
        p = p8.elementwise_plain(x, variant)
        torch.cuda.synchronize()
        assert p8.elementwise.launches == n0 + 1
        assert k.shape == p.shape
        assert torch.equal(k, p)


def test_experiment_kernels_raise_instead_of_falling_back(dev):
    from gyroflow_torch.experiments import fused_bbox as fb, perf_probe3 as p3
    from gyroflow_torch.experiments import perf_probe8 as p8, probe_sampler as ps

    cfg, dyn, mats, img = _case("Y")
    x, y, idx, m = _coords_inputs(cfg, dyn, mats, dev)
    with pytest.raises(TypeError):
        fb.fused_bbox(torch.zeros(8, 8, 1, dtype=torch.int32, device=dev), x, y, idx, m, cfg,
                      dyn, (0.0,))
    i32 = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        p3.window_colsum(torch.zeros(8, 8, dtype=torch.float64, device=dev), i32, i32)
    with pytest.raises(ValueError):
        ps.sample(torch.zeros(8, 8, 3, device=dev), x[:4], y[:4], i32, i32, i32, (8, 8, 8))
    with pytest.raises(ValueError):
        p8.elementwise(torch.zeros(4, 8, dtype=torch.float64, device=dev), "chain")


def test_experiments_run_all_on_the_card(dev):
    """Every probe runs on the card at its small size: each new kernel
    launches, every time is read, and the fp32 samplers match
    remap.sample_input."""
    from gyroflow_torch import experiments

    r = experiments.run_all(dev, small=True)
    assert r["fused_bbox"]["launches"]["fused_bbox"] > 0
    assert r["perf_probe3"]["launches"]["window_colsum"] == 4 * 13
    assert r["perf_probe4"]["launches"]["probe_sampler"] > 0
    assert r["perf_probe5"]["launches"]["probe_sampler"] > 0
    assert r["perf_probe6"]["launches"]["probe_sampler"] > 0
    assert r["perf_probe8"]["launches"]["elementwise"] == 4 * 12
    assert all(isinstance(r["perf_probe4"][m], float) for m in ("base", "noop", "full"))
    assert r["perf_probe4"]["full max_err"] <= 1e-3
    assert r["perf_probe4"]["base vs full max_err"] <= 1e-3
    assert r["perf_probe5"]["Y"]["max_err"] <= 1e-3 and r["perf_probe5"]["UV"]["max_err"] <= 1e-3
    assert r["perf_probe6"]["sampler fp32"]["err"] <= 1e-3
    for name in ("Y", "UV"):
        assert r["fused_bbox"][name]["bbox_err_px"] <= 1e-4
        assert r["fused_bbox"][name]["valid_mismatches"] == 0


def _card_manager(dev, tmp_path):
    """A StabilizationManager on the card: W x H, a fisheye lens, 8 ms
    rolling shutter, a seeded synthetic gyro log."""
    from gyroflow_torch.core.lens_profile import CameraParams, Dimensions, LensProfile
    from gyroflow_torch.core.manager import StabilizationManager

    rng = np.random.default_rng(4)
    rows = ["GYROFLOW IMU LOG", "tscale,0.001", "gscale,1.0", "ascale,1.0", "t,gx,gy,gz"]
    rows += [f"{i},{0.3 * math.sin(i / 30):.5f},{rng.normal(0, 0.05):.5f},0.01"
             for i in range(1200)]
    gcsv = tmp_path / "card.gcsv"
    gcsv.write_text("\n".join(rows))
    m = StabilizationManager(device=dev)
    m.init_from_video_data(1000.0, 30.0, 30, (W, H))
    m.lens = LensProfile(calib_dimension=Dimensions(W, H), fisheye_params=CameraParams(
        camera_matrix=[[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1]],
        distortion_coeffs=[0.25, -0.05, 0.01, -0.001]), distortion_model="opencv_fisheye")
    m.lens.init()
    m.params.frame_readout_time = 8.0
    m.load_gyro_data(str(gcsv))
    m.recompute_blocking()
    return m


@pytest.mark.parametrize("dtype,interpolation", [("uint16", 8), ("uint16", 11), ("uint8", 8),
                                               ("float32", 8)])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_window_vs_per_frame_on_the_card(dev, tmp_path, plane, dtype, interpolation):
    """A 2-frame process_pixels_window on the card: one coords and one
    sampler (or EWA) launch per frame, each frame 0 codes from its own
    process_pixels, in the plane's output dtype."""
    m = _card_manager(dev, tmp_path)
    shape = (H, W, 1) if plane == "Y" else (H // 2, W // 2, 2)
    maxv = 255.0 if dtype == "uint8" else 1023.0
    frames = np.random.default_rng(6).integers(0, int(maxv) + 1, (2,) + shape).astype(dtype)
    ts = [500_000, 533_333]
    kw = dict(interpolation=interpolation, plane_index=0 if plane == "Y" else 1,
              max_pixel_value=maxv, plane_rects=True)
    sample = cuda_ewa.sample if interpolation > 8 else cuda_sampler.sample
    # the fisheye plane's coords launch: the self-contained kernel (its EWA
    # form for EWA), never the coords kernel
    n0 = (cuda_coords.project_gen.launches, sample.launches, cuda_coords.project.launches)
    out, info = m.process_pixels_window(ts, frames, None, **kw)
    torch.cuda.synchronize()
    assert (cuda_coords.project_gen.launches - n0[0], sample.launches - n0[1],
            cuda_coords.project.launches - n0[2]) == (2, 2, 0)
    assert info["backend"] == "cuda-window"
    assert out.dtype == getattr(torch, dtype) and out.device == dev
    assert tuple(out.shape) == frames.shape
    for i in range(2):
        one, _ = m.process_pixels(ts[i], frames[i], **kw)
        assert torch.equal(out[i], one)


def test_undistort_stmap_on_the_card(dev, tmp_path):
    """utils/stmap's undistort projection through the coords kernel against
    the plain undistort_coord on the same card tensors."""
    from gyroflow_torch.ops.kernel_params import dyn_to_torch as to_dev
    from gyroflow_torch.utils import stmap

    m = _card_manager(dev, tmp_path)
    n0 = cuda_coords.project.launches
    u, v, valid = stmap.undistort_uv(m, 500.0)
    assert cuda_coords.project.launches == n0 + 1
    ox, oy, mats, cfg, dyn, out_c, out_f, mesh = stmap.undistort_inputs(m, 500.0)
    assert mesh is None
    up, vp, validp = remap.undistort_coord(ox, oy, mats, cfg, to_dev(dyn, dev), out_c, out_f)
    assert torch.equal(valid, validp)
    assert float((u - up).abs()[valid].max()) <= 1e-4
    assert float((v - vp).abs()[valid].max()) <= 1e-4


# ---- Sony mesh correction and focal-plane distortion (lens.cuh) ------------

def _mesh(grid=(9, 9), fpd=True, seed=3):
    """A seeded mesh buffer over the W x H frame (core/splines.py layout):
    grid points warped by ~1.5 px, FPD shears of ~0.01."""
    from gyroflow_torch.core.splines import build_mesh_buffer
    gw, gh = grid
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, W, gw), np.linspace(0, H, gh))
    pts = np.stack([gx + rng.normal(0, 1.5, gx.shape), gy + rng.normal(0, 1.5, gy.shape)], -1)
    buf = build_mesh_buffer(pts, (float(W), float(H)), focal_plane_shears=rng.normal(
        0, 0.01, (8, 2)) if fpd else None, fpd_enabled=fpd)
    return torch.from_numpy(buf.astype(np.float32))


def _packed(ref, cfg):
    """The reference buffer packed for cfg (cuda_coords.pack_mesh)."""
    return torch.from_numpy(cuda_coords.pack_mesh(ref, cfg))


def _mesh_case(plane, flags, grid=(9, 9), model="opencv_fisheye", **kw):
    """_case with the mesh flag, cfg.mesh_grid and a packed mesh buffer;
    flags adds HAS_FPD_DATA, HAS_IBIS_DATA or FRAMEBUFFER_INVERTED."""
    cfg, dyn, mats, img = _case(plane, flags=flags | HAS_MESH_DATA, **kw)
    cfg = cfg._replace(mesh_grid=grid, distortion_model=model)
    if model != "opencv_fisheye":
        dyn = dyn._replace(k=KernelDynamics.make(k=LENS_K[model]).k)
    return cfg, dyn, mats, img, _packed(_mesh(grid, fpd=bool(flags & HAS_FPD_DATA)), cfg)


MESH_FLAGS = [0, HAS_FPD_DATA, HAS_FPD_DATA | HAS_IBIS_DATA]


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("flags", MESH_FLAGS)
@pytest.mark.parametrize("grid,model", [((9, 9), "opencv_fisheye"), ((5, 4), "sony"),
                                        ((9, 9), "sony")])
def test_coords_kernel_mesh_vs_plain(dev, flags, inverted, grid, model):
    """The mesh form with mesh, mesh + FPD and mesh + FPD + IBIS, with and
    without FRAMEBUFFER_INVERTED: 0 px from the plain version (the same
    float32 operations; the segment indexed, not summed one-hot)."""
    flags |= FRAMEBUFFER_INVERTED if inverted else 0
    cfg, dyn, mats, _, mesh = _mesh_case("Y", flags, grid, model)
    x, y, idx, m = _coords_inputs(cfg._replace(flags=cfg.flags & ~(HAS_MESH_DATA | HAS_FPD_DATA),
                                               mesh_grid=None), dyn, mats, dev)
    mesh = mesh.to(dev)
    n0 = cuda_coords.project.launches
    uk, vk, valk = cuda_coords.project(x, y, idx, m, cfg, dyn, mesh)
    up, vp, valp = cuda_coords.project_plain(x, y, idx, m, cfg, dyn, mesh)
    torch.cuda.synchronize()
    assert cuda_coords.project.launches == n0 + 1
    assert torch.equal(valk, valp)
    assert torch.equal(uk, up) and torch.equal(vk, vp)


def _same_bits(k, p):
    """Kernel and plain outputs bit-identical: the valid masks, and u, v
    with NaN exactly where the other has NaN."""
    for a, b in zip(k, p):
        if a.dtype.is_floating_point:
            assert torch.equal(a.isnan(), b.isnan())
            a, b = (torch.where(t.isnan(), 0.0, t).view(torch.int32) for t in (a, b))
        assert torch.equal(a, b)


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("gh", range(2, 10))
def test_coords_kernel_mesh_every_grid_edges_and_nonfinite(dev, gh, inverted):
    """The mesh form with FPD on every grid height 2-9 (width 11 - gh):
    points spread over -0.4 .. 1.4 of the frame, so the mesh's x and y
    run beyond [0, size] on both sides in every warp (the edge pieces'
    branches), NaN and +-inf among them; bit-identical to the plain
    version, the valid masks too."""
    grid = (11 - gh, gh)
    flags = HAS_FPD_DATA | (FRAMEBUFFER_INVERTED if inverted else 0)
    cfg, dyn, mats, _, mesh = _mesh_case("Y", flags, grid, "sony")
    rng = np.random.default_rng(gh * 2 + inverted)
    x = rng.uniform(-0.4 * W, 1.4 * W, (H, W)).astype(np.float32)
    y = rng.uniform(-0.4 * H, 1.4 * H, (H, W)).astype(np.float32)
    for col, val in ((3, np.nan), (11, np.inf), (19, -np.inf)):
        x[:, col::32] = val
        y[1::2, col + 1::32] = val
    idx = rng.integers(0, H, (H, W)).astype(np.int32)
    x, y, idx, m, mesh = (torch.from_numpy(a).to(dev) for a in (x, y, idx, mats, mesh.numpy()))
    k = cuda_coords.project(x, y, idx, m, cfg, dyn, mesh)
    p = cuda_coords.project_plain(x, y, idx, m, cfg, dyn, mesh)
    torch.cuda.synchronize()
    _same_bits(k, p)
    # the mesh's y beyond both edges: the plain stage's input, before the mesh
    nomesh = cfg._replace(flags=cfg.flags & ~(HAS_MESH_DATA | HAS_FPD_DATA))
    _, v0, _ = cuda_coords.project_plain(x, y, idx, m, nomesh, dyn)
    assert bool((v0 < 0).any()) and bool((v0 > H).any())


ITERATIVE = [(m, d) for m, d in LENSES
             if {m, d} & {"gopro", "gopro_superview", "gopro6_superview", "gopro_hyperview",
                          "gopro_warp"}]


@pytest.mark.parametrize("model,digital", ITERATIVE)
def test_coords_kernel_iterative_lanes_leave_their_loop(dev, model, digital):
    """The iterative forms (gopro's Newton loop, the digital lenses' fixed
    point), where a done lane leaves its loop: every warp mixes a lane at
    the lens centre (1 step), the lane of the most steps among 8192 spread
    points, and a NaN lane (never done: all 10 or 12 steps); bit-identical
    to the plain version."""
    from chip_smoke import LOOP_OF, loop_steps
    cfg, dyn, mats, _ = _lens_case("Y", model, digital)
    m = torch.from_numpy(mats).to(dev)
    loop = LOOP_OF[model if model in LOOP_OF else digital]
    most = 10 if loop == "_gopro_poly_invert" else 12
    rng = np.random.default_rng(len(model) + len(digital or ""))
    # the lens centre: the output pixel whose camera-space (x, y) through row
    # r is (0, 0) (the optical axis), or (W / 2, H / 2) for a digital lens
    # as the main model, which takes (x, y) as pixels
    r = rng.integers(0, H, 8192)
    t = np.array([W / 2.0, H / 2.0]) if tdm.get_model(model).is_digital else np.zeros(2)
    mr = mats[r[0], :9].reshape(3, 3).astype(np.float64)
    cx, cy = np.linalg.solve(mr[:2, :2], t - mr[:2, 2])
    px = np.concatenate([[cx], rng.uniform(-1.0 * W, 2.0 * W, 8191)]).astype(np.float32)
    py = np.concatenate([[cy], rng.uniform(-1.0 * H, 2.0 * H, 8191)]).astype(np.float32)
    pts = [torch.from_numpy(t).to(dev).reshape(64, 128) for t in (px, py, r.astype(np.int32))]
    _, _, steps = loop_steps(lambda: cuda_coords.project_plain(*pts, m, cfg, dyn))
    steps = steps[loop].reshape(-1).cpu().numpy()
    finite = np.isfinite(px) & np.isfinite(py)
    slow = int(np.argmax(np.where(finite, steps, -1)))
    assert steps[0] == 1 and steps[slow] > 1
    # warps of 32: the centre lane, the slowest finite lane, a NaN lane, then spread points
    n = 32 * 16
    wx = rng.uniform(0.0, W, n).astype(np.float32)
    wy = rng.uniform(0.0, H, n).astype(np.float32)
    wr = rng.integers(0, H, n).astype(np.int32)
    for lane, (sx, sy, sr) in enumerate(((px[0], py[0], r[0]), (px[slow], py[slow], r[slow]),
                                         (np.nan, py[0], r[0]))):
        wx[lane::32], wy[lane::32], wr[lane::32] = sx, sy, sr
    x, y, idx = (torch.from_numpy(t).to(dev).reshape(8, 64) for t in (wx, wy, wr))
    k = cuda_coords.project(x, y, idx, m, cfg, dyn)
    p, _, lane_steps = loop_steps(lambda: cuda_coords.project_plain(x, y, idx, m, cfg, dyn))
    torch.cuda.synchronize()
    _same_bits(k, p)
    warps = lane_steps[loop].reshape(-1, 32).cpu().numpy()
    assert (warps[:, 0] == 1).all() and (warps[:, 2] == most).all()
    assert (warps[:, 1] == steps[slow]).all()


def test_coords_kernel_fpd_only_and_digital_with_mesh(dev):
    """FPD without the mesh stage, and the mesh with a digital lens after
    it (remap.py:137-147): 0 px."""
    for flags, digital in ((HAS_FPD_DATA, None), (HAS_FPD_DATA, "gopro_superview")):
        cfg, dyn, mats, _, _ = _mesh_case("Y", flags)
        if digital is None:
            cfg = cfg._replace(flags=cfg.flags & ~HAS_MESH_DATA)
        else:
            cfg = cfg._replace(digital_lens=digital, flags=cfg.flags | HAS_DIGITAL_LENS)
        mesh = _packed(_mesh(fpd=True), cfg)
        x, y, idx, m = _coords_inputs(cfg._replace(flags=0, mesh_grid=None,
                                                   digital_lens=None), dyn, mats, dev)
        k = cuda_coords.project(x, y, idx, m, cfg, dyn, mesh.to(dev))
        p = cuda_coords.project_plain(x, y, idx, m, cfg, dyn, mesh.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(k[2], p[2])
        ok = p[2] & torch.isfinite(p[0]) & torch.isfinite(p[1])
        assert torch.equal(k[0][ok], p[0][ok]) and torch.equal(k[1][ok], p[1][ok])


@pytest.mark.parametrize("interpolation", [8, 11])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_remap_plane_cuda_mesh_vs_plain(dev, plane, interpolation):
    """A mesh + FPD + IBIS plane through remap_plane_cuda: the probe and the
    projection on the coords kernel (2 launches), 0 codes from the plain
    path."""
    cfg, dyn, mats, img, mesh = _mesh_case(plane, HAS_FPD_DATA | HAS_IBIS_DATA,
                                           interpolation=interpolation)
    timg, m, mesh = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev), mesh.to(dev)
    n0 = cuda_coords.project.launches
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, mesh, out_dtype="uint16")
    assert cuda_coords.project.launches == n0 + 2
    want = remap.remap_plane(timg, m, cfg, dyn, mesh, out_dtype="uint16")
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def sony_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_sony_manager(torch.device("cuda", 0), tmp_path_factory.mktemp("sony"), W, H,
                             n=12, grid=5)


def test_sony_mesh_frame_and_window_on_the_card(dev, sony_card):
    """chip_smoke phase 9's Sony clip at W x H: a frame through process_pixels
    and 3 frames through the window, 0 codes from the plain path."""
    m = sony_card
    ts = [int(round(k * 1e6 / 30.0)) for k in (3, 4, 5)]
    ft = m.frame_transform_at(m._adjusted_ts_ms(ts[0]))
    assert ft.kernel_cfg.has(HAS_MESH_DATA) and ft.kernel_cfg.has(HAS_FPD_DATA)
    assert ft.kernel_cfg.distortion_model == "sony"
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 1024, (3, H, W, 1)).astype(np.uint16)
    kw = dict(interpolation=8, max_pixel_value=1023.0)
    out, info = m.process_pixels(ts[0], frames[0], **kw)
    assert info["backend"] == "cuda"
    cfg, dyn = m._plane_cfg_dyn(ft, (H, W, 1), 8, 0, 1023.0, False, None, None)
    mats, mesh = m._mats_on_device(m._adjusted_ts_ms(ts[0]), ft)
    want = remap.remap_plane(torch.from_numpy(frames[0]).to(dev), mats, cfg, dyn, mesh,
                             out_dtype="uint16")
    assert torch.equal(out, want)
    win, info = m.process_pixels_window(ts, frames, None, **kw)
    assert info["backend"] == "cuda-window"
    for i in range(3):
        one, _ = m.process_pixels(ts[i], frames[i], **kw)
        assert torch.equal(win[i], one)


# ---- the drawing overlay (overlay.cu) ----------------------------------------

def _drawing(safe=True):
    """A canvas with output-stage and input-stage marks in every colour and
    alpha, and a safe-area rect."""
    from gyroflow_torch.core.drawing import DrawCanvas, STAGE_ON_INPUT, STAGE_ON_OUTPUT
    c = DrawCanvas(W, H, W, H, 1)
    for i in range(40):
        c.put_pixel(4 + 3.7 * i, 6 + 2.1 * i, 1 + i % 8, i % 4,
                    STAGE_ON_OUTPUT if i % 2 else STAGE_ON_INPUT, size=1 + i % 4)
    return c.state(safe_area_rect=(20.0, 12.0, W - 24.0, H - 10.0) if safe else None)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("c", [1, 2])
def test_overlay_kernel_vs_plain(dev, dtype, c):
    rng = np.random.default_rng(c)
    pixel = torch.from_numpy(rng.uniform(0, 1000, (H, W, c)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(-4, W + 4, (H, W)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(-4, H + 4, (H, W)).astype(np.float32)).to(dev)
    u[0, :8] = float("nan")
    d = _drawing()
    canvas = torch.from_numpy(d.canvas).to(dev)
    for rect in (d.safe_area_rect, None):
        n0 = cuda_overlay.overlay.launches
        k = cuda_overlay.overlay(pixel, u, v, canvas, d.scale, rect, (2, 1, W - 4, H - 2), 1023.0)
        p = cuda_overlay.overlay_plain(pixel, u, v, canvas, d.scale, rect, (2, 1, W - 4, H - 2),
                                       1023.0)
        torch.cuda.synchronize()
        assert cuda_overlay.overlay.launches == n0 + 1
        assert torch.equal(k, p)
    # through remap_plane_cuda on a plane of this dtype: 0 codes
    cfg, dyn, mats, img = _case("Y" if c == 1 else "UV")
    cfg = cfg._replace(flags=cfg.flags | DRAWING_ENABLED)
    maxv = 255.0 if dtype == torch.uint8 else 1023.0
    dyn = dyn._replace(max_pixel_value=np.float32(maxv), pixel_value_limit=np.float32(maxv))
    timg = torch.from_numpy(np.minimum(img, maxv).astype(np.float32)).to(dtype).to(dev)
    m = torch.from_numpy(mats).to(dev)
    out_dtype = {torch.uint8: "uint8", torch.uint16: "uint16", torch.float32: "f32"}[dtype]
    for interpolation in (8, 11):       # the lanczos and the EWA path
        icfg = cfg._replace(interpolation=interpolation)
        idyn = dyn
        if interpolation == 11:
            pw, qw = remap.ewa_coeffs(11)
            idyn = dyn._replace(ewa_coeffs_p=np.asarray(pw, np.float32),
                                ewa_coeffs_q=np.asarray(qw, np.float32))
        n0 = cuda_overlay.overlay.launches
        got = remap.remap_plane_cuda(timg, m, icfg, idyn, drawing=d, out_dtype=out_dtype)
        assert cuda_overlay.overlay.launches == n0 + 1
        want = remap.remap_plane(timg, m, icfg, idyn, drawing=d, out_dtype=out_dtype)
        assert torch.equal(got, want)


# ---- row bands, the sharded window and the entry points ----------------------

@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_reference_layout_mesh_buffer_on_the_card(dev, plane):
    """A mesh buffer in the reference layout on the host goes through
    remap_plane_cuda (packed on the host) with the plain path's bits, as
    the packed buffer on the card does; one in the reference layout on the
    card is refused (it is never downloaded to be packed)."""
    cfg, dyn, mats, img, packed = _mesh_case(plane, HAS_FPD_DATA | HAS_IBIS_DATA)
    ref = _mesh((9, 9), fpd=True)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    want = remap.remap_plane(timg, m, cfg, dyn, ref.to(dev), out_dtype="uint16")
    for mesh in (ref, packed.to(dev)):
        got = remap.remap_plane_cuda(timg, m, cfg, dyn, mesh, out_dtype="uint16")
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="pack_mesh"):
        remap.remap_plane_cuda(timg, m, cfg, dyn, ref.to(dev), out_dtype="uint16")


def _band_cases():
    return [("Y", 8, 0), ("UV", 8, 0), ("Y", 11, 0), ("UV", 11, 0), ("Y", 8, HAS_MESH_DATA),
            ("UV", 8, HAS_MESH_DATA)]


@pytest.mark.parametrize("plane,interpolation,mesh_flag", _band_cases())
def test_bands_assemble_on_the_card(dev, plane, interpolation, mesh_flag):
    """remap_plane_cuda(out_rows, oy0) bands of unequal height are the
    whole plane's rows: 0 codes in uint16, within 1e-5 in float32."""
    if mesh_flag:
        cfg, dyn, mats, img, mesh = _mesh_case(plane, HAS_FPD_DATA | HAS_IBIS_DATA,
                                               interpolation=interpolation)
        mesh = mesh.to(dev)
    else:
        (cfg, dyn, mats, img), mesh = _case(plane, interpolation=interpolation), None
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    oh = cfg.out_buffer[1]
    cuts = (0, oh // 3, oh // 3 + 7, oh)
    for out_dtype in ("uint16", "f32"):
        full = remap.remap_plane_cuda(timg, m, cfg, dyn, mesh, out_dtype=out_dtype)
        got = torch.cat([remap.remap_plane_cuda(timg, m, cfg, dyn, mesh, out_dtype=out_dtype,
                                                out_rows=b - a, oy0=a)
                         for a, b in zip(cuts[:-1], cuts[1:])])
        if out_dtype == "uint16":
            assert torch.equal(got, full)
        else:
            assert float((got - full).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype,interpolation", [("uint16", 8), ("uint16", 11), ("uint8", 8)])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_sharded_window_on_the_card(dev, tmp_path, plane, dtype, interpolation):
    """A 2-frame window on 2 x 2 logical shards of the card: each frame's two
    bands through the coords kernel and the sampler (or EWA) kernel (4
    launches each), the output on the card 0 codes from the one-device
    window."""
    from gyroflow_torch.parallel import make_frame_mesh

    m = _card_manager(dev, tmp_path)
    shape = (H, W, 1) if plane == "Y" else (H // 2, W // 2, 2)
    maxv = 255.0 if dtype == "uint8" else 1023.0
    frames = np.random.default_rng(6).integers(0, int(maxv) + 1, (2,) + shape).astype(dtype)
    ts = [500_000, 533_333]
    kw = dict(interpolation=interpolation, plane_index=0 if plane == "Y" else 1,
              max_pixel_value=maxv, plane_rects=True)
    sample = cuda_ewa.sample if interpolation > 8 else cuda_sampler.sample
    one, _ = m.process_pixels_window(ts, frames, None, **kw)
    n0 = (cuda_coords.project_gen.launches, sample.launches, cuda_coords.project.launches)
    out, info = m.process_pixels_window(ts, frames, make_frame_mesh(devices=[dev] * 4, sp=2),
                                        **kw)
    torch.cuda.synchronize()
    assert (cuda_coords.project_gen.launches - n0[0], sample.launches - n0[1],
            cuda_coords.project.launches - n0[2]) == (4, 4, 0)
    assert info["backend"] == "cuda-sharded" and out.device == dev
    assert torch.equal(out, one)


def test_entry_on_the_card(dev):
    """gyroflow_torch.entry.entry(): one self-contained coords launch and
    one sampler launch, 0 codes from the same step with each wrapper's
    plain version."""
    from gyroflow_torch.entry import entry

    fn, args = entry()
    assert args[0].device == dev
    n0 = (cuda_coords.project_gen.launches, cuda_sampler.sample.launches,
          cuda_coords.project.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert (cuda_coords.project_gen.launches - n0[0], cuda_sampler.sample.launches - n0[1],
            cuda_coords.project.launches - n0[2]) == (1, 1, 0)
    saved = (cuda_coords.project_gen, cuda_sampler.sample)
    cuda_coords.project_gen, cuda_sampler.sample = (cuda_coords.project_gen_plain,
                                                    cuda_sampler.sample_plain)
    try:
        want = fn(*args)
    finally:
        cuda_coords.project_gen, cuda_sampler.sample = saved
    assert torch.equal(got, want)


def test_dryrun_on_logical_shards_of_the_card(dev, capsys):
    from gyroflow_torch.entry import dryrun_multichip

    dryrun_multichip(4, devices=[dev] * 4)
    out = capsys.readouterr().out
    assert "smoke OK" in out and "via cuda-sharded on mesh {'dp': 2, 'sp': 2}" in out


def test_frame_mesh_takes_the_cards(dev):
    from gyroflow_torch.parallel import make_frame_mesh

    n = torch.cuda.device_count()
    mesh = make_frame_mesh()
    assert mesh.shape == {"dp": n, "sp": 1} and mesh.device == dev
    with pytest.raises(RuntimeError, match=f"{n} present"):
        make_frame_mesh(n + 1)


# ---- the two-phase fused kernel, the self-contained coords kernel's blocks
# and the overlay on a band --------------------------------------------------

FUSED_PLANES = [(dt, c, taps) for dt in (torch.uint8, torch.uint16, torch.float32)
                for c in (1, 2, 3, 4) for taps in (2, 4, 8)]


def _fused_pre(cfg, dyn, m, dev):
    """coords_pre's x, y, idx on cfg's whole output grid."""
    dt = dyn_to_torch(dyn, dev)
    ow, oh = cfg.out_buffer
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    out_f = (dt.f[0] / dt.fov, dt.f[1] / dt.fov)
    return remap.coords_pre(ox, oy, m, cfg, dt, (cfg.output_width / 2.0,
                                                 cfg.output_height / 2.0), out_f)


def _hold_fused_to_plain(img, x, y, idx, m, cfg, dyn, bg, limit=240.0):
    n0 = cuda_fused.remap_fused.launches
    k = cuda_fused.remap_fused(img, x, y, idx, m, cfg, dyn, bg, limit)
    p = cuda_fused.remap_fused_plain(img, x, y, idx, m, cfg, dyn, bg, limit)
    torch.cuda.synchronize()
    assert cuda_fused.remap_fused.launches == n0 + 1
    assert k.shape == p.shape == x.shape + (img.shape[2],)
    # the same arithmetic in the same order: the same bits
    assert torch.equal(k, p)


@pytest.mark.parametrize("zoom", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("rotation", [-0.3, 0.3])
@pytest.mark.parametrize("dtype,c,taps", FUSED_PLANES)
def test_fused_kernel_warp_maps_bits(dev, dtype, c, taps, rotation, zoom):
    """Rolled and zoomed frames (zoom 0.5: the output covers twice the
    plane, so tiles reach past every edge) over a plane whose rows are not a
    multiple of 16 bytes, each type, channel count and tap count: the fused
    kernel gives its plain version's bits."""
    cfg, dyn, mats, _ = _warp_fused_case("Y", rotation, zoom)
    cfg = cfg._replace(interpolation=taps)
    m = torch.from_numpy(mats).to(dev)
    x, y, idx = _fused_pre(cfg, dyn, m, dev)
    img = _plane(dev, dtype, c, PH, PW, seed=c * 10 + taps)
    bg = tuple(float(b) for b in np.linspace(20.0, 200.0, c))
    _hold_fused_to_plain(img, x, y, idx, m, cfg, dyn, bg)


@pytest.mark.parametrize("case", ["left", "right", "top", "bottom", "rect_outside",
                                  "non_finite", "odd_offset"])
@pytest.mark.parametrize("dtype,c,taps", TAP_PLANES)
def test_fused_kernel_edges_bits(dev, dtype, c, taps, case):
    """Footprints across each plane edge, a source rect partly outside the
    plane, non-finite and huge x/y, and a plane that is a view at an odd
    element offset: the fused kernel gives its plain version's bits."""
    cfg, dyn, mats, _ = _warp_fused_case("Y", 0.0, 1.0)
    cfg = cfg._replace(interpolation=taps)
    rng = np.random.default_rng(11)
    oh, ow = 40, 64
    x = rng.uniform(0, PW, (oh, ow))
    y = rng.uniform(0, PH, (oh, ow))
    offset = 0
    if case == "left":
        x = rng.uniform(-9, 9, (oh, ow))
    elif case == "right":
        x = rng.uniform(PW - 9, PW + 9, (oh, ow))
    elif case == "top":
        y = rng.uniform(-9, 9, (oh, ow))
    elif case == "bottom":
        y = rng.uniform(PH - 9, PH + 9, (oh, ow))
    elif case == "rect_outside":
        cfg = cfg._replace(source_rect=(-5, -3, PW - 10, PH + 10),
                           flags=cfg.flags | HAS_SOURCE_RECT)
    elif case == "non_finite":
        x[0, :4] = [np.nan, np.inf, -np.inf, 1e30]
        y[1, :4] = [np.inf, np.nan, -1e30, -np.inf]
        x[2, :2] = [4e4, -4e4]
    elif case == "odd_offset":
        offset = 1
    m = torch.from_numpy(mats).to(dev)
    x, y = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, y))
    idx = torch.from_numpy(rng.integers(0, PH, (oh, ow)).astype(np.int32)).to(dev)
    img = _plane(dev, dtype, c, PH, PW, seed=c * 10 + taps + 1, offset=offset)
    assert img.storage_offset() == offset and img.is_contiguous()
    bg = tuple(float(b) for b in np.linspace(20.0, 200.0, c))
    _hold_fused_to_plain(img, x, y, idx, m, cfg, dyn, bg)


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_fused_bands_assemble_on_the_card(dev, plane):
    """remap_plane_cuda(fused=True, out_rows, oy0): one fused launch a band,
    and the bands (one starts at an odd row) are the whole plane's rows."""
    cfg, dyn, mats, img = _case(plane)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    oh = cfg.out_buffer[1]
    cuts = (0, 13, oh // 2 + 3, oh)
    full = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16", fused=True)
    n0 = cuda_fused.remap_fused.launches
    got = torch.cat([remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16", fused=True,
                                            out_rows=b - a, oy0=a)
                     for a, b in zip(cuts[:-1], cuts[1:])])
    assert cuda_fused.remap_fused.launches == n0 + 3
    assert torch.equal(got, full)
    assert torch.equal(full, remap.remap_plane(timg, m, cfg, dyn, out_dtype="uint16"))


GEN_OUT_CF = ((W / 2.0, H / 2.0), (F[0] / 1.05, F[1] / 1.05))


def _gen_bits(cfg, dyn, m, rows, oy0, pos_dx=0.0):
    out_c, out_f = GEN_OUT_CF
    evals = 3 if cfg.interpolation in remap.EWA_BC else 1
    n0 = cuda_coords.project_gen.launches
    k = cuda_coords.project_gen(cfg, dyn, m, rows, oy0, out_c, out_f, pos_dx=pos_dx)
    p = cuda_coords.project_gen_plain(cfg, dyn, m, rows, oy0, out_c, out_f, pos_dx=pos_dx)
    torch.cuda.synchronize()
    assert cuda_coords.project_gen.launches == n0 + 1
    assert k[0].shape == (evals * rows, cfg.out_buffer[0])
    _same_bits(k, p)


@pytest.mark.parametrize("case", ["odd_band", "last_rows", "horizontal", "one_row", "ibis",
                                  "uv_band", "offset_table"])
def test_coords_gen_kernel_bits(dev, case):
    """Bands at odd rows (a tile cut by the band's end), horizontal RS, a
    table of one matrix row, IBIS, the UV plane, and a table that starts 8
    bytes into its buffer: u, v, valid bit-identical to project_gen_plain."""
    plane = "UV" if case == "uv_band" else "Y"
    flags = {"horizontal": HORIZONTAL_RS, "ibis": HAS_IBIS_DATA}.get(case, 0)
    cfg, dyn, mats, _ = _case(plane, flags=flags)
    m = torch.from_numpy(mats).to(dev)
    oh = cfg.out_buffer[1]
    rows, oy0 = {"odd_band": (37, 13), "last_rows": (11, oh - 11),
                 "uv_band": (19, 5)}.get(case, (oh, 0))
    if case == "one_row":
        m = m[:1].contiguous()
    elif case == "offset_table":
        buf = torch.zeros(m.numel() + 2, dtype=torch.float32, device=dev)
        buf[2:] = m.reshape(-1)
        m = buf[2:].view(m.shape)
        assert m.is_contiguous() and m.data_ptr() % 16 == 8
    _gen_bits(cfg, dyn, m, rows, oy0, pos_dx=0.01 if case == "odd_band" else 0.0)


@pytest.mark.parametrize("model", list(tdm.MODEL_IDS))
def test_coords_gen_kernel_every_model_bits(dev, model):
    """Every main model on a band at an odd row, with IBIS: u, v, valid
    bit-identical to project_gen_plain."""
    cfg, dyn, mats, _ = _lens_case("Y", model, None, flags=HAS_IBIS_DATA)
    _gen_bits(cfg, dyn, torch.from_numpy(mats).to(dev), 45, 7, pos_dx=0.01)


@pytest.mark.parametrize("case", ["whole", "odd_band", "last_rows", "horizontal", "one_row",
                                  "ibis", "uv_band", "offset_table", "ref_jac",
                                  "ref_jac_horizontal"])
def test_coords_gen_ewa_kernel_bits(dev, case):
    """The gen kernel's EWA form (an EWA configuration): the whole plane, bands at odd
    rows, horizontal RS, a table of one matrix row, IBIS, the UV plane, a
    table 8 bytes into its buffer, and ewa_ref_jac (a row probe per eval,
    vertical and horizontal RS): the stacked u, v, valid bit-identical to
    ewa_stack + project_plain. The ref_jac cases hold planes where some
    +eps evals do take another row than the base eval's."""
    plane = "UV" if case == "uv_band" else "Y"
    flags = HORIZONTAL_RS if "horizontal" in case else HAS_IBIS_DATA if case == "ibis" else 0
    cfg, dyn, mats, _ = _case(plane, flags=flags, interpolation=11,
                              ewa_ref_jac=case.startswith("ref_jac"))
    m = torch.from_numpy(mats).to(dev)
    oh = cfg.out_buffer[1]
    rows, oy0 = {"odd_band": (37, 13), "last_rows": (11, oh - 11),
                 "uv_band": (19, 5)}.get(case, (oh, 0))
    if case == "one_row":
        m = m[:1].contiguous()
    elif case == "offset_table":
        buf = torch.zeros(m.numel() + 2, dtype=torch.float32, device=dev)
        buf[2:] = m.reshape(-1)
        m = buf[2:].view(m.shape)
        assert m.is_contiguous() and m.data_ptr() % 16 == 8
    _gen_bits(cfg, dyn, m, rows, oy0, pos_dx=0.01 if case == "odd_band" else 0.0)
    if case.startswith("ref_jac"):
        oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                                torch.arange(cfg.out_buffer[0], dtype=torch.float32,
                                             device=dev), indexing="ij")
        idx = remap.ewa_stack(ox, oy, m, cfg, dyn_to_torch(dyn, dev), *GEN_OUT_CF)[2]
        idx0, idx1, idx2 = idx.chunk(3)
        assert bool((idx1 != idx0).any() | (idx2 != idx0).any())


@pytest.mark.parametrize("model", list(tdm.MODEL_IDS))
def test_coords_gen_ewa_kernel_every_model_bits(dev, model):
    """The EWA form for every main model on a band at an odd row, with IBIS:
    bit-identical to ewa_stack + project_plain."""
    cfg, dyn, mats, _ = _lens_case("Y", model, None, flags=HAS_IBIS_DATA, interpolation=11)
    _gen_bits(cfg, dyn, torch.from_numpy(mats).to(dev), 45, 7, pos_dx=0.01)


@pytest.mark.parametrize("n_rows", [2, H])
def test_coords_gen_kernel_centre_row_tables(dev, n_rows):
    """A table of 2 rows, where every pixel selects the centre row (row 1,
    the probe's), and one of H rows, where a band of pixels does and the
    others select their own: bit-identical to project_gen_plain either
    way."""
    cfg, dyn, mats, _ = _case("Y")
    mats = np.ascontiguousarray(mats[np.linspace(0, H - 1, n_rows).round().astype(int)])
    m = torch.from_numpy(mats).to(dev)
    _gen_bits(cfg, dyn, m, H, 0)
    oy, ox = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    _, _, idx = remap.coords_pre(ox, oy, m, cfg, dyn_to_torch(dyn, dev), *GEN_OUT_CF)
    centre = int((idx == n_rows // 2).sum())
    if n_rows == 2:
        assert centre == idx.numel()
    else:
        assert 0 < centre < idx.numel()


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_remap_plane_cuda_gen_route_4k_bits(dev, plane):
    """A 4K 10-bit fisheye plane (UV with its source and output rects) at
    lanczos4 through remap_plane_cuda: one project_gen launch, no project
    launch, and the bits of the composition it replaces, called step by
    step: the output grid, eager coords_pre, the coords kernel,
    coords_post_uv, the sampler kernel and the finish (in-bounds mask,
    colour range, uint16 cast)."""
    cfg, dyn, mats, img = _case(plane, flags=FIX_COLOR_RANGE, w=3840, h=2160)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    n0 = (cuda_coords.project_gen.launches, cuda_coords.project.launches)
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    torch.cuda.synchronize()
    assert (cuda_coords.project_gen.launches, cuda_coords.project.launches) == (n0[0] + 1, n0[1])

    dt = dyn_to_torch(dyn, dev)
    ow, oh = cfg.out_buffer
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    factor = torch.clamp_min(1.0 - dt.lens_correction_amount, 0.001)
    out_c = (float(cfg.output_width) / 2.0, float(cfg.output_height) / 2.0)
    out_f = (dt.f[0] / dt.fov / factor, dt.f[1] / dt.fov / factor)
    x, y, idx = remap.coords_pre(ox, oy, m, cfg, dt, out_c, out_f)
    projected = cuda_coords.project(x, y, idx, m, cfg, dyn)
    _same_bits(cuda_coords.project_gen(cfg, dyn, m, oh, 0, out_c, out_f), projected)
    u, v, valid = projected
    u, v = remap.coords_post_uv(u, v, cfg)
    c = img.shape[-1]
    bg = (dt.background * dt.max_pixel_value)[:c]
    px = cuda_sampler.sample(timg, u, v, valid, tuple(float(b) for b in bg.cpu()),
                             cfg.src_rect, 8, 1023.0)
    px = torch.where(valid[..., None], px, bg)
    orx, ory, orw, orh = cfg.out_rect
    lx = remap.map_coord(ox, float(orx), float(orx + orw), 0.0, float(cfg.output_width))
    ly = remap.map_coord(oy, float(ory), float(ory + orh), 0.0, float(cfg.output_height))
    inside = (lx >= 0.0) & (ly >= 0.0) & (lx < cfg.output_width) & (ly < cfg.output_height)
    px = torch.where(inside[..., None], px, bg)
    px = remap._remap_colorrange(px, cfg.plane_index == 0, dt.max_pixel_value)
    want = remap._cast_out(px, "uint16", 1023.0)
    assert got.dtype == torch.uint16 and got.shape == (oh, ow, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_remap_plane_cuda_gen_ewa_route_4k_bits(dev, plane):
    """A 4K 10-bit fisheye plane (UV with its source and output rects) at
    EWA 11 through remap_plane_cuda: one project_gen launch (the EWA form),
    no project launch, and the bits of the composition it replaces, called
    step by step: the output grid, ewa_stack's three eager coords_pre, the
    stacked coords kernel launch, coords_post_uv, the EWA kernel and the
    finish (in-bounds mask, colour range, uint16 cast)."""
    cfg, dyn, mats, img = _case(plane, flags=FIX_COLOR_RANGE, interpolation=11, w=3840, h=2160)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    n0 = (cuda_coords.project_gen.launches, cuda_coords.project.launches)
    got = remap.remap_plane_cuda(timg, m, cfg, dyn, out_dtype="uint16")
    torch.cuda.synchronize()
    assert (cuda_coords.project_gen.launches, cuda_coords.project.launches) == (n0[0] + 1, n0[1])

    dt = dyn_to_torch(dyn, dev)
    ow, oh = cfg.out_buffer
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    factor = torch.clamp_min(1.0 - dt.lens_correction_amount, 0.001)
    out_c = (float(cfg.output_width) / 2.0, float(cfg.output_height) / 2.0)
    out_f = (dt.f[0] / dt.fov / factor, dt.f[1] / dt.fov / factor)
    x, y, idx = remap.ewa_stack(ox, oy, m, cfg, dt, out_c, out_f)
    projected = cuda_coords.project(x, y, idx, m, cfg, dyn)
    _same_bits(cuda_coords.project_gen(cfg, dyn, m, oh, 0, out_c, out_f), projected)
    u3, v3, valid3 = projected
    u3, v3 = remap.coords_post_uv(u3, v3, cfg)
    u, v, valid = u3[:oh], v3[:oh], valid3[:oh]
    c = img.shape[-1]
    bg = (dt.background * dt.max_pixel_value)[:c]
    px = cuda_ewa.sample(timg, u, v, u3, v3, valid3, tuple(float(b) for b in bg.cpu()),
                         cfg.src_rect, remap._ewa_coeffs_of(dyn), 1023.0)
    px = torch.where(valid[..., None], px, bg)
    orx, ory, orw, orh = cfg.out_rect
    lx = remap.map_coord(ox, float(orx), float(orx + orw), 0.0, float(cfg.output_width))
    ly = remap.map_coord(oy, float(ory), float(ory + orh), 0.0, float(cfg.output_height))
    inside = (lx >= 0.0) & (ly >= 0.0) & (lx < cfg.output_width) & (ly < cfg.output_height)
    px = torch.where(inside[..., None], px, bg)
    px = remap._remap_colorrange(px, cfg.plane_index == 0, dt.max_pixel_value)
    want = remap._cast_out(px, "uint16", 1023.0)
    assert got.dtype == torch.uint16 and got.shape == (oh, ow, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_overlay_on_bands_on_the_card(dev, plane):
    """A drawing on bands of output rows: the overlay kernel on a band at
    oy0 gives the rows of the whole plane's overlay, and remap_plane_cuda's
    bands with a drawing (one overlay launch each) are the whole plane's
    rows and the plain path's, 0 codes."""
    c = 1 if plane == "Y" else 2
    rng = np.random.default_rng(5)
    pixel = torch.from_numpy(rng.uniform(0, 1000, (H, W, c)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(-4, W + 4, (H, W)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.uniform(-4, H + 4, (H, W)).astype(np.float32)).to(dev)
    d = _drawing()
    canvas = torch.from_numpy(d.canvas).to(dev)
    args = (canvas, d.scale, d.safe_area_rect, (2, 1, W - 4, H - 2), 1023.0)
    whole = cuda_overlay.overlay(pixel, u, v, *args)
    for a, b in ((9, 40), (40, 41), (77, H)):
        band = cuda_overlay.overlay(pixel[a:b].contiguous(), u[a:b].contiguous(),
                                    v[a:b].contiguous(), *args, oy0=a)
        assert torch.equal(band, whole[a:b])
        assert torch.equal(band, cuda_overlay.overlay_plain(
            pixel[a:b].contiguous(), u[a:b].contiguous(), v[a:b].contiguous(), *args, oy0=a))
    cfg, dyn, mats, img = _case(plane)
    cfg = cfg._replace(flags=cfg.flags | DRAWING_ENABLED)
    timg, m = torch.from_numpy(img).to(dev), torch.from_numpy(mats).to(dev)
    oh = cfg.out_buffer[1]
    cuts = (0, 7, oh // 2 + 1, oh)
    full = remap.remap_plane_cuda(timg, m, cfg, dyn, drawing=d, out_dtype="uint16")
    n0 = cuda_overlay.overlay.launches
    got = torch.cat([remap.remap_plane_cuda(timg, m, cfg, dyn, drawing=d, out_dtype="uint16",
                                            out_rows=b - a, oy0=a)
                     for a, b in zip(cuts[:-1], cuts[1:])])
    assert cuda_overlay.overlay.launches == n0 + 3
    assert torch.equal(got, full)
    assert torch.equal(full, remap.remap_plane(timg, m, cfg, dyn, drawing=d, out_dtype="uint16"))
