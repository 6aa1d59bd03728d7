"""gyroflow_torch coords stage vs the JAX package's, on the CPU.

- ``cuda_coords.project`` (on CPU tensors: its plain version) against
  ``pallas_coords.project_tiles`` (the Pallas coords kernel in interpret
  mode), fed the same x, y, idx. The layouts are converted with
  ``pallas_sampler.tiled_grid`` / ``out_untileize_c``.
- ``remap.coords_pre`` (output map, translation, lens-correction blend, RS row
  select) against the JAX ``coords_pre``.

Tolerances: u/v within 0.05 px (the ROADMAP's coordinate tolerance; float32
rounding of the same op chain differs by a few ulp between XLA and torch),
valid identical, and at most 0.1% of RS row indices different (rint of the
probe's v can flip a row on a 1-ulp difference).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import distortion_models as jdm
from gyroflow_tpu.ops import pallas_coords, pallas_sampler
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import HAS_DIGITAL_LENS, HAS_IBIS_DATA, HORIZONTAL_RS
from gyroflow_torch.ops import cuda_coords
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.ops.kernel_params import dyn_to_torch

from test_torch_remap import LENS_CASES, lens_kw, make_case
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

UV_TOL_PX = 0.05
IDX_MISMATCH_SHARE = 1e-3


def _out_c_f(cfg, dyn):
    factor = max(1.0 - float(dyn.lens_correction_amount), 0.001)
    return ((cfg.output_width / 2.0, cfg.output_height / 2.0),
            (dyn.f[0] / dyn.fov / factor, dyn.f[1] / dyn.fov / factor))


def _jax_tiled(cfg, dyn, mats):
    """JAX coords_pre + Pallas projection on the tiled grid, untiled to (oh, ow)."""
    ow, oh = cfg.out_buffer
    spec = pallas_sampler.SamplerSpec.create(
        height=oh, width=ow, out_height=oh, out_width=ow, interpolation=cfg.interpolation)
    ox, oy, _ = pallas_sampler.tiled_grid(spec)
    out_c, out_f = _out_c_f(cfg, dyn)
    m = jnp.asarray(mats)
    x, y, idx, _ = jremap.coords_pre(jnp.stack([ox, oy], -1), m, cfg, dyn, out_c, out_f)
    u, v, valid, ov = pallas_coords.project_tiles(cfg, dyn, m, x, y, idx, win_m=256)
    assert not bool(ov)

    def untile(a):
        return np.array(pallas_sampler.out_untileize_c(spec, jnp.asarray(a, jnp.float32)[None])[0])

    return [untile(a) for a in (x, y, idx, u, v, valid)]


@pytest.mark.parametrize("plane,kw", [
    ("Y", {}), ("UV", {}), ("Y", dict(flags=HAS_IBIS_DATA, lrc=1.33)),
    ("Y", dict(flags=HORIZONTAL_RS, fov=1.2))])
def test_project_vs_pallas_coords(plane, kw):
    cfg, dyn, pcfg, pdyn, mats, _ = make_case(plane, **kw)
    x, y, idx, u, v, valid = _jax_tiled(cfg, dyn, mats)
    tu, tv, tvalid = cuda_coords.project(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(idx.astype(np.int32)),
        torch.from_numpy(mats), pcfg, pdyn)
    np.testing.assert_array_equal(tvalid.numpy(), valid > 0.5)
    ok = valid > 0.5
    assert ok.mean() > 0.5
    assert np.abs(tu.numpy() - u)[ok].max() <= UV_TOL_PX
    assert np.abs(tv.numpy() - v)[ok].max() <= UV_TOL_PX


def _fixed_point_converged(cfg, dyn, x, y, idx, mats, u, v):
    """Where the digital lens's 12-step fixed point converged on the
    reference's result (u, v), all in the JAX package: the lens's undistort
    (its forward map) takes (u, v) back to within 0.01 px of the position
    the lens was given (the XLA projection without the digital step)."""
    cfg0 = cfg._replace(flags=cfg.flags & ~HAS_DIGITAL_LENS)
    uv0, _ = jremap.rotate_and_distort(jnp.stack([jnp.asarray(x), jnp.asarray(y)], -1),
                                       jnp.asarray(idx, jnp.int32), jnp.asarray(mats), cfg0, dyn)
    back, _ = jdm.get_model(cfg.digital_lens).undistort(
        jnp.stack([jnp.asarray(u), jnp.asarray(v)], -1), jremap._lens_params(cfg, dyn))
    return np.asarray(jnp.all(jnp.abs(back - uv0) < 0.01, axis=-1))


@pytest.mark.parametrize("model,digital", LENS_CASES)
def test_project_every_lens_vs_pallas_coords(model, digital):
    """Each of the 14 models as the main model, then each digital lens on a
    fisheye base (HAS_DIGITAL_LENS), through the port's projection and the
    Pallas coords kernel in interpret mode. A digital lens is compared where
    its fixed point converged by the JAX package's own reckoning (all but
    hyperview converge on every pixel): hyperview's does not contract near the
    plane's edges, and there the 12th iterate of the oscillation turns the
    reference's own float32 rounding differences (the jitted kernel against
    op-by-op evaluation) into tenths of a pixel."""
    cfg, dyn, pcfg, pdyn, mats, _ = make_case("Y", **lens_kw(model, digital))
    x, y, idx, u, v, valid = _jax_tiled(cfg, dyn, mats)
    tu, tv, tvalid = cuda_coords.project(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(idx.astype(np.int32)),
        torch.from_numpy(mats), pcfg, pdyn)
    np.testing.assert_array_equal(tvalid.numpy(), valid > 0.5)
    ok = valid > 0.5
    if digital is not None:
        ok &= _fixed_point_converged(cfg, dyn, x, y, idx, mats, u, v)
    # every pixel is compared but where hyperview's fixed point oscillates
    # (0.916 of them compared at this size)
    assert ok.mean() >= (0.9 if digital == "gopro_hyperview" else 1.0)
    for got, want in ((tu.numpy(), u), (tv.numpy(), v)):
        # a fixed point that diverges (a digital model fed camera
        # coordinates as the main model) is non-finite in both, and
        # gopro_warp's -99999 sentinel lands on the same pixels
        np.testing.assert_array_equal(np.isfinite(got[ok]), np.isfinite(want[ok]))
        fin = ok & np.isfinite(want)
        if fin.any():
            assert np.abs(got - want)[fin].max() <= UV_TOL_PX


@pytest.mark.parametrize("plane,kw", [
    ("Y", {}), ("UV", {}), ("Y", dict(lens_correction_amount=0.5)),
    ("Y", dict(translation2d=(2.5, -1.5))), ("Y", dict(flags=HORIZONTAL_RS))])
def test_coords_pre_vs_jax(plane, kw):
    cfg, dyn, pcfg, pdyn, mats, _ = make_case(plane, **kw)
    ow, oh = cfg.out_buffer
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    out_c, out_f = _out_c_f(cfg, dyn)
    jx, jy, jidx, _ = jremap.coords_pre(jnp.stack([jnp.asarray(xs), jnp.asarray(ys)], -1),
                                        jnp.asarray(mats), cfg, dyn, out_c, out_f)
    dt = dyn_to_torch(pdyn, torch.device("cpu"))
    tx, ty, tidx = tremap.coords_pre(torch.from_numpy(xs), torch.from_numpy(ys),
                                     torch.from_numpy(mats), pcfg, dt, out_c, out_f)
    assert tidx.dtype == torch.int32
    assert np.abs(tx.numpy() - np.asarray(jx)).max() <= UV_TOL_PX
    assert np.abs(ty.numpy() - np.asarray(jy)).max() <= UV_TOL_PX
    assert (tidx.numpy() != np.asarray(jidx)).mean() <= IDX_MISMATCH_SHARE
    assert 0 <= int(tidx.min()) and int(tidx.max()) < mats.shape[0]


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_undistort_coord_vs_jax(plane):
    """The whole plain coordinate chain (remap.py:294): coords_pre, row-matrix
    gather + projection, coords_post_uv."""
    cfg, dyn, pcfg, pdyn, mats, _ = make_case(plane, background_mode=2, fov=1.2)
    ow, oh = cfg.out_buffer
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    out_c, out_f = _out_c_f(cfg, dyn)
    juv, jvalid = jremap.undistort_coord(jnp.stack([jnp.asarray(xs), jnp.asarray(ys)], -1),
                                         jnp.asarray(mats), cfg, dyn, out_c, out_f)
    tu, tv, tvalid = tremap.undistort_coord(torch.from_numpy(xs), torch.from_numpy(ys),
                                            torch.from_numpy(mats), pcfg,
                                            dyn_to_torch(pdyn, torch.device("cpu")), out_c, out_f)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    ok = np.asarray(jvalid)
    assert np.abs(tu.numpy() - np.asarray(juv[..., 0]))[ok].max() <= UV_TOL_PX
    assert np.abs(tv.numpy() - np.asarray(juv[..., 1]))[ok].max() <= UV_TOL_PX


def test_rint_index_saturates_non_finite():
    a = torch.tensor([np.nan, np.inf, -np.inf, 2.5, 3.5, -7.0, 1e12], dtype=torch.float32)
    np.testing.assert_array_equal(tremap._rint_index(a, 100).numpy(), [0, 100, 0, 2, 4, 0, 100])


def test_wrapper_rejects_unported_configs():
    _, _, pcfg, pdyn, mats, _ = make_case("Y")
    x = torch.zeros(4, 4)
    idx = torch.zeros(4, 4, dtype=torch.int32)
    m = torch.from_numpy(mats)
    mesh_cfg = pcfg._replace(flags=512, mesh_grid=(9, 9))              # HAS_MESH_DATA
    with pytest.raises(ValueError, match="no mesh buffer"):
        cuda_coords._check(x, x, idx, m, mesh_cfg)
    with pytest.raises(ValueError, match="needs"):
        cuda_coords._check(x, x, idx, m, mesh_cfg, torch.zeros(16))
    with pytest.raises(TypeError, match="mesh"):
        cuda_coords._check(x, x, idx, m, mesh_cfg, torch.zeros(2000, dtype=torch.float64))
    # the kernel takes a packed buffer (cuda_coords.pack_mesh), of exactly its length
    with pytest.raises(ValueError, match="pack_mesh"):
        cuda_coords._check(x, x, idx, m, mesh_cfg, torch.zeros(2000))
    cuda_coords._check(x, x, idx, m, mesh_cfg, torch.zeros(cuda_coords.packed_len(mesh_cfg)))
    cuda_coords._check(x, x, idx, m, pcfg._replace(distortion_model="sony"))
    cuda_coords._check(x, x, idx, m, pcfg._replace(digital_lens="gopro_warp",
                                                   flags=HAS_DIGITAL_LENS))
    with pytest.raises(TypeError):
        cuda_coords._check(x, x, idx.float(), m, pcfg)
    with pytest.raises(ValueError):
        cuda_coords._check(x, x[:2], idx, m, pcfg)
    cuda_coords._check(x, x, idx, m, pcfg)


def test_coord_params_layout():
    """The by-value struct carries pallas_coords.pack_params' 39 fields in
    order (k .. stretch, digital_lens_params), then remap._lens_params'
    plane sizes."""
    _, dyn, pcfg, pdyn, _, _ = make_case("UV", lrc=1.2, **lens_kw("opencv_fisheye", "gopro_warp"))
    p = cuda_coords.coord_params(pcfg, pdyn)
    packed = np.asarray(pallas_coords.pack_params(dyn))[0, :39]
    got = np.array(list(p.k) + list(p.f) + list(p.c) + list(p.t3d)
                   + [p.r_limit, p.lrc, p.stretch_h, p.stretch_v] + list(p.dlp), np.float32)
    np.testing.assert_array_equal(got, packed)
    assert (p.width, p.height, p.output_width, p.output_height) == (
        pcfg.width, pcfg.height, pcfg.output_width, pcfg.output_height)


@pytest.mark.parametrize("model,digital", LENS_CASES)
def test_lens_ids(model, digital):
    """The kernels' (model, digital) ids: distortion_models.MODEL_IDS, -1
    without a digital lens; a digital lens needs HAS_DIGITAL_LENS."""
    from gyroflow_torch.ops import distortion_models as tdm
    _, _, pcfg, _, _, _ = make_case("Y", **lens_kw(model, digital))
    want = (tdm.MODEL_IDS[model], -1 if digital is None else tdm.MODEL_IDS[digital])
    assert cuda_coords.lens_ids(pcfg) == want
    assert cuda_coords.lens_ids(pcfg._replace(flags=0))[1] == -1
