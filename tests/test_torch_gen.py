"""gyroflow_torch's self-contained coords (``cuda_coords.project_gen``) vs the
JAX package's ``pallas_coords.project_tiles_gen``, on the CPU.

- ``project_gen`` on CPU tensors (its plain version) against
  ``project_tiles_gen`` with the Pallas kernel in interpret mode, untiled
  with ``pallas_sampler.out_untileize_c``: Y, UV with source/output rects,
  horizontal rolling shutter, an eps ``pos_dx`` (an EWA finite-difference
  eval) and a band with ``oy0 > 0`` and ``out_rows < oh``.
- ``project_gen`` against ``remap.coords_pre`` + ``cuda_coords.project`` on
  the same band (the split path it replaces): bit-identical on the CPU.
- Every main model (one case: opencv_standard); the configurations the
  kernel does not compute (lens correction, mesh, digital lens, as JAX
  gates project_tiles_gen) raise ValueError instead of a different answer.

Tolerances: u/v within 0.05 px (the ROADMAP's coordinate tolerance; the
JAX kernel's in-kernel probe and XLA round the same chain a few ulp apart),
valid masks identical.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import pallas_coords, pallas_sampler
from gyroflow_tpu.ops.kernel_params import HORIZONTAL_RS
from gyroflow_torch.ops import cuda_coords
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.ops.kernel_params import HAS_DIGITAL_LENS, HAS_MESH_DATA, dyn_to_torch

from test_torch_coords import _out_c_f
from test_torch_remap import lens_kw, make_case
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

UV_TOL_PX = 0.05
TILE_H, TILE_W = 8, 128


def _jax_gen(cfg, dyn, mats, out_rows, oy0, pos_dx=0.0, pos_dy=0.0):
    """project_tiles_gen on the (ceil(out_rows/8), ceil(ow/128)) tile grid,
    untiled to (out_rows, ow) u, v, valid."""
    ow = cfg.out_buffer[0]
    ny, nx = -(-out_rows // TILE_H), -(-ow // TILE_W)
    out_c, out_f = _out_c_f(cfg, dyn)
    u, v, valid, ov = pallas_coords.project_tiles_gen(
        cfg, dyn, jnp.asarray(mats), ny, nx, TILE_H, TILE_W, oy0, out_c, out_f,
        pos_dx=pos_dx, pos_dy=pos_dy)
    assert not bool(ov), "matrix window overflow at test size"
    spec = SimpleNamespace(grid=(ny, nx), tile_h=TILE_H, tile_w=TILE_W,
                           out_height=out_rows, out_width=ow)
    return [np.array(pallas_sampler.out_untileize_c(spec, jnp.asarray(a, jnp.float32)[None])[0])
            for a in (u, v, valid)]


# (plane, make_case kwargs, out_rows or None for the whole plane, oy0, pos_dx)
CASES = [
    ("Y", {}, None, 0, 0.0),
    ("UV", dict(translation2d=(1.5, -2.0)), None, 0, 0.01),
    ("Y", dict(flags=HORIZONTAL_RS, fov=1.2), 24, 16, 0.0),
    ("Y", lens_kw("opencv_standard"), 40, 8, 0.0),      # a main model other than fisheye
]


@pytest.mark.parametrize("plane,kw,out_rows,oy0,pos_dx", CASES)
def test_project_gen_vs_project_tiles_gen(plane, kw, out_rows, oy0, pos_dx):
    cfg, dyn, pcfg, pdyn, mats, _ = make_case(plane, **kw)
    rows = out_rows or cfg.out_buffer[1]
    ju, jv, jvalid = _jax_gen(cfg, dyn, mats, rows, oy0, pos_dx=pos_dx)
    out_c, out_f = _out_c_f(cfg, dyn)
    tu, tv, tvalid = cuda_coords.project_gen(pcfg, pdyn, torch.from_numpy(mats), rows, oy0,
                                             out_c, out_f, pos_dx=pos_dx)
    assert tuple(tu.shape) == (rows, cfg.out_buffer[0]) and tvalid.dtype == torch.bool
    np.testing.assert_array_equal(tvalid.numpy(), jvalid > 0.5)
    ok = jvalid > 0.5
    assert ok.mean() > 0.5
    assert np.abs(tu.numpy() - ju)[ok].max() <= UV_TOL_PX
    assert np.abs(tv.numpy() - jv)[ok].max() <= UV_TOL_PX


@pytest.mark.parametrize("plane,kw,out_rows,oy0,pos_dx", CASES)
def test_project_gen_is_coords_pre_plus_project(plane, kw, out_rows, oy0, pos_dx):
    _, dyn, pcfg, pdyn, mats, _ = make_case(plane, **kw)
    ow, oh = pcfg.out_buffer
    rows = out_rows or oh
    out_c, out_f = _out_c_f(pcfg, dyn)
    m = torch.from_numpy(mats)
    dt = dyn_to_torch(pdyn, torch.device("cpu"))
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32),
                            torch.arange(ow, dtype=torch.float32), indexing="ij")
    x, y, idx = tremap.coords_pre(ox + pos_dx, oy, m, pcfg, dt, out_c, out_f)
    want = cuda_coords.project(x[oy0:oy0 + rows].contiguous(), y[oy0:oy0 + rows].contiguous(),
                               idx[oy0:oy0 + rows].contiguous(), m, pcfg, pdyn)
    got = cuda_coords.project_gen(pcfg, pdyn, m, rows, oy0, out_c, out_f, pos_dx=pos_dx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("change", [
    dict(lens_correction=True), dict(flags=HAS_MESH_DATA), dict(flags=HAS_DIGITAL_LENS),
    dict(digital_lens="gopro_superview")])
def test_gated_configurations_raise(change):
    _, dyn, pcfg, pdyn, mats, _ = make_case("Y")
    out_c, out_f = _out_c_f(pcfg, dyn)
    with pytest.raises(ValueError, match="project_tiles_gen"):
        cuda_coords.project_gen(pcfg._replace(**change), pdyn, torch.from_numpy(mats), 8, 0,
                                out_c, out_f)


def test_gen_args_layout():
    """The by-value GenArgs: out-rect map, translation2d and the RS clip."""
    _, _, pcfg, pdyn, _, _ = make_case("UV", flags=HORIZONTAL_RS, translation2d=(3.0, -1.0))
    g = cuda_coords.gen_args(pcfg, pdyn, 5, 0.01, 0.0)
    orx, ory, orw, orh = pcfg.out_rect
    assert g.oy0 == 5 and list(g.pos_d) == [np.float32(0.01), 0.0]
    assert list(g.map_x) == [orx, pcfg.output_width, np.float32(1.0) / np.float32(orw)]
    assert list(g.map_y) == [ory, pcfg.output_height, np.float32(1.0) / np.float32(orh)]
    assert list(g.t2d) == [3.0, -1.0] and g.lim == pcfg.width


def test_gen_args_translation_has_no_negative_zero():
    """The kernel adds translation2d straight to the out-rect map (no + 0
    for the map's out_min): gen_args sends a -0 as +0, and then the kernel's
    sum has the plain version's bits for every map value, -0 included."""
    _, _, pcfg, pdyn, _, _ = make_case("Y", translation2d=(-0.0, 2.5))
    g = cuda_coords.gen_args(pcfg, pdyn, 0, 0.0, 0.0)
    assert list(g.t2d) == [0.0, 2.5] and not np.signbit(g.t2d[0])
    f32 = np.float32
    for a in (f32(-0.0), f32(0.0), f32(1.5), f32(-3.25), f32(np.inf), f32(-np.inf)):
        for t in (f32(-0.0), f32(0.0), f32(2.5), f32(-1.0)):
            want = (a + f32(0.0)) + t
            got = a + (t + f32(0.0))
            assert np.array_equal(np.array(want).view(np.int32), np.array(got).view(np.int32))
