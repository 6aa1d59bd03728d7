"""The drawing overlay in gyroflow_torch, on the CPU.

The port's counterpart of test_drawing.py's TestBlend: the same canvases
and planes go through the port's ``remap_plane`` (the plain overlay,
``remap._draw_overlay``) and ``remap_plane_cuda`` (``cuda_overlay.overlay``,
whose wrapper runs the plain version on CPU tensors), and through the JAX
package's ``remap_plane`` (XLA) and ``remap_plane_pallas`` (interpret mode,
the canvas fetch riding the Pallas sampler). Each case keeps test_drawing.py's
own pixel checks and holds the whole output within 1e-3 of both JAX paths
(the overlay is a blend of exact canvas bytes; float rounding of the
blend's products is far below it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import DRAWING_ENABLED
from gyroflow_torch.core.drawing import (COLOR_GREEN, COLOR_RED, DrawCanvas, STAGE_ON_INPUT,
                                         STAGE_ON_OUTPUT)
from gyroflow_torch.ops import cuda_overlay, kernel_params as tkp
from gyroflow_torch.ops import remap as tremap

from test_drawing import H, W, identityish_matrices, make_cfg_dyn
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-3


def _run(state, flags=DRAWING_ENABLED, fill=100.0, c=3, mats=None):
    """The plane through the four routes: (port plain, port kernel path,
    JAX XLA, JAX Pallas), each (H, W, c) float32."""
    cfg, dyn = make_cfg_dyn(flags)
    mats = identityish_matrices() if mats is None else jnp.asarray(mats, jnp.float32)
    img = np.full((H, W, c), fill, np.float32)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    tm = torch.from_numpy(np.array(mats))
    plain = tremap.remap_plane(torch.from_numpy(img), tm, pcfg, pdyn, drawing=state).numpy()
    kern = tremap.remap_plane_cuda(torch.from_numpy(img), tm, pcfg, pdyn, drawing=state).numpy()
    xla = np.asarray(jremap.remap_plane(jnp.asarray(img), mats, cfg, dyn, drawing=state))
    pal, ov = jremap.remap_plane_pallas(jnp.asarray(img), mats, cfg, dyn, drawing=state)
    assert not bool(ov)
    return plain, kern, xla, np.asarray(pal)


def _check_routes(outs):
    plain, kern, xla, pal = outs
    assert np.array_equal(plain, kern)
    assert np.abs(plain - xla).max() <= TOL
    assert np.abs(plain - pal).max() <= TOL
    return plain


class TestBlend:
    def test_output_stage_colored(self):
        c = DrawCanvas(W, H, W, H, 1)
        c.put_pixel(40, 30, COLOR_RED, 0, STAGE_ON_OUTPUT)  # alpha 100%
        out = _check_routes(_run(c.state()))
        np.testing.assert_allclose(out[30, 40], [255.0, 0.0, 0.0], atol=TOL)
        np.testing.assert_allclose(out[31, 40], 100.0, atol=TOL)

    def test_alpha_blend_50(self):
        c = DrawCanvas(W, H, W, H, 1)
        c.put_pixel(40, 30, COLOR_RED, 2, STAGE_ON_OUTPUT)  # Alpha50
        out = _check_routes(_run(c.state()))
        np.testing.assert_allclose(out[30, 40], [255 * 0.5 + 100 * 0.5, 100 * 0.5, 100 * 0.5],
                                   atol=TOL)

    def test_stage_gating(self):
        c = DrawCanvas(W, H, W, H, 1)
        c.put_pixel(40, 30, COLOR_RED, 0, STAGE_ON_OUTPUT)
        out = _check_routes(_run(c.state(), flags=0))   # DRAWING_ENABLED off: untouched
        np.testing.assert_allclose(out[30, 40], 100.0, atol=TOL)

    def test_input_stage_draws_at_source_position(self):
        c = DrawCanvas(W, H, W, H, 1)
        c.put_pixel(64, 48, COLOR_GREEN, 0, STAGE_ON_INPUT, size=3)
        out = _check_routes(_run(c.state()))
        assert (np.abs(out[44:53, 60:69, 1] - 255.0) < 1.0).any()

    def test_safe_area_dimming(self):
        c = DrawCanvas(W, H, W, H, 1)
        out = _check_routes(_run(c.state(safe_area_rect=(20.0, 20.0, 100.0, 70.0)), fill=200.0))
        np.testing.assert_allclose(out[40, 60], 200.0, atol=TOL)     # inside
        np.testing.assert_allclose(out[40, 110], 100.0, atol=TOL)    # outside
        np.testing.assert_allclose(out[40, 102], 50.0, atol=TOL)     # border band

    def test_pallas_path_falls_back(self):
        c = DrawCanvas(W, H, W, H, 1)
        c.put_pixel(40, 30, COLOR_RED, 0, STAGE_ON_OUTPUT)
        out = _check_routes(_run(c.state(), c=1))
        np.testing.assert_allclose(out[30, 40], [255.0], atol=TOL)


def _busy_canvas(scale):
    """Every colour and alpha on both stages, marks of 1-4 px, on a scaled
    canvas."""
    c = DrawCanvas(W, H, W, H, scale)
    for i in range(48):
        c.put_pixel(3 + 2.6 * i, 4 + 1.8 * i, 1 + i % 8, i % 4,
                    STAGE_ON_OUTPUT if i % 3 else STAGE_ON_INPUT, size=1 + i % 4)
    return c


def _rs_matrices():
    """identityish_matrices' intrinsics through a rotation that drifts
    across the rows (rolling shutter)."""
    import math
    new_k = np.array([[W * 0.8, 0, W / 2], [0, W * 0.8, H / 2], [0, 0, 1.0]])
    rows = []
    for i in range(H):
        a = 0.02 + 4e-4 * i
        r = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        rows.append(list(np.linalg.inv(new_k @ r).flatten()) + [0.0] * 5)
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("c", [1, 2])
def test_busy_canvas_through_rs_matrices(scale, c):
    """A full canvas, a safe area and per-row rolling-shutter matrices (the
    input stage lands away from the output stage)."""
    state = _busy_canvas(scale).state(safe_area_rect=(12.0, 9.0, W - 15.0, H - 11.0))
    out = _check_routes(_run(state, c=c, mats=_rs_matrices()))
    assert np.abs(out - 100.0).max() > 1.0


def test_overlay_on_the_ewa_path():
    """The overlay after EWA sampling (interpolation 11), against the JAX
    XLA route."""
    cfg, dyn = make_cfg_dyn()
    p, q = jremap.ewa_coeffs(11)
    cfg = cfg._replace(interpolation=11)
    dyn = dyn._replace(ewa_coeffs_p=jnp.asarray(p, jnp.float32),
                       ewa_coeffs_q=jnp.asarray(q, jnp.float32))
    state = _busy_canvas(1).state(safe_area_rect=(12.0, 9.0, W - 15.0, H - 11.0))
    mats = _rs_matrices()
    img = np.full((H, W, 2), 100.0, np.float32)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    args = (torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn)
    plain = tremap.remap_plane(*args, drawing=state).numpy()
    kern = tremap.remap_plane_cuda(*args, drawing=state).numpy()
    xla = np.asarray(jremap.remap_plane(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                        drawing=state))
    assert np.array_equal(plain, kern)
    assert np.abs(plain - xla).max() <= TOL


def test_overlay_wrapper_checks():
    pixel = torch.zeros(4, 5, 1)
    u = torch.zeros(4, 5)
    canvas = torch.zeros(4, 5, dtype=torch.uint8)
    with pytest.raises(TypeError):
        cuda_overlay.overlay(pixel, u, u, canvas.float(), 1.0, None, (0, 0, 5, 4), 255.0)
    with pytest.raises(ValueError):
        cuda_overlay.overlay(pixel, u[:3], u, canvas, 1.0, None, (0, 0, 5, 4), 255.0)
    with pytest.raises(ValueError):
        cuda_overlay.overlay(torch.zeros(4, 5, 5), u, u, canvas, 1.0, None, (0, 0, 5, 4), 255.0)
    args = cuda_overlay.overlay_args(2.0, (1.0, 2.0, 3.0, 4.0), (0, 1, 5, 4), 1023.0)
    assert args.safe == 1 and list(args.band) == [-4.0, -3.0, 8.0, 9.0]
    assert list(args.src) == [0.0, 1.0, 5.0, 5.0] and args.maxv == 1023.0
    assert cuda_overlay.overlay_args(1.0, None, (0, 0, 5, 4), 255.0).safe == 0


@pytest.mark.parametrize("oy0,rows", [(5, 35), (57, 39)])
@pytest.mark.parametrize("c", [1, 2])
def test_band_with_drawing_matches_the_jax_band(oy0, rows, c):
    """A band of output rows with a drawing: the safe-area rect's edge (and
    its 5-px border) crosses the band, output-stage marks lie above and
    below that edge, and the RS matrices move the input stage. The port's
    band (remap_plane_cuda(out_rows, oy0), the overlay's plain version on
    the CPU) matches the JAX band of remap_plane_pallas (interpret mode),
    which draws at absolute rows, and equals the same rows of the port's
    whole plane."""
    cfg, dyn = make_cfg_dyn()
    state = _busy_canvas(1).state(safe_area_rect=(12.0, 9.0, W - 15.0, H - 11.0))
    mats = _rs_matrices()
    img = np.full((H, W, c), 100.0, np.float32)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    args = (torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn)
    band = tremap.remap_plane_cuda(*args, drawing=state, out_rows=rows, oy0=oy0).numpy()
    whole = tremap.remap_plane_cuda(*args, drawing=state).numpy()
    pal, ov = jremap.remap_plane_pallas(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                        drawing=state, out_rows=rows, oy0=oy0)
    assert not bool(ov)
    assert band.shape == (rows, W, c)
    assert np.array_equal(band, whole[oy0:oy0 + rows])
    assert np.abs(band - np.asarray(pal)).max() <= TOL
    # the drawing is there: dimmed rows outside the safe area and marks
    assert np.abs(band - 100.0).max() > 1.0


def test_overlay_band_rows_are_absolute():
    """overlay_args carries the band's first row; the plain version draws an
    output-stage mark and the safe-area dim at absolute rows."""
    assert cuda_overlay.overlay_args(1.0, None, (0, 0, 5, 4), 255.0).oy0 == 0
    assert cuda_overlay.overlay_args(1.0, None, (0, 0, 5, 4), 255.0, oy0=37).oy0 == 37
    c = DrawCanvas(W, H, W, H, 1)
    c.put_pixel(40, 30, COLOR_RED, 0, STAGE_ON_OUTPUT)
    state = c.state(safe_area_rect=(0.0, 28.0, W - 1.0, H - 1.0))
    canvas = torch.from_numpy(np.ascontiguousarray(state.canvas, np.uint8))
    pixel = torch.full((4, W, 3), 100.0)
    u = torch.full((4, W), -10.0)
    args = (canvas, 1.0, state.safe_area_rect, (0, 0, W, H), 255.0)
    out = cuda_overlay.overlay(pixel, u, u, *args, oy0=28).numpy()
    np.testing.assert_allclose(out[2, 40], [255.0, 0.0, 0.0])     # row 30
    np.testing.assert_allclose(out[0, 10], 100.0)                 # row 28: inside
    np.testing.assert_allclose(out[2, 41], 100.0)
    top = cuda_overlay.overlay(pixel, u, u, *args).numpy()         # rows 0-3: outside
    np.testing.assert_allclose(top[:, 40], 50.0)
    with pytest.raises(ValueError):
        cuda_overlay.overlay(pixel, u, u, *args, oy0=-1)
