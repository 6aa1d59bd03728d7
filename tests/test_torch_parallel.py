"""gyroflow_torch's sharded frame window (parallel.pipeline) on the CPU.

Mirrors tests/test_parallel.py and the band tests of
tests/test_render_sharded.py. The JAX side runs on its 8 virtual CPU
devices (tests/conftest.py), its Pallas kernels in interpret mode; the port
side runs on logical CPU shards (``make_frame_mesh(devices=["cpu"] * n)``),
where the kernel wrappers take their plain versions.

- ``stabilize_window_sharded`` on a dp x sp mesh (sp 1 and 2) against the
  JAX sharded window on the same seeded inputs: 0.25 of a code in float32;
  against the port's plain per-frame ``stabilize_window`` and JAX's vmapped
  XLA window as test_parallel.py holds them (1.5: the LUT's 32 phases
  against XLA's full phase).
- ``remap_plane_cuda(out_rows, oy0)`` bands assembled against the whole
  plane, for lanczos4, EWA 11, a Sony mesh + FPD + IBIS frame and
  FILL_WITH_BACKGROUND: within 1e-5 in float32 and 0 codes in uint16.
- the production step's kernel route (the bands through
  ``remap_plane_cuda``) on logical shards against its one-device run, and
  the manager's refusal of a mesh that does not start on its device (the
  manager's window on dp x sp meshes: test_torch_window.py).
- ``make_frame_mesh``'s grid, its refusals (fewer cards than asked for,
  devices of two types), the window's divisibility errors, and the
  renderer's dp/sp rule for 1, 4 and 8 devices.
"""
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import FILL_WITH_BACKGROUND
from gyroflow_tpu.parallel import make_frame_mesh as jax_frame_mesh
from gyroflow_tpu.parallel import stabilize_window as jax_window
from gyroflow_tpu.parallel import stabilize_window_sharded as jax_sharded
from gyroflow_torch.core import lens_profile as tlp
from gyroflow_torch.core.manager import StabilizationManager
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.parallel import (make_frame_mesh, stabilize_window, stabilize_window_sharded,
                                     stack_dynamics)
from gyroflow_torch.parallel.pipeline import stabilize_window_production
from gyroflow_torch.render.renderer import plan_window

from test_end_to_end import gcsv_path  # noqa: F401 (fixture)
from test_parallel import _make_window
from test_torch_manager import _build
from test_torch_mesh import _mesh_case
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_window import TS_US, _frames

F32_TOL = 0.25       # of a code, float32 (the ROADMAP's pixel tolerance)


def _port_window(imgs, matss, cfg, dyns):
    """The JAX window's inputs as the port takes them: numpy frames and
    matrices, the port's KernelConfig and host-numpy stacked dynamics."""
    pcfg, _ = tkp.from_reference(cfg, jax_slice(dyns, 0))
    pdyns = stack_dynamics([tkp.from_reference(cfg, jax_slice(dyns, i))[1]
                            for i in range(imgs.shape[0])])
    return np.array(imgs), np.array(matss), pcfg, pdyns


def jax_slice(dyns, i):
    return type(dyns)(*(np.asarray(x)[i] for x in dyns))


@pytest.fixture(scope="module")
def window():
    return _make_window()


@pytest.fixture(scope="module")
def eager(window):
    """JAX's op-by-op remap of each frame (no jit): the order of float
    operations the port follows."""
    imgs, matss, cfg, dyns = window
    return np.stack([np.asarray(jremap.remap_plane(imgs[i], matss[i], cfg, jax_slice(dyns, i)))
                     for i in range(imgs.shape[0])])


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_matches_jax_sharded(window, eager, sp):
    """Within 0.25 of a code of JAX's sharded window wherever JAX's jitted
    window agrees with its own op-by-op remap, and of the op-by-op remap
    everywhere. On this uniform-noise window the jitted program's fused
    float order moves a few pixels (at most 2 a frame) by a LUT phase, up to
    5.4 codes, from JAX's own op-by-op result, as ROADMAP queue 3 item 6
    records for EWA."""
    imgs, matss, cfg, dyns = window
    want, overflow = jax_sharded(jax_frame_mesh(8, sp=sp), imgs, matss, cfg, dyns,
                                 win_h=64, win_w=128)
    want = np.asarray(want)
    assert not bool(np.asarray(overflow).any())
    mesh = make_frame_mesh(8, sp=sp, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 8 // sp, "sp": sp}
    got = stabilize_window_sharded(mesh, *_port_window(imgs, matss, cfg, dyns))
    assert got.dtype == torch.float32 and tuple(got.shape) == imgs.shape
    got = got.numpy()
    assert np.abs(got - eager).max() <= F32_TOL
    jit_agrees = np.abs(want - eager) <= F32_TOL
    assert (~jit_agrees).sum() <= 2 * imgs.shape[0]
    assert np.abs(got - want)[jit_agrees].max() <= F32_TOL


def test_sharded_matches_plain_window(window, eager):
    """The sharded kernel route against the plain per-frame window, as
    test_sharded_matches_xla_fallback holds JAX's (1.5 codes); the plain
    window against JAX's op-by-op remap within 0.25, and against its vmapped
    XLA window wherever that agrees with the op-by-op remap."""
    imgs, matss, cfg, dyns = window
    imgs, matss, dyns = imgs[:4], matss[:4], type(dyns)(*(x[:4] for x in dyns))
    args = _port_window(imgs, matss, cfg, dyns)
    got = stabilize_window_sharded(make_frame_mesh(8, sp=2, devices=["cpu"] * 8), *args)
    plain = stabilize_window(*args).numpy()
    assert np.abs(got.numpy() - plain).max() <= 1.5
    assert np.abs(plain - eager[:4]).max() <= F32_TOL
    want = np.asarray(jax_window(imgs, matss, cfg, dyns))
    jit_agrees = np.abs(want - eager[:4]) <= F32_TOL
    assert np.abs(plain - want)[jit_agrees].max() <= F32_TOL


def test_sharded_divisibility_errors(window):
    imgs, matss, cfg, dyns = window
    args = _port_window(imgs, matss, cfg, dyns)
    with pytest.raises(ValueError, match="frame window 8 not divisible by dp=3"):
        stabilize_window_sharded(make_frame_mesh(3, devices=["cpu"] * 3), *args)
    with pytest.raises(ValueError, match="output height 64 not divisible by sp=3"):
        stabilize_window_sharded(make_frame_mesh(6, sp=3, devices=["cpu"] * 6), *args)


# ---- bands of remap_plane_cuda assembled against the whole plane -----------

def _band_case(case):
    """(port cfg, port dyn, matrices, 10-bit frame, mesh buffer or None)."""
    if case == "sony_mesh":
        cfg, dyn, _, mats, mesh = _mesh_case(fpd=True, ibis=True)
        cfg = cfg._replace(interpolation=8)
        mesh = np.asarray(mesh, np.float32)
    else:
        imgs, matss, cfg, dyns = _make_window(F=1)
        dyn, mats, mesh = jax_slice(dyns, 0), np.array(matss[0]), None
        cfg = cfg._replace(interpolation=11 if case == "ewa11" else 8)
        if case == "ewa11":
            p, q = jremap.ewa_coeffs(11)
            dyn = dyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                               ewa_coeffs_q=np.asarray(q, np.float32))
        if case == "fill":
            cfg = cfg._replace(flags=cfg.flags | FILL_WITH_BACKGROUND)
    pcfg, pdyn = tkp.from_reference(cfg, dyn._replace(max_pixel_value=np.float32(1023.0),
                                                      pixel_value_limit=np.float32(1023.0)))
    ow, oh = pcfg.out_buffer
    img = np.random.default_rng(11).integers(0, 1024, (pcfg.height, pcfg.width, 1))
    return pcfg, pdyn, torch.from_numpy(mats), torch.from_numpy(img.astype(np.uint16)), mesh


@pytest.mark.parametrize("out_dtype", ["f32", "uint16"])
@pytest.mark.parametrize("case", ["lanczos4", "ewa11", "sony_mesh", "fill"])
def test_row_band_offset_assembles(case, out_dtype):
    """Two halves, and three bands of unequal height, give the whole
    plane's bits (within 1e-5 in float32, 0 codes in uint16)."""
    cfg, dyn, mats, img, mesh = _band_case(case)
    oh = cfg.out_buffer[1]
    full = tremap.remap_plane_cuda(img, mats, cfg, dyn, mesh, out_dtype=out_dtype)
    for cuts in ((0, oh // 2, oh), (0, oh // 3, oh // 3 + 7, oh)):
        bands = [tremap.remap_plane_cuda(img, mats, cfg, dyn, mesh, out_dtype=out_dtype,
                                         out_rows=b - a, oy0=a)
                 for a, b in zip(cuts[:-1], cuts[1:])]
        for (a, b), band in zip(zip(cuts[:-1], cuts[1:]), bands):
            assert tuple(band.shape) == (b - a,) + tuple(full.shape[1:]) and band.dtype == full.dtype
        got = torch.cat(bands)
        if out_dtype == "f32":
            assert float((got - full).abs().max()) <= 1e-5
        else:
            assert torch.equal(got, full)
    if case == "fill":
        assert bool((full == full[0, 0]).all())


def test_band_refusals():
    cfg, dyn, mats, img, _ = _band_case("lanczos4")
    oh = cfg.out_buffer[1]
    for rows, oy0 in ((oh, 1), (-1, 0), (8, -8)):
        with pytest.raises(ValueError, match="output band"):
            tremap.remap_plane_cuda(img, mats, cfg, dyn, out_rows=rows, oy0=oy0)


# ---- the window through the managers ---------------------------------------

@pytest.fixture(scope="module")
def tm(gcsv_path):  # noqa: F811
    return _build(StabilizationManager(device="cpu"), tlp, gcsv_path)


def _kw(plane, maxv, interpolation=8):
    return dict(interpolation=interpolation, plane_index=0 if plane == "Y" else 1,
                max_pixel_value=maxv, plane_rects=True)


@pytest.mark.parametrize("interpolation,dtype", [(8, "uint16"), (11, "uint16"), (8, "uint8")])
def test_production_kernel_route_on_shards(tm, interpolation, dtype):
    """The production step's kernel route (the bands through
    remap_plane_cuda) on a 2 x 2 mesh of logical shards against its run on
    one device: 0 codes, in the output dtype."""
    maxv = 255.0 if dtype == "uint8" else 1023.0
    frames = _frames(dtype, "UV", 2)
    fts = [tm.frame_transform_at(tm._adjusted_ts_ms(ts)) for ts in TS_US[:2]]
    cfg, dyns = zip(*(tm._plane_cfg_dyn(ft, frames.shape[1:], interpolation, 1, maxv, True,
                                        None, None) for ft in fts))
    args = (frames, np.stack([ft.matrices for ft in fts]), cfg[0], stack_dynamics(dyns))
    one, b1 = stabilize_window_production(make_frame_mesh(device="cpu"), *args,
                                          out_dtype=dtype, use_kernels=True)
    got, b4 = stabilize_window_production(make_frame_mesh(devices=["cpu"] * 4, sp=2), *args,
                                          out_dtype=dtype, use_kernels=True)
    assert (b1, b4) == ("torch-cpu-window", "torch-cpu-sharded")
    assert got.dtype == getattr(torch, dtype) and torch.equal(got, one)


def test_window_mesh_must_start_on_the_managers_device(tm):
    frames = _frames("uint16", "Y", 2)
    with pytest.raises(ValueError, match="frame mesh on meta"):
        tm.process_pixels_window(TS_US[:2], frames, make_frame_mesh(devices=["meta"]),
                                 **_kw("Y", 1023.0))
    with pytest.raises(ValueError, match="frame window 2 not divisible by dp=4"):
        tm.process_pixels_window(TS_US[:2], frames, make_frame_mesh(devices=["cpu"] * 4),
                                 **_kw("Y", 1023.0))


# ---- make_frame_mesh --------------------------------------------------------

def test_frame_mesh_grid_of_logical_shards():
    mesh = make_frame_mesh(8, sp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2} and mesh.device == torch.device("cpu")
    assert all(len(row) == 2 for row in mesh.devices)
    assert make_frame_mesh(devices=["cpu"] * 6, sp=4).shape == {"dp": 1, "sp": 4}
    assert make_frame_mesh(1, device="cpu").shape == {"dp": 1, "sp": 1}
    assert make_frame_mesh(1, device="cpu") == make_frame_mesh(devices=["cpu"])


def test_frame_mesh_refusals():
    """Cards by default, and never the CPU in their place: fewer cards than
    asked for raise (here there are none)."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for n in (n_cards + 1, 2 * n_cards + 2):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_frame_mesh(n)
    if n_cards == 0:
        with pytest.raises(RuntimeError, match="0 present"):
            make_frame_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_frame_mesh(devices=["cuda:0"])
    with pytest.raises(ValueError, match="2 devices: 1 named"):
        make_frame_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="sp=3"):
        make_frame_mesh(devices=["cpu"] * 2, sp=3)
    with pytest.raises(ValueError, match="more than one type"):
        make_frame_mesh(devices=["cpu", "meta"])


# ---- the renderer's dp/sp rule ---------------------------------------------

@pytest.mark.parametrize("n_dev,frame_window,shard_sp,oh,yuv,want", [
    (1, 0, 1, 2160, True, (8, (1, 1))),       # one device: 8-frame windows
    (1, 0, 4, 2160, True, (8, (1, 1))),       # sp clips to the device count
    (1, 1, 1, 2160, True, (1, None)),         # frame_window=1 opts out
    (4, 0, 1, 2160, True, (4, (4, 1))),       # auto: one frame a device
    (4, 0, 2, 2160, True, (4, (2, 2))),
    (4, 6, 2, 2160, True, (6, (2, 2))),
    (4, 7, 1, 2160, True, (4, (4, 1))),       # rounded down to a multiple of dp
    (4, 0, 4, 2162, True, (1, None)),         # chroma's 1081 rows do not split in 4
    (4, 0, 2, 1082, False, (4, (2, 2))),      # no chroma plane: oh / sp is enough
    (8, 0, 1, 2160, True, (8, (8, 1))),
    (8, 0, 2, 2160, True, (8, (4, 2))),
    (8, 3, 2, 2160, True, (3, (3, 2))),
    (8, 0, 16, 2160, True, (8, (1, 8))),
])
def test_renderer_window_plan(n_dev, frame_window, shard_sp, oh, yuv, want):
    """gyroflow_tpu/render/renderer.py:535-560's rule."""
    assert plan_window(n_dev, frame_window, shard_sp, oh, yuv) == want
