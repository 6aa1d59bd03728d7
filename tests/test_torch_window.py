"""gyroflow_torch's frame window (process_pixels_window, parallel.pipeline)
on the CPU.

The managers are test_torch_manager.py's (128x96, fisheye, 8 ms rolling
shutter, the seeded .gcsv of test_end_to_end.py), one per package.

- The port's window against the JAX manager's (a 1-device mesh, the XLA
  path, use_pallas=False) on F = 4 frames of Y and UV YUV420 planes with
  plane_rects: within 1 code for uint16 and uint8 out, 0.25 code in float32.
- The port's window against its own per-frame process_pixels: 0 codes.
- EWA (interpolation 11) on F = 2 frames, against both.
- The window on dp x sp meshes of logical CPU shards against the
  one-device window (0 codes) and, float32 on 2 x 2 shards, against the
  JAX manager's window on its 4-device mesh (0.25 code); without enough
  cards ``make_frame_mesh`` raises (the sharded window's kernel route and
  the bands: test_torch_parallel.py).
- A window whose kernel configs differ goes through process_pixels frame
  by frame; a mesh buffer too short for its grid raises (Sony windows:
  test_torch_mesh.py); with stabilization off the frames come back
  unchanged.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gyroflow_tpu.core import lens_profile as jlp
from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_tpu.parallel.pipeline import make_frame_mesh as jax_frame_mesh
from gyroflow_torch.core import lens_profile as tlp
from gyroflow_torch.core.manager import StabilizationManager
from gyroflow_torch.parallel.pipeline import FrameMesh, make_frame_mesh

from test_end_to_end import H, W, gcsv_path  # noqa: F401 (fixture)
from test_torch_manager import _build
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TS_US = [466_667, 500_000, 533_333, 566_667]
# (max_pixel_value, tolerance in codes) of each input dtype
DTYPES = {"uint16": (1023.0, 1.0), "uint8": (255.0, 1.0), "float32": (1023.0, 0.25)}


@pytest.fixture(scope="module")
def managers(gcsv_path):  # noqa: F811
    return (_build(StabilizationManager(device="cpu"), tlp, gcsv_path),
            _build(JManager(), jlp, gcsv_path))


def _frames(dtype: str, plane: str, n: int):
    """n frames of one plane, each a little shifted: the smooth sin*cos
    content of experiments/tpu_parity.py plus noise, in the given dtype's
    code range."""
    maxv = DTYPES[dtype][0]
    h, w, c = (H, W, 1) if plane == "Y" else (H // 2, W // 2, 2)
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = (np.sin((xx + 2 * i) * 0.013) * np.cos((yy + i) * 0.011) * 0.5 + 0.5) * (maxv - 2)
        out.append(base[..., None] + rng.uniform(0, 2.0, (h, w, c)))
    stack = np.stack(out).astype(np.float32)
    return stack if dtype == "float32" else np.rint(stack).astype(dtype)


def _window(tm, frames, ts, plane, maxv, interpolation=8, mesh=None):
    return tm.process_pixels_window(ts, frames, mesh, interpolation=interpolation,
                                    plane_index=0 if plane == "Y" else 1,
                                    max_pixel_value=maxv, plane_rects=True)


def _codes(a):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float64)


@pytest.mark.parametrize("plane", ["Y", "UV"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_matches_jax_and_per_frame(managers, dtype, plane):
    tm, jm = managers
    maxv, tol = DTYPES[dtype]
    frames = _frames(dtype, plane, len(TS_US))
    got, info = _window(tm, frames, TS_US, plane, maxv, mesh=make_frame_mesh(device="cpu"))
    want, _ = jm.process_pixels_window(TS_US, frames, jax_frame_mesh(1), interpolation=8,
                                       plane_index=0 if plane == "Y" else 1,
                                       max_pixel_value=maxv, plane_rects=True,
                                       use_pallas=False)
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert info["backend"] == "torch-cpu-window"
    assert set(info) == {"fov", "minimal_fov", "backend"}
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    assert tuple(got.shape) == want.shape == frames.shape
    assert np.abs(_codes(got) - _codes(want)).max() <= tol
    for i, ts in enumerate(TS_US):
        one, _ = tm.process_pixels(ts, frames[i], interpolation=8,
                                   plane_index=0 if plane == "Y" else 1,
                                   max_pixel_value=maxv, plane_rects=True)
        assert torch.equal(got[i], one), (ts, np.abs(_codes(got[i]) - _codes(one)).max())


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_window_ewa(managers, plane):
    """Interpolation 11 (Robidoux) on F = 2 uint16 frames."""
    tm, jm = managers
    frames = _frames("uint16", plane, 2)
    got, info = _window(tm, frames, TS_US[:2], plane, 1023.0, interpolation=11)
    want, _ = jm.process_pixels_window(TS_US[:2], frames, jax_frame_mesh(1), interpolation=11,
                                       plane_index=0 if plane == "Y" else 1,
                                       max_pixel_value=1023.0, plane_rects=True,
                                       use_pallas=False)
    assert info["backend"] == "torch-cpu-window" and got.dtype == torch.uint16
    assert np.abs(_codes(got) - _codes(want)).max() <= 1
    for i, ts in enumerate(TS_US[:2]):
        one, _ = tm.process_pixels(ts, frames[i], interpolation=11,
                                   plane_index=0 if plane == "Y" else 1,
                                   max_pixel_value=1023.0, plane_rects=True)
        assert torch.equal(got[i], one)


def test_heterogeneous_window_goes_per_frame(managers, monkeypatch):
    """One frame's KernelConfig differs (repeat edges instead of the
    background): the window goes through process_pixels frame by frame and
    each frame equals its own process_pixels."""
    tm, _ = managers
    odd = tm.frame_transform_at(tm._adjusted_ts_ms(TS_US[1]))
    plane_cfg_dyn = tm._plane_cfg_dyn

    def patched(ft, *a):
        cfg, dyn = plane_cfg_dyn(ft, *a)
        return (cfg._replace(background_mode=1) if ft is odd else cfg), dyn

    monkeypatch.setattr(tm, "_plane_cfg_dyn", patched)
    frames = _frames("uint16", "Y", len(TS_US))
    got, info = _window(tm, frames, TS_US, "Y", 1023.0)
    assert info["backend"] == "torch-cpu+per-frame"
    for i, ts in enumerate(TS_US):
        one, _ = tm.process_pixels(ts, frames[i], interpolation=8, plane_index=0,
                                   max_pixel_value=1023.0, plane_rects=True)
        assert torch.equal(got[i], one)
    monkeypatch.undo()
    plain, _ = _window(tm, frames, TS_US, "Y", 1023.0)
    assert not torch.equal(plain[1], got[1]) and torch.equal(plain[0], got[0])


@pytest.mark.parametrize("plane", ["Y", "UV"])
@pytest.mark.parametrize("n,sp,dtype", [(4, 2, "uint16"), (8, 2, "float32"), (4, 1, "uint8"),
                                        (2, 2, "uint16")])
def test_frame_mesh_dp_sp_matches_one_device(managers, plane, n, sp, dtype):
    """The window on a dp x sp mesh of n logical CPU shards (F = 4: dp = n /
    sp of 1, 2 or 4) is the one-device window, 0 codes, in its dtype."""
    tm, _ = managers
    maxv, _ = DTYPES[dtype]
    frames = _frames(dtype, plane, len(TS_US))
    mesh = make_frame_mesh(n, sp=sp, devices=["cpu"] * n)
    assert mesh.shape == {"dp": n // sp, "sp": sp} and mesh.device == torch.device("cpu")
    got, info = _window(tm, frames, TS_US, plane, maxv, mesh=mesh)
    one, _ = _window(tm, frames, TS_US, plane, maxv)
    assert info["backend"] == "torch-cpu-sharded" and got.device.type == "cpu"
    assert got.dtype == one.dtype and torch.equal(got, one)


def test_frame_mesh_dp_sp_matches_jax(managers):
    """float32 Y on 2 x 2 logical shards against the JAX manager's window on
    its 4-device (dp 2, sp 2) mesh, XLA path: 0.25 of a code."""
    tm, jm = managers
    frames = _frames("float32", "Y", len(TS_US))
    got, _ = _window(tm, frames, TS_US, "Y", 1023.0,
                     mesh=make_frame_mesh(4, sp=2, devices=["cpu"] * 4))
    want, _ = jm.process_pixels_window(TS_US, frames, jax_frame_mesh(4, sp=2), interpolation=8,
                                       plane_index=0, max_pixel_value=1023.0, plane_rects=True,
                                       use_pallas=False)
    assert np.abs(_codes(got) - _codes(want)).max() <= DTYPES["float32"][1]


def test_frame_mesh_takes_cards():
    """By default the mesh is the cards, and too few cards raise: nothing
    moves to the CPU on its own. Named devices make a 1 x 1 mesh too."""
    mesh = make_frame_mesh(1, device="cpu")
    assert mesh == FrameMesh(((torch.device("cpu"),),)) and mesh.shape == {"dp": 1, "sp": 1}
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        with pytest.raises(RuntimeError, match=f"over 2 CUDA devices: {n_cards} present"):
            make_frame_mesh(2)
    else:
        assert make_frame_mesh(2).devices == ((torch.device("cuda", 0),),
                                              (torch.device("cuda", 1),))


def test_window_refuses_other_devices_and_mesh_data(managers, monkeypatch):
    tm, _ = managers
    frames = _frames("uint16", "Y", 2)
    with pytest.raises(ValueError, match="frame mesh on meta"):
        _window(tm, frames, TS_US[:2], "Y", 1023.0, mesh=make_frame_mesh(devices=["meta"]))
    # a mesh buffer too short for the grid its flags name raises
    ft = tm.frame_transform_at(tm._adjusted_ts_ms(TS_US[0]))
    meshed = dataclasses.replace(ft, mesh_data=np.zeros(16, np.float32),
                                 kernel_cfg=ft.kernel_cfg._replace(
                                     flags=ft.kernel_cfg.flags | 512, mesh_grid=(9, 9)))
    monkeypatch.setattr(tm, "frame_transform_at", lambda ts_ms, rid=None: meshed)
    with pytest.raises(ValueError, match="needs"):
        _window(tm, frames, TS_US[:2], "Y", 1023.0)


def test_window_without_stabilization(managers):
    tm, _ = managers
    frames = _frames("uint16", "UV", 2)
    tm.params.stab_enabled = False
    try:
        got, info = _window(tm, frames, TS_US[:2], "UV", 1023.0)
    finally:
        tm.params.stab_enabled = True
    assert info["backend"] == "none" and got.dtype == torch.uint16
    assert np.array_equal(got.numpy(), frames)
