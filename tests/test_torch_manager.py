"""gyroflow_torch StabilizationManager vs gyroflow_tpu's, on the CPU.

Both managers are built the same way (the ``mgr`` fixture of
test_invalidation.py: 128x96, fisheye lens, 8 ms rolling shutter, the
seeded .gcsv of test_end_to_end.py).

- The host copies (frame transform, zooming, ComputeParams, kernel params)
  must give bit-identical matrices, KernelConfig and KernelDynamics.
- process_pixels on uint16 YUV420 planes must agree within 1 code with the
  JAX manager's XLA path (use_pallas=False) and its Pallas path
  (use_pallas=True, kernels in interpret mode). 1 code: the uint16 cast
  rounds float results that differ by float rounding.
- The device is explicit: cuda:0 by default, an error when that card (or
  the one set_device names) is missing, the CPU only when asked for.
- With jax and gyroflow_tpu blocked by an import hook, every module of the
  port imports, the manager renders and the renderer writes a y4m: the
  card's machine has no jax, and the port carries its own copies of the host
  modules.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from gyroflow_tpu.core import lens_profile as jlp
from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_tpu.parallel.pipeline import WINDOW_LADDER
from gyroflow_torch.core import lens_profile as tlp
from gyroflow_torch.core.manager import StabilizationManager

from test_end_to_end import DUR_S, H, W, gcsv_path  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
TS_US = (500_000, 833_333)


def _build(m, lens_mod, gcsv):
    """Each manager gets its own package's lens classes: the enums and
    dataclasses of the two packages are distinct classes."""
    m.init_from_video_data(DUR_S * 1000.0, 30.0, int(DUR_S * 30), (W, H))
    m.lens = lens_mod.LensProfile(
        calib_dimension=lens_mod.Dimensions(W, H),
        fisheye_params=lens_mod.CameraParams(
            camera_matrix=[[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1]],
            distortion_coeffs=[0.25, -0.05, 0.01, -0.001]),
        distortion_model="opencv_fisheye")
    m.lens.init()
    m.params.frame_readout_time = 8.0
    m.load_gyro_data(gcsv)
    m.recompute_blocking()
    return m


@pytest.fixture(scope="module")
def managers(gcsv_path):  # noqa: F811
    return (_build(StabilizationManager(device="cpu"), tlp, gcsv_path),
            _build(JManager(), jlp, gcsv_path))


def _planes():
    """Smooth 10-bit YUV420 planes (experiments/tpu_parity.py content)."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (h, w, c) in {"Y": (H, W, 1), "UV": (H // 2, W // 2, 2)}.items():
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = (np.sin(xx * 0.013) * np.cos(yy * 0.011) * 0.5 + 0.5) * 1000.0
        img = base[..., None] + rng.uniform(0, 2.0, (h, w, c))
        out[name] = np.rint(img).astype(np.uint16)
    return out


def test_manager_device_is_explicit(managers):
    """No quiet CPU: without a card the default cuda:0 and set_device(99)
    raise; device="cpu" works and get_cloned keeps it."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            StabilizationManager()
    else:
        assert StabilizationManager().device == torch.device("cuda", 0)
    m = StabilizationManager(device="cpu")
    assert m.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda:99"):
        m.set_device(99)
    assert m.device == torch.device("cpu")
    tm, _ = managers
    clone = tm.get_cloned()
    assert clone.device == tm.device == torch.device("cpu")
    assert StabilizationManager.list_gpu_devices()


@pytest.mark.parametrize("ts_us", TS_US)
def test_host_copies_are_bit_identical(managers, ts_us):
    tm, jm = managers
    assert tm.params.fovs == jm.params.fovs
    ft_t = tm.frame_transform_at(ts_us / 1000.0)
    ft_j = jm.frame_transform_at(ts_us / 1000.0)
    assert ft_t.matrices.shape == (H, 14)
    np.testing.assert_array_equal(ft_t.matrices, ft_j.matrices)
    assert ft_t.kernel_cfg == ft_j.kernel_cfg
    for a, b in zip(ft_t.kernel_dyn, ft_j.kernel_dyn):
        np.testing.assert_array_equal(a, b)
    for shape, pi in (((H, W, 1), 0), ((H // 2, W // 2, 2), 1)):
        ct, dt = tm._plane_cfg_dyn(ft_t, shape, 8, pi, 1023.0, True, None, None)
        cj, dj = jm._plane_cfg_dyn(ft_j, shape, 8, pi, 1023.0, True, None, None)
        assert ct == cj
        for a, b in zip(dt, dj):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_process_pixels_matches_jax(managers, plane, use_pallas):
    tm, jm = managers
    img = _planes()[plane]
    pi = 0 if plane == "Y" else 1
    for ts in TS_US[:1] if use_pallas else TS_US:
        if use_pallas:
            # start the JAX manager's window ladder at its widest rung (it
            # covers this small plane) so the test compiles one Pallas rung
            ft = jm.frame_transform_at(jm._adjusted_ts_ms(ts))
            cfg, _ = jm._plane_cfg_dyn(ft, img.shape, 8, pi, 1023.0, True, None, None)
            jm._win_cache[(cfg, img.shape)] = WINDOW_LADDER[-1]
        got, info = tm.process_pixels(ts, img, interpolation=8, plane_index=pi,
                                      max_pixel_value=1023.0, plane_rects=True,
                                      defer_overflow=True)
        want, _ = jm.process_pixels(ts, img, interpolation=8, use_pallas=use_pallas,
                                    plane_index=pi, max_pixel_value=1023.0, plane_rects=True)
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint16
        assert info["backend"] == "torch-cpu" and info["overflow"] is False
        assert tuple(got.shape) == want.shape == img.shape
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1


@pytest.mark.parametrize("plane", ["Y", "UV"])
def test_process_pixels_ewa_matches_jax(managers, plane):
    """EWA (interpolation 11, Robidoux) through both managers: the port's
    plain torch path vs the JAX manager's XLA path, uint16 out."""
    tm, jm = managers
    img = _planes()[plane]
    pi = 0 if plane == "Y" else 1
    got, info = tm.process_pixels(TS_US[0], img, interpolation=11, plane_index=pi,
                                  max_pixel_value=1023.0, plane_rects=True)
    want, _ = jm.process_pixels(TS_US[0], img, interpolation=11, use_pallas=False,
                                plane_index=pi, max_pixel_value=1023.0, plane_rects=True)
    want = np.asarray(want)
    assert got.dtype == torch.uint16 and info["backend"] == "torch-cpu"
    assert tuple(got.shape) == want.shape == img.shape
    assert np.abs(got.numpy().astype(np.int32) - want.astype(np.int32)).max() <= 1


_NO_JAX_SCRIPT = textwrap.dedent('''
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "gyroflow_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())

    import math, pathlib
    import numpy as np
    import gyroflow_torch
    mods = [m.name for m in pkgutil.walk_packages(gyroflow_torch.__path__, "gyroflow_torch.")]
    for name in mods:
        importlib.import_module(name)
    assert len(mods) > 80, mods
    from gyroflow_torch.core.lens_profile import CameraParams, Dimensions, LensProfile
    from gyroflow_torch.core.manager import StabilizationManager

    W, H = 64, 48
    rng = np.random.default_rng(3)
    rows = ["GYROFLOW IMU LOG", "tscale,0.001", "gscale,1.0", "ascale,1.0", "t,gx,gy,gz"]
    rows += [f"{i},{0.3 * math.sin(i / 30):.5f},{rng.normal(0, 0.05):.5f},0.01"
             for i in range(1200)]
    gcsv = pathlib.Path("t.gcsv")          # the test's tmp_path is the cwd
    gcsv.write_text("\\n".join(rows))
    m = StabilizationManager(device="cpu")
    m.init_from_video_data(1000.0, 30.0, 30, (W, H))
    m.lens = LensProfile(calib_dimension=Dimensions(W, H), fisheye_params=CameraParams(
        camera_matrix=[[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1]],
        distortion_coeffs=[0.25, -0.05, 0.01, -0.001]), distortion_model="opencv_fisheye")
    m.lens.init()
    m.params.frame_readout_time = 8.0
    m.load_gyro_data(str(gcsv))
    m.recompute_blocking()
    y, _ = m.process_pixels(500_000, rng.integers(0, 1024, (H, W, 1)).astype(np.uint16),
                            plane_index=0, max_pixel_value=1023.0, plane_rects=True)
    uv, _ = m.process_pixels(500_000, rng.integers(0, 1024, (H // 2, W // 2, 2)).astype(np.uint16),
                             plane_index=1, max_pixel_value=1023.0, plane_rects=True)
    assert tuple(y.shape) == (H, W, 1) and tuple(uv.shape) == (H // 2, W // 2, 2)

    # a 4-frame 10-bit y4m through the renderer (one padded 8-frame window)
    from gyroflow_torch.render.renderer import RenderOptions, render
    from gyroflow_torch.render.y4m_io import Y4MReader, Y4MWriter
    w = Y4MWriter("in.y4m", W, H, 30.0, "yuv420p10le")
    for _ in range(4):
        w.write_planes([rng.integers(0, 1024, s).astype("<u2")
                        for s in ((H, W, 1), (H // 2, W // 2, 1), (H // 2, W // 2, 1))])
    w.close()
    stats = render(m, "in.y4m", "out.y4m", RenderOptions())
    assert stats["frames"] == 4 and stats["frame_window"] == 8, stats
    r = Y4MReader("out.y4m")
    assert len(list(r)) == 4
    r.close()
    assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
    print("NO_JAX_OK", len(mods))
''')


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
