"""gyroflow_torch's end-to-end slice against gyroflow_tpu's, on the CPU.

Mirrors tests/test_end_to_end.py (BASELINE config 1's shape at test
scale): the seeded .gcsv -> integrate -> smooth -> frame transform -> remap,
built once with each package's modules. Each case checks what the JAX test
checks and holds the port's numbers to the JAX package's: the host stages
(integration, smoothing, frame transforms, point transforms, sync offsets)
bit for bit, the remap within 0.25 of a code of JAX's op-by-op remap and
within 0.25 of its jitted remap at all but 0.2% of the pixels (on this
uniform-noise frame float32 rounding moves a few source positions across
one of the LUT's 32 phases; tests/test_torch_entry.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.core import quaternion as jquat
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.frame_transform import frame_transform_at as jft_at
from gyroflow_tpu.ops.frame_transform import frame_transform_for_points as jft_points
from gyroflow_torch.core import quaternion as tquat
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.ops.frame_transform import frame_transform_at as tft_at
from gyroflow_torch.ops.frame_transform import frame_transform_for_points as tft_points

from test_end_to_end import DUR_S, H, RATE, W, gcsv_path  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PHASE_FLIPS = 2e-3


def _pipeline(pkg, gcsv):
    """test_end_to_end.py's pipeline fixture with the modules of pkg."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    fm = mod("core.telemetry").parse_telemetry_file(gcsv)
    assert len(fm.raw_imu) == int(DUR_S * RATE)
    gyro = mod("core.gyro_source").GyroSource()
    gyro.duration_ms = DUR_S * 1000.0
    gyro.integration_method = 1  # Complementary
    gyro.load_from_telemetry(fm)
    assert len(gyro.quaternions) > 0

    params = mod("core.params").StabilizationParams()
    params.size = (W, H)
    params.output_size = (W, H)
    params.fps = 30.0
    params.frame_count = int(DUR_S * 30)
    params.duration_ms = DUR_S * 1000.0
    params.frame_readout_time = 8.0

    lp = mod("core.lens_profile")
    lens = lp.LensProfile(
        calib_dimension=lp.Dimensions(W, H),
        fisheye_params=lp.CameraParams(
            camera_matrix=[[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1]],
            distortion_coeffs=[0.25, -0.05, 0.01, -0.001]),
        distortion_model="opencv_fisheye")
    lens.init()

    class MgrStub:
        pass

    mgr = MgrStub()
    mgr.gyro, mgr.lens, mgr.params = gyro, lens, params
    mgr.keyframes = mod("core.keyframes").KeyframeManager()
    cp = mod("core.params").ComputeParams.from_manager(mgr)
    cp.calculate_camera_fovs()
    sm = mod("core.smoothing")
    smoothed, max_angles = gyro.recompute_smoothness(sm.DefaultAlgo(), sm.HorizonLock(), cp)
    gyro.smoothed_quaternions = smoothed
    gyro.max_angles = max_angles
    return cp, gyro


@pytest.fixture(scope="module")
def pipelines(gcsv_path):  # noqa: F811
    return _pipeline("gyroflow_torch", gcsv_path), _pipeline("gyroflow_tpu", gcsv_path)


def _same_ft(a, b):
    np.testing.assert_array_equal(a.matrices, b.matrices)
    assert tuple(a.kernel_cfg) == tuple(b.kernel_cfg)
    for x, y in zip(a.kernel_dyn, b.kernel_dyn):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestEndToEnd:
    def test_integration_produced_rotation(self, pipelines):
        (_, tg), (_, jg) = pipelines
        total = tquat.angle_between(tg.quaternions.quats[0], tg.quaternions.quats[-1])
        assert total > 0.01  # the synthetic path wobbles
        assert total == jquat.angle_between(jg.quaternions.quats[0], jg.quaternions.quats[-1])
        np.testing.assert_array_equal(np.asarray(tg.quaternions.quats),
                                      np.asarray(jg.quaternions.quats))

    def test_smoothed_is_correction(self, pipelines):
        (_, tg), (_, jg) = pipelines
        assert len(tg.smoothed_quaternions) == len(tg.quaternions)
        assert all(a >= 0 for a in tg.max_angles)
        np.testing.assert_array_equal(np.asarray(tg.max_angles), np.asarray(jg.max_angles))
        np.testing.assert_array_equal(np.asarray(tg.smoothed_quaternions.quats),
                                      np.asarray(jg.smoothed_quaternions.quats))

    def test_frame_transform(self, pipelines):
        (tcp, _), (jcp, _) = pipelines
        ft = tft_at(tcp, 500.0, 15)
        assert ft.matrices.shape == (H, 14)       # per-row RS matrices
        assert np.isfinite(ft.matrices).all()
        assert ft.kernel_cfg.width == W
        assert float(ft.kernel_dyn.fov) > 0
        _same_ft(ft, jft_at(jcp, 500.0, 15))

    def test_frame_transform_no_rs(self, pipelines):
        (tcp, _), (jcp, _) = pipelines
        fts = []
        for cp in (tcp, jcp):
            cp2 = type(cp)(**{**cp.__dict__})
            cp2.frame_readout_time = 0.0
            fts.append((tft_at if cp is tcp else jft_at)(cp2, 500.0, 15))
        assert fts[0].matrices.shape == (1, 14)
        _same_ft(*fts)

    def test_remap_end_to_end(self, pipelines):
        (tcp, _), (jcp, _) = pipelines
        ft = tft_at(tcp, 500.0, 15)
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (H, W, 1)).astype(np.float32)
        cfg, dyn = tkp.from_reference(ft.kernel_cfg, ft.kernel_dyn)
        out = tremap.remap_plane(torch.from_numpy(img), torch.from_numpy(ft.matrices), cfg,
                                 dyn).numpy()
        assert out.shape == (H, W, 1)
        assert np.isfinite(out).all()
        assert (out > 0).mean() > 0.3  # mostly image, some background
        jft = jft_at(jcp, 500.0, 15)
        args = (jnp.asarray(img), jnp.asarray(jft.matrices), jft.kernel_cfg, jft.kernel_dyn)
        assert np.abs(out - np.asarray(jremap.remap_plane(*args))).max() <= 0.25
        jit = np.asarray(jremap.remap_plane_jit(*args))
        assert (np.abs(out - jit) > 0.25).mean() <= PHASE_FLIPS
        # the kernel route on CPU tensors (the wrappers' plain versions)
        kern = tremap.remap_plane_cuda(torch.from_numpy(img), torch.from_numpy(ft.matrices),
                                       cfg, dyn).numpy()
        assert np.abs(kern - out).max() <= 0.25

    def test_points_transform(self, pipelines):
        (tcp, _), (jcp, _) = pipelines
        pts = np.array([[10.0, 10.0], [W - 10.0, H - 10.0]])
        got = tft_points(tcp, pts, 500.0, 15, True)
        want = jft_points(jcp, pts, 500.0, 15, True)
        scaled_k, dist, new_k, rotations, shifts, mesh, fov = got
        assert rotations.shape == (2, 3, 3)
        assert shifts is None and mesh is None
        assert fov > 0
        for a, b in zip(got, want):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_sync_offset_changes_lookup(self, pipelines):
        moved = []
        for (_, gyro), quat in zip(pipelines, (tquat, jquat)):
            q_before = gyro.org_quat_at_timestamp(500.0)
            gyro.set_offset(500_000, 25.0)
            q_after = gyro.org_quat_at_timestamp(500.0)
            gyro.clear_offsets()
            assert quat.angle_between(q_before, q_after) > 1e-5
            moved.append((np.asarray(q_before), np.asarray(q_after)))
        for a, b in zip(*moved):
            np.testing.assert_array_equal(a, b)
