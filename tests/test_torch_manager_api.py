"""gyroflow_torch's StabilizationManager controller surface against
gyroflow_tpu's, on the CPU.

Mirrors tests/test_manager_api.py case by case. Each fixture builds the
port's manager (``device="cpu"``) and the JAX package's manager the same
way; each case runs what the JAX test runs on both, checks what it checks
on the port's, and holds every number the port gives to the JAX manager's
(bit for bit: these are the host copies). Where the port differs by
design, the case says how: ``set_device`` names a card and raises when it
is missing (the JAX manager sets None), ``list_gpu_devices`` names the
cards or "cpu", and the routed ``process_pixels`` returns a tensor on the
manager's device.
"""
import json
import os

import numpy as np
import pytest
import torch

from gyroflow_tpu.core.lens_profile import LensProfile as JLensProfile
from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_torch.core.lens_profile import LensProfile
from gyroflow_torch.core.manager import StabilizationManager

from test_end_to_end import DUR_S, gcsv_path  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _pair(make):
    return make(StabilizationManager(device="cpu")), make(JManager())


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a, dtype=object if a is None else None),
                                  np.asarray(b, dtype=object if b is None else None))


@pytest.fixture()
def mgrs(gcsv_path):  # noqa: F811
    def make(m):
        m.init_from_video_data(duration_ms=DUR_S * 1000.0, fps=30.0,
                               frame_count=int(DUR_S * 30), video_size=(640, 480))
        m.load_gyro_data(str(gcsv_path))
        return m
    return _pair(make)


def _small(m):
    m.init_from_video_data(duration_ms=1000.0, fps=30.0, frame_count=30,
                           video_size=(640, 480))
    return m


@pytest.fixture()
def small():
    return _pair(_small)


LENS = {
    "calib_dimension": {"w": 640, "h": 480},
    "fisheye_params": {
        "camera_matrix": [[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]],
        "distortion_coeffs": [0.1, -0.02, 0.0, 0.0],
    },
}


class TestEstimateBias:
    def test_matches_mean_of_range(self, mgrs):
        tm, jm = mgrs
        bias = tm.estimate_bias([0.5])
        dur = tm.params.duration_ms
        lo, hi = 0.5 * dur - 200.0, 0.5 * dur + 200.0
        rows = [x.gyro for x in tm.gyro.file_metadata.raw_imu
                if x.gyro is not None and lo < x.timestamp_ms < hi]
        np.testing.assert_allclose(bias, -np.mean(np.asarray(rows), axis=0), atol=1e-9)
        _eq(bias, jm.estimate_bias([0.5]))

    def test_string_form_and_apply(self, mgrs):
        means = []
        for m in mgrs:
            m.set_imu_bias(*m.estimate_bias("0.5"))
            dur = m.params.duration_ms
            lo, hi = 0.5 * dur - 200.0, 0.5 * dur + 200.0
            rows = [x.gyro for x in m.gyro.get_raw_imu()
                    if x.gyro is not None and lo < x.timestamp_ms < hi]
            means.append(np.mean(np.asarray(rows), axis=0))
        assert np.abs(means[0]).max() < 1e-6
        _eq(*means)

    def test_empty(self, mgrs):
        tm, jm = mgrs
        assert tm.estimate_bias([]) == (0.0, 0.0, 0.0) == jm.estimate_bias([])


class TestSmallInvokables:
    def test_set_background_color(self, mgrs):
        for m in mgrs:
            m.set_background_color(0.1, 0.2, 0.3, 0.9)
            assert m.params.background == (0.1, 0.2, 0.3, 0.9)

    def test_max_angles_after_recompute(self, mgrs):
        angles = []
        for m in mgrs:
            m.recompute_blocking()
            angles.append(m.get_smoothing_max_angles())
        assert len(angles[0]) == 3
        assert all(np.isfinite(a) and a >= 0.0 for a in angles[0])
        _eq(*angles)

    def test_quats_at_timestamp(self, mgrs):
        got = []
        for m in mgrs:
            m.recompute_blocking()
            got.append(m.quats_at_timestamp(DUR_S * 500.0))
        for q in got[0]:
            assert np.asarray(q).shape[-1] == 4
            assert abs(np.linalg.norm(np.asarray(q)) - 1.0) < 1e-6
        for a, b in zip(*got):
            _eq(a, b)

    def test_scaling_ratio_and_min_fov(self, mgrs):
        tm, jm = mgrs
        for m in mgrs:
            m.set_output_size(320, 240)
        assert tm.get_scaling_ratio() == 640 / 320 == jm.get_scaling_ratio()
        assert tm.get_min_fov() == tm.params.min_fov == jm.get_min_fov()

    def test_turn_speed_and_x_angle(self, mgrs):
        tm, jm = mgrs
        for m in mgrs:
            m.recompute_blocking()
        assert np.isnan(tm.get_turn_speed(100.0))
        ts = DUR_S * 1000.0
        v = tm.get_turn_speed(ts)
        assert np.isfinite(v) and v == jm.get_turn_speed(ts)
        a = tm.get_x_angle(ts)
        assert np.isfinite(a) and -180.0 <= a <= 180.0 and a == jm.get_x_angle(ts)

    def test_mesh_at_frame_empty(self, mgrs):
        tm, jm = mgrs
        assert tm.mesh_at_frame(0) == [] == jm.mesh_at_frame(0)

    def test_set_lens_param(self, mgrs):
        for m, cls in zip(mgrs, (LensProfile, JLensProfile)):
            m.lens = cls.from_dict(LENS)
            m.set_lens_param("fx", 500.0)
            m.set_lens_param("k2", 0.5)
            fp = m.lens.fisheye_params
            assert fp.camera_matrix[0][0] == 500.0
            assert fp.distortion_coeffs[1] == 0.5
            m.set_lens_param("bogus", 1.0)   # ignored like the reference
        _eq(mgrs[0].lens.fisheye_params.camera_matrix, mgrs[1].lens.fisheye_params.camera_matrix)

    def test_frequency_graph(self, mgrs):
        tm, jm = mgrs
        sr, n = 200.0, 64
        samples, out_sr = tm.frequency_graph(0, DUR_S * 500.0, sr, n)
        assert out_sr == sr and len(samples) == n
        assert all(np.isfinite(samples))
        _eq(samples, jm.frequency_graph(0, DUR_S * 500.0, sr, n)[0])
        samples, out_sr = tm.frequency_graph(0, 0.0, 10.0, 10**6)
        assert samples == [] and out_sr == 0.0

    def test_has_flags(self, mgrs):
        tm, jm = mgrs
        assert tm.has_per_frame_focal_length() is False is jm.has_per_frame_focal_length()
        assert tm.has_per_frame_lens_data() is False is jm.has_per_frame_lens_data()
        assert isinstance(tm.has_gravity_vectors(), bool)
        assert tm.has_gravity_vectors() == jm.has_gravity_vectors()

    def test_load_default_preset(self, mgrs, tmp_path, monkeypatch):
        from gyroflow_torch.core import settings
        from gyroflow_torch.core.project_file import export_gyroflow_data
        tm, _ = mgrs
        monkeypatch.setattr(settings, "data_dir", lambda: str(tmp_path))
        assert tm.load_default_preset() is False
        tm.params.video_speed = 0.5
        os.makedirs(str(tmp_path / "lens_profiles"))
        (tmp_path / "lens_profiles" / "default.gyroflow").write_text(export_gyroflow_data(tm))
        m2 = _small(StabilizationManager(device="cpu"))
        assert m2.load_default_preset() is True
        assert m2.params.video_speed == 0.5

    def test_export_lens_profile(self, mgrs, tmp_path):
        dicts = []
        for m, cls in zip(mgrs, (LensProfile, JLensProfile)):
            m.lens = cls.from_dict({
                **LENS, "name": "t", "calibrated_by": "x", "camera_brand": "B",
                "camera_model": "M", "orig_dimension": {"w": 640, "h": 480},
                "output_dimension": {"w": 640, "h": 480}, "calibrator_version": "1.0",
                "date": "2026-01-01"})
            out = tmp_path / f"prof_{len(dicts)}.json"
            m.export_lens_profile(str(out))
            dicts.append(json.loads(out.read_text()))
        assert dicts[0]["camera_brand"] == "B"
        assert LensProfile.from_dict(dicts[0]).is_valid()
        assert dicts[0] == dicts[1]


class TestControllerParitySetters:
    """Thin setters (lib.rs:938-1214): each writes its field and invalidates
    the compute chain, on both managers alike."""

    def test_field_routing(self, small):
        from gyroflow_torch.core.params import BackgroundMode, ReadoutDirection
        tm, jm = small
        cases = [
            ("set_video_rotation", (12.5,), lambda m: m.params.video_rotation == 12.5),
            ("set_stab_enabled", (False,), lambda m: m.params.stab_enabled is False),
            ("set_frame_readout_time", (8.2,), lambda m: m.params.frame_readout_time == 8.2),
            ("set_frame_readout_direction", ("BottomToTop",),
             lambda m: m.params.frame_readout_direction.name == "BottomToTop"),
            ("set_adaptive_zoom", (2.5,), lambda m: m.params.adaptive_zoom_window == 2.5),
            ("set_zooming_center_x", (0.1,),
             lambda m: m.params.adaptive_zoom_center_offset[0] == 0.1),
            ("set_zooming_center_y", (-0.2,),
             lambda m: m.params.adaptive_zoom_center_offset[1] == -0.2),
            ("set_zooming_method", (0,), lambda m: m.params.adaptive_zoom_method == 0),
            ("set_additional_rotation_x", (1.0,), lambda m: m.params.additional_rotation[0] == 1.0),
            ("set_additional_rotation_y", (2.0,), lambda m: m.params.additional_rotation[1] == 2.0),
            ("set_additional_rotation_z", (3.0,), lambda m: m.params.additional_rotation[2] == 3.0),
            ("set_additional_translation_x", (4.0,),
             lambda m: m.params.additional_translation[0] == 4.0),
            ("set_additional_translation_y", (5.0,),
             lambda m: m.params.additional_translation[1] == 5.0),
            ("set_additional_translation_z", (6.0,),
             lambda m: m.params.additional_translation[2] == 6.0),
            ("set_fov", (1.3,), lambda m: m.params.fov == 1.3),
            ("set_fov_overview", (True,), lambda m: m.params.fov_overview is True),
            ("set_lens_correction_amount", (0.5,),
             lambda m: m.params.lens_correction_amount == 0.5),
            ("set_frame_offset", (3,), lambda m: m.params.frame_offset == 3),
            ("set_light_refraction_coefficient", (1.33,),
             lambda m: m.params.light_refraction_coefficient == 1.33),
            ("set_background_mode", (3,), lambda m: m.params.background_mode.value == 3),
            ("set_background_margin", (0.2,), lambda m: m.params.background_margin == 0.2),
            ("set_background_margin_feather", (0.1,),
             lambda m: m.params.background_margin_feather == 0.1),
            ("set_input_horizontal_stretch", (1.33,),
             lambda m: m.lens.input_horizontal_stretch == 1.33),
            ("set_input_vertical_stretch", (1.5,),
             lambda m: m.lens.input_vertical_stretch == 1.5),
            ("set_max_zoom", (150.0, 4), lambda m: m.params.max_zoom == 150.0
             and m.params.max_zoom_iterations == 4),
            ("set_digital_lens_name", ("GoPro Superview",),
             lambda m: m.lens.digital_lens == "GoPro Superview"),
            ("set_digital_lens_param", (1, 0.7),
             lambda m: m.lens.digital_lens_params[1] == 0.7),
            ("set_lens_is_asymmetrical", (True,), lambda m: m.lens.asymmetrical),
            ("set_use_gravity_vectors", (True,), lambda m: m.gyro.use_gravity_vectors),
            ("set_horizon_lock_integration_method", (2,),
             lambda m: m.gyro.horizon_lock_integration_method == 2),
        ]
        for name, args, check in cases:
            for m in small:
                before = m.current_compute_id
                getattr(m, name)(*args)
                assert check(m), name
                assert m.current_compute_id > before, f"{name} must invalidate"
        assert tm.params.background_mode == BackgroundMode(3)
        assert tm.params.frame_readout_direction == ReadoutDirection.BottomToTop
        assert tm.current_compute_id == jm.current_compute_id

    def test_video_speed_links(self, small):
        for m in small:
            m.set_video_speed(2.0, link_with_smoothing=False, link_with_zooming=True,
                              link_with_zooming_limit=False)
            assert m.params.video_speed == 2.0
            assert m.params.video_speed_affects_smoothing is False
            assert m.params.video_speed_affects_zooming is True
            assert m.params.video_speed_affects_zooming_limit is False

    def test_offsets_and_fps_override(self, small):
        for m in small:
            m.set_sync_offset(1_000_000, 12.5)
            m.set_sync_offset(2_000_000, 13.0)
            m.remove_offset(1_000_000)
            assert 1_000_000 not in m.gyro.get_offsets()
            assert m.gyro.get_offsets()[2_000_000] == 13.0
            m.clear_offsets()
            assert not m.gyro.get_offsets()
            m.override_video_fps(60.0, recompute=False)
            assert m.params.fps_scale == pytest.approx(2.0)
        assert small[0].params.fps_scale == small[1].params.fps_scale
        for m in small:
            m.override_video_fps(30.0, recompute=False)
            assert m.params.fps_scale is None

    def test_keyframe_crud(self, small):
        from gyroflow_tpu.core.keyframes import KeyframeType as JKeyframeType
        from gyroflow_torch.core.keyframes import KeyframeType
        vals = []
        for m, kt in zip(small, (KeyframeType, JKeyframeType)):
            m.set_keyframe(kt.Fov, 0, 1.0)
            m.set_keyframe(kt.Fov, 500_000, 2.0)
            assert m.is_keyframed(kt.Fov)
            vals.append(m.keyframe_value_at_video_timestamp(kt.Fov, 250.0))
            m.remove_keyframe(kt.Fov, 500_000)
            vals.append(m.keyframe_value_at_video_timestamp(kt.Fov, 250.0))
        assert vals[:2] == [pytest.approx(1.5), pytest.approx(1.0)]
        assert vals[:2] == vals[2:]


class TestFacadeQueries:
    """Query-side facade methods (lib.rs:416, 994-1014, 1161-1166, 1873, 2043)."""

    def test_smoothing_registry(self, small):
        tm, jm = small
        names = tm.get_smoothing_algs()
        assert [n.lower().split()[0] for n in names][:2] == ["no", "default"] \
            or len(names) == 4
        assert names == jm.get_smoothing_algs()
        st = tm.get_smoothing_status()
        assert "smoothness" in st["params"]
        assert st == jm.get_smoothing_status()

    def test_disable_lens_stretch(self, small):
        for m in small:
            m.lens.input_horizontal_stretch = 1.33
            m.lens.input_vertical_stretch = 1.0
            m.disable_lens_stretch(adjust_size=True)
            assert m.lens.input_horizontal_stretch == 1.0
            assert m.params.size[0] == round(640 * 1.33)
        assert small[0].params.size == small[1].params.size

    def test_project_has_motion_data(self):
        has = StabilizationManager.project_has_motion_data
        for blob in ("{}", json.dumps({"gyro_source": {"raw_imu": [[0, 0.1, 0.2, 0.3]]}}),
                     json.dumps({"gyro_source": {}})):
            assert has(blob) == JManager.project_has_motion_data(blob)
        assert not has("{}")
        assert has(json.dumps({"gyro_source": {"raw_imu": [[0, 0.1, 0.2, 0.3]]}}))

    def test_list_devices_nonempty(self):
        """The cards' names, or ["cpu"] without one."""
        names = StabilizationManager.list_gpu_devices()
        assert len(names) >= 1
        if not torch.cuda.is_available():
            assert names == ["cpu"]


class TestFacadeKeyframesAndFiles:
    """Keyframe easing/move, clear, render params, project file helpers,
    granular invalidation aliases (lib.rs:1016-1028, 1984-2004)."""

    def test_keyframe_easing_and_move(self, small):
        from gyroflow_tpu.core import keyframes as jkf
        from gyroflow_torch.core import keyframes as tkf
        for m, kf in zip(small, (tkf, jkf)):
            m.set_keyframe(kf.KeyframeType.Fov, 100, 1.0)
            m.set_keyframe_easing(kf.KeyframeType.Fov, 100, "EaseIn")
            assert m.keyframe_easing(kf.KeyframeType.Fov, 100) == kf.Easing.EaseIn
            # id/easing lookups snap within 1 ms like set (keyframes.rs get_closest)
            assert m.keyframe_easing(kf.KeyframeType.Fov, 600) == kf.Easing.EaseIn
            # move addressed by keyframe id (lib.rs:1995-2004)
            kid = m.keyframe_id(kf.KeyframeType.Fov, 100)
            m.set_keyframe_timestamp(kf.KeyframeType.Fov, kid, 500_000)
            assert m.keyframe_easing(kf.KeyframeType.Fov, 100) is None
            assert m.keyframe_easing(kf.KeyframeType.Fov, 500_000) == kf.Easing.EaseIn
            assert m.keyframe_id(kf.KeyframeType.Fov, 500_000) == kid
            m.clear_keyframes_type(kf.KeyframeType.Fov)
            assert not m.is_keyframed(kf.KeyframeType.Fov)

    def test_acc_rotation(self, small):
        for m in small:
            m.set_acc_rotation(1.0, 2.0, 3.0)
            assert m.gyro.imu_transforms.acc_rotation_angles == [1.0, 2.0, 3.0]

    def test_clear_and_render_params(self, small):
        for m in small:
            m.set_trim_ranges([(0.1, 0.5)])
            m.clear()
            assert m.params.trim_ranges == []
            assert not m.gyro.has_motion()
            m.set_render_params((1920, 1080), (1280, 720))
            assert m.params.size == (1920, 1080)
            assert m.params.output_size == (1280, 720)

    def test_project_file_roundtrip(self, small, tmp_path):
        tm, jm = small
        p = str(tmp_path / "x.gyroflow")
        tm.params.fov = 1.25
        tm.export_gyroflow_file(p)
        m2 = StabilizationManager(device="cpu")
        m2.import_gyroflow_file(p, blocking=False)
        assert m2.params.fov == 1.25
        j2 = JManager()                 # the JAX manager reads the port's file
        j2.import_gyroflow_file(p, blocking=False)
        assert j2.params.fov == 1.25

    def test_invalidation_aliases(self, small):
        for m in small:
            before = m.current_compute_id
            m.invalidate_smoothing()
            m.invalidate_zooming()
            m.invalidate_ongoing_computations()
            assert m.current_compute_id == before + 3


class TestFacadeFinalBatch:
    """load_video_file, glitch filter, offset alias, data import/export,
    keyframe ids, device pick."""

    def test_load_video_file(self, tmp_path):
        import cv2
        p = str(tmp_path / "v.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (64, 48))
        for _ in range(6):
            vw.write(np.zeros((48, 64, 3), np.uint8))
        vw.release()
        infos = []
        for m in (StabilizationManager(device="cpu"), JManager()):
            infos.append(m.load_video_file(p))
            assert m.params.size == (64, 48) and m.params.fps == 24.0
            assert m.input_file == p
        assert infos[0].frame_count == 6 == infos[1].frame_count

    def test_glitch_filter_and_offset_alias(self, small):
        for m in small:
            m.set_glitch_filter(True, 0.5)
            assert m.gyro.imu_transforms.glitch_filter
            assert m.gyro.imu_transforms.glitch_strength == 0.5
            m.set_offset(1_000_000, 10.0)
            assert m.gyro.get_offsets()[1_000_000] == 10.0
            m.set_sync_lpf(25.0)
            assert m.sync_lpf == 25.0

    def test_data_roundtrip_and_keyframe_id(self, small):
        from gyroflow_tpu.core.keyframes import KeyframeType as JKeyframeType
        from gyroflow_torch.core.keyframes import KeyframeType
        tm, _ = small
        tm.set_keyframe(KeyframeType.Fov, 100, 1.0)
        assert tm.keyframe_id(KeyframeType.Fov, 100) is not None
        blob = tm.export_gyroflow_data()
        m2 = StabilizationManager(device="cpu")
        m2.import_gyroflow_data(blob, blocking=False)
        assert m2.is_keyframed(KeyframeType.Fov)
        j2 = JManager()                 # the JAX manager reads the port's data
        j2.import_gyroflow_data(blob, blocking=False)
        assert j2.is_keyframed(JKeyframeType.Fov)

    def test_set_device(self, small):
        """A card by index; a missing one raises (the JAX manager sets None)."""
        tm, jm = small
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n:
            tm.set_device(0)
            assert tm.device == torch.device("cuda", 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.set_device(10_000)
        jm.set_device(10_000)
        assert jm.device is None

    def test_set_device_routes_processing(self):
        """process_pixels runs on the manager's device and returns there; on
        a zero frame both managers give the same pixels."""
        outs = []
        for m in (StabilizationManager(device="cpu"), JManager()):
            m.init_from_video_data(1000.0, 30.0, 30, (64, 48))
            kw = {} if isinstance(m, StabilizationManager) else {"use_pallas": False}
            out, _ = m.process_pixels(0, np.zeros((48, 64, 1), np.float32), interpolation=2,
                                      **kw)
            assert tuple(out.shape) == (48, 64, 1)
            outs.append(out)
        assert isinstance(outs[0], torch.Tensor) and outs[0].device == torch.device("cpu")
        np.testing.assert_array_equal(outs[0].numpy(), np.asarray(outs[1]))

    def test_offsets_linear_and_near_removal(self):
        plus = []
        for m in (StabilizationManager(device="cpu"), JManager()):
            m.init_from_video_data(1000.0, 30.0, 30, (64, 48))
            for ts, off in ((1_000_000, 10.0), (2_000_000, 11.0), (3_000_000, 12.0)):
                m.set_sync_offset(ts, off)
            p = m.gyro.get_offsets_plus_linear()
            assert set(p) == {1_000_000, 2_000_000, 3_000_000}
            assert all(len(v) == 2 for v in p.values())
            plus.append(p)
            m.gyro.remove_offsets_near(2_000_000, 500.0)
            assert set(m.gyro.get_offsets()) == {1_000_000, 3_000_000}
        assert plus[0] == plus[1]
