"""gyroflow_torch's CLI, ST-map export and copied host modules on the CPU
(the port's counterpart of test_cli_render.py, test_stmap.py and one case
each of test_find_offset.py, test_sync.py, test_calibrator.py and
test_mp4mux.py).

- The CLI runs with ``--device cpu``: version, help, a render of a 10-bit
  y4m with ``-g``, the overwrite guard, export of a project then a render
  from it, metadata export, and one poll of the watch folder. Without a card
  and without ``--device cpu`` it fails with the manager's explicit-device
  error: nothing picks the CPU on its own.
- compute_undistort_stmap and compute_redistort_stmap against the JAX
  package's: within 1e-5 (normalized), the same valid pixels.
- find_offsets_rs_sync, the eight-point pose, the markerless chessboard
  detection and the audio remux of the port's copies give the JAX package's
  answers on the same inputs.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_tpu.utils import stmap as jstmap
from gyroflow_torch import cli
from gyroflow_torch.core.manager import StabilizationManager
from gyroflow_torch.render.y4m_io import Y4MReader, Y4MWriter
from gyroflow_torch.utils import stmap

from test_end_to_end import DUR_S, gcsv_path  # noqa: F401 (fixture)
from test_stmap import FISHEYE_LENS, VH, VW
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, FPS, FRAMES = 64, 48, 30.0, 6
CPU = ["--device", "cpu"]


@pytest.fixture()
def clip(tmp_path):
    """A 6-frame 10-bit YUV420 y4m in its own folder."""
    rng = np.random.default_rng(2)
    path = tmp_path / "clip.y4m"
    w = Y4MWriter(str(path), W, H, FPS, "yuv420p10le")
    for _ in range(FRAMES):
        w.write_planes([rng.integers(0, 1024, s).astype("<u2")
                        for s in ((H, W, 1), (H // 2, W // 2, 1), (H // 2, W // 2, 1))])
    w.close()
    return str(path)


def n_frames(path):
    r = Y4MReader(path)
    n = sum(1 for _ in r)
    r.close()
    return n


def test_version_and_help(capsys):
    assert cli.main(["--version"]) == 0
    assert "gyroflow-torch" in capsys.readouterr().out
    assert cli.main([]) == 1
    assert "--device" in capsys.readouterr().out


def test_render_with_gyro(clip, gcsv_path, tmp_path, capsys):  # noqa: F811
    """A render with -g and a lens profile given after it."""
    lens = tmp_path / "lens.json"
    lens.write_text(json.dumps({**FISHEYE_LENS, "calib_dimension": {"w": W, "h": H}}))
    args = [clip, "-g", gcsv_path, str(lens), "-f", "-t", "_stab",
            "-p", json.dumps({"interpolation": 2})]
    assert cli.main(args + CPU) == 0
    out = os.path.splitext(clip)[0] + "_stab.y4m"
    assert n_frames(out) == FRAMES
    assert f"rendered {FRAMES} frames" in capsys.readouterr().out
    assert cli.main([clip, "-g", gcsv_path, "-t", "_stab"] + CPU) == 2   # exists, no -f


def test_no_card_is_an_error(clip, gcsv_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main([clip, "-g", gcsv_path, "-f"])
    assert not os.path.exists(os.path.splitext(clip)[0] + "_stabilized.y4m")


def test_export_project_then_render_it(clip, gcsv_path):  # noqa: F811
    assert cli.main([clip, "-g", gcsv_path, "-f", "--export-project", "2"] + CPU) == 0
    proj = os.path.splitext(clip)[0] + ".gyroflow"
    assert json.loads(open(proj).read())["version"] == 4
    assert cli.main([proj, "-f", "-t", "_fromproj"] + CPU) == 0
    assert n_frames(os.path.splitext(clip)[0] + "_fromproj.y4m") == FRAMES


def test_export_metadata_types(clip, gcsv_path, tmp_path):  # noqa: F811
    for typ, check in (("1", lambda o: "metadata" in o and "video" in o),
                       ("2", lambda o: "raw_imu" in o and o["raw_imu"]),
                       ("3", lambda o: "fps" in o and len(o["zooming"]["fovs"]) > 0)):
        path = tmp_path / f"meta{typ}.json"
        assert cli.main([clip, "-g", gcsv_path, "-f",
                         "--export-metadata", f"{typ}:{path}"] + CPU) == 0
        obj = json.loads(path.read_text())
        assert check(obj), (typ, list(obj)[:6])


def test_watch_scan_processes_new_videos(clip, gcsv_path, tmp_path):  # noqa: F811
    folder = tmp_path / "incoming"
    folder.mkdir()
    shutil.copy(clip, folder / "a.y4m")
    args = cli.build_parser().parse_args(["--watch", str(folder), "-g", gcsv_path, "-f"] + CPU)
    assert cli._passthrough_flags(args)[:2] == CPU
    processed = set()
    assert cli._watch_scan(str(folder), args, processed) == [str(folder / "a.y4m")]
    assert n_frames(str(folder / "a_stabilized.y4m")) == FRAMES
    assert cli._watch_scan(str(folder), args, processed) == []


def test_export_stmap(clip, gcsv_path, tmp_path):  # noqa: F811
    folder = str(tmp_path / "stmaps")
    assert cli.main([clip, "-g", gcsv_path, "-f", "--export-stmap", f"1:{folder}"] + CPU) == 0
    files = sorted(os.listdir(folder))
    assert len(files) == 2 and "undistort" in files[1] and "redistort" in files[0]


def _stmap_manager(cls, gcsv, **kw):
    """test_stmap.py's manager: 128x96, its fisheye lens profile."""
    m = cls(**kw)
    m.init_from_video_data(DUR_S * 1000.0, 30.0, int(DUR_S * 30.0), (VW, VH))
    m.input_file = "/clips/My Clip.mp4"
    m.load_lens_profile(json.dumps(FISHEYE_LENS))
    m.load_gyro_data(gcsv)
    m.recompute_blocking()
    return m


@pytest.mark.parametrize("per_frame", [False, True])
def test_stmaps_match_jax(gcsv_path, per_frame):  # noqa: F811
    tm = _stmap_manager(StabilizationManager, gcsv_path, device="cpu")
    jm = _stmap_manager(JManager, gcsv_path)
    assert stmap.stmap_filename_base(tm) == "My-Clip-TestBrand-Cam-X1-wide"
    for ts, frame in ((100.0, 3), (900.0, 27)):
        got = stmap.compute_undistort_stmap(tm, ts, per_frame, frame)
        want = jstmap.compute_undistort_stmap(jm, ts, per_frame, frame)
        assert got.shape == want.shape and got.shape[0] > VH and got.shape[1] > VW
        # an invalid pixel is (0, 1, 0)
        invalid = lambda m: (m[..., 0] == 0.0) & (m[..., 1] == 1.0)   # noqa: E731
        assert np.array_equal(invalid(got), invalid(want))
        assert np.abs(got - want).max() <= 1e-5
        red = stmap.compute_redistort_stmap(tm, ts, per_frame, frame)
        jred = jstmap.compute_redistort_stmap(jm, ts, per_frame, frame)
        assert red.shape == (VH, VW, 3) and np.abs(red - jred).max() <= 1e-5


def test_find_offset_matches_jax(gcsv_path):  # noqa: F811
    """test_find_offset.py's recovery of a 47 ms offset from synthetic flow,
    through the port's find_offsets_rs_sync and PoseEstimator."""
    from test_find_offset import FPS as SFPS, TRUE_OFFSET_MS, VH as SVH, VW as SVW
    from test_find_offset import make_manager, synth_estimator
    from gyroflow_tpu.sync.find_offset import find_offsets_rs_sync as jfind
    from gyroflow_torch.sync.find_offset import find_offsets_rs_sync
    from gyroflow_torch.sync.pose_estimator import FrameResult, PoseEstimator

    jm = make_manager(gcsv_path)
    jest, rng = synth_estimator(jm, TRUE_OFFSET_MS)
    tm = StabilizationManager(device="cpu")
    tm.init_from_video_data(DUR_S * 1000.0, SFPS, int(DUR_S * SFPS), (SVW, SVH))
    tm.load_gyro_data(gcsv_path)
    tm.lens.global_shutter = True
    tm.recompute_blocking()
    test = PoseEstimator(tm.get_compute_params(), (SVW, SVH))
    for ts, r in jest.results.items():
        test.results[ts] = FrameResult(ts, of_points=r.of_points, next_ts=r.next_ts,
                                       points=r.points)
    got = find_offsets_rs_sync(tm, test, [rng], initial_offset=0.0, search_size=300.0)
    want = jfind(jm, jest, [rng], initial_offset=0.0, search_size=300.0)
    assert got and abs(got[0][1] - TRUE_OFFSET_MS) < 1.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-9)


def test_eight_point_pose_matches_jax():
    """test_sync.py's eight-point pose on a 3D cloud with parallax."""
    import cv2
    from gyroflow_tpu.sync.pose_estimator import PoseEstimator as JPose
    from gyroflow_torch.sync.pose_estimator import PoseEstimator
    rng = np.random.default_rng(3)
    pts3 = np.c_[rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200), rng.uniform(4, 8, 200)]
    ang = np.radians(2.0)
    R, _ = cv2.Rodrigues(np.array([0.3 * ang, ang, 0.1 * ang]))
    p2 = (pts3 @ R.T) + np.array([0.2, 0.05, 0.0])
    u0, u1 = pts3[:, :2] / pts3[:, 2:], p2[:, :2] / p2[:, 2:]
    got = PoseEstimator._pose_eight_point(u0, u1)
    assert got is not None
    np.testing.assert_array_equal(got, JPose._pose_eight_point(u0, u1))
    np.testing.assert_allclose(cv2.Rodrigues(got)[0].reshape(-1),
                               cv2.Rodrigues(R)[0].reshape(-1), atol=5e-3)


def test_markerless_chessboard_matches_jax():
    """test_calibrator.py's markerless 14x8 board through the port's
    LensCalibrator."""
    from test_calibrator import COLS, ROWS, render_board
    from gyroflow_tpu.calibration.calibrator import LensCalibrator as JCal
    from gyroflow_torch.calibration.calibrator import LensCalibrator
    img = render_board(3.0, 0.9)
    cal, jcal = LensCalibrator(no_marker=True), JCal(no_marker=True)
    assert cal.feed_frame(0, 0, img) and jcal.feed_frame(0, 0, img)
    got, want = cal.image_points[0].points, jcal.image_points[0].points
    assert len(got) == COLS * ROWS
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_remux_matches_jax(tmp_path):
    """test_mp4mux.py's audio merge with chunk relocation through the port's
    remux_with_audio: the same bytes out."""
    from test_mp4mux import make_media_mp4
    from gyroflow_tpu.utils.mp4mux import remux_with_audio as jremux
    from gyroflow_torch.core.telemetry.mp4 import parse_tracks
    from gyroflow_torch.utils.mp4mux import remux_with_audio
    vp = [b"VIDEOFRAME%02d" % i for i in range(5)]
    ap = [bytes([0xA0 + i]) * 37 for i in range(8)]
    vfile, afile = tmp_path / "video.mp4", tmp_path / "source.mp4"
    vfile.write_bytes(make_media_mp4(b"vide", b"Video", b"mp4v", vp))
    afile.write_bytes(make_media_mp4(b"soun", b"Sound", b"mp4a", ap, track_id=1))
    assert remux_with_audio(str(vfile), str(afile), str(tmp_path / "out.mp4"))
    assert jremux(str(vfile), str(afile), str(tmp_path / "jout.mp4"))
    buf = (tmp_path / "out.mp4").read_bytes()
    assert buf == (tmp_path / "jout.mp4").read_bytes()
    by_type = {t.handler_type: t for t in parse_tracks(buf)}
    for (off, size, _t, _d), orig in zip(by_type[b"soun"].samples(), ap):
        assert buf[off:off + size] == orig
