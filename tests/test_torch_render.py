"""gyroflow_torch's renderer and render queue on the CPU (the port's
counterpart of test_render_sharded.py and test_media.py).

Two 64x48, 10-frame clips: an 8-bit and a 10-bit YUV420 y4m, each frame a
shifted crop of one seeded random picture. Both packages' managers are built
the same way (test_render_sharded.py's make_mgr: the seeded .gcsv of
test_end_to_end.py).

- The port's render with frame_window 4 (process_pixels_window) and 1
  (process_pixels per frame): 0 codes apart.
- The port's render against the JAX renderer (frame_window=1): within 1
  code (lanczos4, uint8 / uint16 planes out).
- A window of 8 over 10 frames pads its tail and emits 10 frames.
- Two trim ranges, and the same with pad_with_black, windowed against
  serial: 0 codes.
- A job through the port's RenderQueue.
"""
import functools

import numpy as np
import pytest

from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_tpu.render.renderer import RenderOptions as JRenderOptions
from gyroflow_tpu.render.renderer import render as jax_render
from gyroflow_torch.core import manager as tmanager
from gyroflow_torch.render.render_queue import JobStatus, RenderQueue
from gyroflow_torch.render.renderer import RenderOptions, render
from gyroflow_torch.render.y4m_io import Y4MReader, Y4MWriter

from test_end_to_end import gcsv_path  # noqa: F401 (fixture)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, FPS, FRAMES = 64, 48, 30.0, 10
PIX = {"8bit": ("yuv420p", np.uint8, 255), "10bit": ("yuv420p10le", np.dtype("<u2"), 1023)}


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{name: path} of the 8-bit and the 10-bit clip."""
    out = {}
    for name, (pix, dtype, maxv) in PIX.items():
        rng = np.random.default_rng(7)
        base = [rng.uniform(16, maxv - 16, (h, w, 1)).astype(dtype)
                for h, w in ((H * 2, W * 2), (H, W), (H, W))]
        path = str(tmp_path_factory.mktemp("clip") / f"in_{name}.y4m")
        w = Y4MWriter(path, W, H, FPS, pix)
        for i in range(FRAMES):
            oy = H // 2 + int(8 * np.sin(i / 3.0))
            ox = W // 2 + int(8 * np.cos(i / 4.0))
            w.write_planes([base[0][oy:oy + H, ox:ox + W],
                            base[1][oy // 2:oy // 2 + H // 2, ox // 2:ox // 2 + W // 2],
                            base[2][oy // 2:oy // 2 + H // 2, ox // 2:ox // 2 + W // 2]])
        w.close()
        out[name] = path
    return out


def make_mgr(gcsv, jax=False):
    m = JManager() if jax else tmanager.StabilizationManager(device="cpu")
    m.init_from_video_data(FRAMES / FPS * 1000.0, FPS, FRAMES, (W, H))
    m.load_gyro_data(gcsv)
    m.recompute_blocking()
    return m


def read_planes(path):
    r = Y4MReader(path)
    out = [[p.copy() for p in planes] for _, planes in r]
    r.close()
    return out


def assert_same(a, b, atol=0):
    assert len(a) == len(b) and len(a) > 0
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            assert pa.dtype == pb.dtype and pa.shape == pb.shape
            assert np.abs(pa.astype(np.int32) - pb.astype(np.int32)).max() <= atol


@pytest.fixture(scope="module")
def serial(clips, gcsv_path, tmp_path_factory):  # noqa: F811
    """{clip name: planes} of the port's per-frame render (frame_window=1)."""
    d = tmp_path_factory.mktemp("serial")
    out = {}
    for name, clip in clips.items():
        path = str(d / f"{name}.y4m")
        s = render(make_mgr(gcsv_path), clip, path, RenderOptions(frame_window=1))
        assert s["backend"] == "torch-cpu" and "frame_window" not in s, s
        out[name] = read_planes(path)
    return out


@pytest.mark.parametrize("name", list(PIX))
def test_window_matches_per_frame(clips, serial, gcsv_path, tmp_path, name):  # noqa: F811
    path = str(tmp_path / "w4.y4m")
    s = render(make_mgr(gcsv_path), clips[name], path, RenderOptions(frame_window=4))
    assert s["frames"] == FRAMES and s["pix_fmt"] == PIX[name][0]
    assert s["backend"] == "torch-cpu-window"
    assert s["frame_window"] == 4 and s["mesh"] == {"dp": 1, "sp": 1}
    assert_same(read_planes(path), serial[name])


@pytest.mark.parametrize("name", list(PIX))
def test_matches_jax_renderer(clips, serial, gcsv_path, tmp_path, name):  # noqa: F811
    path = str(tmp_path / "jax.y4m")
    s = jax_render(make_mgr(gcsv_path, jax=True), clips[name], path,
                   JRenderOptions(frame_window=1))
    assert s["frames"] == FRAMES
    got = serial[name]
    assert got[0][0].dtype == PIX[name][1]
    assert_same(got, read_planes(path), atol=1)


def test_tail_window_pads(clips, serial, gcsv_path, tmp_path):  # noqa: F811
    """10 frames, window 8: one full window and a tail of 2 padded to 8,
    whose 6 repeats are not emitted."""
    path = str(tmp_path / "tail.y4m")
    s = render(make_mgr(gcsv_path), clips["10bit"], path, RenderOptions(frame_window=8))
    assert s["frames"] == FRAMES and s["frame_window"] == 8
    assert_same(read_planes(path), serial["10bit"])


@pytest.mark.parametrize("pad_with_black", [False, True])
def test_trim_ranges_windowed_match_serial(clips, gcsv_path, tmp_path,  # noqa: F811
                                           pad_with_black):
    mgr = make_mgr(gcsv_path)
    mgr.params.trim_ranges = [(0.0, 0.3), (0.6, 0.9)]
    outs = []
    for window in (1, 4):
        path = str(tmp_path / f"w{window}.y4m")
        render(mgr, clips["8bit"], path,
               RenderOptions(frame_window=window, pad_with_black=pad_with_black))
        outs.append(read_planes(path))
    assert len(outs[0]) == (FRAMES if pad_with_black else 8)
    assert_same(outs[1], outs[0])


def test_through_render_queue(clips, serial, gcsv_path, tmp_path, monkeypatch):  # noqa: F811
    """A job through the port's RenderQueue: its worker builds its own
    manager (on cuda:0, so on the CPU here only because the test says so)."""
    monkeypatch.setattr(tmanager, "StabilizationManager",
                        functools.partial(tmanager.StabilizationManager, device="cpu"))
    q = RenderQueue(parallel_renders=1, state_path=str(tmp_path / "queue.json"))
    out = str(tmp_path / "queued.y4m")
    q.add_job(make_mgr(gcsv_path), clips["10bit"], out, RenderOptions(frame_window=4))
    q.run(overwrite=True)
    assert all(j.status == JobStatus.Finished for j in q.jobs.values()), \
        {j.job_id: (j.status, j.error) for j in q.jobs.values()}
    assert_same(read_planes(out), serial["10bit"])
    assert RenderQueue.load_state(str(tmp_path / "queue.json")).jobs[1].options.frame_window == 4
