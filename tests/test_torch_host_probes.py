"""The port's two host experiments against the JAX side, on the CPU.

- ``experiments.host_pipeline_bench`` at 64x32, 4 frames: finite, positive
  readings for its five stages; the y4m that each writing stage writes
  hashes as a y4m the JAX package's ``Y4MWriter`` writes from the same
  planes; the port's ``_plane_groups`` / ``_ungroup_planes`` round trip of
  the fixture's planes equals the JAX package's bit for bit; too little
  free space fails before anything is written.
- ``experiments.window_dispatch_probe`` at 64x32: each window's value is
  the sum of its frame steps within float32 rounding; the probe's matrices
  are the reference script's ``make_matrices`` within 1e-6.
- ``main()`` of both raises with no card and prints nothing.
"""
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gyroflow_torch.experiments import host_pipeline_bench, window_dispatch_probe
from gyroflow_torch.render import renderer as trenderer
from gyroflow_torch.render.formats import RAW_FORMATS
from gyroflow_tpu.render import renderer as jrenderer
from gyroflow_tpu.render.formats import RAW_FORMATS as J_RAW_FORMATS
from gyroflow_tpu.render.y4m_io import Y4MWriter as JY4MWriter

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SIZE = (64, 32)            # the Y plane; U and V are 32x16
N = 4
STAGES = ("decode", "convert", "encode", "async_encode", "device_round_trip")
WRITING = ("encode", "async_encode", "device_round_trip")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return host_pipeline_bench.run("cpu", SIZE, N, workdir=tmp_path_factory.mktemp("y4m"))


def test_host_pipeline_readings(host):
    assert list(host["stages"]) == list(STAGES)
    for name, st in host["stages"].items():
        assert st["frames"] == N, name
        for k in ("steady_fps", "mean_fps"):
            assert math.isfinite(st[k]) and st[k] > 0, (name, k)
    e = host["stages"]["device_round_trip"]
    for k in ("stack_ms", "upload_ms", "download_ms"):
        assert all(math.isfinite(v) and v > 0 for v in e[k].values()), k
    assert host["frame_bytes"] == SIZE[0] * SIZE[1] * 3 // 2 * 2


@pytest.mark.parametrize("stage", WRITING)
def test_host_pipeline_output_is_input(host, tmp_path, stage):
    """The input's hash is that of the same frames written by the JAX
    package's Y4MWriter, and each writing stage's output hashed the same."""
    want = tmp_path / "jax.y4m"
    w = JY4MWriter(str(want), *SIZE, host_pipeline_bench.FPS, host_pipeline_bench.PIX_FMT)
    planes = host_pipeline_bench.fixture_planes(SIZE)
    for _ in range(N):
        w.write_planes(planes)
    w.close()
    assert host["input_sha256"] == host_pipeline_bench.sha256(want)
    assert host["stages"][stage]["output_equals_input"] is True


def test_plane_group_round_trip_is_jax():
    planes = host_pipeline_bench.fixture_planes(SIZE)
    assert [p.shape for p in planes] == [(32, 64, 1), (16, 32, 1), (16, 32, 1)]
    fmt, jfmt = RAW_FORMATS["yuv420p10le"], J_RAW_FORMATS["yuv420p10le"]
    groups, jgroups = trenderer._plane_groups(fmt, planes), jrenderer._plane_groups(jfmt, planes)
    assert [pi for _, pi in groups] == [pi for _, pi in jgroups] == [0, 1]
    for (g, _), (jg, _) in zip(groups, jgroups):
        assert g.dtype == jg.dtype == np.uint16 and np.array_equal(g, jg)
    outs = trenderer._ungroup_planes(fmt, [g for g, _ in groups], src_max=fmt.max_value)
    jouts = jrenderer._ungroup_planes(jfmt, [g for g, _ in jgroups], src_max=jfmt.max_value)
    for out, jout, plane in zip(outs, jouts, planes):
        assert out.dtype == jout.dtype == np.uint16
        assert np.array_equal(out, jout) and np.array_equal(out, plane)


def test_host_pipeline_needs_room(monkeypatch, tmp_path):
    monkeypatch.setattr(host_pipeline_bench.shutil, "disk_usage",
                        lambda path: type("Usage", (), {"free": 1000})())
    with pytest.raises(RuntimeError, match="GB free"):
        host_pipeline_bench.run("cpu", SIZE, N, workdir=tmp_path)
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def dispatch():
    return window_dispatch_probe.run("cpu", SIZE)


def test_dispatch_readings(dispatch):
    keys = ["per_frame"] + [f"window_{F}" for F in window_dispatch_probe.WINDOWS]
    for key in keys:
        r = dispatch[key]
        assert math.isfinite(r["ms_per_frame"]) and r["ms_per_frame"] > 0, key
        assert r["fps"] == pytest.approx(1e3 / r["ms_per_frame"])
        assert "device_busy_ms" not in r   # the profiled rep reads the card only
    assert dispatch["window_4"]["windows"] == 6 and dispatch["window_8"]["windows"] == 3


@pytest.mark.parametrize("F", window_dispatch_probe.WINDOWS)
def test_window_value_is_sum_of_frame_steps(dispatch, F):
    """A window of F frame steps at salt 0 against F times the one frame
    step at salt 0: the same frame, so equal up to float32 accumulation."""
    frame = dispatch["per_frame"]["value"]
    window = dispatch[f"window_{F}"]["value"]
    assert frame > 0
    assert window == pytest.approx(F * frame, rel=F * float(np.finfo(np.float32).eps))


def test_dispatch_matrices_are_reference(monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))   # the script inserts a path
    spec = importlib.util.spec_from_file_location(
        "reference_window_dispatch_probe", REPO / "experiments/window_dispatch_probe.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    (cfg_y, _, img_y, mats_y), (cfg_uv, _, img_uv, mats_uv) = \
        window_dispatch_probe.planes("cpu", SIZE)
    assert tuple(img_y.shape) == (32, 64, 1) and tuple(img_uv.shape) == (16, 32, 2)
    for cfg, mats in ((cfg_y, mats_y), (cfg_uv, mats_uv)):
        W, H = cfg.width, cfg.height
        want = ref.make_matrices(W, H, (W * 0.62, W * 0.62), 0.92, H)
        assert mats.shape == want.shape == (H, 14)
        np.testing.assert_allclose(mats.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("module", [host_pipeline_bench, window_dispatch_probe])
def test_main_needs_a_card(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()
    assert capsys.readouterr().out == ""
