"""The FrameTransform's per-row table: the native pass against its numpy twin.

``ops/frame_transform.py`` builds the (rows, 14) float32 table of a frame
(per row the RS matrix and the IBIS / OIS shifts) in one pass of
``native/ft_rows.cpp`` whenever the native library is available, and in numpy
otherwise. Each case below builds the table both ways from the same
ComputeParams:

- the benchmark's GoPro fisheye and Sony (IBIS, 9x9 mesh, FPD) deployments,
  written by ``portbench.deploy`` with their clips cut short: bit-identical;
- framebuffer inverted, horizontal readout, zero readout (one row), rotation
  suppressed (with and without readout), a sync-offset table of three
  entries, timestamps before the first and after the last gyro sample, a row
  on a gyro sample, a near-singular new_k (the pseudo-inverse), a video
  rotation, no gyro data (identity rows): within one float32 ulp.

The port's frame transform is also held to the JAX package's at the same
timestamps on both deployments (matrices to the bit, kernel config and
dynamics equal), and the native library's name to both of its sources.
"""
import copy
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from gyroflow_torch import native, trace
from gyroflow_torch.core.params import ReadoutDirection
from gyroflow_torch.ops import frame_transform as ft

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 977

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is missing: the native pass cannot be built")


def _deployment(name, seconds, tmp_path_factory):
    """(configuration, telemetry file, the port's manager on the CPU): the
    benchmark configuration's deployment, its clip cut to ``seconds``."""
    from portbench import deploy
    cfg = deploy.load_config(name, json.loads((REPO / "BENCHMARK.json").read_text()))
    cfg["clip_seconds"] = seconds
    path = deploy.write_telemetry(tmp_path_factory.mktemp(name), cfg, SEED)
    return cfg, path, deploy.program_manager(cfg, path, "cpu")


def _jax_manager(cfg, path):
    """The JAX package's manager, loaded from the same files as the port's."""
    from gyroflow_tpu.core.manager import StabilizationManager as JManager
    from portbench import deploy
    jm = JManager()
    n = deploy.frame_count(cfg)
    jm.init_from_video_data(n / cfg["fps"] * 1000.0, cfg["fps"], n, (cfg["width"], cfg["height"]))
    jm.load_gyro_data(str(path))
    jm.load_lens_profile(deploy.lens_text(cfg, jm.gyro.file_metadata.lens_profile))
    jm.recompute_blocking()
    return jm


@pytest.fixture(scope="module")
def gopro(tmp_path_factory):
    return _deployment("gopro-hero10-4k60-fisheye", 3.0, tmp_path_factory)


@pytest.fixture(scope="module")
def sony(tmp_path_factory):
    return _deployment("sony-a7iv-4k60-mesh", 0.25, tmp_path_factory)


def _frame_ms(cfg, i):
    return i * 1000.0 / cfg["fps"]


def _with_gyro(cp, **attrs):
    """cp with a shallow copy of its gyro source, attrs set on the copy."""
    gyro = copy.copy(cp.gyro)
    for k, v in attrs.items():
        setattr(gyro, k, v)
    return dataclasses.replace(cp, gyro=gyro)


def _on_sample(cfg, cp, i):
    """Frame i's timestamp moved so that its first row's lookup lands on a
    gyro sample (the slerp's frac is 0 there)."""
    fm = cp.gyro.file_metadata
    t = _frame_ms(cfg, i)
    frt = ft.get_frame_readout_time(cp, True, t, fm)
    pfo = fm.per_frame_time_offsets[i] if i < len(fm.per_frame_time_offsets) else 0.0
    ts_us = cp.gyro.quaternions.timestamps_us
    k = int(np.searchsorted(ts_us, t * 1000.0))
    t = ts_us[k] / 1000.0 + frt / 2.0 - pfo
    lookup0 = int(np.rint((t + pfo - frt / 2.0) * 1000.0))
    assert lookup0 == ts_us[k] and not cp.gyro.offsets_adjusted
    return cp, t, i


def _case(name, cfg, cp):
    """(params, timestamp_ms, frame) of a named case."""
    gyro = cp.gyro
    dur = gyro.duration_ms
    if name in ("gopro", "sony"):
        return cp, _frame_ms(cfg, 10), 10
    if name == "inverted":
        return dataclasses.replace(cp, framebuffer_inverted=True), _frame_ms(cfg, 5), 5
    if name == "horizontal":
        return (dataclasses.replace(cp, frame_readout_direction=ReadoutDirection.LeftToRight),
                _frame_ms(cfg, 7), 7)
    if name == "zero-readout":
        return dataclasses.replace(cp, frame_readout_time=0.0), _frame_ms(cfg, 3), 3
    if name == "suppress":
        return dataclasses.replace(cp, suppress_rotation=True), _frame_ms(cfg, 4), 4
    if name == "suppress-zero-readout":
        return (dataclasses.replace(cp, suppress_rotation=True, frame_readout_time=0.0),
                _frame_ms(cfg, 4), 4)
    if name == "offsets":
        t = _frame_ms(cfg, 6)
        keys = [int(t * 1000) - 3000, int(t * 1000) + 1500, int(t * 1000) + 40000]
        return _with_gyro(cp, offsets_adjusted=dict(zip(keys, [12.5, -7.25, 3.0]))), t, 6
    if name == "before-first":
        return cp, -60.0, 0
    if name == "after-last":
        return cp, dur + 60.0, cp.frame_count - 1
    if name == "on-sample":
        return _on_sample(cfg, cp, 8)
    if name == "pinv":
        p = dataclasses.replace(cp, fov_scale=1e14)
        new_k = ft.get_new_k(p, ft.get_lens_data_at_timestamp(p, _frame_ms(cfg, 2), False)[0],
                             ft.get_fov(p, 2, True, _frame_ms(cfg, 2), False))
        assert np.linalg.cond(new_k) > 1e12        # the SVD branch of _inverse_k
        return p, _frame_ms(cfg, 2), 2
    if name == "video-rotation":
        return dataclasses.replace(cp, video_rotation=33.0), _frame_ms(cfg, 9), 9
    if name == "no-gyro":
        return _with_gyro(cp, duration_ms=0.0), _frame_ms(cfg, 9), 9
    raise KeyError(name)


def _tables(monkeypatch, p, t, i):
    """(native table, numpy table, the native pass's counter)."""
    assert native.available(), "g++ is present but the native library did not build"
    trace.enable()
    try:
        nat = ft.frame_transform_at(p, t, i).matrices
        counted = trace.counts().get("gf.ft.native_rows")
    finally:
        trace.disable()
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        ref = ft.frame_transform_at(p, t, i).matrices
    return nat, ref, counted


def _ulps(a, b):
    """float32 ulps between a and b (+0 and -0 are 0 apart)."""
    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


CASES = ["inverted", "horizontal", "zero-readout", "suppress", "suppress-zero-readout",
         "offsets", "before-first", "after-last", "on-sample", "pinv", "video-rotation",
         "no-gyro"]


@pytest.mark.parametrize("name", ["gopro"] + [f"gopro-{c}" for c in CASES])
def test_gopro_rows_native_vs_numpy(gopro, monkeypatch, name):
    cfg, _, mgr = gopro
    _check(monkeypatch, cfg, mgr, name.removeprefix("gopro-"))


@pytest.mark.parametrize("name", ["sony"] + [f"sony-{c}" for c in
                                             ("inverted", "horizontal", "suppress",
                                              "suppress-zero-readout", "after-last")])
def test_sony_rows_native_vs_numpy(sony, monkeypatch, name):
    cfg, _, mgr = sony
    _check(monkeypatch, cfg, mgr, name.removeprefix("sony-"))


def _check(monkeypatch, cfg, mgr, case):
    cp = mgr.get_compute_params()
    p, t, i = _case(case, cfg, cp)
    nat, ref, counted = _tables(monkeypatch, p, t, i)
    horizontal = p.frame_readout_direction.is_horizontal
    rows = 1 if p.frame_readout_time == 0.0 else (p.width if horizontal else p.height)
    assert nat.shape == ref.shape == (rows, 14) and nat.dtype == np.float32
    assert counted == rows
    assert np.isfinite(ref).all()
    if case in ("gopro", "sony"):
        np.testing.assert_array_equal(nat.view(np.int32), ref.view(np.int32))
    assert _ulps(nat, ref).max() <= 1, case
    stab = p.gyro.file_metadata.camera_stab_data
    if case == "sony":
        assert i < len(stab) and np.abs(ref[:, 9:]).max() > 0     # the IBIS columns are read
    if case == "suppress-zero-readout":
        assert not ref[:, 9:].any()


@pytest.mark.parametrize("which", ["gopro", "sony"])
def test_frame_transform_matches_jax(request, which):
    """The port's frame transform (native pass) against the JAX package's at
    the same timestamps: matrices to the bit, kernel config and dynamics
    equal, the mesh buffer too."""
    from gyroflow_tpu.ops import frame_transform as jft
    cfg, path, mgr = request.getfixturevalue(which)
    cp, jcp = mgr.get_compute_params(), _jax_manager(cfg, path).get_compute_params()
    for i in (1, 9, 14):
        t = _frame_ms(cfg, i)
        got, want = ft.frame_transform_at(cp, t, i), jft.frame_transform_at(jcp, t, i)
        np.testing.assert_array_equal(got.matrices.view(np.int32),
                                      np.asarray(want.matrices, np.float32).view(np.int32))
        assert got.kernel_cfg == want.kernel_cfg
        for a, b in zip(got.kernel_dyn, want.kernel_dyn):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert (got.fov, got.minimal_fov, got.focal_length) == \
            (want.fov, want.minimal_fov, want.focal_length)
        if want.mesh_data is None:
            assert got.mesh_data is None
        else:
            np.testing.assert_array_equal(got.mesh_data, want.mesh_data)


@pytest.mark.parametrize("source", ["gyroflow_native.cpp", "ft_rows.cpp"])
def test_library_name_covers_both_sources(tmp_path, source):
    """The cached library's digest changes when either source changes, and
    ft_rows.cpp alone builds with contraction off."""
    copies = {}
    for src, flags in native.SOURCES.items():
        dst = tmp_path / Path(src).name
        shutil.copyfile(src, dst)
        copies[str(dst)] = flags
    before = native.digest(copies)
    assert before == native.digest(native.SOURCES)
    edited = tmp_path / source
    edited.write_bytes(edited.read_bytes() + b"\n")
    assert native.digest(copies) != before
    flags = {Path(s).name: f for s, f in native.SOURCES.items()}
    assert "-ffp-contract=off" in flags["ft_rows.cpp"]
    assert "-ffp-contract=off" not in flags["gyroflow_native.cpp"]
