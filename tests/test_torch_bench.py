"""gyroflow_torch's measurement path (``gyroflow_torch.bench`` and the
production-path and render-loop probes) against the JAX side, on the CPU.

- ``make_matrices`` equals ``bench.make_matrices`` bit for bit, and the
  gyro log the port's bench writes equals the text of ``bench.py``'s.
- The bench's planes and kernel parameters equal the ones ``bench.py``
  builds with the JAX package's classes.
- The bench's frame step on a 96x64x1 + 48x32x2 pair (seeded uniform
  0..1023, FIX_COLOR_RANGE) through the kernel wrappers' plain versions,
  against JAX ``remap_plane_pallas`` in interpret mode on the same numpy
  inputs: within 0.25 of a code at all but 0.2% of the pixels, the
  coordinates within 0.05 px (valid identical). On uniform noise a source
  position that float32 rounding moves across one of the LUT's 32 phases
  changes a pixel by several codes (ROADMAP queue 3 item 6).
- The production-path manager's ``process_pixels`` against the JAX
  manager built the same way, on uint16 uniform-noise planes: within 1
  code of the JAX manager's frame run op by op (``remap.remap_plane``), and
  of its jitted ``process_pixels`` at all but 0.2% of the pixels (the
  jitted run moves 1-2 pixels a plane by up to 20 codes from its own
  op-by-op result here: a LUT phase flip, as above).
- The production window at F = 2 against JAX's ``make_window_step`` on a
  1-device mesh (Pallas in interpret mode): within 1 code at all but 0.2%
  of the pixels, as above.
- ``main()`` raises with no card and prints nothing; ``python -m
  gyroflow_torch.bench`` exits non-zero.
- The render-loop probe's stubs keep the loop off the remap and the
  kernels; the production-path probe's stages run.
"""
import ast
import io
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as root_bench
from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import FIX_COLOR_RANGE as J_FIX_COLOR_RANGE
from gyroflow_tpu.ops.kernel_params import KernelConfig as JConfig
from gyroflow_tpu.ops.kernel_params import KernelDynamics as JDynamics
from gyroflow_tpu.parallel import pipeline as jpp
from gyroflow_torch import bench
from gyroflow_torch.experiments import prod_path_probe, renderer_loop_bench
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.ops.kernel_params import dyn_to_torch

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
SIZE = (96, 64)            # the Y plane; UV is 48x32x2
PHASE_FLIPS = 2e-3         # share of pixels a LUT phase flip may move
F32_TOL = 0.25             # of a code, float32
U16_TOL = 1                # of a code, uint16
UV_TOL_PX = 0.05


def _jax_plane(W, H, plane_index):
    """bench.py's KernelConfig and KernelDynamics (bench.py:60-69) with the
    JAX package's classes."""
    cfg = JConfig(width=W, height=H, output_width=W, output_height=H, interpolation=8,
                  distortion_model="opencv_fisheye", plane_index=plane_index,
                  flags=J_FIX_COLOR_RANGE)
    dyn = JDynamics.make(f=(W * 0.62, W * 0.62), c=(W / 2, H / 2),
                         k=[0.25, -0.07, 0.02, -0.003], fov=0.92, max_pixel_value=1023.0,
                         pixel_value_limit=1023.0, background=(0, 0, 0, 1))
    return cfg, dyn


@pytest.mark.parametrize("W,H,rows", [(96, 64, 64), (48, 32, 32), (3840, 2160, 16)])
def test_make_matrices_is_bench_py(W, H, rows):
    f = (W * 0.62, W * 0.62)
    got = bench.make_matrices(W, H, f, 0.92, rows)
    assert got.dtype == np.float32 and got.shape == (rows, 14)
    np.testing.assert_array_equal(got, root_bench.make_matrices(W, H, f, 0.92, rows))


def _bench_py_gcsv() -> str:
    """The text bench.py's production path writes: the body of its
    ``with tempfile.NamedTemporaryFile(..., suffix=".gcsv")`` block run on
    a StringIO (bench.py writes it inline in main())."""
    tree = ast.parse((REPO / "bench.py").read_text())
    blocks = [n for n in ast.walk(tree) if isinstance(n, ast.With)
              and any(isinstance(k.value, ast.Constant) and k.value.value == ".gcsv"
                      for it in n.items if isinstance(it.context_expr, ast.Call)
                      for k in it.context_expr.keywords)]
    assert len(blocks) == 1
    body = [s for s in blocks[0].body if not isinstance(s, ast.Assign)]   # gcsv = fh.name
    fh = io.StringIO()
    exec(compile(ast.Module(body=body, type_ignores=[]), "bench.py", "exec"),
         {"fh": fh, "math": math})
    return fh.getvalue()


def test_gcsv_is_bench_py(tmp_path):
    bench.write_gcsv(tmp_path / "b.gcsv")
    text = (tmp_path / "b.gcsv").read_text()
    assert text.startswith("GYROFLOW IMU LOG\n") and text.count("\n") == 1205
    assert text == _bench_py_gcsv()


def test_plane_config_is_bench_py():
    for W, H, pi in ((96, 64, 0), (48, 32, 1), (3840, 2160, 0), (1920, 1080, 1)):
        cfg, dyn = bench.plane_config(W, H, pi)
        jcfg, jdyn = _jax_plane(W, H, pi)
        assert tuple(cfg) == tuple(jcfg)
        for a, b in zip(dyn, jdyn):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_inputs_follow_bench_py_draws():
    """The planes come from default_rng(0) in bench.py's order: the
    primary Y and UV planes, the 8K plane, the production planes, the
    window frames."""
    rng, ref = np.random.default_rng(0), np.random.default_rng(0)
    (_, _, y, _), (_, _, uv, _) = bench.primary_planes(rng, "cpu", SIZE)
    np.testing.assert_array_equal(y.numpy(), ref.uniform(0, 1023, (64, 96, 1)).astype(np.float32))
    np.testing.assert_array_equal(uv.numpy(),
                                  ref.uniform(0, 1023, (32, 48, 2)).astype(np.float32))
    _, _, img8, mats8 = bench.eight_k_plane(rng, "cpu", (128, 80))
    np.testing.assert_array_equal(img8.numpy(),
                                  ref.uniform(0, 1023, (80, 128, 1)).astype(np.float32))
    assert tuple(mats8.shape) == (80, 14)
    y_dev, uv_dev = bench.production_planes(rng, "cpu", SIZE)
    y_host = ref.integers(0, 1024, (64, 96, 1)).astype(np.uint16)
    uv_host = ref.integers(0, 1024, (32, 48, 2)).astype(np.uint16)
    for got, want in zip(y_dev + uv_dev, (y_host, y_host + 1, uv_host, uv_host + 1)):
        assert got.dtype == torch.uint16
        np.testing.assert_array_equal(got.numpy(), want)
    steps = bench.window_steps(rng, torch.device("cpu"), SIZE, 2)
    for (_, placed, _), shape in zip(steps, ((2, 64, 96, 1), (2, 32, 48, 2))):
        imgs, mats, _ = placed[0][torch.device("cpu")]
        np.testing.assert_array_equal(imgs.numpy(),
                                      ref.integers(0, 1024, shape).astype(np.uint16))
        W, H = shape[2], shape[1]
        want = root_bench.make_matrices(W, H, (W * 0.62, W * 0.62), 0.92, H)
        np.testing.assert_array_equal(mats[0].numpy(), want)
        np.testing.assert_array_equal(mats[1, :, 9:].numpy(), want[:, 9:])
        np.testing.assert_array_equal(mats[1, :, :9].numpy(), want[:, :9] * (1.0 + 1e-4))


@pytest.fixture(scope="module")
def primary():
    return bench.primary_planes(np.random.default_rng(0), "cpu", SIZE)


SALT = np.float32(3e-3)


def _uv_port(cfg, dyn, mats):
    ow, oh = cfg.out_buffer
    dt = dyn_to_torch(dyn, "cpu")
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32),
                            torch.arange(ow, dtype=torch.float32), indexing="ij")
    factor = torch.clamp_min(1.0 - dt.lens_correction_amount, 0.001)
    u, v, valid = tremap.undistort_coord(ox, oy, mats, cfg, dt, (ow / 2.0, oh / 2.0),
                                         (dt.f[0] / dt.fov / factor, dt.f[1] / dt.fov / factor))
    return u.numpy(), v.numpy(), valid.numpy()


def _uv_jax(jcfg, jdyn, mats):
    ow, oh = jcfg.out_buffer
    gy, gx = jnp.meshgrid(jnp.arange(oh, dtype=jnp.float32), jnp.arange(ow, dtype=jnp.float32),
                          indexing="ij")
    factor = jnp.maximum(1.0 - jdyn.lens_correction_amount, 0.001)
    uv, valid = jremap.undistort_coord(jnp.stack([gx, gy], -1), jnp.asarray(mats), jcfg, jdyn,
                                       (ow / 2.0, oh / 2.0), (jdyn.f[0] / jdyn.fov / factor,
                                                              jdyn.f[1] / jdyn.fov / factor))
    return np.asarray(uv[..., 0]), np.asarray(uv[..., 1]), np.asarray(valid)


def test_frame_step_matches_pallas(primary):
    """Each plane of the bench's frame against remap_plane_pallas (interpret
    mode) on the same salted numpy plane; the step's value is the two
    outputs' sums plus the salt."""
    (_, _, y, yl), (_, _, uv, uvm) = primary
    salt = torch.tensor(SALT)
    outs = bench.remap_frame(primary, y, yl, uv, uvm, salt)
    for (cfg, dyn, img, mats), out, pi in zip(primary, outs, (0, 1)):
        jcfg, jdyn = _jax_plane(cfg.width, cfg.height, pi)
        want, overflow = jremap.remap_plane_pallas_jit(jnp.asarray(img.numpy() + SALT),
                                                       jnp.asarray(mats.numpy()), jcfg, jdyn)
        assert not bool(overflow)
        want = np.asarray(want)
        got = out.numpy()
        assert got.dtype == np.float32 and got.shape == want.shape == tuple(img.shape)
        assert np.isfinite(got).all() and (got > 0).mean() > 0.3
        assert (np.abs(got - want) > F32_TOL).mean() <= PHASE_FLIPS
        (u, v, valid), (ju, jv, jvalid) = _uv_port(cfg, dyn, mats), _uv_jax(jcfg, jdyn, mats)
        assert np.array_equal(valid, jvalid) and valid.mean() > 0.5
        assert max(np.abs(u - ju)[valid].max(), np.abs(v - jv)[valid].max()) <= UV_TOL_PX
    step = bench.frame_step(primary, y, yl, uv, uvm, salt)
    assert step.dim() == 0
    assert float(step) == float(outs[0].sum() + outs[1].sum() + salt)


def test_run_window_accumulates_frame_steps(primary):
    (_, _, y, yl), (_, _, uv, uvm) = primary
    salts = torch.arange(3, dtype=torch.float32) * 1e-6 + 1e-3
    acc = bench.run_window(primary, y, uv, torch.stack([yl] * 3), torch.stack([uvm] * 3), salts)
    want = torch.zeros(())
    for s in salts:
        want = want + bench.frame_step(primary, y, yl, uv, uvm, s)
    assert acc.dim() == 0 and float(acc) == float(want)


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    """The port's production manager and the JAX manager built the same
    way (bench.py:244-254), and the bench's uint16 planes."""
    tm = bench.production_manager("cpu", SIZE)
    gcsv = tmp_path_factory.mktemp("gcsv") / "bench.gcsv"
    bench.write_gcsv(gcsv)
    jm = JManager()
    jm.init_from_video_data(1000.0, 60.0, 60, SIZE)
    jm.load_gyro_data(str(gcsv))
    jm.params.frame_readout_time = 8.0
    jm.recompute_blocking()
    return tm, jm, bench.production_planes(np.random.default_rng(1), "cpu", SIZE)


@pytest.mark.parametrize("i", [0, 7])
def test_production_frame_matches_jax_manager(production, i):
    tm, jm, (y_dev, uv_dev) = production
    assert tm.device.type == "cpu" and tm.params.frame_readout_time == 8.0
    outs = bench.production_frame(tm, y_dev, uv_dev, i)
    ts_us = int(i * 1e6 / 60.0)
    for out, planes, pi in zip(outs, (y_dev, uv_dev), (0, 1)):
        plane = planes[i % 2].numpy()
        want, _ = jm.process_pixels(ts_us, plane, use_pallas=False, plane_index=pi,
                                    max_pixel_value=1023.0, plane_rects=True)
        want = np.asarray(want).astype(np.int32)
        assert out.dtype == torch.uint16 and tuple(out.shape) == want.shape == plane.shape
        got = out.numpy().astype(np.int32)
        assert got.max() > 0
        assert (np.abs(got - want) > U16_TOL).mean() <= PHASE_FLIPS
        # the JAX manager's frame op by op: the order the port follows
        ft = jm.frame_transform_at(jm._adjusted_ts_ms(ts_us))
        cfg, dyn = jm._plane_cfg_dyn(ft, plane.shape, 8, pi, 1023.0, True, None, None)
        eager = np.asarray(jremap.remap_plane(jnp.asarray(plane.astype(np.float32)),
                                              jnp.asarray(ft.matrices), cfg, dyn))
        eager = np.clip(np.rint(eager), 0, 1023).astype(np.int32)
        assert np.abs(got - eager).max() <= U16_TOL


def test_window_step_matches_jax_window_step():
    """F = 2 frames a plane through the port's window step (a 1-device mesh
    on the CPU) and JAX's make_window_step on a 1-device mesh (Pallas,
    interpret mode), uint16 out."""
    steps = bench.window_steps(np.random.default_rng(0), torch.device("cpu"), SIZE, 2)
    outs = bench.run_windows(steps)
    jmesh = jpp.make_frame_mesh(1, sp=1)
    for (_, placed, dyns), out, pi in zip(steps, outs, (0, 1)):
        imgs, mats, _ = placed[0][torch.device("cpu")]
        H, W = imgs.shape[1:3]
        jcfg, jdyn = _jax_plane(W, H, pi)
        jstep = jpp.make_window_step(jmesh, jcfg, 2, use_pallas=True, out_dtype=jnp.uint16)
        jim, jma, jdy, _ = jpp.place_window(jmesh, imgs.numpy(), mats.numpy(),
                                            jpp.stack_dynamics([jdyn] * 2))
        want, overflow = jstep(jim, jma, jdy)
        assert not bool(np.asarray(overflow).any())
        want = np.asarray(want)
        assert out.dtype == torch.uint16 and tuple(out.shape) == want.shape == tuple(imgs.shape)
        d = np.abs(out.numpy().astype(np.int32) - want.astype(np.int32))
        assert (d > U16_TOL).mean() <= PHASE_FLIPS
        # each frame is the one-frame remap of its own matrices
        for f in range(2):
            cfg, dyn = bench.plane_config(W, H, pi)
            one = tremap.remap_plane_cuda(imgs[f], mats[f], cfg, dyn, out_dtype="uint16")
            assert torch.equal(out[f], one)
        assert int(dyns.fov.shape[0]) == 2


def test_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_module_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "gyroflow_torch.bench"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_render_loop_stub_reaches_no_remap(monkeypatch):
    calls = []
    for name in ("remap_plane", "remap_plane_cuda"):
        fn = getattr(tremap, name)
        monkeypatch.setattr(tremap, name, lambda *a, _fn=fn, **k: calls.append(a) or _fn(*a, **k))
    res = renderer_loop_bench.run("cpu", SIZE, n=10)
    assert not calls
    assert res["launches"] == {"coords": 0, "sampler": 0}
    assert res["frames"] == 10 and res["fps"] > 0
    # 10 frames in 8-frame windows, each window one call a plane group
    assert res["stub_calls"] == {"process_pixels": 0, "process_pixels_window": 4}
    assert res["stats"]["frame_window"] == 8


def test_prod_path_probe_stages():
    res = prod_path_probe.run("cpu", SIZE, n=2)
    assert res["matrix_rows"] == SIZE[1]
    for k in ("frame_transform_ms", "frame_transform_cached_ms", "matrix_upload_ms",
              "frame_issue_ms", "frame_synced_ms", "queued_issue_ms", "queued_drained_ms"):
        assert math.isfinite(res[k]) and res[k] > 0, k
    assert "process_pixels" in res["profile"]
    assert "device_busy_ms" not in res   # the profiler step reads the card only
