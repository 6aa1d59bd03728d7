"""The benchmark's EWA cell, gopro4k-ewa-preview, on the CPU at 160x96 and a
2 s clip (the size of ``portbench/tests``' ``small`` fixture):

- the cell's runs read ``correct`` against the plain reference, on the
  manager's CPU route and with the manager routed through
  ``remap_plane_cuda`` (whose kernel wrappers run their plain versions on
  CPU tensors); three planted faults (Mitchell coefficients for Robidoux,
  the Jacobian's step, UV through lanczos4) read ``correct`` false, and so
  does the EWA control (``portbench/ewa_control.py``, bfloat16);
- a traced stretch (``torch.profiler``, CPU activity) through
  ``remap_plane_cuda``: ``gf.ewa.stack`` and ``gf.ewa.sample`` are recorded
  on EWA planes only, and ``gf.coords.points`` reads 1x, 2x and 3x the
  frame's points on the GoPro, Sony and EWA routes, as the new readers do
  (and ``gf.ft.native_rows`` a frame's rows, where the native library
  builds);
- ``portbench/ewa_work.py`` against a hand count, and the EWA roofline
  reader's arithmetic;
- every new reader reads None from a program whose tracer has no named
  counters; ``--list`` lists the cell.
"""
import copy
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gyroflow_torch import native
from portbench import deploy, ewa_control, ewa_readers, ewa_work, harness, roofline, trace
from portbench.loops import PreviewLoop, Sample

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CELL = "gopro4k-ewa-preview"
PREVIEW_CELLS = ["gopro4k-preview", "sony4k-preview", CELL]
NEW_READERS = ["ewa_roofline_pct.preview", "ewa_stack_ms.preview", "ewa_sample_ms.preview",
               "coords_points_per_frame.preview"]
W, H = 160, 96
SEED = 2 ** 31 + 1234


def small(name, width=W, height=H, clip_seconds=2):
    """(cfg, traffic, metrics) of a cell with its clip cut to width x height
    and clip_seconds, for runs on the CPU."""
    bench = harness.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    cfg = copy.deepcopy(deploy.load_config(cell["config"], bench))
    cfg.update(width=width, height=height, clip_seconds=clip_seconds)
    traffic = harness.load_traffic(cell["traffic"])
    metrics = {s: harness.cell_metrics(bench, name, s) for s in ("end_to_end", "per_layer")}
    return cfg, traffic, metrics


def run(name=CELL, seed=SEED, control=False):
    cfg, traffic, metrics = small(name)
    return harness.run_cell(cfg, traffic, metrics, seed, 0.3, False, "cpu",
                            harness.process_start(), control=control)


def kernel_route(monkeypatch):
    """The manager's planes through remap_plane_cuda, as on a card."""
    from gyroflow_torch.ops import remap
    monkeypatch.setattr(remap, "remap_plane", remap.remap_plane_cuda)


def test_cell_in_the_benchmark():
    bench = harness.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "gopro-hero10-4k60-fisheye-ewa", "preview-closed1-ewa11", 1)
    # the EWA deployment is the GoPro clip, lens, telemetry and limits, nothing cut
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs[cell["config"]]["reduced"] == []
    ewa = deploy.load_config(cell["config"], bench)
    gopro = deploy.load_config("gopro-hero10-4k60-fisheye", bench)
    described = {"name", "source", "deployment", "resampler", "assumed"}
    assert {k: v for k, v in ewa.items() if k not in described} == \
        {k: v for k, v in gopro.items() if k not in described}
    assert set(ewa) - set(gopro) == {"resampler"} and "Robidoux" in ewa["source"]
    traffic = harness.load_traffic(cell["traffic"])
    lanczos = harness.load_traffic("preview-closed1")
    assert set(traffic) == set(lanczos) and traffic["interpolation"] == 11
    assert {k: v for k, v in traffic.items() if k not in ("interpolation", "why")} == \
        {k: v for k, v in lanczos.items() if k not in ("interpolation", "why")}
    reported = {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")}
    assert set(NEW_READERS) <= reported
    assert not reported & {"remap_roofline_pct.preview", "sampler_roofline_pct.preview"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")} == {
        "preview_ms_p95", "device_peak_mib", "setup_s"}


def test_cell_runs_correct(monkeypatch):
    """Through remap_plane_cuda (the manager's CPU route is run by the
    control's test)."""
    kernel_route(monkeypatch)
    res = run()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["check"]["max_code_diff"]["value"] == 0
    assert res["check"]["mismatch_ppm"]["value"] == 0.0
    assert set(res["metrics"]) == {"preview_ms_p95", "device_peak_mib", "setup_s"}


def _mitchell(monkeypatch):
    """Mitchell's coefficients (interpolation 12) where Robidoux (11) is asked for."""
    from gyroflow_torch.ops import remap
    orig = remap.ewa_coeffs
    monkeypatch.setattr(remap, "ewa_coeffs", lambda i: orig(12 if i == 11 else i))


def _jacobian_step(monkeypatch):
    """The Jacobian's differences divided by half the step the +eps evals sit at."""
    from gyroflow_torch.ops import remap
    orig = remap.ewa_jacobian

    def halved_step(u3, v3, valid3):
        u, v, valid, jac = orig(u3, v3, valid3)
        return u, v, valid, jac * 2.0
    monkeypatch.setattr(remap, "ewa_jacobian", halved_step)


def _uv_lanczos4(monkeypatch):
    """UV sampled with lanczos4, Y with EWA."""
    from gyroflow_torch.core.manager import StabilizationManager
    orig = StabilizationManager.process_pixels

    def uv_lanczos4(self, *a, **kw):
        if kw.get("plane_index") == 1:
            kw["interpolation"] = 8
        return orig(self, *a, **kw)
    monkeypatch.setattr(StabilizationManager, "process_pixels", uv_lanczos4)


@pytest.mark.parametrize("fault", [_mitchell, _jacobian_step, _uv_lanczos4],
                         ids=["mitchell", "jacobian_step", "uv_lanczos4"])
def test_planted_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res = run()
    assert res["correct"] is False and res["failed"] > 0


def test_ewa_control_fails_where_the_program_passes():
    with ewa_control.installed():
        res = run(seed=SEED + 7, control=True)
    assert res["correct"] is True
    assert res["control"]["correct"] is False
    assert res["control"]["failed"] == res["control"]["frames"] > 0
    limits = small(CELL)[0]["check_limits"]
    worst = res["control"]["numbers"]
    assert worst["max_code_diff"]["value"] > limits["max_code_diff"]
    assert worst["mismatch_ppm"]["value"] > limits["mismatch_ppm"]
    from portbench.reference import stabilizer
    assert stabilizer.remap_plane_bf16.__name__ == "remap_plane_bf16"


def traced_preview(name, tmp_path, frames=2):
    """A TraceData whose device part is a CPU-profiled stretch of `frames`
    preview frames of the cell (no device events: only the host's)."""
    from torch.profiler import ProfilerActivity, profile

    from gyroflow_torch.ops.pixel_formats import rgb_to_yuv
    cfg, traffic, _ = small(name)
    if cfg["telemetry"]["kind"] == "sony":
        cfg["telemetry"]["mesh_grid"] = 5   # the host's inverse-mesh fit takes ~20 s at 9x9
    mgr = deploy.program_manager(cfg, deploy.write_telemetry(tmp_path, cfg, SEED), "cpu")
    yuva = rgb_to_yuv(np.asarray(mgr.params.background, np.float32), True)
    dep = harness.Deployment(cfg, mgr, deploy.frame_pool(cfg, SEED, 2, "cpu"),
                             [yuva[..., :1], yuva[..., 1:3]], float((1 << cfg["bit_depth"]) - 1),
                             torch.device("cpu"))
    loop = PreviewLoop(dep, traffic, trace.Spans(on=False), Sample(1, SEED))
    loop.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            loop.step()
        wall = time.perf_counter() - t0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    device = trace.reduce_events(events, frames, wall)
    return trace.TraceData(spans={}, frames=frames, device=device, work=roofline.frame_work(cfg))


# projections of a frame's points: the gen launch (GoPro), the mesh frame's
# probe and projection (Sony), the three stacked evals (EWA)
POINTS = {"gopro4k-preview": 1, "sony4k-preview": 2, CELL: 3}


@pytest.mark.parametrize("name", PREVIEW_CELLS)
def test_traced_route_spans_and_coords_points(monkeypatch, tmp_path, name):
    from gyroflow_torch import trace as program_trace
    kernel_route(monkeypatch)
    data = traced_preview(name, tmp_path)
    totals = program_trace.totals()
    frame_points = W * H + (W // 2) * (H // 2)
    counts = {"gf.coords.points": POINTS[name] * frame_points * data.frames}
    if name == CELL:    # each plane's stacked evals on the gen kernel's EWA form
        counts["gf.coords.gen_ewa_planes"] = 2 * data.frames
    launches = dict(counts)     # the coords launches' counts alone
    if native.available():      # each frame's table, built by the native pass
        counts["gf.ft.native_rows"] = H * data.frames
    assert program_trace.counts() == counts
    values = {m: harness.load_reader(m)(data) for m in NEW_READERS}
    assert values["coords_points_per_frame.preview"] == pytest.approx(
        POINTS[name] * frame_points / 1e6)
    # no device events on the CPU: no EWA kernel time, no share
    assert values["ewa_roofline_pct.preview"] is None
    if name == CELL:
        for span in ("gf.ewa.stack", "gf.ewa.sample"):
            assert totals[span].count == 2 * data.frames       # Y and UV
        assert values["ewa_stack_ms.preview"] > 0 and values["ewa_sample_ms.preview"] > 0
        recs = {r.id: r for r in program_trace.records()}
        for r in recs.values():
            if r.name == "gf.ewa.stack":
                assert recs[r.parent].name == "gf.eager" and recs[r.parent].note == "gen"
            if r.name == "gf.ewa.sample":
                assert recs[r.parent].name == "gf.process_pixels"
        # the stacked launch's counts sit on the span open around it
        assert totals["gf.ewa.stack"].counts == launches
    else:
        assert not {"gf.ewa.stack", "gf.ewa.sample"} & set(totals)
        assert values["ewa_stack_ms.preview"] is None and values["ewa_sample_ms.preview"] is None


def test_ewa_work_hand_count():
    # 8x4 YUV420: Y 32 pixels of 1 channel, UV 8 of 2
    setup = 8 + 6 + 14 + 92             # Jacobian, guards, bbox, ellipse
    taps = 5 * 4 + 25 * 7               # 5 rows of 5 taps at their distance test
    assert ewa_work.pixel_ops(1) == setup + 3 + taps == 318
    assert ewa_work.pixel_ops(2) == setup + 5 + taps == 320
    assert ewa_work.frame_work(8, 4) == (32 * 2 * 2 + 8 * 2 * 2 * 2, 32 * 318 + 8 * 320)
    assert ewa_work.bound_s(8, 4) == max(192 / roofline.PEAK_BYTES_S,
                                         12736 / roofline.PEAK_FP32_S)
    for name in ("gopro-hero10-4k60-fisheye", "gopro-hero10-4k60-fisheye-ewa",
                 "sony-a7iv-4k60-mesh"):
        cfg = deploy.load_config(name, harness.load_benchmark())
        assert ewa_work.frame_size(roofline.frame_work(cfg)) == (cfg["width"], cfg["height"])
    assert ewa_work.frame_size(roofline.frame_work(dict(cfg, width=160, height=96))) == (160, 96)
    assert ewa_work.frame_size({}) is None
    assert ewa_work.frame_size({"remap": (100, 0), "sampler": (100, 0)}) is None


def _device(frames, kernels):
    return trace.DeviceTrace(frames=frames, window_s=1.0, busy_s=0.5,
                             ops={"kernel": kernels, "copy": {}})


def test_ewa_roofline_reader():
    cfg = deploy.load_config("gopro-hero10-4k60-fisheye-ewa", harness.load_benchmark())
    bound = ewa_work.bound_s(3840, 2160)
    kernels = {"void (anonymous namespace)::ewa_kernel<unsigned short, 1>(...)": (2, 0.8e-3),
               "void (anonymous namespace)::ewa_kernel<unsigned short, 2>(...)": (2, 0.2e-3),
               "void (anonymous namespace)::coords_kernel<0, false>(...)": (2, 0.6e-3)}
    data = trace.TraceData(spans={}, frames=2, device=_device(2, kernels),
                           work=roofline.frame_work(cfg))
    read = harness.load_reader("ewa_roofline_pct.preview")
    assert read(data) == pytest.approx(100.0 * bound / 0.5e-3)
    lanczos = {"void (anonymous namespace)::sampler_kernel<1>(...)": (2, 0.4e-3)}
    assert read(trace.TraceData(spans={}, frames=2, device=_device(2, lanczos),
                                work=roofline.frame_work(cfg))) is None
    assert read(trace.TraceData(spans={}, frames=2, device=None, work={})) is None


def test_new_readers_without_named_counters(monkeypatch):
    """A program whose tracer has spans and the host-sync counter but no
    counts() (the tracer before named counters), and one without a tracer."""
    cfg = deploy.load_config("gopro-hero10-4k60-fisheye-ewa", harness.load_benchmark())
    kernels = {"void (anonymous namespace)::ewa_kernel<unsigned short, 1>(...)": (2, 0.8e-3)}
    data = trace.TraceData(spans={}, frames=2, device=_device(2, kernels),
                           work=roofline.frame_work(cfg))
    Total = types.SimpleNamespace
    old = types.ModuleType("gyroflow_torch.trace")
    old.totals = lambda: {n: Total(count=4, seconds=1e-3, self_seconds=1e-3, syncs=0)
                          for n in ("gf.ewa.stack", "gf.ewa.sample", "gf.eager")}
    old.syncs = lambda: 10
    monkeypatch.setitem(sys.modules, "gyroflow_torch.trace", old)
    assert ewa_readers.tracer() is None
    assert {m: harness.load_reader(m)(data) for m in NEW_READERS} == dict.fromkeys(NEW_READERS)
    monkeypatch.setitem(sys.modules, "gyroflow_torch.trace", None)
    assert {m: harness.load_reader(m)(data) for m in NEW_READERS} == dict.fromkeys(NEW_READERS)


def test_list_lists_the_cell():
    p = subprocess.run([sys.executable, "-m", "portbench", "--list"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    listed = json.loads(p.stdout.strip().splitlines()[-1])
    assert CELL in listed["workloads"]
    assert "preview-closed1-ewa11" in listed["traffic"]
    assert "gopro-hero10-4k60-fisheye-ewa" in listed["configs"]
    assert set(NEW_READERS) <= set(listed["metrics"])
