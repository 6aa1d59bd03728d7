"""The readers of the program's own spans and counter, on the CPU at a small
size: a preview stretch profiled with the CPU activity gives each a number, a
run with no profiled stretch (no card) None, and so does a program without
the tracer."""
import json
import sys
import time

import numpy as np
import pytest
import torch

from portbench import deploy, harness, trace
from portbench.loops import PreviewLoop, Sample

SEED = 2 ** 31 + 11
READERS = ["upload_ms.preview", "eager_host_ms.preview", "dispatch_self_ms.preview",
           "host_syncs_per_frame.preview", "ft_rows_ms.preview"]
# host syncs a frame: both planes' uploads and dynamics, the matrices (and
# the Sony mesh buffer) once
SYNCS = {"gopro4k-preview": 5, "sony4k-preview": 6}


def profiled_preview(small, name, tmp_path, frames=2):
    """A TraceData whose device part is a CPU-profiled stretch of `frames`
    preview frames (no device events: only the host's)."""
    from torch.profiler import ProfilerActivity, profile
    cell, cfg, traffic, _ = small(name)
    mgr = deploy.program_manager(cfg, deploy.write_telemetry(tmp_path, cfg, SEED), "cpu")
    from gyroflow_torch.ops.pixel_formats import rgb_to_yuv
    yuva = rgb_to_yuv(np.asarray(mgr.params.background, np.float32), True)
    dep = harness.Deployment(cfg, mgr, deploy.frame_pool(cfg, SEED, 4, "cpu"),
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
    return trace.TraceData(spans={}, frames=frames,
                           device=trace.reduce_events(events, frames, wall), work={})


@pytest.mark.parametrize("name", list(SYNCS))
def test_readers_read_a_profiled_stretch(small, tmp_path, name):
    data = profiled_preview(small, name, tmp_path)
    values = {m: harness.load_reader(m)(data) for m in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["host_syncs_per_frame.preview"] == SYNCS[name]
    # the dispatch's self time and its children's lie inside the span
    from gyroflow_torch import trace as program_trace
    pp = program_trace.totals()["gf.process_pixels"]
    assert pp.count == 2 * data.frames and 0 <= pp.self_seconds <= pp.seconds
    assert values["dispatch_self_ms.preview"] == pytest.approx(pp.self_seconds * 1e3 / 2)

    no_card = trace.TraceData(spans={}, frames=data.frames, device=None, work={})
    assert all(harness.load_reader(m)(no_card) is None for m in READERS)


def test_readers_without_the_program_tracer(monkeypatch):
    d = trace.DeviceTrace(frames=2, window_s=1.0, busy_s=0.5, ops={"kernel": {}, "copy": {}})
    data = trace.TraceData(spans={}, frames=2, device=d, work={})
    monkeypatch.setitem(sys.modules, "gyroflow_torch.trace", None)
    assert all(harness.load_reader(m)(data) is None for m in READERS)
