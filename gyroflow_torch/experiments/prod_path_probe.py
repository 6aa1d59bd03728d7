"""Where a production-path frame's time goes, stage by stage, on the host.

The counterpart of ``experiments/prod_path_probe.py``: the production path
of ``gyroflow_torch.bench`` (``bench.production_manager``: a 4K clip, its
gyro log, 8 ms rolling shutter; uint16 Y and UV planes already on the card)
with each stage of ``process_pixels`` timed alone on the host clock,
median over n new timestamps (the manager's caches cleared first):

1. ``frame_transform_at`` (the host FrameTransform build of the per-row RS
   matrices), then the same timestamps again from the manager's cache;
2. the (rows, 14) matrix upload as ``process_pixels`` makes it, a pageable
   ``torch.as_tensor(...).to(device)``;
3. a frame (Y, then UV) issued, then the same frame with a synchronize
   after it; and n frames issued with one synchronize after the last;
4. ``cProfile`` of the issue path over n frames (the top 22 by cumulative
   time go to stdout);
5. on the card, n frames under ``torch.profiler``: the card's busy time a
   frame (its kernels and copies) against the profiled frame's wall, and
   the share of that wall the card idles.

    python -m gyroflow_torch.experiments.prod_path_probe   # on cuda:0

``run(device, size, n)`` returns the readings (ms); on the CPU it runs the
plain path, its times are the CPU's and step 5 is left out.
"""
from __future__ import annotations

import cProfile
import io
import json
import pstats
import statistics
import time

import numpy as np
import torch

from .. import bench


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_ms(fn, timestamps):
    ms = []
    for ts in timestamps:
        t0 = time.perf_counter()
        fn(ts)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def run(device="cuda:0", size=bench.UHD, n=12) -> dict:
    device = torch.device(device)
    mgr = bench.production_manager(device, size)
    y_dev, uv_dev = bench.production_planes(np.random.default_rng(0), device, size)
    bench.production_frame(mgr, y_dev, uv_dev, 0)
    _sync(device)

    def clear():
        mgr._stab_cache.clear()
        mgr._mats_dev.clear()

    def ts_ms(i):
        return i * 1000.0 / bench.FPS

    frames = range(1, n + 1)
    res = {"device": str(device), "size": list(size), "frames": n}
    clear()
    res["frame_transform_ms"] = _median_ms(lambda i: mgr.frame_transform_at(ts_ms(i)), frames)
    res["frame_transform_cached_ms"] = _median_ms(lambda i: mgr.frame_transform_at(ts_ms(i)),
                                                  frames)
    mats = [np.ascontiguousarray(mgr.frame_transform_at(ts_ms(i)).matrices, np.float32)
            for i in frames]
    res["matrix_rows"] = mats[0].shape[0]

    def upload(i):
        torch.as_tensor(mats[i - 1]).to(device)

    res["matrix_upload_ms"] = _median_ms(upload, frames)

    issue, synced = [], []
    clear()
    for i in frames:
        t0 = time.perf_counter()
        bench.production_frame(mgr, y_dev, uv_dev, i)
        t1 = time.perf_counter()
        _sync(device)
        issue.append((t1 - t0) * 1e3)
        synced.append((time.perf_counter() - t0) * 1e3)
    res["frame_issue_ms"] = statistics.median(issue)
    res["frame_synced_ms"] = statistics.median(synced)

    clear()
    t0 = time.perf_counter()
    for i in frames:
        bench.production_frame(mgr, y_dev, uv_dev, i)
    res["queued_issue_ms"] = (time.perf_counter() - t0) * 1e3 / n
    _sync(device)
    res["queued_drained_ms"] = (time.perf_counter() - t0) * 1e3 / n

    clear()
    prof = cProfile.Profile()
    prof.enable()
    for i in frames:
        bench.production_frame(mgr, y_dev, uv_dev, i)
    prof.disable()
    _sync(device)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(22)
    res["profile"] = out.getvalue()

    if device.type == "cuda":
        res.update(_device_busy(lambda i: bench.production_frame(mgr, y_dev, uv_dev, i),
                                frames, clear, device))
    return res


def _device_busy(frame, frames, clear, device) -> dict:
    """The frames under torch.profiler, caches cleared first: the profiled
    wall a frame, the card's busy time a frame (the self device time of
    every device-side event: kernels and copies, one stream, so none
    overlap) and the share of the wall the card idles."""
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):   # the attribute's name before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in frames:
            frame(i)
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3 / len(frames)
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(self_device_us(e) for e in events) / 1e3 / len(frames)
    return {"profiled_frame_ms": wall, "device_busy_ms": busy,
            "device_events_per_frame": sum(e.count for e in events) / len(frames),
            "device_idle_share": 1.0 - busy / wall}


if __name__ == "__main__":
    res = run()
    print(res.pop("profile"))
    print(json.dumps(res))
