"""A render's host stages on a 10-bit YUV420 y4m, the device step mocked.

The counterpart of ``experiments/host_pipeline_bench.py``: a y4m of n
frames (4K 10-bit YUV420 by default, 24.9 MB a frame) written with
``render.y4m_io.Y4MWriter`` to ``/dev/shm`` where it exists, then read back
through five loops, each adding one stage to the one before, with the
renderer's own ``_plane_groups``, ``_ungroup_planes`` and ``_AsyncWriter``:

a. decode only;
b. decode, plane-group and ungroup around an identity mock;
c. (b) and a serial encode to a second y4m;
d. (b) and the renderer's encode thread (``_AsyncWriter``);
e. (d) with the mock an identity on ``device``: each plane group goes up as
   a render's window sends it (stacked on the host as ``render()`` stacks a
   window's frames, then ``torch.as_tensor(...).to(device)``) and comes
   back as ``render()`` takes a frame of the window's output
   (``.cpu().numpy()``). The host stack, the upload and the download are
   timed apart, each copy up to a ``torch.cuda.synchronize()``. No kernel
   runs.

Each stage reports ``steady_fps``, the inverse of the median of its first
16 per-frame times (the reference's reading), and ``mean_fps`` over all n
frames beside it. Stage (e) also reports its host stack, upload and
download in ms a frame (the median of the first 16 and the mean of all n),
and the two copies in GB/s. Stages (c)-(e) hash the y4m they wrote
against the input's hash (``output_equals_input``) and delete it before
the next stage.

    python -m gyroflow_torch.experiments.host_pipeline_bench   # on cuda:0

``run(device, size, n)`` returns the readings; on the CPU stage (e)'s
copies stay on the host and its times are the CPU's.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from .. import bench
from ..render.formats import RAW_FORMATS
from ..render.renderer import _AsyncWriter, _plane_groups, _ungroup_planes
from ..render.y4m_io import Y4MReader, Y4MWriter

N = 48
STEADY = 16          # frames whose median time gives the steady reading
FPS = 60.0
PIX_FMT = "yuv420p10le"


def fixture_planes(size):
    """One frame's Y, U and V uint16 planes, drawn from default_rng(0) in
    the reference's order: Y in 64..940, U and V in 64..960."""
    W, H = size
    rng = np.random.default_rng(0)
    y = rng.integers(64, 940, (H, W, 1)).astype(np.uint16)
    u = rng.integers(64, 960, (H // 2, W // 2, 1)).astype(np.uint16)
    v = rng.integers(64, 960, (H // 2, W // 2, 1)).astype(np.uint16)
    return [y, u, v]


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _workdir(root, need):
    """A new directory under root (/dev/shm where it exists), which must
    have need bytes free."""
    if root is None:
        root = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    if free < need:
        raise RuntimeError(f"host_pipeline_bench: {root} has {free / 1e9:.2f} GB free; the "
                           f"input y4m and one output need {need / 1e9:.2f} GB")
    return tempfile.mkdtemp(dir=root, prefix="host_pipeline_")


def _steady_and_mean(seconds):
    return statistics.median(seconds[:STEADY]), statistics.fmean(seconds)


class _DeviceIdentity:
    """The mock of stage (e): a frame's plane groups stacked on the host, up
    to device and back; the seconds of each step a frame, each copy timed
    to a synchronize."""

    def __init__(self, device):
        self.device = device
        self.seconds = {"stack": [], "upload": [], "download": []}

    def __call__(self, groups):
        t0 = time.perf_counter()
        stacked = [torch.as_tensor(np.stack([g])) for g in groups]
        t1 = time.perf_counter()
        on_dev = [x.to(self.device) for x in stacked]
        _sync(self.device)
        t2 = time.perf_counter()
        outs = [x[0].cpu().numpy() for x in on_dev]
        _sync(self.device)
        for key, dt in zip(self.seconds, (t1 - t0, t2 - t1, time.perf_counter() - t2)):
            self.seconds[key].append(dt)
        return outs


def _stage(src, fmt, mock=None, writer=None):
    """One pass over src: decode, and with a mock the plane groups through
    it and back, and with a writer the encode. Returns the stage's readings;
    the writer is closed (its thread joined) before it returns."""
    marks = []
    t0 = time.perf_counter()
    reader = Y4MReader(src)
    try:
        for _ts, planes in reader:
            if mock is not None:
                outs = mock([g for g, _pi in _plane_groups(fmt, planes)])
                planes = _ungroup_planes(fmt, outs, src_max=fmt.max_value)
                if writer is not None:
                    writer.write_planes(planes)
            marks.append(time.perf_counter())
    finally:
        reader.close()
        if writer is not None:
            writer.close()
    steady, mean = _steady_and_mean(np.diff([t0] + marks).tolist())
    return {"steady_fps": 1.0 / steady, "mean_fps": 1.0 / mean, "frames": len(marks)}


def run(device="cuda:0", size=bench.UHD, n=N, workdir=None) -> dict:
    """Stages (a)-(e) on an n-frame y4m of size (W, H), in a new directory
    under workdir (default /dev/shm where it exists), deleted at the end."""
    device = torch.device(device)
    W, H = size
    fmt = RAW_FORMATS[PIX_FMT]
    frame_bytes = fmt.frame_bytes(W, H)
    tmp = _workdir(workdir, 2 * n * (frame_bytes + 6) + (1 << 20))
    res = {"device": str(device), "size": list(size), "frames": n, "frame_bytes": frame_bytes,
           "workdir": os.path.dirname(tmp), "cores": os.cpu_count(), "stages": {}}
    try:
        src = os.path.join(tmp, "in.y4m")
        planes = fixture_planes(size)
        t0 = time.perf_counter()
        w = Y4MWriter(src, W, H, FPS, PIX_FMT)
        for _ in range(n):
            w.write_planes(planes)
        w.close()
        res["fixture_write_fps"] = n / (time.perf_counter() - t0)
        res["input_sha256"] = sha256(src)

        def identity(groups):
            return groups

        def writing(name, mock, writer_of):
            dst = os.path.join(tmp, f"{name}.y4m")
            out = _stage(src, fmt, mock, writer_of(Y4MWriter(dst, W, H, FPS, PIX_FMT)))
            out["output_equals_input"] = sha256(dst) == res["input_sha256"]
            os.remove(dst)
            return out

        stages = res["stages"]
        stages["decode"] = _stage(src, fmt)
        stages["convert"] = _stage(src, fmt, identity)
        stages["encode"] = writing("encode", identity, lambda w: w)
        stages["async_encode"] = writing("async_encode", identity, _AsyncWriter)
        mock = _DeviceIdentity(device)
        e = stages["device_round_trip"] = writing("device_round_trip", mock, _AsyncWriter)
        for key, seconds in mock.seconds.items():
            steady, mean = _steady_and_mean(seconds)
            e[f"{key}_ms"] = {"steady": steady * 1e3, "mean": mean * 1e3}
        for key in ("upload", "download"):
            e[f"{key}_gb_s"] = frame_bytes / e[f"{key}_ms"]["steady"] / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def main() -> dict:
    """The five stages on cuda:0 at 4K; prints them and one JSON line."""
    from ..core.manager import _cuda_device

    dev = _cuda_device(0)       # no card: the manager's error, nothing timed
    res = run(dev)
    res["card"] = bench.card_info()
    print(f"{res['frames']} frames of {res['size'][0]}x{res['size'][1]} 10-bit YUV420 "
          f"({res['frame_bytes'] / 1e6:.1f} MB a frame) in {res['workdir']}; "
          f"{res['cores']} cores; {res['card']['name']}, {res['card']['power_limit']}")
    for name, s in res["stages"].items():
        print(f"  {name:18s} {s['steady_fps']:7.1f} fps steady, {s['mean_fps']:7.1f} fps mean")
    e = res["stages"]["device_round_trip"]
    print(f"  host stack {e['stack_ms']['steady']:.3f} ms a frame, upload "
          f"{e['upload_ms']['steady']:.3f} ms ({e['upload_gb_s']:.2f} GB/s), download "
          f"{e['download_ms']['steady']:.3f} ms ({e['download_gb_s']:.2f} GB/s)")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
