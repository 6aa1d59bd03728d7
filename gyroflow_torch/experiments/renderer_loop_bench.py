"""The render loop's host throughput, with the device step stubbed out.

The counterpart of ``experiments/renderer_loop_bench.py``: the real
``render.renderer.render()`` loop (decode-ahead thread, plane grouping,
window dispatch, ungroup, the writer thread) on a 4K 10-bit YUV420 clip,
with the manager's device entries replaced by identity stubs, an in-memory
reader that reuses two frames and a ``Y4MWriter`` to ``/dev/null``. It
reports the loop's frames per second and its ``stats``: the ceiling the
host loop puts on a render.

On one card ``render()`` takes 8-frame windows through
``process_pixels_window``; ``frame_window=1`` takes ``process_pixels``.
Both are stubbed, so nothing reaches the card: the coords and sampler
kernels' launch counters must not move during the loop.

    python -m gyroflow_torch.experiments.renderer_loop_bench   # manager on cuda:0

``run(device, size, n)`` returns the readings; on the CPU the manager's
host work is the same and the loop's time is the CPU's.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from ..bench import UHD
from ..core.manager import StabilizationManager
from ..ops import cuda_coords, cuda_sampler
from ..render import renderer
from ..render.formats import RAW_FORMATS
from ..render.y4m_io import Y4MWriter

N, FPS = 96, 60.0


class MemReader:
    """Planar in-memory reader: yields (ts_us, [Y, U, V]) uint16 planes,
    alternating two frames drawn once."""

    def __init__(self, fmt, size, n, fps=FPS):
        self.fmt = fmt
        self.width, self.height = size
        self.fps = fps
        self.frame_count = n
        rng = np.random.default_rng(0)
        self.frames = [[rng.integers(0, 1024, (h, w, 1), dtype=np.uint16)
                        for (h, w, _c) in fmt.plane_shapes(*size)]
                       for _ in range(2)]
        self.i = 0

    def seek_frame(self, idx):
        self.i = idx

    def __iter__(self):
        while self.i < self.frame_count:
            yield int(self.i / self.fps * 1e6), self.frames[self.i % 2]
            self.i += 1

    def close(self):
        pass


def write_gcsv(path, n, fps=FPS):
    """The original's synthetic gyro log: the clip's length plus 200 ms."""
    with open(path, "w") as fh:
        fh.write("GYROFLOW IMU LOG\ntscale,0.001\ngscale,1.0\nascale,1.0\n"
                 "t,gx,gy,gz\n")
        for i in range(int(n / fps * 1000) + 200):
            fh.write(f"{i},{0.02 * np.sin(i / 40):.5f},"
                     f"{0.01 * np.cos(i / 55):.5f},0.003\n")


def run(device="cuda:0", size=UHD, n=N) -> dict:
    fmt = RAW_FORMATS["yuv420p10le"]
    mgr = StabilizationManager(device=device)
    mgr.init_from_video_data(n / FPS * 1000.0, FPS, n, tuple(size))
    with tempfile.TemporaryDirectory() as d:
        gcsv = os.path.join(d, "loop.gcsv")
        write_gcsv(gcsv, n)
        mgr.load_gyro_data(gcsv)
    mgr.recompute_blocking()

    calls = {"process_pixels": 0, "process_pixels_window": 0}

    def fake_process_pixels(ts_us, plane, **kw):
        calls["process_pixels"] += 1
        return plane, {"fov": 1.0, "backend": "stub"}

    def fake_process_pixels_window(timestamps_us, frames, device_mesh=None, **kw):
        calls["process_pixels_window"] += 1
        return frames, {"fov": 1.0, "backend": "stub"}

    mgr.process_pixels = fake_process_pixels
    mgr.process_pixels_window = fake_process_pixels_window
    reader = MemReader(fmt, size, n)

    def fake_open_reader(path):
        return "planar", reader

    def fake_open_writer(path, ow, oh, fps, options, rdr, kind, input_path, **kw):
        return "planar", Y4MWriter(os.devnull, ow, oh, fps, "yuv420p10le")

    saved = renderer.open_reader, renderer.open_writer
    renderer.open_reader, renderer.open_writer = fake_open_reader, fake_open_writer
    before = cuda_coords.project.launches, cuda_sampler.sample.launches
    try:
        opts = renderer.RenderOptions(audio=False, async_encode=True, decode_ahead=4,
                                      pipeline_depth=2)
        t0 = time.perf_counter()
        stats = renderer.render(mgr, "mem://synthetic.y4m", os.devnull, opts)
        dt = time.perf_counter() - t0
    finally:
        renderer.open_reader, renderer.open_writer = saved
    launches = {"coords": cuda_coords.project.launches - before[0],
                "sampler": cuda_sampler.sample.launches - before[1]}
    if any(launches.values()):
        raise RuntimeError(f"the stubbed render loop launched kernels: {launches}")
    if stats["frames"] != n:
        raise RuntimeError(f"the loop rendered {stats['frames']} of {n} frames")
    return {"device": str(mgr.device), "size": list(size), "frames": stats["frames"],
            "fps": stats["frames"] / dt, "ms_per_frame": dt / stats["frames"] * 1e3,
            "stub_calls": calls, "launches": launches,
            "stats": {k: v for k, v in stats.items() if k != "output"}}


if __name__ == "__main__":
    res = run()
    print(f"render loop (device stubbed, {res['size'][0]}x{res['size'][1]} 10-bit YUV420, "
          f"{res['frames']} frames on {res['device']}): {res['fps']:.1f} fps "
          f"({res['ms_per_frame']:.1f} ms/frame)")
    print(json.dumps(res))
