"""Per-frame against windowed dispatch of the bench's frame on one card.

The counterpart of ``experiments/window_dispatch_probe.py``: the primary
frame of ``gyroflow_torch.bench`` (``bench.primary_planes``: Y 3840x2160x1
and UV 1920x1080x2 float32, values 0..1023 from default_rng(0), lanczos4,
opencv_fisheye with k = [0.25, -0.07, 0.02, -0.003], fov 0.92, f = 0.62 W,
per-row RS) dispatched two ways, each reading the best of REPS reps on the
host clock up to a read of the last value:

- per-frame: B ``bench.frame_step`` calls;
- windowed: for each F in WINDOWS, max(B // F, 2) calls of an F-frame
  ``bench.run_window``, each window with its own salt; ms a frame and fps.

Beside each reading, on the card, one more rep under ``torch.profiler``
(``prod_path_probe.device_busy``) gives the card's busy time a frame and
the share of the profiled wall it idles: whether the time the readings
take beyond the card's own is the host's dispatch. Every frame step,
warm-ups included, launches the coords and the sampler kernel once a plane.

    python -m gyroflow_torch.experiments.window_dispatch_probe   # on cuda:0

``run(device, size)`` returns the readings; on the CPU the plain path
runs, its times are the CPU's and the profiled rep is left out.
"""
from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from .. import bench
from .prod_path_probe import device_busy

B = 24               # per-frame dispatch: frame steps a rep
WINDOWS = (4, 8)     # frames a window
REPS = 3             # timed reps of each reading; the best counts


def windows(F):
    """Windows a rep at F frames a window."""
    return max(B // F, 2)


def planes(device, size):
    """The bench's primary Y and UV planes, (cfg, dyn, img, mats) each."""
    return bench.primary_planes(np.random.default_rng(0), device, size)


def _reading(rep, frames, device):
    """ms a frame and fps, the best of REPS reps of rep() (which returns its
    steps' values), each timed up to a read of its last value."""
    best = math.inf
    for _ in range(REPS):
        t0 = time.perf_counter()
        last = float(rep()[-1])
        best = min(best, (time.perf_counter() - t0) / frames)
        if not math.isfinite(last):
            raise RuntimeError(f"window_dispatch_probe: non-finite value {last}")
    out = {"ms_per_frame": best * 1e3, "fps": 1.0 / best}
    if device.type == "cuda":
        out.update(device_busy(rep, frames, device))
    return out


def run(device="cuda:0", size=bench.UHD) -> dict:
    """The per-frame reading and one windowed reading per F; each holds the
    value of its warm-up call: one frame step at salt 0, and one window of
    F frame steps at salt 0."""
    device = torch.device(device)
    frame_planes = planes(device, size)
    (_, _, y, yl), (_, _, uv, uvm) = frame_planes
    res = {"device": str(device), "size": list(size)}

    salts = [torch.tensor(i * 1e-6, dtype=torch.float32, device=device) for i in range(B)]

    def step(i):
        return bench.frame_step(frame_planes, y, yl, uv, uvm, salts[i])

    value = float(step(0))
    res["per_frame"] = {**_reading(lambda: [step(i) for i in range(B)], B, device),
                        "value": value}
    for F in WINDOWS:
        nwin = windows(F)
        yls, uvms = torch.stack([yl] * F), torch.stack([uvm] * F)
        wsalts = [torch.full((F,), j * 1e-6, dtype=torch.float32, device=device)
                  for j in range(nwin)]

        def window(j):
            return bench.run_window(frame_planes, y, uv, yls, uvms, wsalts[j])

        value = float(window(0))
        res[f"window_{F}"] = {**_reading(lambda: [window(j) for j in range(nwin)], nwin * F,
                                         device),
                              "window": F, "windows": nwin, "value": value}
    return res


def main() -> dict:
    """The readings on cuda:0 at 4K; prints them and one JSON line."""
    from ..core.manager import _cuda_device

    dev = _cuda_device(0)       # no card: the manager's error, nothing timed
    res = run(dev)
    res["card"] = bench.card_info()
    for key in ("per_frame",) + tuple(f"window_{F}" for F in WINDOWS):
        r = res[key]
        print(f"{key:10s} {r['ms_per_frame']:.3f} ms a frame = {r['fps']:.2f} fps; under "
              f"torch.profiler {r['profiled_frame_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle {100.0 * r['device_idle_share']:.1f}%")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
