"""Benchmark of the port: 4K60 10-bit stabilized frames per second on one card.

The counterpart of the repository's ``bench.py``, on the port's main path:
the self-contained coords kernel (``gf_coords_gen`` in ``csrc/coords.cu``,
fisheye) and the sampler (``csrc/sampler.cu``, lanczos4), through
``remap.remap_plane_cuda``, the manager's ``process_pixels`` and the frame
window. The inputs are drawn
from ``np.random.default_rng(0)`` in ``bench.py``'s order, so both benches
time the same pixels.

Five readings, each on the host clock around work that ends in
``torch.cuda.synchronize()``, the best of REPS reps, planes pre-staged on
the card:

1. primary (``value``): a 4K frame is the float32 Y plane 3840x2160x1 plus
   the UV plane 1920x1080x2, values 0..1023, FIX_COLOR_RANGE, lanczos4,
   opencv_fisheye, per-row RS; F frames queued with no sync between them,
   then one read of their accumulated sum (bench.py's jitted ``lax.scan``),
   CALLS such windows a rep;
2. ``per_frame_dispatch_fps``: the same step, B calls, one read after the
   last;
3. ``secondary_8k_y_*``: an 8192x4320x1 float32 plane, CALLS_8K calls a rep;
4. ``production_path_fps``: ``StabilizationManager.process_pixels`` for Y,
   then UV with ``plane_rects``, on uint16 planes on the card, NB frames a
   rep, each rep with the manager's frame-transform and matrix caches
   cleared (every frame pays its host FrameTransform and matrix upload);
5. ``production_window_fps``: ``parallel.pipeline.make_window_step`` on a
   1-device mesh, FW distinct uint16 frames a plane, WINDOWS windows a rep.
   FW is bench.py's 16 (the renderer's default window is 8), so that both
   benches time the same work.

What bench.py needs only on the TPU is not here: the sampler-window ladder
(``pick_window``), the ``_win_cache`` seeding, the overflow flags and the
``drain`` read. In eager torch every ``remap_plane_cuda`` call uploads its
dynamics with a copy that waits for the stream, so the primary reading's
F frames dispatch as the per-frame reading's do.

    python -m gyroflow_torch.bench      # on cuda:0; prints one JSON line

Phase timestamps go to stderr; stdout is the one JSON line. A reading that
fails ends the run with its error and prints no line; with no card the run
raises before it times anything.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .experiments.perf_probe import make_matrices
from .ops import remap
from .ops.kernel_params import FIX_COLOR_RANGE, KernelConfig, KernelDynamics
from .parallel import pipeline

UHD = (3840, 2160)
EIGHT_K = (8192, 4320)
LENS_K = [0.25, -0.07, 0.02, -0.003]
FOV = 0.92
MAXV = 1023.0
FPS = 60.0
REPS = 3            # timed reps of each reading; the best counts
F = 16              # primary: frames queued before one read
CALLS = 6           # primary: F-frame windows a rep
B = 24              # per-frame dispatch: calls a rep
CALLS_8K = 6        # 8K Y: calls a rep
NB = 16             # production path: frames a rep
FW = 16             # production window: frames a window
WINDOWS = 4         # production window: windows a rep
METRIC = "4K60 10-bit YUV420 stabilized frames/sec/chip (lanczos4, per-row RS, fisheye)"


def _phase(msg):
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.time()


def write_gcsv(path):
    """bench.py's synthetic gyro log: 1200 samples at 1 ms."""
    with open(path, "w") as fh:
        fh.write("GYROFLOW IMU LOG\ntscale,0.001\ngscale,1.0\n"
                 "ascale,1.0\nt,gx,gy,gz\n")
        for i in range(1200):
            fh.write(f"{i},{0.04 * math.sin(i / 30):.6f},"
                     f"{0.02 * math.cos(i / 45):.6f},0.008\n")


def plane_config(W, H, plane_index):
    """(KernelConfig, KernelDynamics) of one W x H plane as bench.py builds
    them: lanczos4, opencv_fisheye with LENS_K, f = 0.62 W, FOV, 10-bit
    values with FIX_COLOR_RANGE."""
    cfg = KernelConfig(width=W, height=H, output_width=W, output_height=H,
                       interpolation=8, distortion_model="opencv_fisheye",
                       plane_index=plane_index, flags=FIX_COLOR_RANGE)
    dyn = KernelDynamics.make(f=(W * 0.62, W * 0.62), c=(W / 2, H / 2), k=LENS_K, fov=FOV,
                              max_pixel_value=MAXV, pixel_value_limit=MAXV,
                              background=(0, 0, 0, 1))
    return cfg, dyn


def _plane_geometry(size):
    """(W, H, plane_index, channels) of the Y and UV planes of a YUV420
    frame of size (W, H)."""
    W, H = size
    return ((W, H, 0, 1), (W // 2, H // 2, 1, 2))


def _matrices(W, H, device):
    return torch.from_numpy(make_matrices(W, H, (W * 0.62, W * 0.62), FOV, H)).to(device)


def primary_planes(rng, device, size):
    """The primary frame's Y and UV planes, each (cfg, dyn, img, mats) on
    device: img float32 uniform 0..1023 drawn from rng (Y, then UV), mats
    one RS matrix row a line."""
    planes = []
    for W, H, plane_index, kchan in _plane_geometry(size):
        cfg, dyn = plane_config(W, H, plane_index)
        img = torch.from_numpy(rng.uniform(0, 1023, (H, W, kchan)).astype(np.float32))
        planes.append((cfg, dyn, img.to(device), _matrices(W, H, device)))
    return planes


def remap_frame(planes, y, yl, uv, uvm, salt):
    """One frame's Y and UV planes through remap_plane_cuda, each input
    plane plus salt (bench.py:114)."""
    (cfg0, dyn0, _, _), (cfg1, dyn1, _, _) = planes
    return (remap.remap_plane_cuda(y + salt, yl, cfg0, dyn0),
            remap.remap_plane_cuda(uv + salt, uvm, cfg1, dyn1))


def frame_step(planes, y, yl, uv, uvm, salt):
    """The sum of both outputs plus the salt: a 0-d tensor on the card, so
    that a step's value depends on all of its work."""
    out_y, out_uv = remap_frame(planes, y, yl, uv, uvm, salt)
    return out_y.sum() + out_uv.sum() + salt


def run_window(planes, y, uv, yls, uvms, salts):
    """len(salts) frame steps queued one after another, their sum
    accumulated on the card (bench.py's scanned window)."""
    acc = torch.zeros((), dtype=torch.float32, device=y.device)
    for i in range(len(salts)):
        acc = acc + frame_step(planes, y, yls[i], uv, uvms[i], salts[i])
    return acc


def eight_k_plane(rng, device, size):
    """The 8K Y plane: (cfg, dyn, img, mats), img drawn from rng."""
    W, H = size
    cfg, dyn = plane_config(W, H, 0)
    img = torch.from_numpy(rng.uniform(0, 1023, (H, W, 1)).astype(np.float32))
    return cfg, dyn, img.to(device), _matrices(W, H, device)


def production_manager(device, size):
    """bench.py's production-path manager on device: a 1 s clip at 60 fps
    of the given size, its gyro log, 8 ms rolling shutter, recomputed."""
    from .core.manager import StabilizationManager

    mgr = StabilizationManager(device=device)
    mgr.init_from_video_data(1000.0, FPS, 60, tuple(size))
    with tempfile.TemporaryDirectory() as d:
        gcsv = os.path.join(d, "bench.gcsv")
        write_gcsv(gcsv)
        mgr.load_gyro_data(gcsv)
    mgr.params.frame_readout_time = 8.0   # per-row RS matrices
    mgr.recompute_blocking()
    return mgr


def production_planes(rng, device, size):
    """Two uint16 Y planes and two UV planes (the second of each the first
    plus 1) on device, drawn from rng: Y, then UV."""
    (W, H, _, _), (w, h, _, c) = _plane_geometry(size)
    y_host = rng.integers(0, 1024, (H, W, 1)).astype(np.uint16)
    uv_host = rng.integers(0, 1024, (h, w, c)).astype(np.uint16)
    return ([torch.from_numpy(a).to(device) for a in (y_host, y_host + 1)],
            [torch.from_numpy(a).to(device) for a in (uv_host, uv_host + 1)])


def production_frame(mgr, y_dev, uv_dev, i):
    """Frame i through process_pixels: Y, then UV with plane_rects."""
    ts_us = int(i * 1e6 / FPS)
    oy, _ = mgr.process_pixels(ts_us, y_dev[i % 2], plane_index=0, max_pixel_value=MAXV,
                               plane_rects=True, defer_overflow=True)
    ouv, _ = mgr.process_pixels(ts_us, uv_dev[i % 2], plane_index=1, max_pixel_value=MAXV,
                                plane_rects=True, defer_overflow=True)
    return oy, ouv


def window_steps(rng, device, size, frames):
    """The production window of each plane on a 1-device mesh of device:
    (step, placed, dyns), the frames uint16 drawn from rng (Y, then UV),
    frame i's matrix rows scaled by 1 + 1e-4 i."""
    mesh = pipeline.make_frame_mesh(1, sp=1, devices=[device])
    steps = []
    for W, H, plane_index, kchan in _plane_geometry(size):
        cfg, dyn = plane_config(W, H, plane_index)
        dyns = pipeline.stack_dynamics([dyn] * frames)
        imgs = rng.integers(0, 1024, (frames, H, W, kchan)).astype(np.uint16)
        mats = np.stack([make_matrices(W, H, (W * 0.62, W * 0.62), FOV, H)] * frames)
        for i in range(frames):
            mats[i, :, :9] *= (1.0 + 1e-4 * i)   # distinct per-frame RS
        steps.append((pipeline.make_window_step(mesh, cfg, frames, out_dtype="uint16"),
                      pipeline.place_window(mesh, imgs, mats), dyns))
    return steps


def run_windows(steps):
    """One window of each plane: [Y out, UV out], (frames, oh, ow, C) uint16."""
    return [step(placed, dyns) for step, placed, dyns in steps]


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi gives them, and the
    card count."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit, "count": torch.cuda.device_count()}


def _best(rep, frames, before=None):
    """Seconds a frame: the best of REPS reps of rep(), each timed on the
    host clock up to a synchronize and a read of what rep() returned."""
    best = math.inf
    for _ in range(REPS):
        if before is not None:
            before()
        t0 = time.perf_counter()
        out = rep()
        torch.cuda.synchronize()
        _finite(out)
        best = min(best, (time.perf_counter() - t0) / frames)
    return best


def _finite(out):
    if isinstance(out, torch.Tensor) and out.dim() == 0 and not math.isfinite(float(out)):
        raise RuntimeError(f"non-finite bench value {float(out)}")


def main() -> dict:
    """Run the five readings on cuda:0 and print the JSON line; returns it
    as a dict."""
    from .core.manager import _cuda_device

    dev = _cuda_device(0)       # no card: the manager's error, nothing timed
    rng = np.random.default_rng(0)
    result = {"metric": METRIC}

    _phase("primary: inputs")
    planes = primary_planes(rng, dev, UHD)
    (_, _, y_img, y_mats), (_, _, uv_img, uv_mats) = planes
    y_mats_f = torch.stack([y_mats] * F)
    uv_mats_f = torch.stack([uv_mats] * F)
    salts_f = [torch.arange(F, dtype=torch.float32, device=dev) * 1e-6 + i * 1e-3
               for i in range(4)]

    def window(i):
        return run_window(planes, y_img, uv_img, y_mats_f, uv_mats_f, salts_f[i % 4])

    _phase("primary: warm-up")
    _finite(window(0))
    _phase("primary: timing loop")
    best = _best(lambda: [window(i) for i in range(CALLS)][-1], CALLS * F)
    result.update(value=1.0 / best, unit="fps", vs_baseline=1.0 / best / 60.0)

    _phase("per-frame dispatch")
    salts = [torch.tensor(i * 1e-6, dtype=torch.float32, device=dev) for i in range(B)]

    def step(i):
        return frame_step(planes, y_img, y_mats, uv_img, uv_mats, salts[i])

    _finite(step(0))
    result["per_frame_dispatch_fps"] = 1.0 / _best(lambda: [step(i) for i in range(B)][-1], B)

    _phase("8k Y")
    cfg8, dyn8, img8, mats8 = eight_k_plane(rng, dev, EIGHT_K)

    def run8():
        return remap.remap_plane_cuda(img8, mats8, cfg8, dyn8).sum()

    _finite(run8())
    best8 = _best(lambda: [run8() for _ in range(CALLS_8K)][-1], CALLS_8K)
    result.update(secondary_8k_y_ms_per_frame=best8 * 1e3, secondary_8k_y_fps=1.0 / best8)
    del img8, mats8

    _phase("production path")
    mgr = production_manager(dev, UHD)
    y_dev, uv_dev = production_planes(rng, dev, UHD)
    production_frame(mgr, y_dev, uv_dev, 0)

    def clear_caches():
        # every rep pays each frame's FrameTransform build and matrix upload
        mgr._stab_cache.clear()
        mgr._mats_dev.clear()

    bestp = _best(lambda: [production_frame(mgr, y_dev, uv_dev, i) for i in range(NB)],
                  NB, before=clear_caches)
    result["production_path_fps"] = 1.0 / bestp
    del mgr, y_dev, uv_dev

    _phase("production window")
    steps = window_steps(rng, dev, UHD, FW)
    run_windows(steps)
    bestw = _best(lambda: [run_windows(steps) for _ in range(WINDOWS)], WINDOWS * FW)
    result["production_window_fps"] = 1.0 / bestw

    result["device"] = card_info()
    bad = {k: v for k, v in result.items()
           if isinstance(v, float) and not (math.isfinite(v) and v > 0)}
    if bad:
        raise RuntimeError(f"bench readings not finite and > 0: {bad}")
    _phase("done")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
