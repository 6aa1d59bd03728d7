#!/usr/bin/env python3
"""Drive gyroflow_torch's main render path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its numbers; any failed check raises, and the script
exits non-zero without the final line):

1. device: name, and power limit from nvidia-smi;
2. build the CUDA kernels of gyroflow_torch/csrc with nvcc;
3. each kernel against its plain torch version on the card, at the shapes
   of a 4K 10-bit YUV420 render (Y 3840x2160x1, UV 1920x1080x2 uint16), with
   the frame transform of a real StabilizationManager;
3b. EWA (interpolation 11): the stacked coords launch of the base and both
   finite-difference evals (3*oh rows) and the EWA kernel, each against its
   plain version at the same shapes;
4. the main path: StabilizationManager on cuda:0, 3840x2160 at 30 fps, a
   seeded synthetic .gcsv, a fisheye lens, 8 ms rolling shutter; 3 frames of
   Y and UV through process_pixels (lanczos4, uint16 in and out), held within
   1 code of the plain torch path; the kernels' launch counters must show the
   path went through them;
4b. the EWA path: the same 3 frames with interpolation 11, held within 1
   code of the plain torch path, one coords and one EWA launch per plane;
5. times: each kernel and its plain version (CUDA events, median of 10) and
   ms per frame (Y+UV) through process_pixels, kernel path vs plain path;
5b. the same for EWA (the plain EWA runs 100 eager taps per pixel: 3 reps);
6. where one EWA frame's device time goes (torch.profiler, by kernel).

Second-to-last lines: the card's name and power limit, then one JSON object
with the kernels; last line: {"ok": true, "device": {...}}. Needs one card and
nvcc; a copy of the kernel library is built under gyroflow_torch/build/.
About 40 s on an H100, the kernels' build (one nvcc per source, run
together, ~8 s) included.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

W, H = 3840, 2160
FPS = 30.0
FRAMES = 3
MAXV = 1023.0
COORDS_TOL_PX = 0.05        # |du|, |dv| over valid pixels
SAMPLER_TOL = 0.01          # 10-bit codes, same u/v into both
FRAME_TOL_CODES = 1         # uint16 output, kernel path vs plain path
EWA_INTERP = 11             # Robidoux


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def write_gcsv(path, seed=0):
    """A seeded gyro log: slow sinusoidal shake plus noise, 1 kHz for 1 s."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lines = ["GYROFLOW IMU LOG", "version,1.3", "id,chip_smoke", "orientation,xyz",
             "tscale,0.001", "gscale,1.0", "ascale,1.0", "t,gx,gy,gz,ax,ay,az"]
    for i in range(1000):
        gx = 0.4 * math.sin(i / 30.0) + rng.normal(0, 0.05)
        gy = 0.2 * math.cos(i / 45.0) + rng.normal(0, 0.05)
        gz = 0.08 + rng.normal(0, 0.03)
        lines.append(f"{i},{gx:.6f},{gy:.6f},{gz:.6f},0,0,1")
    Path(path).write_text("\n".join(lines))


def smooth_plane(rng, h, w, c):
    """sin*cos content plus a little noise (experiments/tpu_parity.py:43-47),
    as uint16 10-bit codes."""
    import numpy as np
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (np.sin(xx * 0.013) * np.cos(yy * 0.011) * 0.5 + 0.5) * (MAXV - 2)
    img = base[..., None] + rng.uniform(0, 2.0, (h, w, c)).astype(np.float32)
    return np.rint(img).astype(np.uint16)


# mangled names of the kernels the driven paths launch (uint16, C=1/2)
MAIN_PATH_KERNELS = {"coords": "coords_kernel", "sampler<u16,C1,8>": "sampler_kernelItLi1ELi8E",
                     "sampler<u16,C2,8>": "sampler_kernelItLi2ELi8E",
                     "ewa<u16,C1>": "ewa_kernelItLi1EE", "ewa<u16,C2>": "ewa_kernelItLi2EE"}


def ptxas_summary(log):
    """Registers and spills of the main path's kernels from nvcc -Xptxas -v."""
    out, current = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = next((k for k, m in MAIN_PATH_KERNELS.items() if m in ln), None)
        elif current and ("spill" in ln or "registers" in ln):
            out[current] = (out.get(current, "") + " " + ln.split(":")[-1].strip()).strip()
    return out


def cuda_ms(fn, reps=10, warm=2):
    """Median device time of fn in ms (CUDA events around each call)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "gyroflow_torch" / "csrc").is_dir():
        print(f"chip_smoke: gyroflow_torch/csrc not found next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np

    from gyroflow_torch import _build
    from gyroflow_torch.core.lens_profile import CameraParams, Dimensions, LensProfile
    from gyroflow_torch.core.manager import StabilizationManager
    from gyroflow_torch.ops import cuda_coords, cuda_ewa, cuda_sampler, remap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {}

    # ---- 1. device ---------------------------------------------------------
    phase("device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; "
          f"count {torch.cuda.device_count()}")
    print(f"card: {smi}")
    report["card"] = smi

    # ---- 2. build ----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    secs = time.perf_counter() - t0
    print(f"nvcc {' '.join(_build.NVCC_FLAGS)}")
    print(f"built {path.name} in {secs:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s)")
    for name, info in ptxas_summary(_build.build_log).items():
        print(f"  ptxas {name}: {info}")
    report["build_s"] = secs

    # ---- the manager (frame transform for phases 3-5) ----------------------
    tmp = tempfile.TemporaryDirectory()
    gcsv = Path(tmp.name) / "chip_smoke.gcsv"
    write_gcsv(gcsv)
    mgr = StabilizationManager(device=dev)
    mgr.init_from_video_data(1000.0, FPS, int(FPS), (W, H))
    mgr.lens = LensProfile(
        calib_dimension=Dimensions(W, H),
        fisheye_params=CameraParams(
            camera_matrix=[[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1]],
            distortion_coeffs=[0.25, -0.05, 0.01, -0.001]),
        distortion_model="opencv_fisheye")
    mgr.lens.init()
    mgr.params.frame_readout_time = 8.0
    mgr.load_gyro_data(str(gcsv))
    t0 = time.perf_counter()
    mgr.recompute_blocking()
    print(f"manager: {W}x{H} @ {FPS} fps, recompute_blocking {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(0)
    planes = {"Y": (0, smooth_plane(rng, H, W, 1)),
              "UV": (1, smooth_plane(rng, H // 2, W // 2, 2))}

    def plane_setup(ts_us, name, interpolation=8):
        pi, host = planes[name]
        ts_ms = mgr._adjusted_ts_ms(ts_us)
        ft = mgr.frame_transform_at(ts_ms)
        cfg, dyn = mgr._plane_cfg_dyn(ft, host.shape, interpolation, pi, MAXV, True, None, None)
        mats, _ = mgr._mats_on_device(ts_ms, ft)
        return cfg, dyn, mats

    from gyroflow_torch.ops.kernel_params import dyn_to_torch

    def coords_inputs(name, interpolation):
        """x, y, idx of the plane as remap_plane_cuda builds them (3*oh rows
        for EWA)."""
        cfg, dyn, mats = plane_setup(500_000, name, interpolation)
        dyn_t = dyn_to_torch(dyn, dev)
        ow, oh = cfg.out_buffer
        oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                                torch.arange(ow, dtype=torch.float32, device=dev),
                                indexing="ij")
        factor = torch.clamp_min(1.0 - dyn_t.lens_correction_amount, 0.001)
        out_c = (cfg.output_width / 2.0, cfg.output_height / 2.0)
        out_f = (dyn_t.f[0] / dyn_t.fov / factor, dyn_t.f[1] / dyn_t.fov / factor)
        pre = remap.ewa_stack if interpolation in remap.EWA_BC else remap.coords_pre
        return (*pre(ox, oy, mats, cfg, dyn_t, out_c, out_f), mats, cfg, dyn)

    def check_coords(label, x, y, idx, mats, cfg, dyn):
        uk, vk, valk = cuda_coords.project(x, y, idx, mats, cfg, dyn)
        up, vp, valp = cuda_coords.project_plain(x, y, idx, mats, cfg, dyn)
        torch.cuda.synchronize()
        n_valid_mismatch = int((valk != valp).sum())
        both = valk & valp
        du = float((uk - up).abs()[both].max())
        dv = float((vk - vp).abs()[both].max())
        print(f"{label} ({x.shape[0]}x{x.shape[1]}, {mats.shape[0]} RS rows): max|du| {du:.3g} "
              f"max|dv| {dv:.3g} px (limit {COORDS_TOL_PX}); valid mismatches "
              f"{n_valid_mismatch} (limit 0); valid share {float(both.float().mean()):.4f}")
        check(n_valid_mismatch == 0, f"{label}: valid masks differ")
        check(du < COORDS_TOL_PX and dv < COORDS_TOL_PX, f"{label}: u/v differ")
        return up, vp, valp, max(du, dv)

    def plane_bg(dyn, img):
        return tuple(float(b) for b in
                     (np.asarray(dyn.background, np.float32) * np.float32(MAXV))[:img.shape[2]])

    # ---- 3. kernels vs plain at the main-path shapes ------------------------
    phase("kernels vs plain torch on the card")
    errs = {"coords": 0.0, "sampler": 0.0}
    shapes = {}
    dev_planes = {n: torch.from_numpy(p).to(dev) for n, (_, p) in planes.items()}
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn = coords_inputs(name, 8)
        up, vp, valp, d = check_coords(f"coords  {name:2s}", x, y, idx, mats, cfg, dyn)
        errs["coords"] = max(errs["coords"], d)

        u, v = remap.coords_post_uv(up, vp, cfg)
        img = dev_planes[name]
        bg = plane_bg(dyn, img)
        sk = cuda_sampler.sample(img, u, v, valp, bg, cfg.src_rect, 8, MAXV)
        sp = cuda_sampler.sample_plain(img, u, v, valp, bg, cfg.src_rect, 8, MAXV)
        torch.cuda.synchronize()
        ds = float((sk - sp).abs().max())
        check(bool(torch.isfinite(sk).all()), f"sampler {name}: non-finite output")
        print(f"sampler {name:2s} (plane {tuple(img.shape)} uint16 -> {tuple(sk.shape)}): "
              f"max|d| {ds:.3g} codes (limit {SAMPLER_TOL})")
        check(ds < SAMPLER_TOL, f"sampler {name}: output differs")
        errs["sampler"] = max(errs["sampler"], ds)
        shapes[name] = (x, y, idx, mats, cfg, dyn, u, v, valp, img, bg)

    # ---- 3b. EWA: stacked coords launch and EWA kernel vs plain -------------
    phase("EWA (interpolation 11): stacked coords and EWA kernel vs plain torch on the card")
    errs.update(coords_stacked=0.0, ewa=0.0)
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn = coords_inputs(name, EWA_INTERP)
        up, vp, valp, d = check_coords(f"coords  {name:2s} stacked 3 evals", x, y, idx, mats,
                                       cfg, dyn)
        errs["coords_stacked"] = max(errs["coords_stacked"], d)
        u3, v3 = remap.coords_post_uv(up, vp, cfg)
        u, v, valid, jac = remap.ewa_jacobian(u3, v3, valp)
        img = dev_planes[name]
        bg = plane_bg(dyn, img)
        coeffs = remap._ewa_coeffs_of(dyn)
        ek = cuda_ewa.sample(img, u, v, jac, valid, bg, cfg.src_rect, coeffs, MAXV)
        ep = cuda_ewa.sample_plain(img, u, v, jac, valid, bg, cfg.src_rect, coeffs, MAXV)
        torch.cuda.synchronize()
        de = float((ek - ep).abs().max())
        check(bool(torch.isfinite(ek).all()), f"ewa {name}: non-finite output")
        print(f"ewa     {name:2s} (plane {tuple(img.shape)} uint16 -> {tuple(ek.shape)}; "
              f"|jac| max {float(jac[valid].abs().max()):.4g}): max|d| {de:.3g} codes "
              f"(limit {SAMPLER_TOL})")
        check(de < SAMPLER_TOL, f"ewa {name}: output differs")
        errs["ewa"] = max(errs["ewa"], de)
        shapes[f"ewa {name}"] = (x, y, idx, mats, cfg, dyn, u, v, jac, valid, img, bg, coeffs)

    ts_list = [int(round((i + 5) * 1e6 / FPS)) for i in range(FRAMES)]
    counters = {"coords": cuda_coords.project, "sampler": cuda_sampler.sample,
                "ewa": cuda_ewa.sample}

    def drive(interpolation, expected):
        """3 frames of Y and UV through process_pixels, every launch count
        set to 0 just before and read just after; each plane held against
        the plain torch path."""
        for fn in counters.values():
            fn.launches = 0
        outs = []
        for ts in ts_list:
            for name in ("Y", "UV"):
                pi, host = planes[name]
                out, info = mgr.process_pixels(ts, host, interpolation=interpolation,
                                               plane_index=pi, max_pixel_value=MAXV,
                                               plane_rects=True)
                outs.append((ts, name, out, info))
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        print(f"launch counts over {FRAMES} frames: {counts} (expected {expected})")
        check(counts == expected, "the path did not launch each of its kernels once per plane")
        for ts, name, out, info in outs:
            want_shape = (H, W, 1) if name == "Y" else (H // 2, W // 2, 2)
            check(tuple(out.shape) == want_shape, f"{name}: shape {tuple(out.shape)}")
            check(out.dtype == torch.uint16 and out.device.type == "cuda",
                  f"{name}: {out.dtype} on {out.device}")
            check(info["backend"] == "cuda", f"{name}: backend {info['backend']}")
            cfg, dyn, mats = plane_setup(ts, name, interpolation)
            ref = remap.remap_plane(dev_planes[name], mats, cfg, dyn, out_dtype="uint16")
            d = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
            n_diff = int((out.to(torch.int32) != ref.to(torch.int32)).sum())
            print(f"frame ts {ts} us {name:2s}: {tuple(out.shape)} {out.dtype} on {out.device}; "
                  f"vs plain path max|d| {d} codes over {n_diff} px (limit {FRAME_TOL_CODES}); "
                  f"mean {float(out.float().mean()):.2f}")
            check(d <= FRAME_TOL_CODES, f"{name} at {ts}: kernel path differs from plain path")
        return counts

    # ---- 4. the main path through the manager -------------------------------
    phase("main path: process_pixels, 3 frames of 4K 10-bit YUV420, lanczos4")
    launches = drive(8, {"coords": 2 * FRAMES, "sampler": 2 * FRAMES, "ewa": 0})

    # ---- 4b. the EWA path through the manager -------------------------------
    phase("EWA path: process_pixels, 3 frames of 4K 10-bit YUV420, interpolation 11")
    launches_ewa = drive(EWA_INTERP, {"coords": 2 * FRAMES, "sampler": 0, "ewa": 2 * FRAMES})
    check("jax" not in sys.modules, "jax was imported")
    print("jax in sys.modules: False")

    # ---- 5. times ------------------------------------------------------------
    phase(f"times on {smi}")
    times = {"coords": [0.0, 0.0], "sampler": [0.0, 0.0]}
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u, v, valp, img, bg = shapes[name]
        ck = cuda_ms(lambda: cuda_coords.project(x, y, idx, mats, cfg, dyn))
        cp = cuda_ms(lambda: cuda_coords.project_plain(x, y, idx, mats, cfg, dyn))
        sk = cuda_ms(lambda: cuda_sampler.sample(img, u, v, valp, bg, cfg.src_rect, 8, MAXV))
        sp = cuda_ms(lambda: cuda_sampler.sample_plain(img, u, v, valp, bg, cfg.src_rect, 8, MAXV))
        print(f"{name:2s} coords  kernel {ck:.4f} ms  plain {cp:.4f} ms")
        print(f"{name:2s} sampler kernel {sk:.4f} ms  plain {sp:.4f} ms")
        times["coords"][0] += ck
        times["coords"][1] += cp
        times["sampler"][0] += sk
        times["sampler"][1] += sp

    def frame_kernel(ts, interpolation):
        for name in ("Y", "UV"):
            pi, _ = planes[name]
            mgr.process_pixels(ts, dev_planes[name], interpolation=interpolation, plane_index=pi,
                               max_pixel_value=MAXV, plane_rects=True)

    def frame_plain(ts, interpolation):
        for name in ("Y", "UV"):
            cfg, dyn, mats = plane_setup(ts, name, interpolation)
            remap.remap_plane(dev_planes[name], mats, cfg, dyn, out_dtype="uint16")

    def per_frame_ms(fn, n, interpolation):
        mgr._stab_cache.clear()
        mgr._mats_dev.clear()
        fn(ts_list[0], interpolation)        # warm-up
        torch.cuda.synchronize()
        ms = []
        for i in range(n):
            t0 = time.perf_counter()
            fn(int(round((i + 10) * 1e6 / FPS)), interpolation)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    fp1 = per_frame_ms(frame_plain, 5, 8)
    fk1 = per_frame_ms(frame_kernel, 10, 8)
    fk2 = per_frame_ms(frame_kernel, 10, 8)
    fp2 = per_frame_ms(frame_plain, 5, 8)
    print(f"process_pixels Y+UV per frame (host clock, median; plain, kernel, kernel, plain): "
          f"{fp1:.3f}, {fk1:.3f}, {fk2:.3f}, {fp2:.3f} ms")

    # ---- 5b. EWA times -------------------------------------------------------
    phase(f"EWA times on {smi}")
    times.update(coords_stacked=[0.0, 0.0], ewa=[0.0, 0.0])
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u, v, jac, valid, img, bg, coeffs = shapes[f"ewa {name}"]
        ck = cuda_ms(lambda: cuda_coords.project(x, y, idx, mats, cfg, dyn))
        cp = cuda_ms(lambda: cuda_coords.project_plain(x, y, idx, mats, cfg, dyn))
        ek = cuda_ms(lambda: cuda_ewa.sample(img, u, v, jac, valid, bg, cfg.src_rect, coeffs,
                                             MAXV))
        ep = cuda_ms(lambda: cuda_ewa.sample_plain(img, u, v, jac, valid, bg, cfg.src_rect,
                                                   coeffs, MAXV), reps=3, warm=1)
        print(f"{name:2s} coords stacked ({x.shape[0]}x{x.shape[1]}) kernel {ck:.4f} ms  "
              f"plain {cp:.4f} ms")
        print(f"{name:2s} ewa     kernel {ek:.4f} ms  plain {ep:.4f} ms")
        times["coords_stacked"][0] += ck
        times["coords_stacked"][1] += cp
        times["ewa"][0] += ek
        times["ewa"][1] += ep
    ep1 = per_frame_ms(frame_plain, 3, EWA_INTERP)
    ek1 = per_frame_ms(frame_kernel, 10, EWA_INTERP)
    ek2 = per_frame_ms(frame_kernel, 10, EWA_INTERP)
    ep2 = per_frame_ms(frame_plain, 3, EWA_INTERP)
    print(f"process_pixels EWA Y+UV per frame (host clock, median; plain, kernel, kernel, plain): "
          f"{ep1:.3f}, {ek1:.3f}, {ek2:.3f}, {ep2:.3f} ms")
    report.update(frame_ms={"kernel": [fk1, fk2], "plain": [fp1, fp2]},
                  ewa_frame_ms={"kernel": [ek1, ek2], "plain": [ep1, ep2]},
                  launches=launches, launches_ewa=launches_ewa, errs=errs, kernel_ms=times)

    # ---- 6. where an EWA frame's device time goes ----------------------------
    phase("profile: 3 new EWA frames (Y+UV) on the kernel path, device time by kernel")
    from torch.profiler import ProfilerActivity, profile
    frame_kernel(ts_list[0], EWA_INTERP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(FRAMES):
            frame_kernel(int(round((i + 40) * 1e6 / FPS)), EWA_INTERP)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES

    def self_device_us(e):   # the attribute's name before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: the aten ops' rows repeat their kernels' time
    rows = [(e.key, self_device_us(e) / 1e3 / FRAMES, e.count / FRAMES)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and self_device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    if rows:
        print(f"per frame: wall {wall_ms:.3f} ms (profiler on), device busy {dev_ms:.3f} ms "
              f"({100.0 * dev_ms / wall_ms:.1f}%) over {sum(r[2] for r in rows):.0f} kernels")
    else:
        print("device time per frame: not measured (no device events)")
    for key, ms, n in rows[:10]:
        print(f"  {ms:8.3f} ms/frame  {n:5.0f} launches/frame  {key[:100]}")
    report["ewa_profile"] = {"wall_ms_per_frame": wall_ms, "device_ms_per_frame": dev_ms,
                             "top": rows[:10]}

    kernels = [
        {"name": "coords", "route": "cuda", "source": "gyroflow_torch/csrc/coords.cu",
         "replaces": "gyroflow_tpu/ops/pallas_coords.py:68", "launches": launches["coords"],
         "max_abs_err": errs["coords"], "ms": times["coords"][0], "plain_ms": times["coords"][1]},
        {"name": "sampler", "route": "cuda", "source": "gyroflow_torch/csrc/sampler.cu",
         "replaces": "gyroflow_tpu/ops/pallas_sampler.py:471", "launches": launches["sampler"],
         "max_abs_err": errs["sampler"], "ms": times["sampler"][0],
         "plain_ms": times["sampler"][1]},
        {"name": "ewa", "route": "cuda", "source": "gyroflow_torch/csrc/ewa.cu",
         "replaces": "gyroflow_tpu/ops/pallas_sampler.py:715", "launches": launches_ewa["ewa"],
         "max_abs_err": errs["ewa"], "ms": times["ewa"][0], "plain_ms": times["ewa"][1]},
    ]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({**report, "kernels": kernels}, indent=1))
    tmp.cleanup()
    print("kernel ms and plain_ms: one frame's Y+UV launches (Y 3840x2160x1 + UV 1920x1080x2); "
          "coords and sampler from the lanczos4 path, ewa from the EWA path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
