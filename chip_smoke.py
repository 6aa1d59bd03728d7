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
   finite-difference evals (3*oh rows), the self-contained coords kernel's
   EWA form (cuda_coords.project_gen on an EWA plane: the same three evals
   in one launch, with no x/y/idx input, bit-identical to ewa_stack and the
   plain projection) and the EWA kernel, which forms the Jacobian from those
   evals itself, each against its plain version at the same shapes;
3c. the fused projection + sampling kernel (remap_plane_cuda(fused=True))
   and the self-contained coords kernel (cuda_coords.project_gen), each
   against its plain version at the same shapes;
4. the main path: StabilizationManager on cuda:0, 3840x2160 at 30 fps, a
   seeded synthetic .gcsv, a fisheye lens, 8 ms rolling shutter; 3 frames of
   Y and UV through process_pixels (lanczos4, uint16 in and out), held within
   1 code of the plain torch path; the kernels' launch counters must show the
   path went through them (a fisheye lanczos4 plane: one self-contained
   coords launch, cuda_coords.project_gen, and one sampler launch), and no
   plain version may run while a path is driven (4-4d);
4b. the EWA path: the same 3 frames with interpolation 11, held within 1
   code of the plain torch path, one coords launch (the self-contained
   kernel's EWA form, cuda_coords.project_gen) and one EWA launch
   per plane;
4c. the fused path: the 3 frames' planes through remap_plane_cuda(fused=True),
   held within 1 code of the split kernels, one fused launch per plane and
   no coords or sampler launch;
4d. the self-contained coords path: the 3 frames' planes through
   cuda_coords.project_gen, held within 0.05 px (valid identical) of
   coords_pre + the coords kernel, one launch per plane;
4e. the frame window: process_pixels_window over 8 timestamps of the 4K Y
   and UV planes (lanczos4; 16 coords_gen and 16 sampler launches), each frame 0
   codes from process_pixels of the same frame and frame 0 within 1 code of
   the plain torch path; then an EWA window of 2 (4 coords_gen and 4 EWA
   launches), checked the same way;
4f. decode -> stabilize -> encode: a seeded 8-frame 3840x2160 10-bit YUV420
   .y4m written to a temporary directory, rendered by render.renderer.render
   on the manager (8-frame windows; 16 coords_gen and 16 sampler launches), each
   output frame within 1 code of process_pixels on the same decoded planes;
   then the same clip through gyroflow_torch.cli (-g gyro log, lens profile,
   --device cuda:0), which must return 0, write 8 frames and launch the
   kernels 16 times each;
4g. ST maps: utils.stmap.export_stmaps on cuda:0 (one coords launch), the
   undistort projection held within 0.05 px (valid identical) of the plain
   undistort_coord on the card;
5. times: each kernel (experiments.perf_probe.cuda_ms: median of 10 CUDA
   event pairs, each call behind an L2-flushing read and a device spin that
   covers the host's wrapper work) and its plain version (CUDA events around
   each call, median of 10), and ms per frame (Y+UV) through process_pixels,
   kernel path vs plain path;
5b. the same for EWA (the plain EWA runs 100 eager taps per pixel: 3 reps),
   the stacked coords launch beside the gen kernel's EWA form;
5c. the fused kernel against the split coords + sampler kernels, and
   project_gen against the eager output grid + coords_pre + the coords
   kernel (the kernels' timer), then the eager stage's and project_gen's
   device busy time (torch.profiler);
5d. ms per frame (Y+UV, host clock) through process_pixels_window with 8
   frames pre-staged on the card against 8 process_pixels calls, phase 4f's
   render fps and per-stage ms per frame, and the parts of a render's
   stabilize stage: the upload of a window's decoded planes, the window's
   device busy time (torch.profiler), each frame's download (printed, not
   claimed);
6. where a lanczos4 and an EWA frame's device time goes (torch.profiler, by
   kernel), and the concatenation copies of each frame;
7. the experiments' kernels (gyroflow_torch/experiments: the fused kernel
   with per-tile bboxes, window column sums, the sampler probes' kernel in
   each mode and precision, the Triton elementwise pass), each against its
   plain version at the probes' shapes (4K Y and UV float32 planes, 512
   windows of a 3840x2176 plane, 5400x1536 floats), then the path:
   experiments.run_all with every launch counter set to 0 before and read
   after, no plain version allowed to run, each probe's readings checked
   (fused_bbox's bbox and output against the split path, the float32
   samplers against remap.sample_input, sampler.cu against probe 4's full
   mode, the coords kernel against rotate_and_distort); times are the
   probes' own (CUDA events around each call, L2 flushed before it), with
   each kernel's bound;
8. every lens model and digital lens (csrc/lens.cuh): each of the 14
   models as the main model and each of the 5 digital lenses on the fisheye
   base through the coords kernel at the 4K Y plane's shapes (the main
   manager's frame transform with the lens swapped in), gf_coords_gen
   (models) and gf_fused, each against its plain version (0.01 px, valid
   identical; 0.01 codes), with each one's time and bound; insta360's
   lens-correction coords_pre in eager torch (timed, not fixed); then the
   slice's frames through a manager built with each lens: (a) Sony, (b) a
   GoPro HERO 4K SuperView clip (fisheye + gopro_superview, lens correction
   0.5), (c) Canon (opencv_standard), (d) EWA (interpolation 11) with (a);
   3 frames of Y and UV through process_pixels and a process_pixels_window
   (F = 8; 2 for EWA), held as phases 4-4e hold the fisheye render, with
   launch counts, ms per frame and device time per frame;
9. a synthesised 4K Sony clip (sony_tagmap: 60 frames in an MP4's rtmd
   track as KLV samples; the sony lens, IBIS, a seeded 9x9 lens mesh and
   FPD shears): the mesh form of gf_coords (its own instantiation) and
   the overlay kernel (csrc/overlay.cu, on tracking points from
   manager.draw_overlays and a safe-area rect) against their plain versions
   at the 4K Y and UV planes' shapes, bit-identical, with times and bounds;
   then 3 frames through process_pixels (the probe on the coords kernel: 2
   coords launches a plane), an 8-frame process_pixels_window, 3 EWA frames,
   an 8-frame 4K y4m through render(), an ST-map export, a per-frame
   undistort map (its rolling-shutter probe on the coords kernel) and one
   overlay frame, each 0 codes from the plain path, the overlay frame's Y
   plane in 3 row bands (remap_plane_cuda(out_rows, oy0) with the drawing,
   cut inside the safe-area rect's border) 0 codes from the whole plane,
   and the Sony frame's device time and launches under torch.profiler;
10. the sharded window (parallel.pipeline: frames over "dp", output-row
   bands over "sp", each band through remap_plane_cuda(out_rows, oy0)) on a
   2 x 2 mesh of logical shards of cuda:0: (a) phase 4e's 8 timestamps of
   the 4K Y and UV planes (16 coords_gen and 16 sampler launches a plane), (b)
   its EWA window of 2 (4 coords_gen and 4 EWA launches a plane), (c) 4 frames
   of phase 9's Sony clip (the probe and the projection: 2 coords launches
   a band), each frame 0 codes from the one-device window of its phase, no
   plain version run; (d) gyroflow_torch.entry.entry() on cuda:0, 0 codes
   from the same step with each wrapper's plain version; (e)
   dryrun_multichip(4) on 4 logical shards; (f) (a) over the real cards
   where there is more than one (else it says so); then the host-clock ms
   per frame of (a) against the one-device window (printed, not claimed);
11. the port's measurement path: one primary frame of gyroflow_torch.bench
   (4K float32 Y + UV through remap_plane_cuda) within 0.25 codes of the
   plain torch path; gyroflow_torch.bench.main() at its full size, its JSON
   line printed and each of its numbers finite and > 0, with every coords
   and sampler launch it makes counted (bench_launches); then
   experiments.prod_path_probe (with a production frame's device busy time
   and idle share under torch.profiler) and experiments.renderer_loop_bench
   (its device step stubbed: no launch) once each at 4K.

Each kernel's bound (the least time the card could take for the same work)
is the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its FP32 operations (counted from the kernel source, at
this run's inputs: taps only for valid pixels, EWA taps only inside each
pixel's bbox, and their weights and sums only where dr < 4, the taps with a
nonzero weight; a lens's masked loop only for the steps before each pixel
is done, counted on the plain version's run) over 67 TFLOP/s, the H100 SXM's published peaks. The 67
TFLOP/s counts a fused multiply-add as two operations; the kernels are built
with --fmad=false, so each multiply and add issues on its own and an
operation-bound kernel can reach at most half that rate. The bound keeps
its definition so that it compares across runs.

Second-to-last lines: the card's name and power limit, then one JSON object
with the kernels; last line: {"ok": true, "device": {...}}. Needs one card and
nvcc; a copy of the kernel library is built under gyroflow_torch/build/.
A few minutes on an H100 (180-230 s in all), the kernels' build (one nvcc per
source, run together; ~55 s, fused.cu's 72 instantiations the longest), Triton's
compile, phase 4g's host-side ST maps, phase 8's three extra managers and
phase 11's bench and probes (~20 s) included: the host's share varies with
the machine's load.
"""
from __future__ import annotations

import contextlib
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
WINDOW = 8                  # frames of a production window (the renderer's default)
EWA_WINDOW = 2

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, FP32 rate
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# FP32 operations per pixel, counted from csrc/ (adds, multiplies,
# divisions, square roots, compares and min/max; integer index math not
# counted). project_point (lens.cuh, fisheye, no IBIS/underwater): 3x3
# projection 15, validity 8, x/z y/z r 6, Cephes arctangent 19, theta powers
# 4, theta_d 9, scale selects 5, scale/f/c/stretch 11.
PROJECT_OPS = 77
POST_OPS = 16               # fused: source-rect map 8, guard 6, tap offset 2
GEN_PRE_OPS = 16            # gen: position 3, out-rect map 6, t2d 2, rint index 4, select 1
# gen's EWA form: GEN_PRE_OPS, the two +eps adds, the x1 and y2 maps (3 + 1
# each); then one probe and three projections a pixel
GEN_EWA_PRE_OPS = 26
# FP32 operations of each model's distort_xy (csrc/lens.cuh), counted as
# PROJECT_OPS is: (outside its loop, per loop step). A masked loop (gopro's
# Newton, a digital lens's fixed point: its map + 10) is counted at the
# steps this run's inputs need (lens_ops), not at its 10 or 12. The rest of
# the projection (3x3, validity, f, c, stretch) is PROJECT_OPS less
# fisheye's 46; a digital lens adds its test and its map after c.
DISTORT_OPS = {"opencv_fisheye": (46, 0), "opencv_standard": (48, 0), "poly3": (9, 0),
               "poly5": (12, 0), "ptlens": (15, 0), "insta360": (43, 0), "sony": (49, 0),
               "generic_polynomial": (78, 0), "gopro": (42, 31), "gopro_superview": (11, 28),
               "gopro6_superview": (10, 25), "gopro_hyperview": (11, 34),
               "gopro_warp": (61, 49), "digital_stretch": (2, 0)}
# the plain loop (distortion_models) each iterative model runs
LOOP_OF = {"gopro": "_gopro_poly_invert", "gopro_superview": "_fixed_point_invert",
           "gopro6_superview": "_fixed_point_invert", "gopro_hyperview": "_fixed_point_invert",
           "gopro_warp": "_fixed_point_invert"}
PROJECT_BASE_OPS = PROJECT_OPS - DISTORT_OPS["opencv_fisheye"][0]
IBIS_OPS = 15               # the IBIS test 5, cos and sin 2, the rotation and shifts 8
LENS_TOL_PX = 0.01          # phase 8: kernel vs plain, the same float32 ops (0 expected)
# the lenses of phase 8: coefficient shapes of real profiles
# (tests/test_distortion_models.py COEFFS) and digital-lens parameters
LENS_K = {"opencv_fisheye": [0.25, -0.1, 0.03, -0.004],
          "opencv_standard": [-0.28, 0.09, 0.0001, -0.0002, -0.015],
          "poly3": [0.08], "poly5": [0.05, -0.01], "ptlens": [0.01, -0.03, 0.02],
          "insta360": [0.05, -0.01, 0.002, 0.0005, -0.0003, 1.1],
          "sony": [1.0, 0.02, 0.1, -0.05, 0.01, -0.001],
          "generic_polynomial": [1.0, 0.0, 0.16, 0.0, 0.012],
          "gopro": [0.0, 1.1, 0.05, 0.22, -0.1, 0.02, 0.0]}
LENS_DLP = {"digital_stretch": [1.333333, 1.0],
            "gopro_warp": [1.05, 0.2, -0.1, 0.05, -0.01, 0.002, -0.0001, 0.02,
                           1.02, 0.05, -0.01, 0.03, -0.005, 0.001, 1.3333, 0.0]}


def lenses():
    """Phase 8's lenses: each model as the main model, in the kernels' id
    order (distortion_models.MODEL_IDS), then each digital lens on the
    fisheye base."""
    from gyroflow_torch.ops.distortion_models import MODEL_IDS, get_model
    return ([(m, None) for m in MODEL_IDS]
            + [("opencv_fisheye", m) for m in MODEL_IDS if get_model(m).is_digital])


# resources/camera_presets/GoPro_HERO11_Black_wide_3840x2160_59940.json
GOPRO_HERO11 = dict(k=[0.262, -0.0587, 0.0222, -0.0034], f=1714.944)
# the slice's frames: (label, lens of make_manager, interpolation)
SLICES = (("a: Sony", dict(model="sony", k=LENS_K["sony"]), 8),
          ("b: GoPro HERO 4K SuperView", dict(digital="gopro_superview", lens_correction=0.5,
                                              **GOPRO_HERO11), 8),
          ("c: Canon", dict(model="opencv_standard", k=LENS_K["opencv_standard"]), 8),
          ("d: Sony, EWA", dict(model="sony", k=LENS_K["sony"]), 11))


# phase 9: a synthesised Sony clip (the tag-map fields of
# tests/test_sony_canon.py's fixture) with a seeded 9x9 lens mesh, focal-plane
# shears and IBIS on every frame, written as real SMPTE KLV samples
SONY_GRID = 9
SONY_FRAMES = 60


def sony_tagmap(i, w, h, grid=SONY_GRID, seed=9):
    """Frame i's Sony tag map for a w x h clip: gyro and accelerometer at
    990 Hz, the ILCE-7M4 imager, the sony lens polynomial, 12 IBIS and OIS
    samples, and one seeded grid x grid mesh and FPD block shared by every
    frame (the inverse mesh is fitted once per distinct mesh)."""
    import numpy as np
    rate = 990.0
    t0 = i * 1000.0 / FPS
    n = int(round(rate / FPS))
    gyro = [(t0 + j / rate * 1000.0, 20.0 * math.sin((t0 + j) * 0.05),
             10.0 * math.cos((t0 + j) * 0.04), 4.0) for j in range(n)]
    step = 1e6 / FPS / 12.0
    size = (6912.0, 4608.0)
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, size[0], grid), np.linspace(0, size[1], grid))
    pts = np.stack([gx + rng.normal(0, 10.0, gx.shape), gy + rng.normal(0, 8.0, gy.shape)], -1)
    pts = [tuple(p) for p in pts.reshape(-1, 2).tolist()]
    sensor_h = 4608.0 * 5940.0
    return {
        "camera_model": "ILCE-7M4", "frame_rate": FPS, "frame_readout_time": 8.0,
        "video_size": (w, h), "imu_orientation": "XYZ",
        "imager": {"first_frame_ts": 2.0, "exposure_time": 2.0,
                   "sensor_size_px": (7008, 4672), "pixel_pitch": (5940, 5940),
                   "capture_area_origin": (48.0, 36.0), "capture_area_size": size},
        "gyroscope": {"frequency": int(rate), "time_offset": 5.0, "scaler": 1000000,
                      "data": gyro},
        "accelerometer": {"data": [(t, 0.0, 0.0, 9.8) for (t, *_r) in gyro]},
        "lens": {"focal_length": 35.0, "display_name": "FE 35mm F1.8"},
        "lens_distortion": {"enabled": True, "data": {
            "focal_length_nm": 35.0e6, "effective_sensor_height_nm": sensor_h,
            "coeff_scale": 100.0,
            "coeffs": [100.0 * math.degrees(math.atan(r / 10.0 * (sensor_h / 1e9) / 0.035))
                       * (1.0 + 0.01 * (r / 10.0) ** 2) for r in range(1, 11)]}},
        "ibis": {"data": [(int(j * step), int(40 * math.sin(i + j * 0.5)),
                           int(30 * math.cos(i + j * 0.4)), 0) for j in range(12)],
                 "data2": [(int(j * step), 0, 0, int(5 * math.sin(j))) for j in range(12)]},
        "lens_oss": {"data": [(int(j * step), int(10 * math.sin(j + i)), int(8 * math.cos(j)), 0)
                              for j in range(12)]},
        "mesh_correction": {"data": {"size": size, "divisions": (grid, grid), "mesh": pts,
                                     "raw_mesh": pts}},
        "focal_plane_distortion": {"data": {
            "unk1": 1, "unk2": 2, "scale": 100.0,
            "unk4": [tuple(int(v) for v in rng.integers(-60, 61, 2)) for _ in range(8)]}},
    }


def make_sony_manager(dev, workdir, w=None, h=None, n=SONY_FRAMES, grid=SONY_GRID):
    """A StabilizationManager on dev that loaded an n-frame w x h Sony clip
    (sony_tagmap's frames in an MP4's rtmd track, KLV samples) written to
    workdir, then the lens profile the clip carries: the sony lens, IBIS,
    the grid x grid mesh and FPD from the clip. The host fits the inverse
    mesh once (Nelder-Mead per grid point: ~20 s at 9x9)."""
    from gyroflow_torch.core.manager import StabilizationManager
    from gyroflow_torch.core.telemetry import sony
    w, h = w or W, h or H
    path = Path(workdir) / "chip_smoke_sony.mp4"
    path.write_bytes(sony.build_tagmap_mp4([sony_tagmap(i, w, h, grid) for i in range(n)], FPS,
                                           encoding="klv"))
    t0 = time.perf_counter()
    mgr = StabilizationManager(device=dev)
    mgr.init_from_video_data(n / FPS * 1000.0, FPS, n, (w, h))
    mgr.load_gyro_data(str(path))
    mgr.load_lens_profile(json.dumps(mgr.gyro.file_metadata.lens_profile))
    mgr.recompute_blocking()
    print(f"Sony manager: {w}x{h} @ {FPS} fps, {n} frames, lens {mgr.lens.distortion_model}, "
          f"loaded and recomputed in {time.perf_counter() - t0:.2f} s")
    return mgr


def sampler_ops(C, taps=8):
    """FP32 operations of one valid pixel's separable tap loop (taps.cuh):
    a multiply and an add per tap and channel, two per row and channel, the
    clamp, the guard and offset (8) and the phase (2)."""
    return taps * taps * 2 * C + taps * 2 * C + C + 10


def bound(parts):
    """(bound_ms, bound_by) of launches run one after the other; parts is a
    list of (bytes, operations), one per launch."""
    t_bytes = sum(b / PEAK_BYTES_S for b, _ in parts)
    t_ops = sum(o / PEAK_FP32_S for _, o in parts)
    total = sum(max(b / PEAK_BYTES_S, o / PEAK_FP32_S) for b, o in parts)
    return total * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def make_planes():
    """{name: (plane_index, host uint16 plane)} of the 4K 10-bit YUV420 frame."""
    import numpy as np
    rng = np.random.default_rng(0)
    return {"Y": (0, smooth_plane(rng, H, W, 1)),
            "UV": (1, smooth_plane(rng, H // 2, W // 2, 2))}


def make_manager(dev, workdir, model="opencv_fisheye", k=(0.25, -0.05, 0.01, -0.001),
                 f=None, digital=None, lens_correction=1.0):
    """The main path's StabilizationManager on dev: W x H at FPS, a lens
    (by default the main path's fisheye, f = 0.6 W), 8 ms rolling shutter,
    the seeded gyro log written to workdir."""
    from gyroflow_torch.core.lens_profile import CameraParams, Dimensions, LensProfile
    from gyroflow_torch.core.manager import StabilizationManager
    gcsv = Path(workdir) / "chip_smoke.gcsv"
    write_gcsv(gcsv)
    f = W * 0.6 if f is None else f
    mgr = StabilizationManager(device=dev)
    mgr.init_from_video_data(1000.0, FPS, int(FPS), (W, H))
    mgr.lens = LensProfile(
        calib_dimension=Dimensions(W, H),
        fisheye_params=CameraParams(
            camera_matrix=[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
            distortion_coeffs=list(k)),
        distortion_model=model, digital_lens=digital)
    mgr.lens.init()
    mgr.params.frame_readout_time = 8.0
    mgr.params.lens_correction_amount = lens_correction
    mgr.load_gyro_data(str(gcsv))
    t0 = time.perf_counter()
    mgr.recompute_blocking()
    print(f"manager: {W}x{H} @ {FPS} fps, {model}{'+' + digital if digital else ''}, lens "
          f"correction {lens_correction}, recompute_blocking {time.perf_counter() - t0:.2f} s")
    return mgr


def lens_profile_json():
    """The main path's fisheye lens as a lens-profile file's JSON (the CLI's
    input)."""
    return json.dumps({
        "camera_brand": "chip_smoke", "camera_model": "synthetic", "lens_model": "fisheye",
        "calib_dimension": {"w": W, "h": H}, "frame_readout_time": 8.0,
        "fisheye_params": {"camera_matrix": [[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2], [0, 0, 1]],
                           "distortion_coeffs": [0.25, -0.05, 0.01, -0.001]},
        "sync_settings": {}, "calibrator_version": "1"})


def write_clip(path, planes, n):
    """n frames of the main path's planes as a 10-bit YUV420 .y4m, frame i
    rolled 4i px (Y) and 2i px (UV) to the right."""
    import numpy as np
    from gyroflow_torch.render.y4m_io import Y4MWriter
    y, uv = planes["Y"][1], planes["UV"][1]
    w = Y4MWriter(str(path), W, H, FPS, "yuv420p10le")
    try:
        for i in range(n):
            uvi = np.roll(uv, 2 * i, axis=1)
            w.write_planes([np.roll(y, 4 * i, axis=1), uvi[..., :1], uvi[..., 1:]])
    finally:
        w.close()


def plane_setup(mgr, planes, ts_us, name, interpolation=8):
    """(cfg, dyn, matrices on the card) of one plane at ts_us, as
    process_pixels builds them."""
    pi, host = planes[name]
    ts_ms = mgr._adjusted_ts_ms(ts_us)
    ft = mgr.frame_transform_at(ts_ms)
    cfg, dyn = mgr._plane_cfg_dyn(ft, host.shape, interpolation, pi, MAXV, True, None, None)
    mats, _ = mgr._mats_on_device(ts_ms, ft)
    return cfg, dyn, mats


def plane_mesh(mgr, ts_us):
    """The frame's mesh buffer on the card as process_pixels reads it (None
    for a clip without Sony mesh or focal-plane data)."""
    ts_ms = mgr._adjusted_ts_ms(ts_us)
    return mgr._mats_on_device(ts_ms, mgr.frame_transform_at(ts_ms))[1]


def plane_bg(dyn, img):
    """The plane's background in codes, one value per channel."""
    import numpy as np
    return tuple(float(b) for b in
                 (np.asarray(dyn.background, np.float32) * np.float32(MAXV))[:img.shape[2]])


# mangled names of the kernels the driven paths launch (uint16 planes, C=1/2;
# the experiments' float32 planes): coords, coords_gen and fused are the
# fisheye instantiations; phase 8's lenses follow (lens_kernels)
MAIN_PATH_KERNELS = {"coords": "coords_kernelILi0ELb0ELb0EE",
                     "sampler<u16,C1,8>": "sampler_kernelItLi1ELi8E",
                     "sampler<u16,C2,8>": "sampler_kernelItLi2ELi8E",
                     "ewa<u16,C1>": "ewa_kernelItLi1EE", "ewa<u16,C2>": "ewa_kernelItLi2EE",
                     "fused<u16,C1,8>": "fused_kernelItLi1ELi8ELb0EE",
                     "fused<u16,C2,8>": "fused_kernelItLi2ELi8ELb0EE",
                     "coords_gen": "coords_gen_kernelILi0EE",
                     "coords_gen_ewa": "coords_gen_kernel_ewaILi0EE",
                     "fused_bbox<C1,8>": "fused_bbox_kernelILi1ELi8E",
                     "fused_bbox<C2,8>": "fused_bbox_kernelILi2ELi8E",
                     "window_colsum": "window_colsum_kernel",
                     "window_colsum<tma>": "window_colsum_tma_kernel",
                     "probe_sampler<C1,full,fp32>": "probe_sampler_kernelILi1ELi3ELi0EE",
                     "probe_sampler<C1,full,bf16>": "probe_sampler_kernelILi1ELi3ELi1EE",
                     "probe_sampler<C1,full,bf16x3>": "probe_sampler_kernelILi1ELi3ELi2EE",
                     "probe_sampler<C2,full,fp32>": "probe_sampler_kernelILi2ELi3ELi0EE",
                     "probe_sampler<C1,nomatmul>": "probe_sampler_kernelILi1ELi2ELi0EE",
                     "fused<u16,C1,8,any lens>": "fused_kernelItLi1ELi8ELb1EE",
                     "overlay<C1>": "overlay_kernelILi1EE", "overlay<C2>": "overlay_kernelILi2EE"}


def lens_kernels():
    """Mangled names of phase 8's instantiations, by model id
    (distortion_models.MODEL_IDS, lens.cuh's ModelId)."""
    from gyroflow_torch.ops.distortion_models import MODEL_IDS
    return {**{f"coords<{m}>": f"coords_kernelILi{i}ELb0ELb0EE"
               for m, i in MODEL_IDS.items() if i},
            **{f"coords<{m},digital>": f"coords_kernelILi{i}ELb1ELb0EE"
               for m, i in MODEL_IDS.items()},
            **{f"coords<{m},mesh>": f"coords_kernelILi{i}ELb1ELb1EE" for m, i in MODEL_IDS.items()},
            **{f"coords<sony,mesh,{g} rows>": f"coords_mesh_kernelILi{MODEL_IDS['sony']}ELi{g}EE"
               for g in range(2, 10)},
            **{f"coords_gen<{m}>": f"coords_gen_kernelILi{i}EE"
               for m, i in MODEL_IDS.items() if i}}


def ptxas_summary(log):
    """Registers and spills of the driven paths' kernels from nvcc -Xptxas -v."""
    names = {**MAIN_PATH_KERNELS, **lens_kernels()}
    out, current = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = next((k for k, m in names.items() if m in ln), None)
        elif current and ("spill" in ln or "registers" in ln):
            out[current] = (out.get(current, "") + " " + ln.split(":")[-1].strip()).strip()
    return out


def ewa_bbox_taps(u, v, jac, valid):
    """(taps, rows, weighted) of ewa.cu's 10x10 stencil over the valid
    pixels of the plane: the taps and rows inside each pixel's reference
    bbox (affine_bbox), and the bbox taps whose dr is below 4, the only ones
    with a nonzero weight (the others stop at dr)."""
    import torch
    from gyroflow_torch.ops import remap
    u, v, (x0, x1, y0, y1), (abc_x, abc_y, abc_z) = remap.ewa_footprint(u, v, jac)
    bx = torch.floor(u).to(torch.int32) - remap.EWA_CAP
    by = torch.floor(v).to(torch.int32) - remap.EWA_CAP
    taps = rows = weighted = 0
    for ty in range(2 * remap.EWA_CAP + 2):
        in_y = by + ty
        row = valid & (in_y >= y0) & (in_y <= y1)
        rows += int(row.sum())
        fy = in_y.to(torch.float32) - v
        for tx in range(2 * remap.EWA_CAP + 2):
            in_x = bx + tx
            tap = row & (in_x >= x0) & (in_x <= x1)
            fx = in_x.to(torch.float32) - u
            dr = fx * fx * abc_x + fx * (fy * abc_y) + fy * fy * abc_z
            taps += int(tap.sum())
            weighted += int((tap & (dr < 4.0)).sum())
    return taps, rows, weighted


def cuda_ms(fn, reps=10, warm=2):
    """Median time of fn in ms, CUDA events around each call: no L2 flush
    and no device spin, so the host's work inside fn shows in the reading.
    The plain versions' timer; the kernels take experiments.perf_probe.cuda_ms."""
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


def window_taps(u, v, lo_x, hi_x, lo_y, hi_y, x0=None, y0=None, xoff=None, window=None):
    """(taps, rows) summed over all pixels: the taps of each pixel's 8-tap
    lanczos4 stencil at rint((u - 3) * 32) inside [lo, hi) on both
    axes and, if a window (Sr, Sc, K) is given, inside its rows y0 .. y0 + Sr
    and columns x0 + xoff .. x0 + xoff + K (per-tile origins)."""
    import torch
    fx = torch.round((u - 3.0) * 32).to(torch.int32) >> 5
    fy = torch.round((v - 3.0) * 32).to(torch.int32) >> 5
    t = torch.arange(8, dtype=torch.int32, device=u.device)
    xs, ys = fx[..., None] + t, fy[..., None] + t
    col = (xs >= lo_x) & (xs < hi_x)
    row = (ys >= lo_y) & (ys < hi_y)
    if window is not None:
        Sr, _, K = window
        cx = xs - (x0 + xoff)[:, None, None]
        ry = ys - y0[:, None, None]
        col &= (cx >= 0) & (cx < K)
        row &= (ry >= 0) & (ry < Sr)
    ncol, nrow = col.sum(-1).double(), row.sum(-1).double()
    return int((ncol * nrow).sum()), int(nrow.sum())


def window_union_bytes(shape, y0, x0, Sr, Sc):
    """Bytes of the plane (H, W, C) float32 under the union of the Sr x Sc
    windows at (y0, x0): what a call must read, once, however much its
    windows overlap."""
    import torch
    H, W = shape[:2]
    cover = torch.zeros(H + Sr + 1, W + Sc + 1, dtype=torch.int32, device=y0.device)
    ys, xs = y0.long().clamp(0, H), x0.long().clamp(0, W)
    # one 2-D difference array: +1 at each window's corner, -1 past its edges
    for dy, dx, sign in ((0, 0, 1), (Sr, 0, -1), (0, Sc, -1), (Sr, Sc, 1)):
        cover.index_put_((ys + dy, xs + dx), torch.full_like(ys, sign, dtype=torch.int32),
                         accumulate=True)
    covered = cover.cumsum(0).cumsum(1)[:H, :W] > 0
    return int(covered.sum()) * 4 * (shape[2] if len(shape) > 2 else 1)


def experiments_phase(dev, smi):
    """Phase 7: the experiments' four kernels (TPU kernels 6-11) against their
    plain versions at the probes' shapes, then experiments.run_all on the
    card with every launch counter set to 0 before and read after. Returns
    (entries for the kernels line, report)."""
    import torch
    from gyroflow_torch import experiments
    from gyroflow_torch.experiments import fused_bbox as fb
    from gyroflow_torch.experiments import perf_probe3 as p3
    from gyroflow_torch.experiments import perf_probe4 as p4
    from gyroflow_torch.experiments import perf_probe5 as p5
    from gyroflow_torch.experiments import perf_probe6 as p6
    from gyroflow_torch.experiments import perf_probe8 as p8
    from gyroflow_torch.experiments import probe_sampler as psm
    from gyroflow_torch.ops import cuda_coords, cuda_sampler, remap

    err = {k: 0.0 for k in ("fused_bbox", "window", "probe4", "probe5", "probe6", "triton")}
    plain_ms = {k: 0.0 for k in err}
    parts = {k: [] for k in err}
    # a background for the checks (the probes' own is 0, which would hide a
    # wrong background weight)
    check_bg = (100.0, 50.0)

    phase("experiments: fused_bbox, window, probe sampler and Triton kernels vs plain torch on "
          "the card")
    for name, (img, x, y, idx, mats, cfg, dyn, _) in fb.inputs(dev).items():
        bg = check_bg[:img.shape[2]]
        k_out, k_val, k_box = fb.fused_bbox(img, x, y, idx, mats, cfg, dyn, bg)
        p_out, p_val, p_box = fb.fused_bbox_plain(img, x, y, idx, mats, cfg, dyn, bg)
        torch.cuda.synchronize()
        d, db = float((k_out - p_out).abs().max()), float((k_box - p_box).abs().max())
        n_mis = int((k_val != p_val).sum())
        print(f"fused_bbox {name:2s} (plane {tuple(img.shape)} f32, tiles {tuple(k_box.shape[:2])}"
              f" of {fb.TILE}, bg {bg}): out max|d| {d:.3g} codes (limit {SAMPLER_TOL}), valid mismatches "
              f"{n_mis} (limit 0), bbox max|d| {db:.3g} px (limit 1e-4)")
        check(bool(torch.isfinite(k_out).all()) and d <= SAMPLER_TOL and n_mis == 0 and db <= 1e-4,
              f"fused_bbox {name}: differs from its plain version")
        err["fused_bbox"] = max(err["fused_bbox"], d, db)
        plain_ms["fused_bbox"] += cuda_ms(
            lambda: fb.fused_bbox_plain(img, x, y, idx, mats, cfg, dyn, bg), reps=3, warm=1)
        u, v, val = cuda_coords.project(x, y, idx, mats, cfg, dyn)
        u, v = remap.coords_post_uv(u, v, cfg)
        u, v = remap._guard_uv(u), remap._guard_uv(v)
        print(f"fused_bbox {name:2s}: {fb.fast_share(u, v, cfg, img.shape):.4f} of the pixels' "
              f"stencils take the fast path (wholly inside the source rect and the plane)")
        n_px, C, ntiles = x.numel(), img.shape[2], k_box.shape[0] * k_box.shape[1]
        srx, sry, srw, srh = cfg.src_rect
        taps, rows = window_taps(u, v, srx, srx + srw, sry, sry + srh)
        # per pixel: projection, post-map + guard + offset, phases 2, bbox 4,
        # weight masks and sums 32, bg weight 2 + 2C; per in-rect row 2C,
        # per in-rect tap 2C
        parts["fused_bbox"].append(
            (img.numel() * 4 + mats.numel() * 4 + n_px * (16 + 4 * C) + ntiles * 16,
             n_px * (PROJECT_OPS + POST_OPS + 2 + 4 + 32 + 2 + 2 * C) + rows * 2 * C
             + taps * 2 * C))

    img, cases = p3.inputs(dev)
    for align, Sc, y0, x0 in cases:
        k = p3.window_colsum(img, y0, x0, p3.SR, Sc)
        p = p3.window_colsum_plain(img, y0, x0, p3.SR, Sc)
        torch.cuda.synchronize()
        d = float((k - p).abs().max())
        print(f"window  align {align:3d} Sc {Sc} ({y0.shape[0]} tiles of {p3.SR}x{Sc}, design "
              f"{p3.window_path(img, p3.SR, Sc)}, {int((x0 % 4 != 0).sum())} tiles at an origin "
              f"column off 16 bytes, which sum with the checked loop): bit-identical "
              f"{torch.equal(k, p)}, max|d| {d:.3g} (limit: bit-identical)")
        check(torch.equal(k, p), f"window align {align} Sc {Sc}: differs from its plain version")
        err["window"] = max(err["window"], d)
        plain_ms["window"] += cuda_ms(lambda: p3.window_colsum_plain(img, y0, x0, p3.SR, Sc))
        n = y0.shape[0]
        union = window_union_bytes(img.shape, y0, x0, p3.SR, Sc)
        print(f"window  align {align:3d} Sc {Sc}: the windows cover {union} B of the "
              f"{img.numel() * 4} B plane ({n * p3.SR * Sc * 4} B counted window by window)")
        parts["window"].append((union + n * Sc * 4 + n * 8, n * p3.SR * Sc))

    def sampler_case(key, label, img, u, v, y0, x0, xoff, window, mode, precision="fp32"):
        bg = check_bg[:img.shape[2]] if mode == "full" else None
        k = psm.sample(img, u, v, y0, x0, xoff, window, mode, precision, bg)
        p = psm.sample_plain(img, u, v, y0, x0, xoff, window, mode, precision, bg)
        torch.cuda.synchronize()
        d = float((k - p).abs().max())
        limit = 1e-4 * float(p.abs().max()) if mode == "nobuild" else SAMPLER_TOL
        print(f"probe sampler {label} {mode} {precision} ({u.shape[0]} tiles x {u.shape[1]} px, "
              f"window {window}, bg {bg}): max|d| {d:.3g} (limit {limit:.3g})")
        check(bool(torch.isfinite(k).all()) and d <= limit,
              f"probe sampler {label} {mode} {precision}: differs from its plain version")
        if mode == "full":
            print(f"probe sampler {label} {mode} {precision}: "
                  f"{psm.fast_share(img.shape, u, v, y0, x0, xoff, window):.4f} of the pixels' "
                  f"stencils take the fast path (wholly inside the window and the frame)")
        err[key] = max(err[key], d)
        pms = cuda_ms(lambda: psm.sample_plain(img, u, v, y0, x0, xoff, window, mode, precision,
                                               bg), reps=3, warm=1)
        n_px, C, n = u.numel(), img.shape[2], u.shape[0]
        io = n_px * 4 * (1 + C) + n * 12
        if mode == "noop":
            part = (io + n * 4 * C, n_px * C)
        elif mode == "nomatmul":
            part = (io + n_px * 4 + n * 4 * C, n_px * (38 + 3 * C))
        elif mode == "nobuild":
            Sr, Sc, _ = window
            part = (io + window_union_bytes(img.shape, y0, x0, Sr, Sc),
                    n * Sr * Sc * C * 4 + n_px * (1 + Sr * C * 5))
        else:
            H, W, _ = img.shape
            taps, rows = window_taps(u, v, 0, W, 0, H, x0, y0, xoff, window)
            per_tap = {"fp32": 2, "bf16": 4, "bf16x3": 12}[precision]
            part = (io + n_px * 4 + img.numel() * 4,
                    n_px * (38 + 2 * C) + rows * 2 * C + taps * per_tap * C)
        return pms, part

    img, u, v, valid, y0, x0, xoff, _, _ = p4.inputs(dev)
    probe4_plain, probe4_parts = {}, {}
    for mode in p4.MODES:
        probe4_plain[mode], probe4_parts[mode] = sampler_case(
            "probe4", "4 Y", img, u, v, y0, x0, xoff, p4.WINDOW, mode)
    plain_ms["probe4"] = probe4_plain["full"]
    parts["probe4"] = [probe4_parts["full"]]
    for name, (img, u, v, valid, y0, x0, xoff, _, _, window) in p5.inputs(dev).items():
        pms, part = sampler_case("probe5", f"5 {name}", img, u, v, y0, x0, xoff, window, "full")
        plain_ms["probe5"] += pms
        parts["probe5"].append(part)
    img, _, _, _, (u, v, valid, y0, x0, xoff, _) = p6.inputs(dev)
    probe6_plain, probe6_parts = {}, {}
    for prec in p6.PRECISIONS:
        probe6_plain[prec], probe6_parts[prec] = sampler_case(
            "probe6", "6 Y", img, u, v, y0, x0, xoff, p6.WINDOW, "full", prec)
    plain_ms["probe6"] = probe6_plain["bf16"]
    parts["probe6"] = [probe6_parts["bf16"]]

    xs = p8.inputs(dev)
    for key, which, variant in p8.CALLS:
        k = p8.elementwise(xs[which], variant)
        p = p8.elementwise_plain(xs[which], variant)
        torch.cuda.synchronize()
        d = float((k - p).abs().max())
        print(f"triton  {key} ({variant} on {tuple(xs[which].shape)}): bit-identical "
              f"{torch.equal(k, p)}, max|d| {d:.3g} (limit: bit-identical)")
        check(torch.equal(k, p), f"triton {key}: differs from its plain version")
        plain_ms["triton"] += cuda_ms(lambda: p8.elementwise_plain(xs[which], variant))
        n = xs[which].numel()
        ops = {"chain": 100, "chain_plus1": 101, "sum10": 20}[variant]
        parts["triton"].append((n * 8, n * ops))

    # ---- the path: run_all with every counter at 0 and no plain version ------
    phase("experiments path: experiments.run_all on the card (the six probes at their own shapes)")
    counters = {"fused_bbox": fb.fused_bbox, "window": p3.window_colsum,
                "probe_sampler": psm.sample, "triton": p8.elementwise,
                "coords": cuda_coords.project, "sampler": cuda_sampler.sample}
    plain_versions = ((fb, "fused_bbox_plain"), (p3, "window_colsum_plain"),
                      (psm, "sample_plain"), (p8, "elementwise_plain"),
                      (cuda_coords, "project_plain"), (cuda_sampler, "sample_plain"))
    for fn in counters.values():
        fn.launches = 0
    plain_calls = []

    def refuse(*a, **kw):
        plain_calls.append(a)
        raise AssertionError("a plain version was called on the card's tensors")

    saved = [(mod, nm, getattr(mod, nm)) for mod, nm in plain_versions]
    for mod, nm, _ in saved:
        setattr(mod, nm, refuse)
    t0 = time.perf_counter()
    try:
        r = experiments.run_all(dev)
    finally:
        for mod, nm, fn in saved:
            setattr(mod, nm, fn)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    print(f"run_all: {secs:.1f} s; launch counts {counts}; plain versions called "
          f"{len(plain_calls)} (expected 0)")
    print(json.dumps(r))
    check(not plain_calls, "run_all: a plain version ran on the card's tensors")
    check(all(counts[k] > 0 for k in ("fused_bbox", "window", "probe_sampler", "triton")),
          "run_all: a kernel of the path was not launched")
    by_probe = {p: r[p]["launches"].get("probe_sampler", 0)
                for p in ("perf_probe4", "perf_probe5", "perf_probe6")}
    check(sum(by_probe.values()) == counts["probe_sampler"],
          f"run_all: probe sampler launches by probe {by_probe} != {counts['probe_sampler']}")

    fbr, r3, r4, r5, r6, r8 = (r[p] for p in experiments.perf_probe.PROBES)
    for name in ("Y", "UV"):
        check(fbr[name]["bbox_err_px"] <= 1e-4 and fbr[name]["valid_mismatches"] == 0
              and fbr[name]["max_err"] <= SAMPLER_TOL,
              f"fused_bbox probe {name}: bbox, valid or output off the split path")
        check(r5[name]["max_err"] <= SAMPLER_TOL, f"probe 5 {name}: off sample_input")
    check(r4["full max_err"] <= SAMPLER_TOL, "probe 4: full off sample_input")
    check(r4["base vs full max_err"] <= SAMPLER_TOL, "probe 4: sampler.cu off the full mode")
    check(r6["sampler fp32"]["err"] <= SAMPLER_TOL, "probe 6: fp32 off sample_input")
    check(max(r6["coords kernel err px"]) <= COORDS_TOL_PX,
          "probe 6: coords off rotate_and_distort")
    ms = {"fused_bbox": fbr["Y"]["ms"] + fbr["UV"]["ms"],
          "window": sum(r3[f"window align{a} Sc{s}"]["ms"] for a, s in p3.CASES),
          "probe4": r4["full"], "probe5": r5["Y"]["rolled"] + r5["UV"]["rolled"],
          "probe6": r6["sampler bf16"]["ms"],
          "triton": sum(r8[key] for key, _, _ in p8.CALLS)}
    launches = {"fused_bbox": counts["fused_bbox"], "window": counts["window"],
                "probe4": by_probe["perf_probe4"], "probe5": by_probe["perf_probe5"],
                "probe6": by_probe["perf_probe6"], "triton": counts["triton"]}
    check(all(isinstance(t, float) and t > 0 for t in ms.values()), f"run_all: times {ms}")

    phase(f"experiments times and bounds on {smi}")
    print(f"probe 4 (Y 4K, tile 16x128, window 48x256), CUDA events, L2 flushed: base "
          f"(sampler.cu on the frame layout, same function, max|d| vs full "
          f"{r4['base vs full max_err']:.3g} codes) {r4['base']:.4f} ms; " + "; ".join(
              f"{m} {r4[m]:.4f} ms (plain {probe4_plain[m]:.4f}, bound "
              f"{bound([probe4_parts[m]])[0]:.4f} {bound([probe4_parts[m]])[1]})"
              for m in p4.MODES))
    print("probe 6 (Y 4K, tile 16x96, window 48x256, K 128): " + "; ".join(
        f"{p} {r6[f'sampler {p}']['ms']:.4f} ms, err vs sample_input "
        f"{r6[f'sampler {p}']['err']:.4g} codes (plain {probe6_plain[p]:.4f} ms, bound "
        f"{bound([probe6_parts[p]])[0]:.4f})" for p in p6.PRECISIONS))
    sources = {"fused_bbox": ("csrc/fused_bbox.cu", "experiments/pallas_fused.py:36", "cuda"),
               "window": ("csrc/probe_window.cu", "experiments/perf_probe3.py:30", "cuda"),
               "probe4": ("csrc/probe_sampler.cu", "experiments/perf_probe4.py:210", "cuda"),
               "probe5": ("csrc/probe_sampler.cu", "experiments/perf_probe5.py:118", "cuda"),
               "probe6": ("csrc/probe_sampler.cu", "experiments/perf_probe6.py:143", "cuda"),
               "triton": ("experiments/perf_probe8.py", "experiments/perf_probe8.py:24",
                          "triton")}
    entries = []
    for key, (src, replaces, route) in sources.items():
        b_ms, by = bound(parts[key])
        print(f"bound {key:10s}: {b_ms:.4f} ms ({by}); kernel {ms[key]:.4f} ms = "
              f"{100.0 * b_ms / ms[key]:.1f}% of the bound's speed; plain {plain_ms[key]:.4f} "
              f"ms; launches {launches[key]}")
        entries.append({"name": key, "route": route, "source": f"gyroflow_torch/{src}",
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err[key], "ms": ms[key], "plain_ms": plain_ms[key],
                        "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    print("library_ms: null for the six: no single PyTorch call computes them (per-tile "
          "window sums at given origins, 32-phase LUT lanczos4 with separable background, "
          "per-tile bboxes, or the 100-operation chain with the same rounding)")
    return entries, {"readings": r, "run_all_s": secs, "launches": counts, "errs": err,
                     "plain_ms": plain_ms,
                     "bounds": {k: bound(v) for k, v in parts.items()}}


def lens_name(model, digital):
    return model if digital is None else f"{model}+{digital}"


def with_lens(cfg, dyn, model, digital, lens_correction=1.0):
    """A plane's (cfg, dyn) with the lens (model, digital) and its
    coefficients (LENS_K, LENS_DLP) swapped in."""
    from gyroflow_torch.ops.kernel_params import HAS_DIGITAL_LENS, KernelDynamics
    lens = KernelDynamics.make(k=LENS_K.get(model), lens_correction_amount=lens_correction,
                               digital_lens_params=LENS_DLP.get(digital or model))
    cfg = cfg._replace(distortion_model=model, digital_lens=digital,
                       flags=(cfg.flags & ~HAS_DIGITAL_LENS) | (HAS_DIGITAL_LENS if digital else 0),
                       lens_correction=lens_correction < 1.0)
    dyn = dyn._replace(k=lens.k, digital_lens_params=lens.digital_lens_params,
                       lens_correction_amount=lens.lens_correction_amount)
    return cfg, dyn


def loop_steps(fn):
    """(fn(), lane-steps, steps a lane) of a plain run: each masked loop of
    the lens math (distortion_models' _gopro_poly_invert and
    _fixed_point_invert) counts, step by step, the lanes not yet done at the
    step's start, which are the steps the function needs; {loop name:
    lane-steps summed over the run}, and {loop name: each lane's steps}
    (int32, the loop's input shape; None for a loop that did not run), read
    from the masks whose sums those counts are: what the kernel runs for
    that lane, now that a done lane leaves its loop."""
    import torch
    from torch.overrides import TorchFunctionMode
    from gyroflow_torch.ops import distortion_models as tdm

    class Masks(TorchFunctionMode):
        """Keeps the operand of each bool sum (the loop's count of the
        lanes not done)."""
        def __init__(self, out):
            super().__init__()
            self.out = out

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.sum and args and args[0].dtype == torch.bool:
                self.out.append(args[0])
            return func(*args, **(kwargs or {}))

    def hooked(f, live, masks):
        def run(*a, **kw):
            with Masks(masks):
                return f(*a, live=live, **kw)
        return run

    live = {name: [] for name in set(LOOP_OF.values())}
    masks = {name: [] for name in live}
    saved = {name: getattr(tdm, name) for name in live}
    try:
        for name, f in saved.items():
            setattr(tdm, name, hooked(f, live[name], masks[name]))
        out = fn()
    finally:
        for name, f in saved.items():
            setattr(tdm, name, f)
    steps = {name: sum(int(n) for n in counts) for name, counts in live.items()}
    per_lane = {name: (sum(mk.to(torch.int32) for mk in m) if m else None)
                for name, m in masks.items()}
    for name, t in per_lane.items():
        check((t is None and steps[name] == 0) or int(t.sum()) == steps[name],
              f"{name}: per-lane steps do not add up to the lane-steps")
    return out, steps, per_lane


def warp_max_steps(lane_steps, ow):
    """The mean over the coords kernel's warps (32 neighbouring columns of
    one row; blocks are 32x8) of the steps of each warp's slowest lane: what
    a warp runs now that a done lane leaves its loop. lane_steps: (rows * ow)
    or (rows, ow) steps a lane."""
    import torch
    t = lane_steps.reshape(-1, ow)
    pad = -ow % 32
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    return float(t.reshape(t.shape[0], -1, 32).amax(-1).float().mean())


def lens_ops(model, digital, n_proj, steps):
    """FP32 operations of n_proj projections with the lens, each masked loop
    at the lane-steps this run needs (steps, from loop_steps)."""
    loops = [LOOP_OF[m] for m in (model, digital) if m in LOOP_OF]
    check(len(set(loops)) == len(loops), f"{model}+{digital}: two loops of one kind")
    ops = n_proj * (PROJECT_BASE_OPS + DISTORT_OPS[model][0]
                    + (1 + DISTORT_OPS[digital][0] if digital else 0))
    for m in (model, digital):
        if m in LOOP_OF:
            ops += DISTORT_OPS[m][1] * steps[LOOP_OF[m]]
    return ops


def same_bits(k, p):
    """Kernel and plain outputs bit-identical: the valid masks, and u, v
    with NaN exactly where the other has NaN."""
    import torch
    for a, b in zip(k, p):
        if a.dtype.is_floating_point:
            if not torch.equal(a.isnan(), b.isnan()):
                return False
            a, b = (torch.where(t.isnan(), 0.0, t).view(torch.int32) for t in (a, b))
        if not torch.equal(a, b):
            return False
    return True


def compare_lens_uv(label, k, p):
    """Phase 8's check of a projection against its plain version: valid
    masks identical, the same non-finite values (a fixed point that
    diverges), finite u and v within LENS_TOL_PX. Returns max |du|, |dv|."""
    import torch
    (uk, vk, valk), (up, vp, valp) = k, p
    check(torch.equal(valk, valp), f"{label}: valid masks differ")
    d = 0.0
    for a, b in ((uk, up), (vk, vp)):
        fin = torch.isfinite(b)
        check(torch.equal(torch.isfinite(a), fin)
              and torch.equal(a[~fin].isnan(), b[~fin].isnan()),
              f"{label}: non-finite values differ")
        ok = valk & fin
        if bool(ok.any()):
            d = max(d, float((a - b).abs()[ok].max()))
    check(d <= LENS_TOL_PX, f"{label}: u/v differ by {d}")
    return d


def lens_phase(dev, smi, workdir, mgr, planes, dev_planes, kernel_ms, pre_coords, out_cf,
               drive, drive_window, expect, device_rows, ptxas):
    """Phase 8: every lens model and digital lens through gf_coords,
    gf_coords_gen and gf_fused against their plain versions at the 4K Y
    plane's shapes, with times, bounds and (gf_coords) registers; a masked
    loop's mean lane-steps and mean warp-max steps (what the kernel runs);
    then the slice's frames (a)-(d) through process_pixels and the window of
    a manager built with each lens. Returns (entries for the kernels line,
    report)."""
    import torch
    from gyroflow_torch.ops import cuda_coords, cuda_fused, remap
    from gyroflow_torch.ops.kernel_params import dyn_to_torch

    phase("every lens model and digital lens: gf_coords (4K Y), gf_coords_gen and gf_fused vs "
          "plain torch on the card")
    cfg0, dyn0, mats = plane_setup(mgr, planes, 500_000, "Y", 8)
    img = dev_planes["Y"]
    bg = plane_bg(dyn0, img)
    ow, oh = cfg0.out_buffer
    n_px, C = ow * oh, img.shape[2]
    table, plane_bytes = mats.numel() * 4, img.numel() * img.element_size()
    rows = {}
    for model, digital in lenses():
        name = lens_name(model, digital)
        cfg, dyn = with_lens(cfg0, dyn0, model, digital)
        x, y, idx = pre_coords(cfg, dyn, mats)
        k = cuda_coords.project(x, y, idx, mats, cfg, dyn)
        p, steps, lane_steps = loop_steps(
            lambda: cuda_coords.project_plain(x, y, idx, mats, cfg, dyn))
        torch.cuda.synchronize()
        n_valid = int(p[2].sum())
        ops = lens_ops(model, digital, n_px, steps)
        form = f"coords<{model}>" if model != "opencv_fisheye" else "coords"
        if digital:
            form = f"coords<{model},digital>"
        r = {"model": model, "digital": digital, "ptxas": ptxas.get(form, "not reported"),
             "loop_steps_per_px": {m: steps[LOOP_OF[m]] / n_px
                                   for m in (model, digital) if m in LOOP_OF},
             "warp_max_steps": {m: warp_max_steps(lane_steps[LOOP_OF[m]], ow)
                                for m in (model, digital) if m in LOOP_OF},
             "coords": {"err": compare_lens_uv(f"coords {name}", k, p),
                        "ms": kernel_ms(lambda: cuda_coords.project(x, y, idx, mats, cfg, dyn)),
                        "plain_ms": cuda_ms(lambda: cuda_coords.project_plain(
                            x, y, idx, mats, cfg, dyn), reps=3, warm=1),
                        "bound": bound([(n_px * 21 + table, ops)])}}
        if digital is None:
            cf = out_cf(cfg, dyn_to_torch(dyn, dev))
            gk = cuda_coords.project_gen(cfg, dyn, mats, oh, 0, *cf)
            gp, gsteps, _ = loop_steps(lambda: cuda_coords.project_gen_plain(cfg, dyn, mats, oh,
                                                                             0, *cf))
            torch.cuda.synchronize()
            r["coords_gen"] = {
                "err": compare_lens_uv(f"gen {name}", gk, gp),
                "ms": kernel_ms(lambda: cuda_coords.project_gen(cfg, dyn, mats, oh, 0, *cf)),
                "plain_ms": cuda_ms(lambda: cuda_coords.project_gen_plain(
                    cfg, dyn, mats, oh, 0, *cf), reps=3, warm=1),
                "bound": bound([(table + n_px * 9,
                                 n_px * GEN_PRE_OPS + lens_ops(model, digital, 2 * n_px, gsteps))])}
        fk = cuda_fused.remap_fused(img, x, y, idx, mats, cfg, dyn, bg, MAXV)
        fp = cuda_fused.remap_fused_plain(img, x, y, idx, mats, cfg, dyn, bg, MAXV)
        torch.cuda.synchronize()
        df = float((fk - fp).abs().max())
        check(bool(torch.isfinite(fk).all()) and df <= SAMPLER_TOL,
              f"fused {name}: differs from its plain version by {df}")
        r["fused"] = {"err": df,
                      "ms": kernel_ms(lambda: cuda_fused.remap_fused(img, x, y, idx, mats, cfg,
                                                                     dyn, bg, MAXV)),
                      "plain_ms": cuda_ms(lambda: cuda_fused.remap_fused_plain(
                          img, x, y, idx, mats, cfg, dyn, bg, MAXV), reps=3, warm=1),
                      "bound": bound([(plane_bytes + table + n_px * (12 + 4 * C),
                                       ops + n_valid * (POST_OPS + sampler_ops(C)))])}
        loops = "".join(f" {m} loop steps {v:.3f}/px, warp-max {r['warp_max_steps'][m]:.3f} "
                        f"of {10 if m == 'gopro' else 12};"
                        for m, v in r["loop_steps_per_px"].items())
        print(f"{name:32s} valid {n_valid / n_px:.4f};{loops} {form} ptxas {r['ptxas']}; "
              + "; ".join(
            f"{kind} max|d| {v['err']:.3g} kernel {v['ms']:.4f} ms plain {v['plain_ms']:.4f} ms "
            f"bound {v['bound'][0]:.4f} ({v['bound'][1]}, "
            f"{100.0 * v['bound'][0] / v['ms']:.1f}%)"
            for kind, v in r.items() if kind in ("coords", "coords_gen", "fused")))
        rows[name] = r

    cfg, dyn = with_lens(cfg0, dyn0, "insta360", None, lens_correction=0.5)
    pre_ms = cuda_ms(lambda: pre_coords(cfg, dyn, mats), reps=1, warm=1)
    _, pre_rows = device_rows(lambda i: pre_coords(cfg, dyn, mats), 1)
    print(f"insta360 with lens correction 0.5: coords_pre (eager torch, 200 masked fixed-point "
          f"steps) on the 4K Y plane {pre_ms:.1f} ms (CUDA events), device busy "
          f"{sum(r[1] for r in pre_rows):.1f} ms over {sum(r[2] for r in pre_rows):.0f} kernels "
          f"(torch.profiler); not fixed here ({smi})")

    # ---- the slice's frames through a manager with each lens ----------------
    slices, lens_mgrs = {}, {}
    win_ts = [int(round((i + 20) * 1e6 / FPS)) for i in range(WINDOW)]
    for label, lens, interpolation in SLICES:
        key = lens_name(lens.get("model", "opencv_fisheye"), lens.get("digital"))
        phase(f"slice frame {label} ({key}, interpolation {interpolation}): process_pixels and "
              f"process_pixels_window, 4K 10-bit YUV420")
        if key not in lens_mgrs:
            lens_mgrs[key] = make_manager(dev, workdir, **lens)
        lm = lens_mgrs[key]
        sampler = "ewa" if interpolation in remap.EWA_BC else "sampler"
        n_win = EWA_WINDOW if sampler == "ewa" else WINDOW
        # the slice's coords launch: the self-contained kernel (its EWA form
        # for EWA) for a plane that remap_plane_cuda routes to it
        cfg0 = plane_setup(lm, planes, win_ts[0], "Y", interpolation)[0]
        coords = "coords_gen" if cuda_coords.gen_admits(cfg0) else "coords"
        counts = drive(interpolation, expect(**{coords: 2 * FRAMES, sampler: 2 * FRAMES}),
                       m=lm)
        wcounts = drive_window(interpolation, n_win,
                               expect(**{coords: 2 * n_win, sampler: 2 * n_win}), m=lm)

        def frame(i):
            for nm in ("Y", "UV"):
                lm.process_pixels(int(round((i + 10) * 1e6 / FPS)), dev_planes[nm],
                                  interpolation=interpolation, plane_index=planes[nm][0],
                                  max_pixel_value=MAXV, plane_rects=True)

        win = {nm: dev_planes[nm][None].expand(n_win, *dev_planes[nm].shape).contiguous()
               for nm in ("Y", "UV")}

        def window():
            for nm in ("Y", "UV"):
                lm.process_pixels_window(win_ts[:n_win], win[nm], None,
                                         interpolation=interpolation,
                                         plane_index=planes[nm][0], max_pixel_value=MAXV,
                                         plane_rects=True)

        def host_ms(fn, n, per):
            ms = []
            for i in range(n):
                lm._stab_cache.clear()
                lm._mats_dev.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / per)
            return statistics.median(ms)

        frame(0)
        window()
        frame_ms = host_ms(frame, 5, 1)
        window_ms = host_ms(lambda i: window(), 3, n_win)
        lm._stab_cache.clear()
        lm._mats_dev.clear()
        wall, dev_rows = device_rows(lambda i: frame(i + 40), 3)
        busy = sum(r[1] for r in dev_rows)
        del win
        slices[label] = {"lens": key, "interpolation": interpolation, "launches": counts,
                         "window_launches": wcounts, "frame_ms": frame_ms,
                         "window_ms_per_frame": window_ms, "profiled_wall_ms": wall,
                         "device_ms": busy, "kernels_per_frame": sum(r[2] for r in dev_rows)}
        print(f"slice {label}: process_pixels Y+UV {frame_ms:.3f} ms/frame (host clock, median "
              f"of 5), process_pixels_window (F = {n_win}) {window_ms:.3f} ms/frame (median of "
              f"3); under torch.profiler {wall:.3f} ms/frame, device busy {busy:.3f} ms "
              f"({100.0 * busy / wall:.1f}%) over {slices[label]['kernels_per_frame']:.0f} "
              f"kernels; {smi}")

    # ---- the kernels line's entries: the instantiations besides fisheye ------
    launched = {}
    for sl in slices.values():
        for kind in ("coords", "coords_gen"):
            launched[sl["lens"], kind] = (launched.get((sl["lens"], kind), 0)
                                          + sl["launches"][kind] + sl["window_launches"][kind])
    sources = {"coords": ("gyroflow_torch/csrc/coords.cu", "gyroflow_tpu/ops/pallas_coords.py:68"),
               "coords_gen": ("gyroflow_torch/csrc/coords.cu",
                              "gyroflow_tpu/ops/pallas_coords.py:257"),
               "fused": ("gyroflow_torch/csrc/fused.cu", "gyroflow_tpu/ops/pallas_fused.py:57")}
    entries = []
    for name, r in rows.items():
        if name == "opencv_fisheye":       # the existing coords, coords_gen, fused entries
            continue
        for kind in ("coords", "coords_gen", "fused"):
            if kind not in r:
                continue
            v = r[kind]
            entries.append({"name": f"{kind}<{name}>", "route": "cuda",
                            "source": sources[kind][0], "replaces": sources[kind][1],
                            "launches": launched.get((name, kind), 0),
                            "max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
                            "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
                            "library_ms": None})
    check("jax" not in sys.modules, "jax was imported")
    return entries, {"lenses": rows, "insta360_lens_correction_coords_pre_ms": pre_ms,
                     "slices": slices}


def mesh_ops(gh, mesh=True, fpd_steps=None):
    """FP32 operations of one pixel's mesh stage (lens.cuh), counted as
    PROJECT_OPS is: the crop maps in and out (14), the x segment (8) and the
    y segment with its edge tests (8), which both channels share; per
    channel, the x spline pieces of the gh grid rows (8 each) and the y
    spline (the recurrence 7 a row, the backward pass 2 a row, the piece's b
    and d 8, its evaluation 12). The launch-uniform constants (h, 1 / h,
    3 / h, h / 3, 3 h, the spans and the band) come from the host's packed
    block and are not counted; reading segment fi's coefficients is a load,
    and the selects by which the kernel reads a piece out of its registers
    (`pick`) are not counted either. fpd_steps: the focal-plane shear's mean
    loop steps a pixel at this run's inputs (4 operations each besides its 7
    tests), or None without FPD (the rest 29)."""
    ops = 0
    if mesh:
        spline = 7 * (gh - 2) + 2 * (gh - 1) + 8 + 12
        ops += 30 + 2 * (8 * gh + spline)
    if fpd_steps is not None:
        ops += 29 + 7 + 4 * fpd_steps
    return ops


OVERLAY_BASE_OPS = 30       # source-rect test 4, two canvas fetches 16, safe-area dim 10
# per blended canvas byte: its alpha 2, then per channel 5 (colour scale, blend)


def canvas_reach(canvas, scale, points):
    """The number of distinct canvas bytes the overlay needs: the byte under
    each point (x, y) where its gate holds and it lies on the canvas, as
    remap._canvas_fetch finds it; points is a list of (x, y, gate or None)."""
    import torch
    hc, wc = canvas.shape
    seen = torch.zeros(hc * wc, dtype=torch.bool, device=canvas.device)
    for x, y, gate in points:
        xi, yi = torch.floor(x / scale), torch.floor(y / scale)
        inb = (xi >= 0) & (yi >= 0) & (xi < wc) & (yi < hc)
        if gate is not None:
            inb = inb & gate
        seen[(yi[inb].to(torch.int64) * wc + xi[inb].to(torch.int64))] = True
    return int(seen.sum())


def sony_phase(dev, smi, workdir, planes, dev_planes, kernel_ms, driven, expect, drive,
               drive_window, device_rows, out_cf, ptxas, keep=None):
    """Phase 9: a synthesised 4K Sony clip (sony lens, IBIS, a 9x9 lens mesh
    and FPD on every frame). The mesh form of gf_coords and the overlay
    kernel against their plain versions at the 4K planes' shapes, with
    times and bounds; then the clip's frames through process_pixels,
    process_pixels_window (F = 8), render() of an 8-frame y4m, an EWA frame,
    an ST-map export and one overlay frame (tracking points and a safe-area
    rect from manager.draw_overlays), each held at 0 codes from the plain
    path. keep, a dict, gets the Sony manager ("manager") and its window's
    planes ("window"), which phase 10 holds its sharded window to. Returns
    (entries for the kernels line, report)."""
    import numpy as np
    import torch
    from gyroflow_torch.core.drawing import DrawCanvas
    from gyroflow_torch.ops import cuda_coords, cuda_overlay, cuda_sampler, remap
    from gyroflow_torch.ops.kernel_params import (DRAWING_ENABLED, HAS_FPD_DATA, HAS_IBIS_DATA,
                                                  HAS_MESH_DATA, dyn_to_torch)
    from gyroflow_torch.render.formats import RAW_FORMATS
    from gyroflow_torch.render.renderer import RenderOptions, _plane_backgrounds, render
    from gyroflow_torch.render.y4m_io import Y4MReader
    from gyroflow_torch.sync.pose_estimator import FrameResult, PoseEstimator
    from gyroflow_torch.utils import stmap

    phase(f"Sony clip: a {SONY_FRAMES}-frame {W}x{H} clip with IBIS, a {SONY_GRID}x{SONY_GRID} "
          f"lens mesh and FPD; the mesh form of gf_coords and the overlay kernel vs plain torch")
    sm = make_sony_manager(dev, workdir)
    keep = {} if keep is None else keep
    keep["manager"] = sm
    ts0 = 500_000
    cfg0 = sm.frame_transform_at(sm._adjusted_ts_ms(ts0)).kernel_cfg
    check(cfg0.distortion_model == "sony" and cfg0.mesh_grid == (SONY_GRID, SONY_GRID)
          and all(cfg0.has(f) for f in (HAS_MESH_DATA, HAS_FPD_DATA, HAS_IBIS_DATA)),
          f"Sony clip: cfg {cfg0}")
    rows, ov_rows = {}, {}
    canvas = DrawCanvas(W, H, W, H)
    est = PoseEstimator(sm.get_compute_params(), (W, H))
    rng = np.random.default_rng(11)
    p0 = np.stack([rng.uniform(0, W, 400), rng.uniform(0, H, 400)], -1)
    est.results[ts0] = FrameResult(ts0, of_points=(p0, p0 + rng.normal(0, 3.0, p0.shape)),
                                   next_ts=ts0 + 33_333, points=400)
    sm.pose_estimator = est
    sm.params.show_detected_features = True
    sm.draw_overlays(canvas, ts0)
    sm.params.show_detected_features = False
    drawing = canvas.state(safe_area_rect=(0.1 * W, 0.1 * H, 0.9 * W, 0.9 * H))
    check(int((drawing.canvas > 0).sum()) > 0, "overlay: draw_overlays drew nothing")
    dcanvas = torch.from_numpy(drawing.canvas).to(dev)
    for name in ("Y", "UV"):
        cfg, dyn, mats = plane_setup(sm, planes, ts0, name, 8)
        mesh = plane_mesh(sm, ts0)
        dyn_t = dyn_to_torch(dyn, dev)
        cf = out_cf(cfg, dyn_t)
        ow, oh = cfg.out_buffer
        oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                                torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
        probe = remap.mesh_probe(mats, cfg, dyn, mesh)
        x, y, idx = remap.coords_pre(ox, oy, mats, cfg, dyn_t, *cf, mesh=mesh, probe=probe)
        _, _, idx_plain = remap.coords_pre(ox, oy, mats, cfg, dyn_t, *cf, mesh=mesh)
        check(torch.equal(idx, idx_plain), f"mesh {name}: the kernel probe selected other rows")
        k = cuda_coords.project(x, y, idx, mats, cfg, dyn, mesh)
        p = cuda_coords.project_plain(x, y, idx, mats, cfg, dyn, mesh)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        d = max(float((a - b).abs()[k[2]].max()) for a, b in zip(k[:2], p[:2]))
        print(f"coords<sony,mesh+fpd> {name:2s} ({oh}x{ow}): max|d| {d:.3g} px over valid pixels, "
              f"bit-identical {same} (limit: identical); kernel probe rows identical True")
        check(same, f"mesh {name}: the coords kernel differs from its plain version")
        # the FPD loop's steps at these inputs: the band index of each pixel
        nofpd = cfg._replace(flags=cfg.flags & ~HAS_FPD_DATA)
        um, vm, _ = cuda_coords.project_plain(x, y, idx, mats, nofpd, dyn, mesh)
        size_y, oyc, chc = (float(mesh[i]) for i in (4, 6, 8))
        mv = (vm * ((oyc + chc) - oyc)) * float(np.float32(1.0) / np.float32(cfg.height)) + oyc
        fpd_steps = float(torch.clamp(torch.floor(mv / (size_y / 8.0)), 0.0, 7.0).mean())
        n_px = ow * oh
        ops = n_px * (PROJECT_BASE_OPS + DISTORT_OPS["sony"][0] + IBIS_OPS
                      + mesh_ops(SONY_GRID, True, fpd_steps))
        # the kernel reads the packed block of the buffer, not its reference part
        block_bytes = (mesh.numel() - cuda_coords.mesh_block_offset(cfg)) * 4
        rows[name] = {"err": d, "fpd_steps_per_px": fpd_steps,
                      "ms": kernel_ms(lambda: cuda_coords.project(x, y, idx, mats, cfg, dyn, mesh)),
                      "probe_ms": kernel_ms(lambda: probe(x, y)),
                      "plain_ms": cuda_ms(lambda: cuda_coords.project_plain(
                          x, y, idx, mats, cfg, dyn, mesh), reps=3, warm=1),
                      "bound": (n_px * 21 + mats.numel() * 4 + block_bytes, ops)}
        # the overlay kernel on this plane's sampled pixels and positions
        u, v = remap.coords_post_uv(k[0], k[1], cfg)
        img = dev_planes[name]
        pixel = cuda_sampler.sample(img, u, v, k[2], plane_bg(dyn, img), cfg.src_rect, 8, MAXV)
        oargs = (pixel, u, v, dcanvas, drawing.scale, drawing.safe_area_rect, cfg.src_rect, MAXV)
        ok_ = cuda_overlay.overlay(*oargs)
        op_ = cuda_overlay.overlay_plain(*oargs)
        torch.cuda.synchronize()
        same = torch.equal(ok_, op_)
        print(f"overlay {name:2s} ({tuple(pixel.shape)} float32, canvas {tuple(dcanvas.shape)}): "
              f"max|d| {float((ok_ - op_).abs().max()):.3g} codes, bit-identical {same}; pixels "
              f"changed {int((op_ != pixel).any(-1).sum())}")
        check(same, f"overlay {name}: the kernel differs from its plain version")
        s_t = torch.full((), float(drawing.scale), dtype=torch.float32, device=dev)
        d_in = remap._canvas_fetch(dcanvas, u, v, s_t)
        d_out = remap._canvas_fetch(dcanvas, ox, oy, s_t)
        src_in = ((v >= cfg.src_rect[1]) & (v < cfg.src_rect[1] + cfg.src_rect[3])
                  & (u >= cfg.src_rect[0]) & (u < cfg.src_rect[0] + cfg.src_rect[2]))
        n_blend = int(((d_in > 0) & ((d_in >> 3) < 9) & src_in & ((d_in & 1) == 0)).sum()
                      + ((d_out > 0) & ((d_out >> 3) < 9) & ((d_out & 1) == 1)).sum())
        C = pixel.shape[2]
        # the canvas bytes the fetches need: at (u, v) inside the source
        # rect (the input stage's gate) and at every output pixel
        reach = canvas_reach(dcanvas, s_t, [(u, v, src_in), (ox, oy, None)])
        ov_rows[name] = {
            "err": float((ok_ - op_).abs().max()), "blended": n_blend, "canvas_bytes": reach,
            "ms": kernel_ms(lambda: cuda_overlay.overlay(*oargs)),
            "plain_ms": cuda_ms(lambda: cuda_overlay.overlay_plain(*oargs), reps=3, warm=1),
            "bound": (n_px * (8 * C + 8) + reach,
                      n_px * (OVERLAY_BASE_OPS + C) + n_blend * (2 + 5 * C))}
    for label, r in (("coords<sony,mesh+fpd>", rows), ("overlay", ov_rows)):
        for name, v in r.items():
            b = bound([v["bound"]])
            print(f"{label} {name:2s}: kernel {v['ms']:.4f} ms"
                  + (f" (the full-plane probe launch, mesh_probe's shape: {v['probe_ms']:.4f} "
                     f"ms)" if "probe_ms" in v else "")
                  + f", plain {v['plain_ms']:.4f} ms, "
                  f"bound {b[0]:.4f} ms ({b[1]}, {100.0 * b[0] / v['ms']:.1f}%)"
                  + (f", FPD loop steps {v['fpd_steps_per_px']:.3f}/px of 7"
                     if "fpd_steps_per_px" in v else "")
                  + (f", canvas bytes read {v['canvas_bytes']}" if "canvas_bytes" in v else "")
                  + f"; {smi}")

    # ---- the clip through the manager's entry points -------------------------
    ts_list = [int(round((i + 5) * 1e6 / FPS)) for i in range(FRAMES)]
    phase(f"Sony clip: process_pixels, {FRAMES} frames of 4K 10-bit YUV420, lanczos4 (the probe "
          f"and the projection on the coords kernel: 2 launches a plane)")
    launches = drive(8, expect(coords=4 * FRAMES, sampler=2 * FRAMES), m=sm, tol=0)
    phase(f"Sony clip: process_pixels_window, {WINDOW} timestamps, lanczos4")
    launches_window = drive_window(8, WINDOW, expect(coords=4 * WINDOW, sampler=2 * WINDOW),
                                   m=sm, tol=0, keep=keep.setdefault("window", {}))
    phase(f"Sony clip: process_pixels, {FRAMES} frames, interpolation {EWA_INTERP} (the probe "
          f"and the stacked 3-eval launch)")
    launches_ewa = drive(EWA_INTERP, expect(coords=4 * FRAMES, ewa=2 * FRAMES), m=sm, tol=0)

    phase(f"Sony clip: an {WINDOW}-frame {W}x{H} 10-bit YUV420 .y4m through render()")
    work = Path(workdir)
    clip, rendered = work / "chip_smoke_sony.y4m", work / "chip_smoke_sony_render.y4m"
    write_clip(clip, planes, WINDOW)
    with driven("render", expect(coords=4 * WINDOW, sampler=2 * WINDOW),
                frames=WINDOW) as launches_render:
        render_stats = render(sm, str(clip), str(rendered),
                              RenderOptions(interpolation=8, frame_window=WINDOW))
    check(render_stats["frames"] == WINDOW and render_stats["backend"] == "cuda-window",
          f"Sony render: stats {render_stats}")
    bgs = _plane_backgrounds(RAW_FORMATS["yuv420p10le"], sm.params.background, True)
    rin, rout = Y4MReader(str(clip)), Y4MReader(str(rendered))
    n_out, d_render = 0, 0
    try:
        for (ts, p_in), (_, p_out) in zip(rin, rout):
            for pi, src, got in ((0, p_in[0], p_out[0]),
                                 (1, np.concatenate(p_in[1:], -1), np.concatenate(p_out[1:], -1))):
                name = "Y" if pi == 0 else "UV"
                ts_ms = sm._adjusted_ts_ms(ts)
                ft = sm.frame_transform_at(ts_ms)
                cfg, dyn = sm._plane_cfg_dyn(ft, src.shape, 8, pi, MAXV, True, bgs[pi], None)
                mats, mesh = sm._mats_on_device(ts_ms, ft)
                want = remap.remap_plane(torch.from_numpy(np.array(src)).to(dev), mats, cfg, dyn,
                                         mesh, out_dtype="uint16").cpu().numpy()
                d_render = max(d_render, int(np.abs(want.astype(np.int32)
                                                    - got.astype(np.int32)).max()))
            n_out += 1
    finally:
        rin.close()
        rout.close()
    print(f"Sony render: {n_out} frames (expected {WINDOW}); vs the plain path on the decoded "
          f"planes max|d| {d_render} codes (limit 0); {render_stats['fps']} fps "
          f"(host clock; {smi})")
    check(n_out == WINDOW and d_render == 0, "Sony render: output frames")
    for f in (clip, rendered):
        f.unlink()

    phase("Sony clip: ST maps (export_stmaps; the undistort map's projection on the coords "
          "kernel, the redistort map on the host points path)")
    st_dir = work / "sony_stmaps"
    t0 = time.perf_counter()
    # a single-frame export zeroes the readout time: one matrix row, so the
    # undistort map is one coords launch with no rolling-shutter probe
    with driven("export_stmaps", expect(coords=1), frames=1) as launches_stmap:
        stmap.export_stmaps(sm, str(st_dir), single_frame=True, ext=".npy")
    files = sorted(f.name for f in st_dir.iterdir())
    und = np.load(st_dir / next(f for f in files if "undistort" in f))
    red = np.load(st_dir / next(f for f in files if "redistort" in f))
    print(f"export_stmaps: {files} in {time.perf_counter() - t0:.2f} s (host clock; {smi})")
    check(len(files) == 2 and bool(np.isfinite(und).all()) and bool(np.isfinite(red).all()),
          "Sony export_stmaps: files")
    # the exported frame, and a per-frame map (its readout time kept: one
    # matrix row per image row, so the rolling-shutter probe runs on the
    # coords kernel, stmap.undistort_uv's mesh_probe), each against the plain
    # undistort_coord on the same inputs
    st_frame = 5
    with driven("undistort_uv(per_frame=True)", expect(coords=2), frames=1) as launches_stprobe:
        k_rs = stmap.undistort_uv(sm, st_frame * 1000.0 / FPS, per_frame=True, frame=st_frame)
    for label, ts, per_frame, k in (("single-frame", 0.0, False, stmap.undistort_uv(sm, 0.0)),
                                    ("per-frame", st_frame * 1000.0 / FPS, True, k_rs)):
        ox, oy, smats, scfg, sdyn, out_c, out_f, smesh = stmap.undistort_inputs(
            sm, ts, per_frame, st_frame if per_frame else 0)
        check(smesh is not None, "Sony ST map: no mesh buffer")
        check(smats.shape[0] > 1 if per_frame else smats.shape[0] == 1,
              f"Sony ST map {label}: {smats.shape[0]} matrix rows")
        p = remap.undistort_coord(ox, oy, smats, scfg, dyn_to_torch(sdyn, dev), out_c, out_f,
                                  mesh=smesh)
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        print(f"Sony ST map undistort, {label} ({smats.shape[0]} matrix rows; coords kernel) vs "
              f"plain undistort_coord: bit-identical {same}")
        check(same, f"Sony ST map {label}: the kernel path differs from the plain path")

    phase("Sony clip: one overlay frame (tracking points and a safe-area rect from "
          "manager.draw_overlays) through process_pixels")
    outs = {}
    with driven("overlay frame", expect(coords=4, sampler=2, overlay=1),
                frames=1) as launches_overlay:
        for name in ("Y", "UV"):
            pi, host = planes[name]
            outs[name] = sm.process_pixels(ts0, host, interpolation=8, plane_index=pi,
                                           max_pixel_value=MAXV, plane_rects=True,
                                           drawing=drawing if pi == 0 else None)[0]
    for name in ("Y", "UV"):
        pi = planes[name][0]
        cfg, dyn, mats = plane_setup(sm, planes, ts0, name, 8)
        if pi == 0:
            cfg = cfg._replace(flags=cfg.flags | DRAWING_ENABLED)
        want = remap.remap_plane(dev_planes[name], mats, cfg, dyn, plane_mesh(sm, ts0),
                                 drawing=drawing if pi == 0 else None, out_dtype="uint16")
        d = int((outs[name].to(torch.int32) - want.to(torch.int32)).abs().max())
        print(f"overlay frame {name:2s}: vs the plain path max|d| {d} codes (limit 0)")
        check(d == 0, f"overlay frame {name}: differs from the plain path")

    # the drawing on row bands (remap_plane_cuda(out_rows, oy0)), cut inside
    # the safe-area rect's 5-px border at its top and bottom edges
    phase("Sony clip: the overlay frame's Y plane in 3 row bands through remap_plane_cuda("
          "out_rows, oy0), the bands against the whole plane")
    cfg, dyn, mats = plane_setup(sm, planes, ts0, "Y", 8)
    cfg = cfg._replace(flags=cfg.flags | DRAWING_ENABLED)
    mesh = plane_mesh(sm, ts0)
    whole = remap.remap_plane_cuda(dev_planes["Y"], mats, cfg, dyn, mesh, drawing=drawing,
                                   out_dtype="uint16")
    top, bottom = int(round(0.1 * H)) - 2, int(round(0.9 * H)) + 2
    cuts = (0, top, bottom, H)
    with driven("overlay bands", expect(coords=2 * 3, sampler=3, overlay=3),
                frames=1) as launches_bands:
        got = torch.cat([remap.remap_plane_cuda(dev_planes["Y"], mats, cfg, dyn, mesh,
                                                drawing=drawing, out_dtype="uint16",
                                                out_rows=b - a, oy0=a)
                         for a, b in zip(cuts[:-1], cuts[1:])])
    d = int((got.to(torch.int32) - whole.to(torch.int32)).abs().max())
    print(f"overlay bands Y (rows {cuts}): {tuple(got.shape)} {got.dtype}; vs the whole plane "
          f"max|d| {d} codes (limit 0); vs the overlay frame's Y {int((got != outs['Y']).sum())} "
          f"px differ")
    check(d == 0, "overlay bands: differ from the whole plane")

    # ---- where a Sony frame's device time goes ---------------------------------
    def frame(i):
        for name in ("Y", "UV"):
            sm.process_pixels(int(round((i + 40) * 1e6 / FPS)), dev_planes[name],
                              interpolation=8, plane_index=planes[name][0],
                              max_pixel_value=MAXV, plane_rects=True)

    frame(0)
    sm._stab_cache.clear()
    sm._mats_dev.clear()
    wall, dev_rows = device_rows(frame, 3)
    busy = sum(r[1] for r in dev_rows)
    n_k = sum(r[2] for r in dev_rows)
    form = f"coords<sony,mesh,{SONY_GRID} rows>"
    print(f"the mesh form's registers and spills ({form}, ptxas): "
          f"{ptxas.get(form, 'not reported')}; for a grid height read at run time "
          f"(coords<sony,mesh>): {ptxas.get('coords<sony,mesh>', 'not reported')}; "
          f"the fisheye plain form "
          f"(coords): {ptxas.get('coords', 'not reported')}; the fisheye digital form "
          f"(coords<opencv_fisheye,digital>): "
          f"{ptxas.get('coords<opencv_fisheye,digital>', 'not reported')}")
    print(f"Sony frame (Y+UV, lanczos4): under torch.profiler {wall:.3f} ms/frame, device busy "
          f"{busy:.3f} ms ({100.0 * busy / wall:.1f}%) over {n_k:.0f} kernels a frame (with the "
          f"mesh form before its redesign: 2.586 ms over 123, PERF.md section 5, NVIDIA H100 "
          f"80GB HBM3, 700.00 W); {smi}")
    for key, ms, n in dev_rows[:6]:
        print(f"  {ms:8.3f} ms/frame  {n:5.0f} launches/frame  {key[:100]}")

    n_coords = sum(c["coords"] for c in (launches, launches_window, launches_ewa,
                                          launches_render, launches_stmap, launches_stprobe,
                                          launches_overlay, launches_bands))
    b_c = bound([rows[n]["bound"] for n in ("Y", "UV")])
    b_o = bound([ov_rows[n]["bound"] for n in ("Y", "UV")])
    entries = [
        {"name": "coords<sony,mesh+fpd>", "route": "cuda",
         "source": "gyroflow_torch/csrc/coords.cu",
         "replaces": "gyroflow_tpu/ops/pallas_coords.py:68", "launches": n_coords,
         "max_abs_err": max(r["err"] for r in rows.values()),
         "ms": sum(r["ms"] for r in rows.values()),
         "plain_ms": sum(r["plain_ms"] for r in rows.values()),
         "bound_ms": b_c[0], "bound_by": b_c[1], "library_ms": None},
        {"name": "overlay", "route": "cuda", "source": "gyroflow_torch/csrc/overlay.cu",
         "replaces": "gyroflow_tpu/ops/pallas_sampler.py:536",
         "launches": launches_overlay["overlay"] + launches_bands["overlay"],
         "max_abs_err": max(r["err"] for r in ov_rows.values()),
         "ms": sum(r["ms"] for r in ov_rows.values()),
         "plain_ms": sum(r["plain_ms"] for r in ov_rows.values()),
         "bound_ms": b_o[0], "bound_by": b_o[1], "library_ms": None}]
    check("jax" not in sys.modules, "jax was imported")
    return entries, {"coords_mesh": rows, "overlay": ov_rows,
                     "launches": {"process_pixels": launches, "window": launches_window,
                                  "ewa": launches_ewa, "render": launches_render,
                                  "stmap": launches_stmap, "stmap_per_frame": launches_stprobe,
                                  "overlay": launches_overlay, "overlay_bands": launches_bands},
                     "render": render_stats, "profiled_wall_ms": wall, "device_ms": busy,
                     "kernels_per_frame": n_k}


def sharded_phase(dev, smi, mgr, planes, win_ts, windows, driven, expect, device_rows):
    """Phase 10: the production window over a (dp, sp) mesh of logical
    shards on the card (parallel.pipeline; each (frame, row band) through
    remap_plane_cuda(out_rows, oy0)): (a) the 4K Y and UV planes over phase
    4e's 8 timestamps on 2 x 2 shards, (b) the EWA window of 2 on 2 x 2, (c)
    4 frames of phase 9's Sony clip on 2 x 2, each frame 0 codes from the
    one-device window of its phase; (d) entry(): the kernel run 0 codes from
    the same step with each wrapper's plain version; (e) dryrun_multichip(4)
    on 4 logical shards; (f) (a) over the real cards when there are more
    than one. Then the host-clock ms per frame of (a) against the one-device
    window, and each one's device busy time under torch.profiler (printed,
    not claimed). Returns the phase's report."""
    import numpy as np
    import torch
    from gyroflow_torch.entry import dryrun_multichip, entry
    from gyroflow_torch.ops import cuda_coords, cuda_sampler
    from gyroflow_torch.parallel import make_frame_mesh

    report = {}
    shards = make_frame_mesh(devices=[dev] * 4, sp=2)

    def sharded(m, n, interpolation, mesh, label, expected, ref):
        """process_pixels_window of m over n timestamps of the Y and UV
        planes on mesh inside driven(); each frame 0 codes from ref."""
        outs = {}
        with driven(label, expected, frames=n) as counts:
            for name in ("Y", "UV"):
                pi, host = planes[name]
                outs[name] = m.process_pixels_window(
                    win_ts[:n], np.stack([host] * n), mesh, interpolation=interpolation,
                    plane_index=pi, max_pixel_value=MAXV, plane_rects=True)
        for name, (out, info) in outs.items():
            host = planes[name][1]
            check(tuple(out.shape) == (n,) + host.shape and out.dtype == torch.uint16
                  and out.device == dev, f"{label} {name}: {tuple(out.shape)} {out.dtype} on "
                                         f"{out.device}")
            check(info["backend"] == "cuda-sharded", f"{label} {name}: {info['backend']}")
            d = int((out.to(torch.int32) - ref[name][:n].to(torch.int32)).abs().max())
            print(f"{label} {name:2s}: {tuple(out.shape)} {out.dtype} on {out.device}, mesh "
                  f"{mesh.shape}; vs the one-device window max|d| {d} codes (limit 0)")
            check(d == 0, f"{label} {name}: the sharded window differs from the one-device one")
        return counts

    bands = 2 * 2   # Y and UV, 2 row bands each
    phase(f"sharded window (a): process_pixels_window, {WINDOW} timestamps of 4K 10-bit YUV420, "
          f"lanczos4, on 2 x 2 logical shards of {dev} (dp 2, sp 2)")
    report["launches_a"] = sharded(mgr, WINDOW, 8, shards, "sharded window (a)",
                                   expect(coords_gen=bands * WINDOW, sampler=bands * WINDOW),
                                   windows["lanczos4"])
    phase(f"sharded window (b): the EWA window of {EWA_WINDOW}, interpolation {EWA_INTERP}, "
          f"on 2 x 2 shards")
    report["launches_b"] = sharded(mgr, EWA_WINDOW, EWA_INTERP, shards, "sharded window (b)",
                                   expect(coords_gen=bands * EWA_WINDOW,
                                          ewa=bands * EWA_WINDOW),
                                   windows["ewa"])
    phase("sharded window (c): 4 frames of the Sony clip on 2 x 2 shards (the probe and the "
          "projection on the coords kernel: 2 launches a band)")
    report["launches_c"] = sharded(windows["sony"]["manager"], 4, 8, shards,
                                   "sharded window (c)", expect(coords=2 * bands * 4,
                                                                sampler=bands * 4),
                                   windows["sony"]["window"])

    phase("entry (d): gyroflow_torch.entry.entry() on cuda:0, the kernels against the plain "
          "versions")
    fn, args = entry()
    with driven("entry()", expect(coords_gen=1, sampler=1), frames=1) as report["launches_d"]:
        out_k = fn(*args)
    saved = (cuda_coords.project_gen, cuda_sampler.sample)
    cuda_coords.project_gen, cuda_sampler.sample = (cuda_coords.project_gen_plain,
                                                    cuda_sampler.sample_plain)
    try:
        out_p = fn(*args)
    finally:
        cuda_coords.project_gen, cuda_sampler.sample = saved
    d = float((out_k - out_p).abs().max())
    print(f"entry(): {tuple(out_k.shape)} {out_k.dtype} on {out_k.device}; kernels vs plain "
          f"versions max|d| {d} codes (limit 0)")
    check(tuple(out_k.shape) == (720, 1280, 1) and bool(torch.isfinite(out_k).all()) and d == 0,
          "entry(): the kernel run differs from the plain run")

    phase("dryrun (e): gyroflow_torch.entry.dryrun_multichip(4) on 4 logical shards of "
          f"{dev} (dp 2, sp 2)")
    with driven("dryrun_multichip(4)", expect(coords_gen=32, sampler=32),
                frames=16) as report["launches_e"]:
        dryrun_multichip(4, devices=[dev] * 4)

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        n = 4 if n_cards >= 4 else 2
        cards = make_frame_mesh(n, sp=2)
        phase(f"sharded window (f): (a) over {n} cards (dp {n // 2}, sp 2)")
        report["launches_f"] = sharded(mgr, WINDOW, 8, cards, "sharded window (f)",
                                       expect(coords_gen=bands * WINDOW,
                                              sampler=bands * WINDOW),
                                       windows["lanczos4"])
    else:
        print(f"sharded window (f): one card present ({torch.cuda.get_device_name(0)}); the "
              f"multi-card run was not exercised")

    phase(f"sharded window times on {smi}")
    staged = {name: torch.as_tensor(np.stack([planes[name][1]] * WINDOW)).to(dev)
              for name in ("Y", "UV")}

    def window_pass(mesh):
        for name in ("Y", "UV"):
            mgr.process_pixels_window(win_ts, staged[name], mesh, interpolation=8,
                                      plane_index=planes[name][0], max_pixel_value=MAXV,
                                      plane_rects=True)

    def per_frame_ms(mesh, reps=3):
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window_pass(mesh)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / WINDOW)
        return statistics.median(ms)

    window_pass(None)
    window_pass(shards)
    wms = [per_frame_ms(None), per_frame_ms(shards), per_frame_ms(shards), per_frame_ms(None)]
    print(f"Y+UV per frame (host clock, median of 3, frames on the card; one device, 2 x 2 "
          f"shards, 2 x 2 shards, one device): {wms[0]:.3f}, {wms[1]:.3f}, {wms[2]:.3f}, "
          f"{wms[3]:.3f} ms (F = {WINDOW}); {smi}")
    report["window_ms"] = {"one_device": [wms[0], wms[3]], "shards_2x2": [wms[1], wms[2]]}
    for label, mesh in (("one device", None), ("2 x 2 shards", shards)):
        wall, rows = device_rows(lambda i: window_pass(mesh), 1)
        wall, busy = wall / WINDOW, sum(r[1] for r in rows) / WINDOW
        n_k = sum(r[2] for r in rows) / WINDOW
        print(f"window on {label} (Y+UV per frame, frame transforms cached): under "
              f"torch.profiler {wall:.3f} ms, device busy {busy:.3f} ms ({100.0 * busy / wall:.1f}%)"
              f" over {n_k:.0f} kernels; {smi}")
        report[f"profile {label}"] = {"wall_ms": wall, "device_ms": busy, "kernels": n_k}
    return report


BENCH_TOL = 0.25            # float32 codes: the bench's primary frame, kernels vs plain path
BENCH_NUMBERS = ("value", "vs_baseline", "per_frame_dispatch_fps", "secondary_8k_y_ms_per_frame",
                 "secondary_8k_y_fps", "production_path_fps", "production_window_fps")


def bench_launches(bench):
    """Coords (and sampler) launches of one bench.main() run: two a 4K
    frame, one an 8K plane, warm-up calls included."""
    frames = ((1 + bench.REPS * bench.CALLS) * bench.F + 1 + bench.REPS * bench.B
              + 1 + bench.REPS * bench.NB + (1 + bench.REPS * bench.WINDOWS) * bench.FW)
    return 2 * frames + 1 + bench.REPS * bench.CALLS_8K


def dispatch_launches(probe):
    """Coords (and sampler) launches of one window_dispatch_probe.run() on
    the card: two a frame step; each reading's warm-up call, its REPS reps
    and its profiled rep."""
    reps = probe.REPS + 1
    frames = 1 + reps * probe.B + sum(F * (1 + reps * probe.windows(F)) for F in probe.WINDOWS)
    return 2 * frames


def bench_phase(dev, smi, driven, expect):
    """Phase 11: the port's measurement path. One primary frame of
    gyroflow_torch.bench (its Y and UV planes through remap_plane_cuda)
    against the plain torch path on the card, within BENCH_TOL; then
    bench.main() at its full size, launch counts set to 0 before and read
    after, its JSON line printed and each of its numbers finite and > 0;
    then the production-path probe and the render-loop probe (its device
    step stubbed: no launch) once each at the 4K size; then the
    window-dispatch probe (its coords and sampler launches counted, every
    reading finite and > 0) and the host pipeline on a 4K 10-bit y4m (no
    launch; each y4m it writes equal to its input). Returns the phase's
    report."""
    import numpy as np
    import torch
    from gyroflow_torch import bench
    from gyroflow_torch.experiments import (host_pipeline_bench, prod_path_probe,
                                            renderer_loop_bench, window_dispatch_probe)
    from gyroflow_torch.ops import remap

    phase("bench: one primary frame (Y 3840x2160x1 + UV 1920x1080x2 float32, lanczos4) "
          "through the kernels against the plain path on the card")
    planes = bench.primary_planes(np.random.default_rng(0), dev, bench.UHD)
    (_, _, y, yl), (_, _, uv, uvm) = planes
    salt = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    errs = {}
    for (cfg, dyn, img, mats), out, name in zip(planes, bench.remap_frame(planes, y, yl, uv, uvm,
                                                                          salt), ("Y", "UV")):
        ref = remap.remap_plane(img + salt, mats, cfg, dyn)
        d = (out - ref).abs()
        errs[name] = float(d.max())
        print(f"bench primary {name} {tuple(out.shape)}: kernels vs plain max|d| {errs[name]:.3g} "
              f"codes over {int((d > 0).sum())} px (limit {BENCH_TOL}); mean "
              f"{float(out.mean()):.2f}")
        check(bool(torch.isfinite(out).all()), f"bench primary {name}: non-finite output")
        check(errs[name] <= BENCH_TOL, f"bench primary {name}: kernels differ from the plain path")
    del planes, y, uv, yl, uvm

    phase(f"bench: gyroflow_torch.bench.main() (the five readings at full size) on {smi}")
    n = bench_launches(bench)
    t0 = time.perf_counter()
    with driven("bench.main", expect(coords_gen=n, sampler=n), frames="all"):
        result = bench.main()
    secs = time.perf_counter() - t0
    for key in BENCH_NUMBERS:
        v = result.get(key)
        check(isinstance(v, float) and math.isfinite(v) and v > 0, f"bench {key}: {v!r}")
    card = result.get("device", {})
    check(card.get("count") == torch.cuda.device_count() and card.get("name")
          and card.get("power_limit"), f"bench device: {card!r}")
    print(f"bench.main {secs:.1f} s: {result['value']:.3f} fps primary, "
          f"{result['per_frame_dispatch_fps']:.3f} per-frame dispatch, "
          f"{result['secondary_8k_y_ms_per_frame']:.3f} ms 8K Y, {result['production_path_fps']:.3f} "
          f"production path, {result['production_window_fps']:.3f} production window; {smi}")

    phase("bench: the production-path probe (experiments.prod_path_probe, 4K)")
    n_probe = 12
    with driven("prod_path_probe", expect(coords_gen=2 * (1 + 4 * n_probe),
                                          sampler=2 * (1 + 4 * n_probe)), frames=n_probe):
        probe = prod_path_probe.run(dev, (W, H), n_probe)
    print(probe.pop("profile"))
    print(json.dumps(probe))
    check(0 < probe["device_busy_ms"] < probe["profiled_frame_ms"],
          f"prod_path_probe: device busy {probe['device_busy_ms']!r} ms of "
          f"{probe['profiled_frame_ms']!r} ms a profiled frame")
    print(f"production frame under torch.profiler: {probe['profiled_frame_ms']:.3f} ms, device "
          f"busy {probe['device_busy_ms']:.3f} ms, idle {100.0 * probe['device_idle_share']:.1f}%; "
          f"{smi}")
    phase("bench: the render-loop probe (experiments.renderer_loop_bench, 4K, device stubbed)")
    with driven("renderer_loop_bench", expect(), frames=renderer_loop_bench.N):
        loop = renderer_loop_bench.run(dev, (W, H), renderer_loop_bench.N)
    print(json.dumps(loop))

    phase("bench: per-frame against windowed dispatch (experiments.window_dispatch_probe, 4K)")
    n_disp = dispatch_launches(window_dispatch_probe)
    with driven("window_dispatch_probe", expect(coords_gen=n_disp, sampler=n_disp),
                frames=n_disp // 2):
        disp = window_dispatch_probe.run(dev, (W, H))
    print(json.dumps(disp))
    for key in ("per_frame",) + tuple(f"window_{F}" for F in window_dispatch_probe.WINDOWS):
        for name, v in disp[key].items():
            check(math.isfinite(v) and v > 0, f"window_dispatch_probe {key} {name}: {v!r}")
        r = disp[key]
        print(f"dispatch {key}: {r['ms_per_frame']:.3f} ms a frame ({r['fps']:.2f} fps); under "
              f"torch.profiler {r['profiled_frame_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle {100.0 * r['device_idle_share']:.1f}%; {smi}")

    phase(f"bench: the host pipeline (experiments.host_pipeline_bench, {host_pipeline_bench.N} "
          f"frames of a 4K 10-bit y4m, the device step an identity on the card)")
    with driven("host_pipeline_bench", expect(), frames=host_pipeline_bench.N):
        host = host_pipeline_bench.run(dev, (W, H), host_pipeline_bench.N)
    print(json.dumps(host))
    for name, st in host["stages"].items():
        check(st["frames"] == host_pipeline_bench.N and all(
            math.isfinite(st[k]) and st[k] > 0 for k in ("steady_fps", "mean_fps")),
            f"host_pipeline_bench {name}: {st!r}")
    for name in ("encode", "async_encode", "device_round_trip"):
        check(host["stages"][name]["output_equals_input"] is True,
              f"host_pipeline_bench {name}: the y4m it wrote differs from its input")
    e = host["stages"]["device_round_trip"]
    check(all(math.isfinite(v) and v > 0 for k in ("stack_ms", "upload_ms", "download_ms")
              for v in e[k].values()), f"host_pipeline_bench copies: {e!r}")
    print(f"host pipeline ({host['workdir']}, {host['cores']} cores), fps steady / mean: "
          + ", ".join(f"{name} {st['steady_fps']:.1f} / {st['mean_fps']:.1f}"
                      for name, st in host["stages"].items())
          + f"; host stack {e['stack_ms']['steady']:.3f} ms a frame, upload "
          f"{e['upload_ms']['steady']:.3f} ms ({e['upload_gb_s']:.2f} GB/s), download "
          f"{e['download_ms']['steady']:.3f} ms ({e['download_gb_s']:.2f} GB/s); {smi}")
    return {"primary_vs_plain": errs, "bench": result, "bench_s": secs,
            "prod_path_probe": probe, "renderer_loop": loop, "window_dispatch": disp,
            "host_pipeline": host}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "gyroflow_torch" / "csrc").is_dir():
        print(f"chip_smoke: gyroflow_torch/csrc not found next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from gyroflow_torch import _build
    from gyroflow_torch.experiments import perf_probe
    from gyroflow_torch.ops import (cuda_coords, cuda_ewa, cuda_fused, cuda_overlay, cuda_sampler,
                                    remap)

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
    report["ptxas"] = ptxas_summary(_build.build_log)
    for name, info in report["ptxas"].items():
        print(f"  ptxas {name}: {info}")
    report["build_s"] = secs

    # ---- the manager (frame transform for phases 3-5) ----------------------
    tmp = tempfile.TemporaryDirectory()
    mgr = make_manager(dev, tmp.name)
    planes = make_planes()

    def kernel_ms(fn):
        """A kernel's device time: L2 flushed and the card spinning ahead of
        each call (experiments.perf_probe.cuda_ms), so the host's wrapper
        work stays out of the reading."""
        return perf_probe.cuda_ms(fn, dev)

    from gyroflow_torch.ops.kernel_params import dyn_to_torch

    def out_cf(cfg, dyn_t):
        """(out_c, out_f) as remap._remap builds them."""
        factor = torch.clamp_min(1.0 - dyn_t.lens_correction_amount, 0.001)
        return ((cfg.output_width / 2.0, cfg.output_height / 2.0),
                (dyn_t.f[0] / dyn_t.fov / factor, dyn_t.f[1] / dyn_t.fov / factor))

    def grid_and_pre(cfg, dyn_t, mats, cf, ewa=False):
        """The plane's output grid, then coords_pre (or the EWA stack) on
        it, as remap_plane_cuda runs them: x, y, idx. dyn_t and cf = (out_c,
        out_f) come from the caller (the render's finish needs them too)."""
        ow, oh = cfg.out_buffer
        oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                                torch.arange(ow, dtype=torch.float32, device=dev),
                                indexing="ij")
        pre = remap.ewa_stack if ewa else remap.coords_pre
        return pre(ox, oy, mats, cfg, dyn_t, *cf)

    def pre_coords(cfg, dyn, mats, ewa=False):
        dyn_t = dyn_to_torch(dyn, dev)
        return grid_and_pre(cfg, dyn_t, mats, out_cf(cfg, dyn_t), ewa)

    def coords_inputs(name, interpolation):
        """x, y, idx of the plane as remap_plane_cuda builds them (3*oh rows
        for EWA)."""
        cfg, dyn, mats = plane_setup(mgr, planes, 500_000, name, interpolation)
        return (*pre_coords(cfg, dyn, mats, interpolation in remap.EWA_BC), mats, cfg, dyn)

    def compare_uv(label, k, p, rows):
        """Max |du|, |dv| over pixels valid in both, with identical masks."""
        (uk, vk, valk), (up, vp, valp) = k, p
        n_valid_mismatch = int((valk != valp).sum())
        both = valk & valp
        du = float((uk - up).abs()[both].max())
        dv = float((vk - vp).abs()[both].max())
        print(f"{label} ({uk.shape[0]}x{uk.shape[1]}, {rows} RS rows): max|du| {du:.3g} "
              f"max|dv| {dv:.3g} px (limit {COORDS_TOL_PX}); valid mismatches "
              f"{n_valid_mismatch} (limit 0); valid share {float(both.float().mean()):.4f}")
        check(n_valid_mismatch == 0, f"{label}: valid masks differ")
        check(du < COORDS_TOL_PX and dv < COORDS_TOL_PX, f"{label}: u/v differ")
        return max(du, dv)

    def check_coords(label, x, y, idx, mats, cfg, dyn):
        k = cuda_coords.project(x, y, idx, mats, cfg, dyn)
        p = cuda_coords.project_plain(x, y, idx, mats, cfg, dyn)
        torch.cuda.synchronize()
        return (*p, compare_uv(label, k, p, mats.shape[0]))

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
    errs.update(coords_stacked=0.0, coords_gen_ewa=0.0, ewa=0.0)
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn = coords_inputs(name, EWA_INTERP)
        up, vp, valp, d = check_coords(f"coords  {name:2s} stacked 3 evals", x, y, idx, mats,
                                       cfg, dyn)
        errs["coords_stacked"] = max(errs["coords_stacked"], d)
        cf = out_cf(cfg, dyn_to_torch(dyn, dev))
        gk = cuda_coords.project_gen(cfg, dyn, mats, cfg.out_buffer[1], 0, *cf)
        torch.cuda.synchronize()
        # bit-identical by design: the +eps evals differ from the base eval
        # by EWA_EPS * du/dx, about 0.01-0.03 px, so a tolerance in px could
        # not tell a kernel that dropped eps from one that adds it
        same = same_bits(gk, (up, vp, valp))
        both = gk[2] & valp
        d = max(float((a - b).abs()[both].max()) for a, b in zip(gk[:2], (up, vp)))
        print(f"gen ewa {name:2s} 3 evals ({gk[0].shape[0]}x{gk[0].shape[1]}, "
              f"{mats.shape[0]} RS rows) vs ewa_stack + plain projection: max|d| {d:.3g} px "
              f"over valid pixels, bit-identical {same} (limit: identical)")
        check(same, f"gen ewa {name}: the stacked evals differ from ewa_stack + project_plain")
        errs["coords_gen_ewa"] = max(errs["coords_gen_ewa"], d)
        shapes[f"gen ewa {name}"] = (cfg, dyn, mats, cf)
        u3, v3 = remap.coords_post_uv(up, vp, cfg)
        oh = u3.shape[0] // 3
        u, v = u3[:oh], v3[:oh]       # background mode 0: the base eval's rows
        img = dev_planes[name]
        bg = plane_bg(dyn, img)
        coeffs = remap._ewa_coeffs_of(dyn)
        ek = cuda_ewa.sample(img, u, v, u3, v3, valp, bg, cfg.src_rect, coeffs, MAXV)
        ep = cuda_ewa.sample_plain(img, u, v, u3, v3, valp, bg, cfg.src_rect, coeffs, MAXV)
        _, _, valid, jac = remap.ewa_jacobian(u3, v3, valp)
        torch.cuda.synchronize()
        de = float((ek - ep).abs().max())
        check(bool(torch.isfinite(ek).all()), f"ewa {name}: non-finite output")
        print(f"ewa     {name:2s} (plane {tuple(img.shape)} uint16 -> {tuple(ek.shape)}; "
              f"|jac| max {float(jac[valid].abs().max()):.4g}): max|d| {de:.3g} codes "
              f"(limit {SAMPLER_TOL})")
        check(de < SAMPLER_TOL, f"ewa {name}: output differs")
        errs["ewa"] = max(errs["ewa"], de)
        shapes[f"ewa {name}"] = (x, y, idx, mats, cfg, dyn, u3, v3, valp, img, bg, coeffs)

    # ---- 3c. fused kernel and self-contained coords kernel vs plain ---------
    phase("fused projection + sampling kernel and self-contained coords kernel vs plain torch "
          "on the card")
    errs.update(fused=0.0, coords_gen=0.0)
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u, v, valp, img, bg = shapes[name]
        check(remap.use_fused(cfg, mats), f"fused: the {name} plane would take the split path")
        fk = cuda_fused.remap_fused(img, x, y, idx, mats, cfg, dyn, bg, MAXV)
        fp = cuda_fused.remap_fused_plain(img, x, y, idx, mats, cfg, dyn, bg, MAXV)
        torch.cuda.synchronize()
        df = float((fk - fp).abs().max())
        check(bool(torch.isfinite(fk).all()), f"fused {name}: non-finite output")
        print(f"fused   {name:2s} (plane {tuple(img.shape)} uint16 -> {tuple(fk.shape)}): "
              f"max|d| {df:.3g} codes (limit {SAMPLER_TOL})")
        check(df < SAMPLER_TOL, f"fused {name}: output differs")
        errs["fused"] = max(errs["fused"], df)
        dyn_t = dyn_to_torch(dyn, dev)
        cf = out_cf(cfg, dyn_t)
        oh = cfg.out_buffer[1]
        gk = cuda_coords.project_gen(cfg, dyn, mats, oh, 0, *cf)
        gp = cuda_coords.project_gen_plain(cfg, dyn, mats, oh, 0, *cf)
        torch.cuda.synchronize()
        errs["coords_gen"] = max(errs["coords_gen"],
                                 compare_uv(f"gen     {name:2s}", gk, gp, mats.shape[0]))
        shapes[f"gen {name}"] = (cfg, dyn, mats, dyn_t, cf)

    ts_list = [int(round((i + 5) * 1e6 / FPS)) for i in range(FRAMES)]
    counters = {"coords": cuda_coords.project, "sampler": cuda_sampler.sample,
                "ewa": cuda_ewa.sample, "fused": cuda_fused.remap_fused,
                "coords_gen": cuda_coords.project_gen, "overlay": cuda_overlay.overlay}
    plain_versions = ((cuda_coords, "project_plain"), (cuda_coords, "project_gen_plain"),
                      (cuda_sampler, "sample_plain"), (cuda_ewa, "sample_plain"),
                      (cuda_fused, "remap_fused_plain"), (cuda_overlay, "overlay_plain"))

    @contextlib.contextmanager
    def driven(label, expected, frames=FRAMES):
        """Every launch count set to 0 on entry and read on exit, and the
        wrappers' plain versions replaced by functions that count and raise
        in between: a CUDA tensor must never reach a plain version."""
        for fn in counters.values():
            fn.launches = 0
        plain_calls = []

        def refuse(*a, **k):
            plain_calls.append(a)
            raise AssertionError("a plain version was called on the card's tensors")

        saved = [(mod, name, getattr(mod, name)) for mod, name in plain_versions]
        for mod, name, _ in saved:
            setattr(mod, name, refuse)
        counts = {}
        try:
            yield counts
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        torch.cuda.synchronize()
        counts.update({k: fn.launches for k, fn in counters.items()})
        print(f"{label} launch counts over {frames} frames: {counts} (expected {expected}); "
              f"plain versions called: {len(plain_calls)} (expected 0)")
        check(not plain_calls, f"{label}: a plain version ran on the card's tensors")
        check(counts == expected, f"{label}: the path did not launch each of its kernels "
                                  f"once per plane")

    def expect(**kw):
        return {k: kw.get(k, 0) for k in counters}

    def drive(interpolation, expected, m=None, tol=FRAME_TOL_CODES):
        """3 frames of Y and UV through process_pixels of m (the main
        manager by default) inside driven(); each plane held against the
        plain torch path (with the frame's mesh buffer), within tol codes."""
        m = m or mgr
        outs = []
        with driven("process_pixels", expected) as counts:
            for ts in ts_list:
                for name in ("Y", "UV"):
                    pi, host = planes[name]
                    out, info = m.process_pixels(ts, host, interpolation=interpolation,
                                                 plane_index=pi, max_pixel_value=MAXV,
                                                 plane_rects=True)
                    outs.append((ts, name, out, info))
        for ts, name, out, info in outs:
            want_shape = (H, W, 1) if name == "Y" else (H // 2, W // 2, 2)
            check(tuple(out.shape) == want_shape, f"{name}: shape {tuple(out.shape)}")
            check(out.dtype == torch.uint16 and out.device.type == "cuda",
                  f"{name}: {out.dtype} on {out.device}")
            check(info["backend"] == "cuda", f"{name}: backend {info['backend']}")
            cfg, dyn, mats = plane_setup(m, planes, ts, name, interpolation)
            ref = remap.remap_plane(dev_planes[name], mats, cfg, dyn, plane_mesh(m, ts),
                                    out_dtype="uint16")
            d = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
            n_diff = int((out.to(torch.int32) != ref.to(torch.int32)).sum())
            print(f"frame ts {ts} us {name:2s}: {tuple(out.shape)} {out.dtype} on {out.device}; "
                  f"vs plain path max|d| {d} codes over {n_diff} px (limit {tol}); "
                  f"mean {float(out.float().mean()):.2f}")
            check(d <= tol, f"{name} at {ts}: kernel path differs from plain path")
        return counts

    # ---- 4. the main path through the manager -------------------------------
    phase("main path: process_pixels, 3 frames of 4K 10-bit YUV420, lanczos4")
    launches = drive(8, expect(coords_gen=2 * FRAMES, sampler=2 * FRAMES))

    # ---- 4b. the EWA path through the manager -------------------------------
    phase("EWA path: process_pixels, 3 frames of 4K 10-bit YUV420, interpolation 11")
    launches_ewa = drive(EWA_INTERP, expect(coords_gen=2 * FRAMES, ewa=2 * FRAMES))

    # ---- 4c. the fused path ------------------------------------------------
    phase("fused path: remap_plane_cuda(fused=True), the 3 frames' Y and UV planes, lanczos4")
    outs = []
    with driven("remap_plane_cuda(fused=True)", expect(fused=2 * FRAMES)) as launches_fused:
        for ts in ts_list:
            for name in ("Y", "UV"):
                cfg, dyn, mats = plane_setup(mgr, planes, ts, name, 8)
                outs.append((ts, name, cfg, dyn, mats,
                             remap.remap_plane_cuda(dev_planes[name], mats, cfg, dyn,
                                                    out_dtype="uint16", fused=True)))
    for ts, name, cfg, dyn, mats, out in outs:
        split = remap.remap_plane_cuda(dev_planes[name], mats, cfg, dyn, out_dtype="uint16")
        d = int((out.to(torch.int32) - split.to(torch.int32)).abs().max())
        n_diff = int((out != split).sum())
        print(f"fused frame ts {ts} us {name:2s}: {tuple(out.shape)} {out.dtype}; vs split kernels "
              f"max|d| {d} codes over {n_diff} px (limit {FRAME_TOL_CODES})")
        check(out.dtype == torch.uint16 and d <= FRAME_TOL_CODES,
              f"fused {name} at {ts}: differs from the split path")

    # ---- 4d. the self-contained coords path ---------------------------------
    phase("self-contained coords path: cuda_coords.project_gen, the 3 frames' Y and UV planes")
    outs = []
    with driven("project_gen", expect(coords_gen=2 * FRAMES)) as launches_gen:
        for ts in ts_list:
            for name in ("Y", "UV"):
                cfg, dyn, mats = plane_setup(mgr, planes, ts, name, 8)
                cf = out_cf(cfg, dyn_to_torch(dyn, dev))
                outs.append((ts, name, cfg, dyn, mats,
                             cuda_coords.project_gen(cfg, dyn, mats, cfg.out_buffer[1], 0, *cf)))
    for ts, name, cfg, dyn, mats, got in outs:
        x, y, idx = pre_coords(cfg, dyn, mats)
        compare_uv(f"gen frame ts {ts} us {name:2s} vs coords_pre + coords kernel", got,
                   cuda_coords.project(x, y, idx, mats, cfg, dyn), mats.shape[0])

    # ---- 4e. the frame window ------------------------------------------------
    import numpy as np
    win_ts = [int(round((i + 20) * 1e6 / FPS)) for i in range(WINDOW)]

    def drive_window(interpolation, n, expected, m=None, tol=FRAME_TOL_CODES, keep=None):
        """process_pixels_window of m (the main manager by default) over n
        timestamps of the Y and UV planes inside driven(); each frame held
        against process_pixels, frame 0 against the plain torch path (with
        its mesh buffer) within tol codes. keep, a dict, gets each plane's
        window by its name (phase 10 holds the sharded window to it)."""
        m = m or mgr
        outs = {}
        with driven(f"process_pixels_window (F = {n})", expected, frames=n) as counts:
            for name in ("Y", "UV"):
                pi, host = planes[name]
                outs[name] = m.process_pixels_window(
                    win_ts[:n], np.stack([host] * n), None, interpolation=interpolation,
                    plane_index=pi, max_pixel_value=MAXV, plane_rects=True)
        for name, (out, info) in outs.items():
            pi, host = planes[name]
            check(tuple(out.shape) == (n,) + host.shape and out.dtype == torch.uint16
                  and out.device == dev, f"window {name}: {tuple(out.shape)} {out.dtype} on "
                                         f"{out.device}")
            check(info["backend"] == "cuda-window", f"window {name}: backend {info['backend']}")
            d_pf = 0
            for i, ts in enumerate(win_ts[:n]):
                one, _ = m.process_pixels(ts, host, interpolation=interpolation, plane_index=pi,
                                          max_pixel_value=MAXV, plane_rects=True)
                d_pf = max(d_pf, int((out[i].to(torch.int32) - one.to(torch.int32)).abs().max()))
            cfg, dyn, mats = plane_setup(m, planes, win_ts[0], name, interpolation)
            ref = remap.remap_plane(dev_planes[name], mats, cfg, dyn, plane_mesh(m, win_ts[0]),
                                    out_dtype="uint16")
            d0 = int((out[0].to(torch.int32) - ref.to(torch.int32)).abs().max())
            print(f"window {name:2s}: {tuple(out.shape)} {out.dtype} on {out.device}; vs "
                  f"process_pixels per frame max|d| {d_pf} codes (limit 0); frame 0 vs plain "
                  f"path max|d| {d0} codes (limit {tol})")
            check(d_pf == 0, f"window {name}: differs from process_pixels")
            check(d0 <= tol, f"window {name}: frame 0 differs from the plain path")
            if keep is not None:
                keep[name] = out
        return counts

    phase(f"frame window: process_pixels_window, {WINDOW} timestamps of 4K 10-bit YUV420, "
          f"lanczos4")
    windows = {"lanczos4": {}, "ewa": {}, "sony": {}}   # phase 10's references
    launches_window = drive_window(8, WINDOW, expect(coords_gen=2 * WINDOW,
                                                     sampler=2 * WINDOW),
                                   keep=windows["lanczos4"])
    phase(f"EWA frame window: process_pixels_window, {EWA_WINDOW} timestamps, interpolation 11")
    launches_window_ewa = drive_window(EWA_INTERP, EWA_WINDOW,
                                       expect(coords_gen=2 * EWA_WINDOW, ewa=2 * EWA_WINDOW),
                                       keep=windows["ewa"])

    # ---- 4f. decode -> stabilize -> encode -----------------------------------
    from gyroflow_torch import cli
    from gyroflow_torch.render.formats import RAW_FORMATS
    from gyroflow_torch.render.renderer import RenderOptions, _plane_backgrounds, render
    from gyroflow_torch.render.y4m_io import Y4MReader
    phase(f"render: an {WINDOW}-frame {W}x{H} 10-bit YUV420 .y4m through render.renderer.render "
          f"and gyroflow_torch.cli")
    work = Path(tmp.name)
    clip, rendered = work / "chip_smoke.y4m", work / "chip_smoke_render.y4m"
    cli_out = work / "chip_smoke_stabilized.y4m"
    t0 = time.perf_counter()
    write_clip(clip, planes, WINDOW)
    print(f"wrote {clip.name}: {clip.stat().st_size} B in {time.perf_counter() - t0:.2f} s "
          f"(host clock; {smi})")
    with driven("render", expect(coords_gen=2 * WINDOW, sampler=2 * WINDOW),
                frames=WINDOW):
        render_stats = render(mgr, str(clip), str(rendered),
                              RenderOptions(interpolation=8, frame_window=WINDOW, trace=True))
    print(f"render stats: {json.dumps(render_stats)} ({smi})")
    check(render_stats["frames"] == WINDOW and render_stats["backend"] == "cuda-window"
          and render_stats["frame_window"] == WINDOW, "render: stats")
    bgs = _plane_backgrounds(RAW_FORMATS["yuv420p10le"], mgr.params.background, True)
    rin, rout = Y4MReader(str(clip)), Y4MReader(str(rendered))
    n_out, d_render = 0, 0
    try:
        for (ts, p_in), (_, p_out) in zip(rin, rout):
            for pi, src, got in ((0, p_in[0], p_out[0]),
                                 (1, np.concatenate(p_in[1:], -1), np.concatenate(p_out[1:], -1))):
                want, _ = mgr.process_pixels(ts, src, interpolation=8, plane_index=pi,
                                             max_pixel_value=MAXV, plane_rects=True,
                                             background_override=bgs[pi])
                d_render = max(d_render, int(np.abs(want.cpu().numpy().astype(np.int32)
                                                    - got.astype(np.int32)).max()))
            n_out += 1
        n_out += sum(1 for _ in rout)
    finally:
        rin.close()
        rout.close()
    print(f"render: {n_out} frames out (expected {WINDOW}); vs process_pixels on the decoded "
          f"planes max|d| {d_render} codes (limit {FRAME_TOL_CODES})")
    check(n_out == WINDOW and d_render <= FRAME_TOL_CODES, "render: output frames")
    lens = work / "chip_smoke_lens.json"
    lens.write_text(lens_profile_json())
    with driven("cli", expect(coords_gen=2 * WINDOW, sampler=2 * WINDOW), frames=WINDOW):
        rc = cli.main([str(clip), "-g", str(work / "chip_smoke.gcsv"), str(lens), "-f",
                       "--device", "cuda:0"])
    r = Y4MReader(str(cli_out))
    n_cli = sum(1 for _ in r)
    r.close()
    print(f"cli: exit {rc}, {n_cli} frames in {cli_out.name} (expected 0, {WINDOW})")
    check(rc == 0 and n_cli == WINDOW, "cli: render failed")
    for f in (clip, rendered, cli_out):
        f.unlink()

    # ---- 4g. ST maps ---------------------------------------------------------
    from gyroflow_torch.utils import stmap
    phase("ST maps: utils.stmap.export_stmaps on cuda:0, the undistort projection through the "
          "coords kernel")
    st_dir = work / "stmaps"
    t0 = time.perf_counter()
    with driven("export_stmaps", expect(coords=1), frames=1) as launches_stmap:
        stmap.export_stmaps(mgr, str(st_dir), single_frame=True, ext=".npy")
    files = sorted(f.name for f in st_dir.iterdir())
    und = np.load(st_dir / next(f for f in files if "undistort" in f))
    print(f"export_stmaps: {files} in {time.perf_counter() - t0:.2f} s (host clock; {smi}); "
          f"undistort map {und.shape}")
    check(len(files) == 2 and bool(np.isfinite(und).all()) and und.shape[0] >= H
          and und.shape[1] >= W, "export_stmaps: files or undistort map")
    ox, oy, smats, scfg, sdyn, out_c, out_f, _ = stmap.undistort_inputs(mgr, 0.0)
    compare_uv("stmap undistort (coords kernel) vs plain undistort_coord",
               stmap.undistort_uv(mgr, 0.0),
               remap.undistort_coord(ox, oy, smats, scfg, dyn_to_torch(sdyn, dev), out_c, out_f),
               smats.shape[0])
    check("jax" not in sys.modules, "jax was imported")
    print("jax in sys.modules: False")

    # ---- 5. times ------------------------------------------------------------
    phase(f"times on {smi}")
    times = {"coords": [0.0, 0.0], "sampler": [0.0, 0.0]}
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u, v, valp, img, bg = shapes[name]
        ck = kernel_ms(lambda: cuda_coords.project(x, y, idx, mats, cfg, dyn))
        cp = cuda_ms(lambda: cuda_coords.project_plain(x, y, idx, mats, cfg, dyn))
        sk = kernel_ms(lambda: cuda_sampler.sample(img, u, v, valp, bg, cfg.src_rect, 8, MAXV))
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
            cfg, dyn, mats = plane_setup(mgr, planes, ts, name, interpolation)
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
    times.update(coords_stacked=[0.0, 0.0], coords_gen_ewa=[0.0, 0.0], ewa=[0.0, 0.0])
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u3, v3, valp, img, bg, coeffs = shapes[f"ewa {name}"]
        u, v = u3[:u3.shape[0] // 3], v3[:v3.shape[0] // 3]
        ck = kernel_ms(lambda: cuda_coords.project(x, y, idx, mats, cfg, dyn))
        cp = cuda_ms(lambda: cuda_coords.project_plain(x, y, idx, mats, cfg, dyn))
        _, _, _, cf = shapes[f"gen ewa {name}"]
        oh = cfg.out_buffer[1]
        gk = kernel_ms(lambda: cuda_coords.project_gen(cfg, dyn, mats, oh, 0, *cf))
        gp = cuda_ms(lambda: cuda_coords.project_gen_plain(cfg, dyn, mats, oh, 0, *cf))
        print(f"{name:2s} gen ewa (3 evals of {oh}x{x.shape[1]}) kernel {gk:.4f} ms  "
              f"plain {gp:.4f} ms")
        times["coords_gen_ewa"][0] += gk
        times["coords_gen_ewa"][1] += gp
        ek = kernel_ms(lambda: cuda_ewa.sample(img, u, v, u3, v3, valp, bg, cfg.src_rect,
                                             coeffs, MAXV))
        ep = cuda_ms(lambda: cuda_ewa.sample_plain(img, u, v, u3, v3, valp, bg, cfg.src_rect,
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
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):   # the attribute's name before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def device_rows(fn, n):
        """fn(i) for i < n under torch.profiler: (wall ms per call, [(kernel,
        device ms per call, launches per call)], longest first). Device-side
        events only: the aten ops' rows repeat their kernels' time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        rows = [(e.key, self_device_us(e) / 1e3 / n, e.count / n) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and self_device_us(e) > 0]
        return wall, sorted(rows, key=lambda r: -r[1])

    # ---- 5c. fused and self-contained coords times ---------------------------
    phase(f"fused and self-contained coords times on {smi}")
    times.update(fused=[0.0, 0.0], coords_gen=[0.0, 0.0])
    split_ms = {"coords + coords_post_uv + sampler": 0.0, "grid + coords_pre (eager)": 0.0,
                "grid + coords_pre (eager) + coords kernel": 0.0}
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u, v, valp, img, bg = shapes[name]
        gcfg, gdyn, gmats, gdyn_t, cf = shapes[f"gen {name}"]
        oh = gcfg.out_buffer[1]

        def split_chain():
            uu, vv, vl = cuda_coords.project(x, y, idx, mats, cfg, dyn)
            uu, vv = remap.coords_post_uv(uu, vv, cfg)
            return cuda_sampler.sample(img, uu, vv, vl, bg, cfg.src_rect, 8, MAXV)

        def pre_and_coords():
            return cuda_coords.project(*grid_and_pre(gcfg, gdyn_t, gmats, cf), gmats, gcfg,
                                       gdyn)

        fk = kernel_ms(lambda: cuda_fused.remap_fused(img, x, y, idx, mats, cfg, dyn, bg, MAXV))
        fp = cuda_ms(lambda: cuda_fused.remap_fused_plain(img, x, y, idx, mats, cfg, dyn, bg,
                                                          MAXV))
        sc = kernel_ms(split_chain)
        gk = kernel_ms(lambda: cuda_coords.project_gen(gcfg, gdyn, gmats, oh, 0, *cf))
        gp = cuda_ms(lambda: cuda_coords.project_gen_plain(gcfg, gdyn, gmats, oh, 0, *cf))
        pre = kernel_ms(lambda: grid_and_pre(gcfg, gdyn_t, gmats, cf))
        pc = kernel_ms(pre_and_coords)
        print(f"{name:2s} fused   kernel {fk:.4f} ms  plain {fp:.4f} ms; split chain (coords "
              f"kernel, eager coords_post_uv, sampler kernel) {sc:.4f} ms")
        print(f"{name:2s} gen     kernel {gk:.4f} ms  plain {gp:.4f} ms; eager grid + "
              f"coords_pre {pre:.4f} ms, + coords kernel {pc:.4f} ms")
        times["fused"][0] += fk
        times["fused"][1] += fp
        times["coords_gen"][0] += gk
        times["coords_gen"][1] += gp
        split_ms["coords + coords_post_uv + sampler"] += sc
        split_ms["grid + coords_pre (eager)"] += pre
        split_ms["grid + coords_pre (eager) + coords kernel"] += pc
    print(f"Y+UV: fused kernel {times['fused'][0]:.4f} ms vs coords + sampler kernels "
          f"{times['coords'][0] + times['sampler'][0]:.4f} ms (phase 5) and the split chain "
          f"{split_ms['coords + coords_post_uv + sampler']:.4f} ms; project_gen "
          f"{times['coords_gen'][0]:.4f} ms vs eager grid + coords_pre + coords kernel "
          f"{split_ms['grid + coords_pre (eager) + coords kernel']:.4f} ms (grid + "
          f"coords_pre alone {split_ms['grid + coords_pre (eager)']:.4f} ms)")
    # device busy time of the eager grid + coords_pre (the span above also
    # holds the host's launch gaps) and of project_gen, one call per plane
    gen_planes = [shapes[f"gen {name}"] for name in ("Y", "UV")]
    busy = {}
    for label, fn in (("grid + coords_pre (eager)",
                       lambda c, d, m, dt, cf: grid_and_pre(c, dt, m, cf)),
                      ("project_gen", lambda c, d, m, dt, cf: cuda_coords.project_gen(
                          c, d, m, c.out_buffer[1], 0, *cf))):
        _, rows = device_rows(lambda i: [fn(*g) for g in gen_planes], 3)
        busy[label] = (sum(r[1] for r in rows), sum(r[2] for r in rows))
        print(f"{label} Y+UV under torch.profiler: device busy {busy[label][0]:.4f} ms over "
              f"{busy[label][1]:.0f} kernels per frame")
    split_ms["device busy"] = busy

    # ---- 5d. the frame window's times ----------------------------------------
    phase(f"frame window times on {smi}")
    win_dev = {name: dev_planes[name][None].expand(WINDOW, *dev_planes[name].shape).contiguous()
               for name in ("Y", "UV")}

    def window_pass():
        for name in ("Y", "UV"):
            mgr.process_pixels_window(win_ts, win_dev[name], None, interpolation=8,
                                      plane_index=planes[name][0], max_pixel_value=MAXV,
                                      plane_rects=True)

    def per_frame_pass():
        for ts in win_ts:
            frame_kernel(ts, 8)

    def per_frame_ms(fn, fresh=True, reps=3):
        """Median host-clock ms per frame of fn over the window's timestamps;
        fresh: the frame transforms rebuilt each time (as a render meets
        them)."""
        ms = []
        for _ in range(reps):
            if fresh:
                mgr._stab_cache.clear()
                mgr._mats_dev.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / WINDOW)
        return statistics.median(ms)

    window_pass()
    per_frame_pass()
    wms = [per_frame_ms(per_frame_pass), per_frame_ms(window_pass), per_frame_ms(window_pass),
           per_frame_ms(per_frame_pass)]
    print(f"Y+UV per frame (host clock, median of 3, frames on the card; per-frame, window, "
          f"window, per-frame): 8 process_pixels calls {wms[0]:.3f}, process_pixels_window "
          f"(F = {WINDOW}) {wms[1]:.3f}, {wms[2]:.3f}, 8 process_pixels calls {wms[3]:.3f} ms; "
          f"render (4f, decode + stabilize + encode of a .y4m) {render_stats['fps']} fps, "
          f"ms per frame {render_stats['trace']['ms_per_frame']}; {smi}")

    # where a render's stabilize stage goes: the host stack and upload of a
    # window's decoded planes, the window on the card, each frame's download
    win_out = [mgr.process_pixels_window(win_ts, win_dev[name], None, interpolation=8,
                                         plane_index=planes[name][0], max_pixel_value=MAXV,
                                         plane_rects=True)[0] for name in ("Y", "UV")]
    up_ms = per_frame_ms(lambda: [torch.as_tensor(np.stack([planes[name][1]] * WINDOW)).to(dev)
                                  for name in ("Y", "UV")], fresh=False)
    down_ms = per_frame_ms(lambda: [out[i].cpu().numpy() for out in win_out
                                    for i in range(WINDOW)], fresh=False)
    del win_out
    mgr._stab_cache.clear()
    mgr._mats_dev.clear()
    win_wall, win_rows = device_rows(lambda i: window_pass(), 1)
    win_busy = sum(r[1] for r in win_rows) / WINDOW
    win_wall /= WINDOW
    print(f"a render's stabilize stage per frame (Y+UV, host clock, median of 3): host stack + "
          f"upload of the decoded planes {up_ms:.3f} ms; the window on the card {wms[1]:.3f} ms "
          f"(under torch.profiler {win_wall:.3f} ms, device busy {win_busy:.3f} ms = "
          f"{100.0 * win_busy / win_wall:.1f}%); download with .cpu() {down_ms:.3f} ms; {smi}")
    report.update(window_ms={"per_frame": [wms[0], wms[3]], "window": [wms[1], wms[2]],
                             "upload": up_ms, "download": down_ms,
                             "profiled_wall": win_wall, "device_busy": win_busy},
                  render=render_stats, launches_window=launches_window,
                  launches_window_ewa=launches_window_ewa)
    del win_dev
    report.update(frame_ms={"kernel": [fk1, fk2], "plain": [fp1, fp2]},
                  ewa_frame_ms={"kernel": [ek1, ek2], "plain": [ep1, ep2]},
                  launches=launches, launches_ewa=launches_ewa, launches_fused=launches_fused,
                  launches_gen=launches_gen, errs=errs, kernel_ms=times, split_ms=split_ms)

    # ---- 6. where a frame's device time goes -----------------------------------
    for label, interpolation in (("lanczos4", 8), ("EWA", EWA_INTERP)):
        phase(f"profile: {FRAMES} new {label} frames (Y+UV) on the kernel path, device time "
              f"by kernel")
        frame_kernel(ts_list[0], interpolation)
        torch.cuda.synchronize()
        wall_ms, rows = device_rows(
            lambda i: frame_kernel(int(round((i + 40) * 1e6 / FPS)), interpolation), FRAMES)
        dev_ms = sum(r[1] for r in rows)
        if rows:
            print(f"per frame: wall {wall_ms:.3f} ms (profiler on), device busy {dev_ms:.3f} ms "
                  f"({100.0 * dev_ms / wall_ms:.1f}%) over {sum(r[2] for r in rows):.0f} kernels")
        else:
            print("device time per frame: not measured (no device events)")
        for key, ms, n in rows[:10]:
            print(f"  {ms:8.3f} ms/frame  {n:5.0f} launches/frame  {key[:100]}")
        cats = [(key, ms, n) for key, ms, n in rows if "Cat" in key]
        print(f"  concatenation copies (torch.cat / torch.stack): "
              f"{sum(r[1] for r in cats):.3f} ms/frame over {sum(r[2] for r in cats):.0f} "
              f"launches/frame" + "".join(f"; {ms:.3f} ms x {n:.0f} {key[:60]}"
                                          for key, ms, n in cats))
        report[f"{label}_profile"] = {"wall_ms_per_frame": wall_ms,
                                      "device_ms_per_frame": dev_ms, "top": rows[:10]}

    # ---- bounds at this run's inputs (Y + UV launches of one frame) ----------
    bounds = {k: [] for k in ("coords", "sampler", "ewa", "fused", "coords_gen",
                              "coords_gen_ewa")}
    for name in ("Y", "UV"):
        x, y, idx, mats, cfg, dyn, u, v, valp, img, bg = shapes[name]
        n_px, n_valid, C = x.numel(), int(valp.sum()), img.shape[2]
        table, plane = mats.numel() * 4, img.numel() * img.element_size()
        tap_ops = n_valid * sampler_ops(C)
        bounds["coords"].append((n_px * 21 + table, n_px * PROJECT_OPS))
        bounds["sampler"].append((plane + n_px * (9 + 4 * C), tap_ops))
        bounds["fused"].append((plane + table + n_px * (12 + 4 * C),
                                n_px * PROJECT_OPS + n_valid * POST_OPS + tap_ops))
        gcfg, gdyn, gmats, _, _ = shapes[f"gen {name}"]
        bounds["coords_gen"].append((gmats.numel() * 4 + n_px * 9,
                                     n_px * (GEN_PRE_OPS + 2 * PROJECT_OPS)))
        # the EWA form: three evals' u, v, valid; one probe, three projections
        bounds["coords_gen_ewa"].append((gmats.numel() * 4 + n_px * 3 * 9,
                                         n_px * (GEN_EWA_PRE_OPS + 4 * PROJECT_OPS)))
        _, _, _, _, _, _, u3, v3, valp, img, _, _ = shapes[f"ewa {name}"]
        u, v, valid, jac = remap.ewa_jacobian(u3, v3, valp)
        taps, tap_rows, weighted = ewa_bbox_taps(u, v, jac, valid)
        n_valid = int(valid.sum())
        # per valid pixel: the Jacobian 12 (4 selects, 4 subtractions, 4
        # divisions), setup 125 (guard, bbox, clamped ellipse); 4 per bbox
        # row; per bbox tap 7 (its offset, dr and the test dr < 4); per tap
        # with dr < 4 another 11 (sqrt, the piece, the cubic), a multiply-add
        # per channel and the weight sum. Bytes: the plane, the three evals'
        # u, v, valid (9 B each) and the output per pixel
        bounds["ewa"].append((plane + u.numel() * (3 * 9 + 4 * C),
                              n_valid * (12 + 125) + tap_rows * 4 + taps * 7
                              + weighted * (11 + 2 * C + 1)))
    bound_of = {k: bound(v) for k, v in bounds.items()}
    for k, (b_ms, by) in bound_of.items():
        ms = times[k][0]
        print(f"bound {k:10s}: {b_ms:.4f} ms ({by}); kernel {ms:.4f} ms = "
              f"{100.0 * b_ms / ms:.1f}% of the bound's speed")
    print("library_ms: null for every kernel: no single PyTorch call computes these functions "
          "(F.grid_sample samples at continuous coordinates: no 32-phase quantization, no "
          "8-tap lanczos4, no per-tap source-rect background, no EWA)")

    def entry(name, source, replaces, n_launch, key=None):
        key = key or name
        b_ms, by = bound_of[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": errs[key], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": b_ms, "bound_by": by,
                "library_ms": None}

    kernels = [
        entry("coords", "gyroflow_torch/csrc/coords.cu", "gyroflow_tpu/ops/pallas_coords.py:68",
              launches_stmap["coords"]),
        entry("sampler", "gyroflow_torch/csrc/sampler.cu",
              "gyroflow_tpu/ops/pallas_sampler.py:471", launches["sampler"]),
        entry("ewa", "gyroflow_torch/csrc/ewa.cu", "gyroflow_tpu/ops/pallas_sampler.py:715",
              launches_ewa["ewa"]),
        entry("fused", "gyroflow_torch/csrc/fused.cu", "gyroflow_tpu/ops/pallas_fused.py:57",
              launches_fused["fused"]),
        entry("coords_gen", "gyroflow_torch/csrc/coords.cu",
              "gyroflow_tpu/ops/pallas_coords.py:257",
              launches["coords_gen"] + launches_gen["coords_gen"]),
        # the JAX EWA path projects its stacked evals with _coords_call
        # (remap.py:773-796), not with the gen kernel
        entry("coords_gen_ewa", "gyroflow_torch/csrc/coords.cu",
              "gyroflow_tpu/ops/pallas_coords.py:68", launches_ewa["coords_gen"]),
    ]

    # ---- 7. the experiments' kernels (TPU kernels 6-11) ----------------------
    exp_entries, report["experiments"] = experiments_phase(dev, smi)
    check("jax" not in sys.modules, "jax was imported")
    kernels += exp_entries

    # ---- 8. every lens model and digital lens ---------------------------------
    lens_entries, report["lenses"] = lens_phase(
        dev, smi, tmp.name, mgr, planes, dev_planes, kernel_ms, pre_coords, out_cf, drive,
        drive_window, expect, device_rows, report["ptxas"])
    kernels += lens_entries

    # ---- 9. a Sony clip: mesh, FPD and the overlay ------------------------------
    sony_entries, report["sony"] = sony_phase(
        dev, smi, tmp.name, planes, dev_planes, kernel_ms, driven, expect, drive, drive_window,
        device_rows, out_cf, report["ptxas"], keep=windows["sony"])
    kernels += sony_entries

    # ---- 10. the sharded window on the card ----------------------------------
    report["sharded"] = sharded_phase(dev, smi, mgr, planes, win_ts, windows, driven, expect,
                                      device_rows)

    # ---- 11. the port's measurement path: bench.py's readings and the probes -
    report["bench"] = bench_phase(dev, smi, driven, expect)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({**report, "bounds": bound_of,
                                                         "kernels": kernels}, indent=1))
    tmp.cleanup()
    print(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s")
    print("kernel ms, plain_ms and bound_ms: one frame's Y+UV launches (Y 3840x2160x1 + UV "
          "1920x1080x2); coords, sampler, fused and coords_gen at lanczos4, ewa at "
          "interpolation 11; the experiments' kernels at their probes' shapes (fused_bbox Y+UV "
          "float32 planes, window the four cases summed, probe4 the full mode, probe5 Y+UV, "
          "probe6 the bf16 mode, triton the four calls summed); coords<lens>, "
          "coords_gen<model> and fused<lens> (phase 8) on the 4K Y plane alone, the "
          "lens's instantiation, launches from the slice frames' drives; coords<sony,mesh+fpd> "
          "and overlay (phase 9) ms and bounds of one Sony frame's Y+UV launches, their "
          "launches summed over phase 9's drives (process_pixels, the window, EWA, render, the "
          "ST maps, the overlay frame); every kernel ms from "
          "experiments.perf_probe.cuda_ms (L2 flushed and the card spinning before each "
          "call), every plain_ms from CUDA events around each call")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
