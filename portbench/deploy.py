"""A deployment's inputs, made from the seed, and the two sides that read them.

A configuration file (``configs/<name>.json``) states the clip: its size,
frame rate, 10-bit YUV420 planes, the telemetry it carries and the lens. From
the seed this module writes the clip's telemetry file (a gcsv gyro log, or a
Sony MP4 whose rtmd track holds KLV samples) into a scratch directory, makes
a pool of distinct host frames, and builds on them both the program under
test (the port's ``StabilizationManager``) and the plain reference
(``reference.stabilizer.ReferenceStabilizer``). Both read the same files;
neither sees what the other derived from them.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parent
GYRO_TRACE_SEED = 20240817     # the fixed motion of every seed's gyro log


def load_config(name: str, benchmark: dict) -> dict:
    """The configuration named in BENCHMARK.json, read from its file."""
    for c in benchmark["configs"]:
        if c["name"] == name:
            return json.loads((PKG.parent / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def frame_count(cfg: dict) -> int:
    return int(round(cfg["clip_seconds"] * cfg["fps"]))


def write_gcsv(path: Path, cfg: dict):
    """A handheld gyro log at the configuration's rate over the whole clip.
    One fixed trace (three sinusoids per axis and noise, rad/s, from a fixed
    generator), the same for every seed, so the recompute (smoothing, adaptive
    zoom and its max-zoom iterations) does the same work whatever the seed
    (the same trace rotated in time by the seed tripled the recompute at some
    rotations). The seed varies the frames and the sample. The accelerometer
    rests."""
    tel = cfg["telemetry"]
    rate = float(tel["rate_hz"])
    n = int(round(cfg["clip_seconds"] * rate)) + 1
    t = np.arange(n) / rate
    base = np.random.default_rng(GYRO_TRACE_SEED)
    gyro = np.zeros((n, 3))
    for axis, amp in enumerate(tel["shake_rad_s"]):
        for freq in tel["shake_hz"]:
            gyro[:, axis] += amp * np.sin(2 * math.pi * freq * t + base.uniform(0, 2 * math.pi))
    gyro += base.normal(0.0, tel["noise_rad_s"], gyro.shape)
    lines = ["GYROFLOW IMU LOG", "version,1.3", "id,portbench", "orientation,XYZ",
             f"tscale,{1.0 / rate:.9f}", "gscale,1.0", "ascale,1.0",
             f"frame_readout_time,{tel['readout_ms']}", "t,gx,gy,gz,ax,ay,az"]
    lines += [f"{i},{g[0]:.6f},{g[1]:.6f},{g[2]:.6f},0,0,1" for i, g in enumerate(gyro)]
    path.write_text("\n".join(lines) + "\n")


def sony_tagmap(i: int, cfg: dict, mesh_pts, fpd_shears) -> dict:
    """Frame i's Sony tag map (the rtmd fields Gyroflow's Sony parser reads):
    gyroscope and accelerometer at the configuration's rate, the imager of
    the ILCE-7M4, the sony lens polynomial, 12 IBIS and OIS samples a frame,
    and the clip's one lens mesh and focal-plane block."""
    tel = cfg["telemetry"]
    fps, (w, h) = cfg["fps"], (cfg["width"], cfg["height"])
    rate = float(tel["rate_hz"])
    t0 = i * 1000.0 / fps
    n = int(round(rate / fps))
    gyro = [(t0 + j / rate * 1000.0, 20.0 * math.sin((t0 + j) * 0.05),
             10.0 * math.cos((t0 + j) * 0.04), 4.0) for j in range(n)]
    step = 1e6 / fps / 12.0
    size = tuple(tel["capture_area_size"])
    grid = tel["mesh_grid"]
    sensor_h = size[1] * 5940.0
    return {
        "camera_model": "ILCE-7M4", "frame_rate": fps, "frame_readout_time": tel["readout_ms"],
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
        "mesh_correction": {"data": {"size": size, "divisions": (grid, grid), "mesh": mesh_pts,
                                     "raw_mesh": mesh_pts}},
        "focal_plane_distortion": {"data": {"unk1": 1, "unk2": 2, "scale": 100.0,
                                            "unk4": fpd_shears}},
    }


def write_sony_clip(path: Path, cfg: dict, seed: int):
    """The clip's rtmd track as KLV samples in an MP4, one tag map a frame;
    the mesh's jitter and the focal-plane shears come from the seed."""
    from .reference.core.telemetry.sony import build_tagmap_mp4
    tel = cfg["telemetry"]
    rng = np.random.default_rng(seed)
    size, grid = tel["capture_area_size"], tel["mesh_grid"]
    gx, gy = np.meshgrid(np.linspace(0, size[0], grid), np.linspace(0, size[1], grid))
    pts = np.stack([gx + rng.normal(0, 10.0, gx.shape), gy + rng.normal(0, 8.0, gy.shape)], -1)
    mesh_pts = [tuple(p) for p in pts.reshape(-1, 2).tolist()]
    shears = [tuple(int(v) for v in rng.integers(-60, 61, 2)) for _ in range(8)]
    maps = [sony_tagmap(i, cfg, mesh_pts, shears) for i in range(frame_count(cfg))]
    path.write_bytes(build_tagmap_mp4(maps, cfg["fps"], encoding="klv"))


def write_telemetry(workdir: Path, cfg: dict, seed: int) -> Path:
    kind = cfg["telemetry"]["kind"]
    if kind == "gcsv":
        path = workdir / "clip.gcsv"
        write_gcsv(path, cfg)
    elif kind == "sony":
        path = workdir / "clip.mp4"
        write_sony_clip(path, cfg, seed)
    else:
        raise ValueError(f"unknown telemetry kind {kind!r}")
    return path


def lens_text(cfg: dict, fm_lens_profile=None) -> str:
    """The lens profile JSON the clip is stabilized with: the configuration's
    own, or the one the clip carries (Sony)."""
    if cfg.get("lens_profile") is not None:
        return json.dumps(cfg["lens_profile"])
    if fm_lens_profile is None:
        raise ValueError("the configuration names no lens and the clip carries none")
    return json.dumps(fm_lens_profile)


@dataclass
class Frame:
    """A decoded frame as the reader hands it over: uint16 10-bit Y
    (H, W, 1) and interleaved UV (H/2, W/2, 2) host planes."""
    y: np.ndarray
    uv: np.ndarray


def frame_pool(cfg: dict, seed: int, n: int, device) -> list:
    """n distinct host frames: smooth gradients with seeded phases plus
    seeded noise, drawn on the device in one call per plane group and
    brought to the host, as a decoder would leave them."""
    w, h = cfg["width"], cfg["height"]
    maxv = (1 << cfg["bit_depth"]) - 1
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    shapes = ((h, w, 1), (h // 2, w // 2, 2))
    planes = []
    for (ph, pw, c) in shapes:
        yy = torch.arange(ph, device=device, dtype=torch.float32).view(1, ph, 1, 1)
        xx = torch.arange(pw, device=device, dtype=torch.float32).view(1, 1, pw, 1)
        phase = torch.rand((n, 1, 1, c), generator=gen, device=device) * 6.2831855
        fx = (0.004 + 0.02 * torch.rand((n, 1, 1, c), generator=gen, device=device)) * (w / pw)
        fy = (0.004 + 0.02 * torch.rand((n, 1, 1, c), generator=gen, device=device)) * (w / pw)
        base = torch.sin(xx * fx + phase) * torch.cos(yy * fy - phase) * 0.45 + 0.5
        noise = torch.rand((n, ph, pw, c), generator=gen, device=device) * 0.04 - 0.02
        img = torch.round((base + noise).clamp_(0.0, 1.0) * maxv).to(torch.int16)
        planes.append(img.cpu().numpy().view(np.uint16))
    return [Frame(planes[0][i], planes[1][i]) for i in range(n)]


def program_manager(cfg: dict, telemetry: Path, device):
    """The port's StabilizationManager on device, loaded as a user loads the
    clip: video data, the telemetry file, the lens profile, a recompute."""
    from gyroflow_torch.core.manager import StabilizationManager
    mgr = StabilizationManager(device=device)
    n = frame_count(cfg)
    mgr.init_from_video_data(n / cfg["fps"] * 1000.0, cfg["fps"], n,
                             (cfg["width"], cfg["height"]))
    mgr.load_gyro_data(str(telemetry))
    mgr.load_lens_profile(lens_text(cfg, mgr.gyro.file_metadata.lens_profile))
    mgr.recompute_blocking()
    return mgr


def reference_stabilizer(cfg: dict, telemetry: Path, device):
    """The plain reference, loaded from the same files."""
    from .reference.stabilizer import ReferenceStabilizer
    ref = ReferenceStabilizer(device)
    n = frame_count(cfg)
    ref.init_from_video_data(n / cfg["fps"] * 1000.0, cfg["fps"], n,
                             (cfg["width"], cfg["height"]))
    fm = ref.load_gyro_data(str(telemetry), cfg["telemetry"]["kind"])
    ref.load_lens_profile(lens_text(cfg, fm.lens_profile))
    ref.recompute()
    return ref


def timestamp_us(cfg: dict, i: int) -> int:
    """Frame i's video timestamp: frames advance through the clip and wrap at
    its end."""
    return int(round((i % frame_count(cfg)) * 1e6 / cfg["fps"]))
