"""Sony camera metadata processing (IBIS/OIS splines, per-frame lens params,
mesh correction, time offsets).

Port of gyroflow src/core/gyro_source/sony.rs. The reference receives
per-sample "tag maps" from the external telemetry-parser crate (whose raw
SMPTE RTMD KLV decoding is not part of the reference repo); this module works
on the same tag-map abstraction:

    {"imager": {"first_frame_ts", "exposure_time", "sensor_size_px",
                "pixel_pitch", "capture_area_origin", "capture_area_size"},
     "gyroscope": {"frequency", "time_offset", "scaler", "data": [(t_ms, x, y, z)]},
     "accelerometer": {"data": [...]},
     "ibis": {"data": [(t, x, y, z)], "data2": [(t, x, y, z)]},   # shift, angle
     "lens_oss": {"data": [(t, x, y, z)]},
     "lens": {"focal_length", "display_name", "pixel_focal_length"},
     "lens_distortion": {"enabled", "data": {"focal_length_nm",
                         "effective_sensor_height_nm", "coeff_scale", "coeffs"}},
     "mesh_correction": {"data": {"size", "divisions", "mesh", "raw_mesh"}},
     "focal_plane_distortion": {"data": {"unk1", "unk2", "scale", "unk4"}}}

MP4 carriage: samples of an `rtmd` metadata track holding either real SMPTE
ST 336 KLV sets (decoded by telemetry/klv.py — 16-byte ULs, BER lengths,
RDD 18 local sets; Sony's vendor gyro/IBIS items live in the user-defined
set, see klv.SONY_USER_TAGS) or the CBOR tag-map fixture encoding kept for
tests. `parse_sony_mp4` auto-detects per sample; anything that is neither is
rejected with a clear error instead of being misparsed.
"""
from __future__ import annotations

import logging
import math
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import splines
from ..file_metadata import CameraStabData, FileMetadata, LensParamsEntry, TimeIMU

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Lens profile from the LensDistortion polynomial (sony.rs:11-186)
# ---------------------------------------------------------------------------

def init_lens_profile(md: FileMetadata, tag_map: dict, size: Tuple[int, int],
                      timestamp_ms: float, camera_model: str = "",
                      video_rotation: int = 0):
    lmd = tag_map.get("lens_distortion")
    if not lmd:
        return
    imager = tag_map.get("imager", {})
    pixel_pitch = imager.get("pixel_pitch")
    crop_size = imager.get("capture_area_size")
    lens = tag_map.get("lens", {})
    enabled = bool(lmd.get("enabled", False))
    v = lmd.get("data")
    if v is None or pixel_pitch is None or crop_size is None:
        return

    is_vertical = abs(video_rotation) in (90, 270)
    fl_tag = lens.get("focal_length")
    focal_length_str = f"{fl_tag:.2f} mm" if fl_tag is not None else None
    focal_length_mm = v.get("focal_length_nm", 0.0) / 1e6
    approx_fl = fl_tag if fl_tag is not None else focal_length_mm
    ratio = approx_fl / max(focal_length_mm, 1e-6)
    is_bad_fl = abs(ratio - 1.0) > 0.5

    sensor_height = v.get("effective_sensor_height_nm", 0.0) / 1e9
    coeff_scale = v.get("coeff_scale", 1.0)
    coeffs = [c / max(coeff_scale, 1.0) / 180.0 * math.pi
              for c in v.get("coeffs", [])]
    ts_us = int(round(timestamp_ms * 1000.0))

    def lens_name():
        name = lens.get("display_name", "")
        if name and focal_length_str:
            return f"{name} ({focal_length_str})"
        return name or (focal_length_str or "")

    def profile(fx, fy, calibrated_by, model_name, official):
        return {
            "calibrated_by": calibrated_by,
            "camera_brand": "Sony",
            "camera_model": camera_model,
            "lens_model": lens_name(),
            "calib_dimension": {"w": size[0], "h": size[1]},
            "orig_dimension": {"w": size[0], "h": size[1]},
            "output_dimension": {"w": size[1] if is_vertical else size[0],
                                 "h": size[0] if is_vertical else size[1]},
            "frame_readout_time": md.frame_readout_time,
            "official": official,
            "asymmetrical": False,
            "note": f"Distortion comp.: {'On' if enabled else 'Off'}",
            "fisheye_params": {
                "camera_matrix": [[fx, 0.0, size[0] / 2], [0.0, fy, size[1] / 2],
                                  [0.0, 0.0, 1.0]],
                "distortion_coeffs": []},
            "distortion_model": model_name,
            "sync_settings": {"initial_offset": 0, "initial_offset_inv": False,
                              "search_size": 0.3, "max_sync_points": 5,
                              "every_nth_frame": 1, "time_per_syncpoint": 0.5,
                              "do_autosync": False},
            "calibrator_version": "---",
        }

    if not coeffs or sensor_height == 0.0 or is_bad_fl:
        # fallback profile: focal length only (sony.rs:46-97)
        sensor_size_px = imager.get("sensor_size_px")
        if sensor_size_px is None:
            return
        fl = approx_fl if is_bad_fl else focal_length_mm
        sws = crop_size[0] / max(sensor_size_px[0], 1.0)
        shs = crop_size[1] / max(sensor_size_px[1], 1.0)
        default = tag_map.get("default", {})
        sw = default.get("sensor_width", 0.0) * sws
        sh = default.get("sensor_height", 0.0) * shs
        if fl > 0.0 and sw > 0.0 and sh > 0.0:
            fx = fl / sw * size[0]
            fy = fl / sh * size[1]
            lp = md.lens_params.get(ts_us)
            if lp is not None:
                lp.focal_length = fl
                lp.pixel_focal_length = (fx, fy)
            if md.lens_profile is None:
                md.lens_profile = profile(fx, fy, "Not calibrated", None, False)
                md.lens_profile.pop("distortion_model")
        return

    # polynomial fit: angle -> sensor radius (sony.rs:99-137)
    angles = np.asarray([0.0] + coeffs, np.float64)
    lens_out_radius = np.arange(11, dtype=np.float64) / 10.0 * sensor_height
    matrix = np.stack([angles ** (p + 1) for p in range(6)], axis=1)   # (11, 6)
    poly, *_ = np.linalg.lstsq(matrix, lens_out_radius, rcond=None)

    pixel_pitch_m = np.asarray(pixel_pitch, np.float64) / 1e9
    sensor_crop_px = np.asarray(crop_size, np.float64)
    video_res_px = np.asarray(size, np.float64)
    pixel_pitch_scaled = pixel_pitch_m * sensor_crop_px / video_res_px
    f_meters = focal_length_mm / 1000.0
    fx = f_meters / pixel_pitch_scaled[0]
    fy = f_meters / pixel_pitch_scaled[1]
    normalized = [float(c / f_meters) for c in poly]
    if abs(normalized[0] - 1.0) > 0.05:
        log.warning("Sony polynomial fit: c_0 = %.4f (expected ~1.0)", normalized[0])

    lp = md.lens_params.get(ts_us)
    if lp is not None:
        lp.focal_length = focal_length_mm
        lp.pixel_focal_length = (fx, fy)
        lp.distortion_coefficients = normalized
    if md.lens_profile is None:
        md.lens_profile = profile(fx, fy, "Sony", "sony", True)


# ---------------------------------------------------------------------------
# Gyro/frame time offset (sony.rs:189-208)
# ---------------------------------------------------------------------------

def get_time_offset(md: FileMetadata, tag_map: dict, sample_rate: float,
                    camera_model: str = "") -> Optional[Tuple[float, float]]:
    model_offset = 1.5 if camera_model == "DSC-RX0M2" else 0.0
    imager = tag_map.get("imager")
    gyro = tag_map.get("gyroscope")
    if not imager or not gyro:
        return None
    try:
        first_frame_ts = imager["first_frame_ts"]
        exposure_time = imager["exposure_time"]
        offset = gyro["time_offset"]
        sampling_frequency = float(gyro["frequency"])
    except KeyError:
        return None
    scaler = float(gyro.get("scaler", 1000000))

    rounded = round(offset * 1000.0 * (1000000.0 / scaler))
    period = 1000000.0 / sampling_frequency
    offset_diff = round(rounded - period * math.floor(rounded / period)) / 1000.0

    frame_offset = (first_frame_ts - exposure_time / 2.0 +
                    (md.frame_readout_time or 0.0) / 2.0 + model_offset +
                    offset_diff - offset)
    return sampling_frequency, frame_offset / sampling_frequency * sample_rate


# ---------------------------------------------------------------------------
# IBIS/OIS sample collection + per-frame Catmull-Rom splines (sony.rs:210-428)
# ---------------------------------------------------------------------------

class ISTemp:
    def __init__(self):
        self.frame_interval = 0
        self.original_sample_rate = 0.0
        self.first_frame_ts: List[float] = []
        self.pixel_pitch = (1, 1)
        self.sensor_size = (1, 1)
        self.per_frame_exposure: List[float] = []
        self.per_frame_start_idx: List[int] = []
        self.per_frame_crop: List[Tuple[float, float, float, float]] = []
        self.t: List[int] = []
        self.ibis_x: List[int] = []
        self.ibis_y: List[int] = []
        self.ibis_a: List[int] = []
        self.ois_x: List[int] = []
        self.ois_y: List[int] = []

    def calc_time_diff(self, i1: int, i2: int) -> int:
        a = max(min(min(i1, i2), len(self.t) - 1), 0)
        b = max(min(max(i1, i2), len(self.t) - 1), 0)
        dt = self.t[b] - self.t[a]
        if dt < 0:
            dt += self.frame_interval
        return dt

    def search_idx(self, frame: int, top_offset: float, time_offset: float):
        start_idx = self.per_frame_start_idx[frame]
        index = start_idx
        current_time = float(self.t[start_idx])
        if top_offset >= 0.0:
            while current_time <= time_offset and index < len(self.t) - 1:
                current_time += self.calc_time_diff(index, index + 1)
                index += 1
        else:
            while index > 0 and current_time > time_offset:
                current_time -= self.calc_time_diff(index - 1, index)
                index -= 1
        return index, current_time

    def search_top_idx2(self, frame: int, top_offset: float):
        top_index, current_time = self.search_idx(frame, top_offset, top_offset)
        adj = 2 if top_offset >= 0.0 else 1
        for _ in range(adj):
            if top_index > 0:
                current_time -= self.calc_time_diff(top_index - 1, top_index)
                top_index -= 1
        return top_index, current_time

    def search_bot_idx2(self, frame: int, top_offset: float, bot_offset: float):
        bot_index, current_time = self.search_idx(frame, top_offset, bot_offset)
        adj = 2 if bot_offset >= 0.0 else 1
        for _ in range(adj):
            if bot_index > 0:
                current_time += self.calc_time_diff(bot_index, bot_index + 1)
                bot_index += 1
        return bot_index, current_time

    def calc_ofs(self, idx: int) -> int:
        acc = 0
        for i in range(idx):
            acc += self.calc_time_diff(i, i + 1)
        return acc


def stab_collect(is_temp: ISTemp, tag_map: dict, frame_rate: float) -> bool:
    """Collect one frame's IBIS/OIS samples (sony.rs:289-345)."""
    imager = tag_map.get("imager")
    gyro = tag_map.get("gyroscope")
    if not imager or not gyro:
        return False
    try:
        original_sample_rate = float(gyro["frequency"])
        first_frame_ts = imager["first_frame_ts"]
        exposure_time = imager["exposure_time"]
        sensor_size = tuple(imager["sensor_size_px"])
        pixel_pitch = tuple(imager["pixel_pitch"])
        crop_origin = tuple(imager["capture_area_origin"])
        crop_size = tuple(imager["capture_area_size"])
    except KeyError:
        return False

    start_idx = len(is_temp.t)
    ibis = tag_map.get("ibis")
    if ibis and ibis.get("data"):
        shift = ibis["data"]
        angle = ibis.get("data2") or [(s[0], 0, 0, 0) for s in shift]
        for s, a in zip(shift, angle):
            is_temp.t.append(int(s[0]))
            is_temp.ibis_x.append(int(s[1]))
            is_temp.ibis_y.append(int(s[2]))
            is_temp.ibis_a.append(int(a[3]))
    ois = tag_map.get("lens_oss")
    if ois and ois.get("data"):
        for s in ois["data"]:
            if not is_temp.ibis_x:
                is_temp.t.append(int(s[0]))
            is_temp.ois_x.append(int(s[1]))
            is_temp.ois_y.append(int(s[2]))

    is_temp.frame_interval = int(1000000.0 / frame_rate)
    is_temp.per_frame_exposure.append(exposure_time * 1000.0)
    is_temp.per_frame_start_idx.append(start_idx)
    is_temp.per_frame_crop.append((crop_origin[0], crop_origin[1],
                                   crop_size[0], crop_size[1]))
    is_temp.original_sample_rate = original_sample_rate
    is_temp.first_frame_ts.append(first_frame_ts * 1000.0)
    is_temp.pixel_pitch = pixel_pitch
    is_temp.sensor_size = sensor_size
    return True


def stab_calc_splines(md: FileMetadata, is_temp: ISTemp) -> Optional[List[CameraStabData]]:
    """Per-frame IBIS/OIS Catmull-Rom splines over sensor rows (sony.rs:347-409)."""
    num_frames = len(is_temp.per_frame_exposure)
    readout_time = max((md.frame_readout_time or 0.0) * 1000.0, 1.0)
    out = []
    for frame in range(num_frames):
        crop_area = is_temp.per_frame_crop[frame]
        exposure = is_temp.per_frame_exposure[frame]
        first_ts = is_temp.first_frame_ts[frame]
        top_offset = first_ts - exposure / 2.0
        bot_offset = top_offset + readout_time
        entry_rate = is_temp.sensor_size[1] / readout_time

        top_index, time = is_temp.search_top_idx2(frame, top_offset)
        n_entries = (is_temp.search_bot_idx2(frame, top_offset, bot_offset)[0]
                     - top_index + 1)
        ofs_rows = int(abs(time - top_offset) * entry_rate)

        ibis_spline = splines.CatmullRom()
        ois_spline = splines.CatmullRom()
        for i in range(n_entries):
            ts = is_temp.calc_ofs(i) * entry_rate
            if top_index + i < len(is_temp.ibis_x):
                ibis_spline.add_point(ts, np.asarray([
                    is_temp.ibis_x[top_index + i],
                    is_temp.ibis_y[top_index + i],
                    is_temp.ibis_a[top_index + i]], np.float64))
            if top_index + i < len(is_temp.ois_x):
                ois_spline.add_point(ts, np.asarray([
                    is_temp.ois_x[top_index + i],
                    is_temp.ois_y[top_index + i], 0.0], np.float64))
        out.append(CameraStabData(
            offset=float(ofs_rows), sensor_size=is_temp.sensor_size,
            crop_area=crop_area, pixel_pitch=is_temp.pixel_pitch,
            ibis_spline=ibis_spline, ois_spline=ois_spline))
    return out or None


# ---------------------------------------------------------------------------
# Mesh correction + focal-plane distortion (sony.rs:411-557)
# ---------------------------------------------------------------------------

def _fit_row_coeffs(mesh: List[float], offset: int, gw: int, gh: int,
                    size_x: float):
    """Append per-row x-spline coefficient blocks for one channel."""
    out = []
    pts = np.asarray(mesh[9:9 + gw * gh * 2], np.float64).reshape(gh, gw, 2)
    a, b, c, d = splines.cubic_spline_coefficients(pts[..., offset], size_x)
    for j in range(gh):
        for arr in (a, b, c, d):
            row = np.zeros(splines.MAX_GRID_SIZE)
            row[:gw] = arr[j][:gw]
            out.extend(row.tolist())
    return out


def _build_mesh_vec(divisions, size, crop_origin, crop_size, grid_pts,
                    focal_plane_data) -> np.ndarray:
    gw, gh = divisions
    mesh = [0.0, float(gw), float(gh), float(size[0]), float(size[1]),
            float(crop_origin[0]), float(crop_origin[1]),
            float(crop_size[0]), float(crop_size[1])]
    if grid_pts is not None:
        mesh.extend(np.asarray(grid_pts, np.float64).reshape(-1).tolist())
        for ch in range(2):
            mesh.extend(_fit_row_coeffs(mesh, ch, gw, gh, size[0]))
    mesh[0] = float(len(mesh))
    mesh.extend(focal_plane_data)
    return np.asarray(mesh, np.float64)


def _inverse_interpolate_mesh(xp: float, yp: float, size, mesh) -> Tuple[float, float]:
    """Nelder-Mead inverse like sony.rs:568-597."""
    from scipy.optimize import minimize

    def cost(p):
        uv = splines.interpolate_mesh(np.asarray([p[0]]), np.asarray([p[1]]),
                                      size, mesh)
        return float((uv[0, 0] - xp) ** 2 + (uv[0, 1] - yp) ** 2)

    res = minimize(cost, np.asarray([xp, yp]), method="Nelder-Mead",
                   options={"maxiter": 400, "xatol": 1e-8, "fatol": 1e-16})
    return float(res.x[0]), float(res.x[1])


def get_mesh_correction(tag_map: dict, cache: Dict[int, tuple]) -> Optional[tuple]:
    """(mesh f64, inverse mesh f32) per frame (sony.rs:411-557)."""
    mesh_group = tag_map.get("mesh_correction")
    fpd_group = tag_map.get("focal_plane_distortion")
    imager = tag_map.get("imager", {})
    crop_origin = imager.get("capture_area_origin")
    crop_size = imager.get("capture_area_size")
    if crop_origin is None or crop_size is None:
        return None
    mesh_data = (mesh_group or {}).get("data")
    fpd_data = (fpd_group or {}).get("data")

    key = zlib.crc32(repr((mesh_data, fpd_data, crop_origin, crop_size)).encode())
    if key in cache:
        return cache[key]

    has_mesh = bool(mesh_data) and any(
        c[0] != 0.0 or c[1] != 0.0 for c in mesh_data.get("raw_mesh", []))
    focal_plane = [0.0]
    has_fpd = False
    if fpd_data:
        coords = []
        for c in fpd_data.get("unk4", []):
            has_fpd = True
            coords.extend([c[0] / 32768.0, c[1] / 32768.0])
        focal_plane = [float(len(fpd_data.get("unk4", []))),
                       float(fpd_data.get("unk1", 0)),
                       float(fpd_data.get("unk2", 0)),
                       float(fpd_data.get("scale", 0.0))] + coords
        if len(focal_plane) == 4 or focal_plane[0] != 8.0:
            if focal_plane[0] != 8.0 and len(focal_plane) > 4:
                log.error("Invalid FocalPlaneDistortion data: %s", focal_plane[:4])
            focal_plane = [0.0]
            has_fpd = False
    if not has_mesh and not has_fpd:
        return None

    size = tuple(mesh_data.get("size", (0.0, 0.0))) if mesh_data else (0.0, 0.0)
    divisions = tuple(mesh_data.get("divisions", (0, 0))) if mesh_data else (0, 0)

    grid = np.asarray(mesh_data["mesh"], np.float64) if has_mesh else None
    mesh = _build_mesh_vec(divisions, size, crop_origin, crop_size, grid,
                           focal_plane)

    if has_mesh:
        gw, gh = divisions
        step = (size[0] / (gw - 1.0), size[1] / (gh - 1.0))
        inv_pts = []
        for yi in range(gh):
            for xi in range(gw):
                inv_pts.append(_inverse_interpolate_mesh(step[0] * xi,
                                                         step[1] * yi,
                                                         size, mesh))
        inv_grid = np.asarray(inv_pts, np.float64)
    else:
        inv_grid = None
    inv_mesh = _build_mesh_vec(divisions, size, crop_origin, crop_size,
                               inv_grid, focal_plane).astype(np.float32)

    result = (mesh, inv_mesh)
    cache[key] = result
    return result


# ---------------------------------------------------------------------------
# MP4 carriage (synthetic rtmd tag-map track)
# ---------------------------------------------------------------------------

def has_sony_rtmd(path: str) -> bool:
    from .mp4 import find_metadata_track, mapped
    try:
        with mapped(path) as buf:
            return find_metadata_track(buf, b"rtmd") is not None
    except Exception:
        return False


def build_tagmap_mp4(tag_maps: List[dict], fps: float = 30.0,
                     encoding: str = "cbor") -> bytes:
    """Serialize per-frame tag maps into an MP4 with an `rtmd` metadata track.

    encoding="klv" writes real SMPTE ST 336 samples (telemetry/klv.py);
    "cbor" keeps the legacy fixture encoding. Used by tests and by tooling
    that embeds pre-parsed Sony telemetry back into a clip."""
    from ...utils import cbor
    from . import klv
    from .mp4 import build_metadata_mp4

    if encoding == "klv":
        payloads = [klv.encode_rtmd_sample(tm) for tm in tag_maps]
    else:
        payloads = [cbor.dumps(tm) for tm in tag_maps]
    return build_metadata_mp4(b"rtmd", "Sony RTMD", payloads, fps)


def parse_sony_mp4(path: str, fps: float = 0.0, size=(0, 0),
                   progress_cb=None) -> FileMetadata:
    """Assemble FileMetadata from per-frame rtmd tag maps (the wiring of
    gyro_source/mod.rs:440-541 for the Sony branch)."""
    from ...utils import cbor
    from .mp4 import find_metadata_track

    from .mp4 import mapped
    with mapped(path) as buf:
        track = find_metadata_track(buf, b"rtmd")
        if track is None:
            raise ValueError(f"No rtmd track in {path}")
        sample_payloads = [(bytes(buf[off:off + sz]), ts)
                           for (off, sz, ts, _dur) in track.samples()]

    from . import klv

    tag_maps = []
    klv_skipped = 0
    for payload, ts in sample_payloads:
        if klv.looks_like_klv(payload):
            try:
                tm, skipped = klv.decode_rtmd_sample(payload)
            except klv.KLVError as e:
                raise ValueError(f"malformed Sony RTMD KLV sample: {e}")
            klv_skipped += skipped
            tag_maps.append((ts, tm))
            continue
        try:
            tag_maps.append((ts, cbor.loads(payload)))
        except Exception:
            raise ValueError(
                "rtmd track present but neither SMPTE KLV nor the "
                "gyroflow_tpu tag-map encoding")
    if klv_skipped:
        log.info("Sony RTMD: skipped %d unknown KLV tags/sets", klv_skipped)

    md = FileMetadata()
    md.detected_source = "Sony " + (tag_maps[0][1].get("camera_model", "")
                                    if tag_maps else "")
    camera_model = (tag_maps[0][1].get("camera_model", "") if tag_maps else "")
    first = tag_maps[0][1] if tag_maps else {}
    # surface lens identity for profile autoload (the camera identifier
    # needs a lens_info segment; bodies report the mounted lens name in the
    # RTMD lens set — fall back to "stock" so IBIS bodies still match the
    # bundled starter presets when the clip omits it)
    if first.get("lens_model"):
        md.additional_data["lens_model"] = str(first["lens_model"])
    md.additional_data.setdefault("lens_info", "stock")
    frame_rate = fps or first.get("frame_rate", 30.0)
    md.frame_rate = frame_rate
    md.frame_readout_time = first.get("frame_readout_time")
    if size == (0, 0):
        size = tuple(first.get("video_size", (1920, 1080)))

    # raw IMU from per-frame gyro/accel sample lists
    sample_rate = 0.0
    for (_ts, tm) in tag_maps:
        g = tm.get("gyroscope", {})
        if g.get("frequency"):
            sample_rate = float(g["frequency"])
            break
    for (_ts, tm) in tag_maps:
        for (t_ms, x, y, z) in tm.get("gyroscope", {}).get("data", []):
            md.raw_imu.append(TimeIMU(timestamp_ms=float(t_ms),
                                      gyro=np.asarray([x, y, z], np.float64)))
    acc_all = [s for (_ts, tm) in tag_maps
               for s in tm.get("accelerometer", {}).get("data", [])]
    for i, s in enumerate(acc_all):
        if i < len(md.raw_imu):
            md.raw_imu[i].accl = np.asarray(s[1:], np.float64)
    md.imu_orientation = first.get("imu_orientation", "XYZ")

    is_temp = ISTemp()
    mesh_cache: Dict[int, tuple] = {}
    original_sample_rate = sample_rate
    for fi, (ts_ms, tm) in enumerate(tag_maps):
        res = get_time_offset(md, tm, sample_rate, camera_model)
        if res is not None:
            original_sample_rate, offset = res
            md.per_frame_time_offsets.append(offset)
        md.lens_params.setdefault(int(round(ts_ms * 1000.0)), LensParamsEntry(
            pixel_pitch=tuple(tm.get("imager", {}).get("pixel_pitch", (0, 0))),
            capture_area_size=tuple(tm.get("imager", {}).get("capture_area_size", (0, 0))),
            sensor_size_px=tuple(tm.get("imager", {}).get("sensor_size_px", (0, 0)))))
        init_lens_profile(md, tm, size, ts_ms, camera_model)
        stab_collect(is_temp, tm, frame_rate)
        mesh = get_mesh_correction(tm, mesh_cache)
        if mesh is not None:
            md.mesh_correction.append(mesh)
        if progress_cb:
            progress_cb((fi + 1) / len(tag_maps))

    if is_temp.t:
        md.camera_stab_data = stab_calc_splines(md, is_temp) or []
        if md.frame_readout_time and original_sample_rate:
            md.frame_readout_time = (md.frame_readout_time /
                                     original_sample_rate * sample_rate)
    return md
