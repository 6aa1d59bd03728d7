"""Insta360 .insv/.insp trailer telemetry parser.

The reference delegates Insta360 parsing to the external `telemetry-parser`
crate (src/core/Cargo.toml:14) and applies per-frame exposure time offsets at
gyroflow src/core/gyro_source/mod.rs:502-532. The trailer container
format is publicly reverse-engineered (exiftool's ProcessInsta360,
telemetry-parser's insta360 module, lolimay/insta360-insv-format):

  [record data][record descriptor: id u16le + size u32le] ... repeated ...
  [fixed tail][32-byte ASCII magic "8db42d694ccc418790edff439fe026bf"]

Records are walked BACK-TO-FRONT starting just before the fixed tail; each
6-byte descriptor gives the id and the byte length of the record data that
precedes it. Known record ids:

  0x101  file info (serial, firmware, camera model strings)
  0x300  gyro samples:  [t f64 seconds][gyro xyz f64 rad/s][accel xyz f64 g]
         (56 bytes per sample)
  0x400  exposure:      [t f64 seconds][exposure f64 seconds] (16 bytes)
  0x600  frame time map: [t f64][v f64] pairs (ms) — actual vs. nominal
         frame times (best-effort layout; the crate source isn't vendored)

The per-frame time offsets mirror gyro_source/mod.rs:505-531: for each video
frame, offset = -(exposure_ms / 2) - 0.9 - (video_ts - t)*1000 - tm_diff
- zero_ref, where zero_ref is the first frame's reference time and
tm_diff = tm[i].t - tm[i].v from the TimeMap record (mod.rs:521-524; the
0.9 ms constant is carried over verbatim — the reference marks it as
empirical).
"""
from __future__ import annotations

import logging
import math
import os
import struct
from typing import Callable, Optional

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU

log = logging.getLogger(__name__)

MAGIC = b"8db42d694ccc418790edff439fe026bf"
TAIL_FIXED = 78          # fixed tail incl. the 32-byte magic
RECORD_INFO = 0x101
RECORD_GYRO = 0x300
RECORD_EXPOSURE = 0x400
RECORD_TIMESTAMPS = 0x600
G_TO_MS2 = 9.80665
RAD2DEG = 180.0 / math.pi


def has_insv_trailer(path: str) -> bool:
    try:
        size = os.path.getsize(path)
        if size < TAIL_FIXED:
            return False
        with open(path, "rb") as f:
            f.seek(size - len(MAGIC))
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def _walk_records(path: str):
    """Yield (record_id, bytes) walking the trailer back-to-front."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = size - TAIL_FIXED
        while pos >= 6:
            f.seek(pos - 6)
            rid, rsize = struct.unpack("<HI", f.read(6))
            if rsize == 0 or rsize > pos - 6:
                break
            f.seek(pos - 6 - rsize)
            data = f.read(rsize)
            yield rid, data
            pos -= 6 + rsize


def parse_insv(path: str, fps: float = 0.0,
               progress_cb: Optional[Callable[[float], None]] = None) -> FileMetadata:
    """Parse an Insta360 .insv/.insp trailer into FileMetadata."""
    md = FileMetadata()
    md.detected_source = "Insta360"
    # telemetry-parser reports Insta360 IMU axes remapped as (x, z, y)
    md.imu_orientation = "xzy"
    # fixed wide lenses on the GO/X/Ace consumer line — gives the camera
    # identifier its lens_info segment so profile autoload can match
    md.additional_data["lens_info"] = "wide"

    gyro = acc = ts = None
    exposures = []          # (t_s, exposure_s)
    time_map = []           # (t_ms, v_ms) pairs from record 0x600

    for rid, data in _walk_records(path):
        if rid == RECORD_GYRO and len(data) >= 56 and len(data) % 56 == 0:
            arr = np.frombuffer(data, dtype="<f8").reshape(-1, 7)
            ts = arr[:, 0] * 1000.0                     # -> ms
            gyro = arr[:, 1:4].astype(np.float64)       # rad/s
            acc = arr[:, 4:7].astype(np.float64)        # g
        elif rid == RECORD_EXPOSURE and len(data) >= 16 and len(data) % 16 == 0:
            arr = np.frombuffer(data, dtype="<f8").reshape(-1, 2)
            exposures = [(float(t), float(e)) for t, e in arr]
        elif rid == RECORD_TIMESTAMPS and len(data) >= 16 and len(data) % 16 == 0:
            arr = np.frombuffer(data, dtype="<f8").reshape(-1, 2)
            time_map = [(float(t), float(v)) for t, v in arr]
        elif rid == RECORD_INFO:
            try:
                txt = data.split(b"\x00")[0].decode("utf-8", "replace").strip()
                if txt:
                    md.additional_data["camera_info"] = txt
                    # surface the camera model for lens autoload
                    # (camera_identifier.rs builds ids from brand+model):
                    # the info string carries "Insta360 <model>" or a bare
                    # model name like "GO 3" / "X3" / "Ace Pro"
                    model = txt
                    if model.lower().startswith("insta360"):
                        model = model[len("insta360"):].strip(" _-")
                    keep = []
                    for tok in model.split():
                        tl = tok.lower()
                        # stop at firmware-version-ish tokens ("v1.0", "2.1")
                        if (tl[:1] == "v" and tl[1:2].isdigit()) or \
                                (tl[:1].isdigit() and "." in tl):
                            break
                        keep.append(tok)
                    model = " ".join(keep)
                    if model:
                        md.detected_source = f"Insta360 {model}"
            except Exception:
                pass

    if gyro is None or ts is None or len(ts) == 0:
        raise ValueError(f"no gyro record (0x300) in {os.path.basename(path)}")

    # normalize to a zero-based ms timeline like the other parsers
    t0 = float(ts[0])
    t_ms = ts - t0
    gyro_deg = gyro * RAD2DEG
    accl = acc * G_TO_MS2
    n = len(t_ms)
    md.raw_imu = []
    for i in range(n):
        md.raw_imu.append(TimeIMU(timestamp_ms=float(t_ms[i]),
                                  gyro=gyro_deg[i].copy(),
                                  accl=accl[i].copy()))
        if progress_cb and i % 4096 == 0:
            progress_cb(i / n)

    # per-frame time offsets (gyro_source/mod.rs:505-531)
    if exposures and fps > 0:
        # The 0x600 pair layout is inferred, not documented. A genuine
        # actual-vs-nominal time map drifts by well under a frame interval;
        # if the diffs are frame-sized the record is something else (e.g.
        # plain per-frame timestamps read as pairs) — ignore it rather than
        # corrupt every offset.
        if time_map:
            diffs = np.asarray([t - v for t, v in time_map])
            ts_col = np.asarray([t for t, _ in time_map])
            if (not np.isfinite(diffs).all()
                    or np.any(np.diff(ts_col) < 0)
                    or np.abs(diffs).max() > 0.6 * (1000.0 / fps)):
                log.warning("insv record 0x600 does not look like a "
                            "(t, v) time map (max |t-v| = %.3f ms); "
                            "ignoring it", float(np.abs(diffs).max()))
                time_map = []
        video_ts = 0.0
        zero_ref = None
        prev_t = 0.0
        i = 0
        for t, exp in exposures:
            if t > prev_t or t == 0.0:
                if zero_ref is None:
                    zero_ref = t * 1000.0
                # TimeMap correction (gyro_source/mod.rs:521-524):
                # tm_diff = tm[i].t - tm[i].v, already in ms
                tm_diff = (time_map[i][0] - time_map[i][1]
                           if i < len(time_map) else 0.0)
                diff = (video_ts - t) * 1000.0
                md.per_frame_time_offsets.append(
                    -(exp * 1000.0 / 2.0) - 0.9 - diff - tm_diff - zero_ref)
                video_ts += 1.0 / fps
                prev_t = t
                i += 1

    if progress_cb:
        progress_cb(1.0)
    return md
