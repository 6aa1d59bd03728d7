"""GoPro GPMF telemetry parser (MP4 `gpmd` track).

From-scratch implementation of the public GPMF KLV format (GoPro's
gpmf-parser spec): 32-bit aligned Key-Length-Value records — 4-byte FourCC,
1-byte type char, 1-byte struct size, 2-byte big-endian repeat count; type 0
marks a nested container. The reference obtains the same data via the
external `telemetry-parser` crate (src/core/Cargo.toml:14); feature parity
target is GyroSource::parse_telemetry_file (gyro_source/mod.rs:110) for
GoPro sources: GYRO/ACCL raw IMU, CORI camera quaternions, IORI image
orientations, GRAV gravity vectors, per-stream SCAL scaling and ORIN axis
remap, sample timing distributed across MP4 payload sample durations.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..file_metadata import FileMetadata, TimeIMU
from ..time_quat import TimeQuat

_SCALARS = {
    b"b": ("b", 1), b"B": ("B", 1), b"s": ("h", 2), b"S": ("H", 2),
    b"l": ("i", 4), b"L": ("I", 4), b"f": ("f", 4), b"d": ("d", 8),
    b"j": ("q", 8), b"J": ("Q", 8),
}


class KLV:
    __slots__ = ("key", "type", "ssize", "repeat", "data", "children")

    def __init__(self, key, typ, ssize, repeat, data, children):
        self.key, self.type, self.ssize, self.repeat = key, typ, ssize, repeat
        self.data, self.children = data, children

    def values(self) -> Optional[np.ndarray]:
        """Decode payload to (repeat, n_components) float array."""
        t = self.type
        if t in _SCALARS:
            fmt, width = _SCALARS[t]
            per = max(self.ssize // width, 1)
            total = per * self.repeat
            vals = struct.unpack(f">{total}{fmt}", self.data[:total * width])
            return np.asarray(vals, np.float64).reshape(self.repeat, per)
        if t == b"q":  # Q15.16 fixed point
            total = max(self.ssize // 4, 1) * self.repeat
            raw = struct.unpack(f">{total}i", self.data[:total * 4])
            return (np.asarray(raw, np.float64) / 65536.0).reshape(self.repeat, -1)
        return None

    def string(self) -> str:
        return self.data.split(b"\x00")[0].decode("latin-1", "replace")

    def find(self, key: bytes) -> Optional["KLV"]:
        for c in self.children:
            if c.key == key:
                return c
        return None

    def find_all(self, key: bytes) -> List["KLV"]:
        return [c for c in self.children if c.key == key]


def parse_klv(buf: bytes, start: int = 0, end: Optional[int] = None) -> List[KLV]:
    if end is None:
        end = len(buf)
    out = []
    pos = start
    while pos + 8 <= end:
        key = buf[pos:pos + 4]
        typ = buf[pos + 4:pos + 5]
        ssize = buf[pos + 5]
        repeat = struct.unpack_from(">H", buf, pos + 6)[0]
        dlen = ssize * repeat
        payload_end = pos + 8 + dlen
        if payload_end > end:
            break
        if typ == b"\x00":
            children = parse_klv(buf, pos + 8, payload_end)
            out.append(KLV(key, typ, ssize, repeat, b"", children))
        else:
            out.append(KLV(key, typ, ssize, repeat, buf[pos + 8:payload_end], []))
        pos += 8 + ((dlen + 3) & ~3)  # 32-bit aligned
    return out


_AXIS = {"X": 0, "Y": 1, "Z": 2}


def _apply_orientation(vals: np.ndarray, orin: Optional[str]) -> np.ndarray:
    """ORIN gives the axis order/sign of the stored components; remap to XYZ.

    Uppercase = positive, lowercase = negative, e.g. "zxY" means the stored
    triple is (-z, -x, +y)."""
    if not orin or len(orin) != vals.shape[1]:
        return vals
    out = np.empty_like(vals)
    for i, ch in enumerate(orin):
        axis = _AXIS.get(ch.upper())
        if axis is None:
            return vals
        out[:, axis] = vals[:, i] * (1.0 if ch.isupper() else -1.0)
    return out


def _scaled(strm: KLV, key: bytes) -> Optional[np.ndarray]:
    node = strm.find(key)
    if node is None:
        return None
    vals = node.values()
    if vals is None:
        return None
    scal = strm.find(b"SCAL")
    if scal is not None:
        sv = scal.values()
        if sv is not None:
            sv = sv.reshape(-1)
            if len(sv) == vals.shape[1]:
                vals = vals / sv[None, :]
            else:
                vals = vals / sv[0]
    orin = strm.find(b"ORIN")
    return _apply_orientation(vals, orin.string() if orin is not None else None)


def _sample_times_ms(t0_s: float, dur_s: float, n: int) -> np.ndarray:
    if n <= 0:
        return np.zeros(0)
    return (t0_s + np.arange(n) * (dur_s / n)) * 1000.0


def parse_gpmf_payloads(payloads: List[Tuple[bytes, float, float]]) -> FileMetadata:
    """Assemble FileMetadata from (gpmf_bytes, start_time_s, duration_s) payloads."""
    fm = FileMetadata()
    imu: Dict[float, TimeIMU] = {}
    quats_t, quats_v = [], []
    iori_t, iori_v = [], []
    grav_t, grav_v = [], []
    model = None

    for blob, t0, dur in payloads:
        for devc in parse_klv(blob):
            if devc.key != b"DEVC":
                continue
            dvnm = devc.find(b"DVNM")
            if dvnm is not None and model is None:
                model = dvnm.string()
            for strm in devc.find_all(b"STRM"):
                for key, units in ((b"GYRO", "rad/s"), (b"ACCL", "m/s2")):
                    vals = _scaled(strm, key)
                    if vals is None:
                        continue
                    ts = _sample_times_ms(t0, dur, len(vals))
                    for t, v in zip(ts, vals):
                        rec = imu.setdefault(round(float(t), 6), TimeIMU(timestamp_ms=float(t)))
                        if key == b"GYRO":
                            rec.gyro = np.degrees(v[:3])     # TimeIMU stores deg/s
                        else:
                            rec.accl = v[:3].astype(np.float64)
                for key, (tl, vl) in ((b"CORI", (quats_t, quats_v)),
                                      (b"IORI", (iori_t, iori_v))):
                    node = strm.find(key)
                    if node is None:
                        continue
                    vals = node.values()
                    if vals is None or vals.shape[1] < 4:
                        continue
                    scal = strm.find(b"SCAL")
                    if scal is not None and scal.values() is not None:
                        vals = vals / scal.values().reshape(-1)[0]
                    ts = _sample_times_ms(t0, dur, len(vals))
                    tl.extend(ts.tolist())
                    vl.append(vals[:, :4])
                gnode = strm.find(b"GRAV")
                if gnode is not None:
                    vals = gnode.values()
                    if vals is not None and vals.shape[1] >= 3:
                        scal = strm.find(b"SCAL")
                        if scal is not None and scal.values() is not None:
                            vals = vals / scal.values().reshape(-1)[0]
                        ts = _sample_times_ms(t0, dur, len(vals))
                        grav_t.extend(ts.tolist())
                        grav_v.append(vals[:, :3])

    fm.raw_imu = [imu[k] for k in sorted(imu)]
    if quats_v:
        q = np.concatenate(quats_v)          # GPMF CORI order: (w, x, y, z)
        n = np.linalg.norm(q, axis=-1, keepdims=True)
        q = q / np.where(n == 0, 1.0, n)
        fm.quaternions = TimeQuat((np.asarray(quats_t) * 1000).astype(np.int64), q)
    if iori_v:
        q = np.concatenate(iori_v)
        n = np.linalg.norm(q, axis=-1, keepdims=True)
        fm.image_orientations = TimeQuat((np.asarray(iori_t) * 1000).astype(np.int64),
                                         q / np.where(n == 0, 1.0, n))
    if grav_v:
        fm.gravity_vectors = {"ts": (np.asarray(grav_t) * 1000).astype(np.int64),
                              "vec": np.concatenate(grav_v)}
    fm.detected_source = f"GoPro {model}" if model else "GoPro"
    fm.has_accurate_timestamps = True
    return fm


def parse_gpmf_mp4(path: str, progress_cb=None) -> FileMetadata:
    """Extract the `gpmd` metadata track from an MP4 and parse its payloads."""
    from .mp4 import find_metadata_track, mapped
    with mapped(path) as buf:
        track = find_metadata_track(buf, b"gpmd")
        if track is None:
            from . import TelemetryError
            raise TelemetryError("no GPMF (gpmd) track in MP4")
        payloads = []
        samples = track.samples()
        for i, (off, size, t, dur) in enumerate(samples):
            payloads.append((bytes(buf[off:off + size]), t, dur))
            if progress_cb:
                progress_cb((i + 1) / max(len(samples), 1))
    return parse_gpmf_payloads(payloads)


def has_gpmf(path: str) -> bool:
    try:
        from .mp4 import find_metadata_track, mapped
        with mapped(path) as buf:
            return find_metadata_track(buf, b"gpmd") is not None
    except Exception:
        return False
