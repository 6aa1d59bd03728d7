"""Keyframed parameter system.

Port of gyroflow src/core/keyframes.rs: 27 keyframe types, per-keyframe
sine easing (NoEasing/EaseIn/EaseOut/EaseInOut resolved pairwise), closest-
timestamp snapping (±1ms), gyro-offset-aware lookup, VFR timestamp scale.
Serialization format matches the reference's serde JSON so `.gyroflow`
project files round-trip.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional

import numpy as np

from .time_quat import interp_series


class KeyframeType(str, Enum):
    # names must match keyframes.rs:24-52 exactly (serialized into projects)
    Fov = "Fov"
    VideoRotation = "VideoRotation"
    ZoomingSpeed = "ZoomingSpeed"
    ZoomingCenterX = "ZoomingCenterX"
    ZoomingCenterY = "ZoomingCenterY"
    MaxZoom = "MaxZoom"
    AdditionalRotationX = "AdditionalRotationX"
    AdditionalRotationY = "AdditionalRotationY"
    AdditionalRotationZ = "AdditionalRotationZ"
    AdditionalTranslationX = "AdditionalTranslationX"
    AdditionalTranslationY = "AdditionalTranslationY"
    AdditionalTranslationZ = "AdditionalTranslationZ"
    BackgroundMargin = "BackgroundMargin"
    BackgroundFeather = "BackgroundFeather"
    LockHorizonAmount = "LockHorizonAmount"
    LockHorizonRoll = "LockHorizonRoll"
    LockHorizonPitchEnabled = "LockHorizonPitchEnabled"
    LockHorizonPitch = "LockHorizonPitch"
    LensCorrectionStrength = "LensCorrectionStrength"
    LightRefractionCoeff = "LightRefractionCoeff"
    SmoothingParamTimeConstant = "SmoothingParamTimeConstant"
    SmoothingParamTimeConstant2 = "SmoothingParamTimeConstant2"
    SmoothingParamSmoothness = "SmoothingParamSmoothness"
    SmoothingParamPitch = "SmoothingParamPitch"
    SmoothingParamRoll = "SmoothingParamRoll"
    SmoothingParamYaw = "SmoothingParamYaw"
    VideoSpeed = "VideoSpeed"


class Easing(str, Enum):
    NoEasing = "NoEasing"
    EaseIn = "EaseIn"
    EaseOut = "EaseOut"
    EaseInOut = "EaseInOut"

    @staticmethod
    def resolve(a: "Easing", b: "Easing") -> "Easing":
        """Pairwise easing resolution (keyframes.rs:278-288)."""
        a_out = a in (Easing.EaseOut, Easing.EaseInOut)
        b_in = b in (Easing.EaseIn, Easing.EaseInOut)
        if a_out and b_in:
            return Easing.EaseInOut
        if b_in:
            return Easing.EaseOut
        if a_out:
            return Easing.EaseIn
        return Easing.NoEasing

    def apply(self, x: float) -> float:
        """Sine easings, computed in f32 like simple_easing (keyframes.rs:290-296)."""
        xf = np.float32(x)
        if self is Easing.EaseIn:
            return float(np.float32(1.0) - np.cos(xf * np.float32(math.pi / 2)))
        if self is Easing.EaseOut:
            return float(np.sin(xf * np.float32(math.pi / 2)))
        if self is Easing.EaseInOut:
            return float(-(np.cos(np.float32(math.pi) * xf) - np.float32(1.0)) / np.float32(2.0))
        return x

    def interpolate(self, a: float, b: float, x: float) -> float:
        return a + (b - a) * self.apply(x)


@dataclass
class Keyframe:
    value: float
    easing: Easing = Easing.EaseInOut
    id: int = field(default_factory=lambda: random.randint(1, 2147483639))


class KeyframeManager:
    """BTreeMap-per-type keyframe store with eased interpolation (keyframes.rs:75+)."""

    def __init__(self):
        self.keyframes: Dict[KeyframeType, Dict[int, Keyframe]] = {}
        self.gyro_offsets: Dict[int, float] = {}
        self.timestamp_scale: Optional[float] = None

    def clone(self) -> "KeyframeManager":
        km = KeyframeManager()
        km.keyframes = {t: dict(v) for t, v in self.keyframes.items()}
        km.gyro_offsets = dict(self.gyro_offsets)
        km.timestamp_scale = self.timestamp_scale
        return km

    def _closest_timestamp(self, typ: KeyframeType, timestamp_us: int) -> int:
        kfs = self.keyframes.get(typ)
        if kfs:
            for ts in sorted(kfs):
                if timestamp_us - 1000 <= ts <= timestamp_us + 1000:
                    return ts
        return timestamp_us

    def set(self, typ: KeyframeType, timestamp_us: int, value: float):
        timestamp_us = self._closest_timestamp(typ, timestamp_us)
        kfs = self.keyframes.setdefault(typ, {})
        if timestamp_us in kfs:
            kfs[timestamp_us].value = value
        else:
            kfs[timestamp_us] = Keyframe(value)

    def set_easing(self, typ: KeyframeType, timestamp_us: int, easing: Easing):
        timestamp_us = self._closest_timestamp(typ, timestamp_us)
        kf = self.keyframes.get(typ, {}).get(timestamp_us)
        if kf:
            kf.easing = easing

    def remove(self, typ: KeyframeType, timestamp_us: int):
        timestamp_us = self._closest_timestamp(typ, timestamp_us)
        self.keyframes.get(typ, {}).pop(timestamp_us, None)

    def is_keyframed(self, typ: KeyframeType) -> bool:
        return bool(self.keyframes.get(typ))

    def clear(self):
        self.__init__()

    def clear_type(self, typ: KeyframeType):
        self.keyframes.pop(typ, None)

    def get_all_keys(self):
        return [t for t, v in self.keyframes.items() if v]

    def value_at_video_timestamp(self, typ: KeyframeType, timestamp_ms: float) -> Optional[float]:
        """keyframes.rs:167-201: clamp to [first,last], eased interpolation."""
        kfs = self.keyframes.get(typ)
        if not kfs:
            return None
        ts_sorted = sorted(kfs)
        if len(ts_sorted) == 1:
            return kfs[ts_sorted[0]].value
        scale = self.timestamp_scale or 1.0
        timestamp_us = int(round(timestamp_ms * 1000.0 * scale))
        lookup = min(max(timestamp_us, ts_sorted[0]), ts_sorted[-1])
        # left bracket
        import bisect
        i = bisect.bisect_right(ts_sorted, lookup) - 1
        t1 = ts_sorted[i]
        if t1 == lookup:
            return kfs[t1].value
        t2 = ts_sorted[min(i + 1, len(ts_sorted) - 1)]
        if t2 == t1:
            return kfs[t1].value
        alpha = (timestamp_us - t1) / (t2 - t1)
        e = Easing.resolve(kfs[t1].easing, kfs[t2].easing)
        return e.interpolate(kfs[t1].value, kfs[t2].value, alpha)

    def value_at_gyro_timestamp(self, typ: KeyframeType, timestamp_ms: float) -> Optional[float]:
        if self.gyro_offsets:
            ts = np.asarray(sorted(self.gyro_offsets), dtype=np.int64)
            vs = np.asarray([self.gyro_offsets[int(t)] for t in ts])
            timestamp_ms = timestamp_ms + float(interp_series(ts, vs, timestamp_ms))
        return self.value_at_video_timestamp(typ, timestamp_ms)

    def update_gyro(self, gyro):
        self.gyro_offsets = dict(gyro.offsets)

    # --- dense evaluation helpers for the compute pipeline -----------------

    def values_or_default(self, typ: KeyframeType, timestamps_ms, default: float,
                          gyro_time: bool = False) -> np.ndarray:
        """Evaluate at many timestamps; plain array fill when not keyframed."""
        timestamps_ms = np.atleast_1d(np.asarray(timestamps_ms, dtype=np.float64))
        if not self.is_keyframed(typ):
            return np.full(timestamps_ms.shape, default)
        fn = self.value_at_gyro_timestamp if gyro_time else self.value_at_video_timestamp
        out = np.empty(timestamps_ms.shape)
        for i, t in enumerate(timestamps_ms):
            v = fn(typ, float(t))
            out[i] = default if v is None else v
        return out

    # --- serialization (format-compatible with keyframes.rs serde) ---------

    def serialize(self) -> dict:
        return {
            typ.value: {
                str(ts): {"id": kf.id, "value": kf.value, "easing": kf.easing.value}
                for ts, kf in kfs.items()
            }
            for typ, kfs in self.keyframes.items() if kfs
        }

    def deserialize(self, data: dict):
        self.keyframes = {}
        if not isinstance(data, dict):
            return
        for typ_name, kfs in data.items():
            try:
                typ = KeyframeType(typ_name)
            except ValueError:
                continue
            out = {}
            for ts, kf in kfs.items():
                out[int(ts)] = Keyframe(
                    value=float(kf["value"]),
                    easing=Easing(kf.get("easing", "EaseInOut")),
                    id=int(kf.get("id", 1)))
            self.keyframes[typ] = out
