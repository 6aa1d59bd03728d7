"""Lens calibration profile.

Port of gyroflow src/core/lens_profile.rs. The JSON schema is preserved
verbatim so the reference's lens-profile database files load directly.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Dimensions:
    w: int = 0
    h: int = 0


@dataclass
class CameraParams:
    """lens_profile.rs:21."""
    RMS_error: float = 0.0
    camera_matrix: List[List[float]] = field(default_factory=list)
    distortion_coeffs: List[float] = field(default_factory=list)
    radial_distortion_limit: Optional[float] = None


@dataclass
class LensProfile:
    """lens_profile.rs:25-83 (field names match serde)."""
    name: str = ""
    note: str = ""
    calibrated_by: str = ""
    camera_brand: str = ""
    camera_model: str = ""
    lens_model: str = ""
    camera_setting: str = ""
    calib_dimension: Dimensions = field(default_factory=Dimensions)
    orig_dimension: Dimensions = field(default_factory=Dimensions)
    output_dimension: Optional[Dimensions] = None
    frame_readout_time: Optional[float] = None
    frame_readout_direction: Optional[object] = None
    gyro_lpf: Optional[float] = None
    input_horizontal_stretch: float = 0.0
    input_vertical_stretch: float = 0.0
    num_images: int = 0
    fps: float = 0.0
    crop: Optional[float] = None
    official: bool = False
    asymmetrical: bool = False
    fisheye_params: CameraParams = field(default_factory=CameraParams)
    identifier: str = ""
    calibrator_version: str = ""
    date: str = ""
    compatible_settings: List[dict] = field(default_factory=list)
    sync_settings: Optional[dict] = None
    distortion_model: Optional[str] = None
    digital_lens: Optional[str] = None
    digital_lens_params: Optional[List[float]] = None
    interpolations: Optional[dict] = None
    focal_length: Optional[float] = None
    crop_factor: Optional[float] = None
    global_shutter: bool = False
    path_to_file: str = ""
    optimal_fov: Optional[float] = None
    is_copy: bool = False
    rating: Optional[float] = None
    checksum: Optional[str] = None
    _parsed_interpolations: Dict[int, "LensProfile"] = field(default_factory=dict, repr=False)

    def init(self):
        """lens_profile.rs:86-91: compute radial distortion limit."""
        if self.fisheye_params.distortion_coeffs and self.distortion_model != "gopro":
            from ..ops.distortion_models import get_model, radial_distortion_limit
            model = get_model(self.distortion_model or "opencv_fisheye")
            self.fisheye_params.radial_distortion_limit = \
                radial_distortion_limit(model, self.get_distortion_coeffs())

    @classmethod
    def from_dict(cls, d: dict) -> "LensProfile":
        p = cls()
        for k, v in d.items():
            if k in ("calib_dimension", "orig_dimension", "output_dimension") and isinstance(v, dict):
                v = Dimensions(int(v.get("w", 0)), int(v.get("h", 0)))
            elif k == "fisheye_params" and isinstance(v, dict):
                v = CameraParams(
                    RMS_error=float(v.get("RMS_error", 0.0)),
                    camera_matrix=v.get("camera_matrix", []),
                    distortion_coeffs=v.get("distortion_coeffs", []),
                    radial_distortion_limit=v.get("radial_distortion_limit"))
            if hasattr(p, k):
                setattr(p, k, v)
        p.init()
        return p

    @classmethod
    def from_json(cls, text: str) -> "LensProfile":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load_from_file(cls, path: str) -> "LensProfile":
        with open(path) as f:
            d = json.loads(f.read())
        p = cls.from_dict(d)
        # database-loaded profiles default to official unless the file says
        # otherwise (the bundled starter set marks itself unofficial)
        if "official" not in d:
            p.official = True
        p.path_to_file = path
        return p

    def to_dict(self) -> dict:
        d = {}
        for k in ("name", "note", "calibrated_by", "camera_brand", "camera_model",
                  "lens_model", "camera_setting", "identifier", "calibrator_version",
                  "date", "official", "asymmetrical", "input_horizontal_stretch",
                  "input_vertical_stretch", "num_images", "fps", "crop",
                  "frame_readout_time", "gyro_lpf", "distortion_model", "digital_lens",
                  "digital_lens_params", "focal_length", "crop_factor", "global_shutter",
                  "sync_settings", "compatible_settings"):
            v = getattr(self, k)
            if v not in (None, "", [], {}):
                d[k] = v
        d["calib_dimension"] = {"w": self.calib_dimension.w, "h": self.calib_dimension.h}
        d["orig_dimension"] = {"w": self.orig_dimension.w, "h": self.orig_dimension.h}
        d["fisheye_params"] = {
            "RMS_error": self.fisheye_params.RMS_error,
            "camera_matrix": self.fisheye_params.camera_matrix,
            "distortion_coeffs": self.fisheye_params.distortion_coeffs,
            "radial_distortion_limit": self.fisheye_params.radial_distortion_limit,
        }
        return d

    # ---- geometry ----------------------------------------------------------

    def get_camera_matrix_internal(self, invert_h: bool) -> Optional[np.ndarray]:
        """lens_profile.rs:268-288."""
        if len(self.fisheye_params.camera_matrix) != 3:
            return None
        mat = np.asarray(self.fisheye_params.camera_matrix, dtype=np.float64).copy()
        if not self.asymmetrical:
            mat[0, 2] = self.calib_dimension.w / 2.0
            mat[1, 2] = self.calib_dimension.h / 2.0
        elif invert_h:
            mat[1, 2] = self.calib_dimension.h - mat[1, 2]
        if self.crop:
            mat[0, 0] /= self.crop
            mat[1, 1] /= self.crop
        return mat

    def get_camera_matrix(self, size, invert_h: bool = False) -> np.ndarray:
        """lens_profile.rs:289-308 (default: f = 0.8*w centered)."""
        mat = self.get_camera_matrix_internal(invert_h)
        if mat is not None:
            return mat
        out = np.eye(3)
        out[0, 0] = size[0] * 0.8
        out[1, 1] = size[0] * 0.8
        out[0, 2] = size[0] / 2.0
        out[1, 2] = size[1] / 2.0
        return out

    def get_distortion_coeffs(self) -> np.ndarray:
        out = np.zeros(12)
        for i, x in enumerate(self.fisheye_params.distortion_coeffs[:12]):
            out[i] = x
        return out

    def get_aspect_ratio(self) -> float:
        if self.calib_dimension.h == 0:
            return 0.0
        return self.calib_dimension.w / self.calib_dimension.h

    def is_valid(self) -> bool:
        return (len(self.fisheye_params.camera_matrix) == 3 and
                self.calib_dimension.w > 0 and self.calib_dimension.h > 0)

    def resolve_interpolations(self, db=None):
        """lens_profile.rs:551-608: parse the `interpolations` JSON map into
        per-position profiles, optionally pulling whole profiles from the db
        by `identifier`, with camera_matrix/distortion_coeffs/focal_length
        overrides per entry."""
        import copy
        if self._parsed_interpolations or not isinstance(self.interpolations, dict):
            return
        parsed = {}
        for k, v in self.interpolations.items():
            if not isinstance(v, dict):
                continue
            try:
                key = int(round(float(k) * 1_000_000.0))
            except (TypeError, ValueError):
                continue
            prof = copy.deepcopy(self)
            ident = v.get("identifier")
            if ident and db is not None:
                from_db = db.find_by_identifier(ident)
                if from_db is not None:
                    prof = copy.deepcopy(from_db)
            prof.interpolations = None
            prof._parsed_interpolations = {}
            cm = v.get("camera_matrix")
            if isinstance(cm, list):
                for i, row in enumerate(cm[:3]):
                    for j, c in enumerate(row[:3]):
                        prof.fisheye_params.camera_matrix[i][j] = float(c)
            dc = v.get("distortion_coeffs")
            if isinstance(dc, list):
                for i, c in enumerate(dc[:len(prof.fisheye_params.distortion_coeffs)]):
                    prof.fisheye_params.distortion_coeffs[i] = float(c)
            if v.get("focal_length") is not None:
                prof.focal_length = float(v["focal_length"])
            parsed[key] = prof
        self._parsed_interpolations = parsed

    def get_interpolated_lens_at(self, val: float) -> "LensProfile":
        """lens_profile.rs:495-549: linear blend between the two enclosing
        per-position profiles (camera matrix f/c entries, distortion coeffs,
        crop, focal length, calib dims, input stretches)."""
        import copy
        if not self._parsed_interpolations:
            return self
        key = int(round(val * 1_000_000.0))
        table = self._parsed_interpolations
        if key in table:
            return table[key]
        keys = sorted(table)
        first, last = keys[0], keys[-1]
        lookup = min(max(key, first + 1), last - 1)
        below = [k for k in keys if k <= lookup]
        if not below:
            return self
        k1 = below[-1]
        if k1 == lookup:
            return table[k1]
        above = [k for k in keys if k >= lookup]
        if not above:
            return self
        k2 = above[0]
        l1, l2 = table[k1], table[k2]
        fract = (key - k1) / float(k2 - k1)
        cpy = copy.deepcopy(self)

        def mix(a, b):
            return a * (1.0 - fract) + b * fract

        m1, m2 = l1.fisheye_params.camera_matrix, l2.fisheye_params.camera_matrix
        mo = cpy.fisheye_params.camera_matrix
        if len(m1) == 3 and len(m2) == 3 and len(mo) == 3:
            for (i, j) in ((0, 0), (1, 1), (0, 2), (1, 2)):
                mo[i][j] = mix(m1[i][j], m2[i][j])
        d1, d2 = l1.fisheye_params.distortion_coeffs, l2.fisheye_params.distortion_coeffs
        if len(cpy.fisheye_params.distortion_coeffs) == len(d1) == len(d2):
            for i in range(len(d1)):
                cpy.fisheye_params.distortion_coeffs[i] = mix(d1[i], d2[i])
        cpy.crop = mix(l1.crop or 1.0, l2.crop or 1.0)
        if l1.focal_length is not None and l2.focal_length is not None:
            cpy.focal_length = mix(l1.focal_length, l2.focal_length)
        cpy.calib_dimension = Dimensions(
            int(round(mix(l1.calib_dimension.w, l2.calib_dimension.w))),
            int(round(mix(l1.calib_dimension.h, l2.calib_dimension.h))))
        cpy.input_horizontal_stretch = mix(l1.input_horizontal_stretch,
                                           l2.input_horizontal_stretch)
        cpy.input_vertical_stretch = mix(l1.input_vertical_stretch,
                                         l2.input_vertical_stretch)
        return cpy

    def set_from_telemetry(self, lens_data: dict):
        """Apply a telemetry-embedded profile (Sony etc.)."""
        self.__dict__.update(LensProfile.from_dict(lens_data).__dict__)
