"""Stable camera identifier for lens-profile autoload.

Port of gyroflow src/core/camera_identifier.rs: brand/model/lens/
resolution/fps assembled into a normalized id string (:213-227) with
per-brand quirks applied by the telemetry parsers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class CameraIdentifier:
    brand: str = ""
    model: str = ""
    lens_model: str = ""
    lens_info: str = ""
    focal_length: Optional[float] = None
    camera_setting: str = ""
    fps: int = 0                    # fps * 1000 rounded
    video_width: int = 0
    video_height: int = 0
    additional: str = ""
    identifier: str = field(default="")

    @classmethod
    def from_metadata(cls, file_metadata, video_width: int, video_height: int,
                      fps: float) -> "CameraIdentifier":
        src = (file_metadata.detected_source or "").strip()
        parts = src.split(" ", 1)
        cid = cls(
            brand=parts[0] if parts else "",
            model=parts[1] if len(parts) > 1 else "",
            video_width=video_width, video_height=video_height,
            fps=int(round(fps * 1000.0)))
        if cid.brand.lower() in ("runcam", "caddx"):
            cid.lens_info = "wide"
        extra = file_metadata.additional_data or {}
        cid.lens_info = extra.get("lens_info", cid.lens_info)
        cid.lens_model = extra.get("lens_model", cid.lens_model)
        if cid.brand and cid.brand in cid.model:
            cid.model = cid.model.replace(cid.brand, "").strip()
        cid.identifier = cid.get_identifier()
        return cid

    def get_identifier(self) -> str:
        """camera_identifier.rs:213-227."""
        if not self.brand or not self.model or not self.lens_info:
            return ""
        fps = 0 if self.brand in ("RED", "RED RAW") else self.fps
        iid = (f"{self.brand}-{self.model}-{self.lens_model}-{self.lens_info}-"
               f"{self.video_width}x{self.video_height}@{fps}-{self.additional}")
        iid = iid.replace(" ", "").replace("--", "-").replace("--", "-")
        return iid.strip("- ").lower()

    def get_identifier_for_autoload(self) -> str:
        """camera_identifier.rs:207-211 (GoPro model aliasing)."""
        return (self.identifier.replace("hero12", "hero11")
                .replace("hero13", "hero11")
                .replace("hero11blackmini", "hero11black"))
