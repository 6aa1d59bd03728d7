"""Canon camera metadata processing (time offsets + embedded lens profile).

Port of gyroflow src/core/gyro_source/canon.rs: when the camera's
internal distortion correction is off, the OpenCV-standard coefficients from
the Lens tag feed per-timestamp lens params; a pixel-focal-length lens profile
is synthesized; frame time offsets account for exposure, readout and the
gyro sampling phase.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

from ..file_metadata import FileMetadata

log = logging.getLogger(__name__)


def init_lens_profile(md: FileMetadata, tag_map: dict, size: Tuple[int, int],
                      timestamp_ms: float, camera_model: str = "",
                      video_rotation: int = 0):
    lens = tag_map.get("lens", {})
    corrections = lens.get("enabled_corrections")
    if corrections is not None and len(corrections) == 4 and corrections[2] == 0:
        # no internal distortion correction -> use the OpenCV params
        distortion = lens.get("distortion")
        if distortion is not None and len(distortion) == 8:
            ts_us = int(round(timestamp_ms * 1000.0))
            lp = md.lens_params.get(ts_us)
            if lp is not None:
                # canon order: k1 k2 k3 k4 k5 k6 p1 p2 -> opencv
                # k1 k2 p1 p2 k3 k4 k5 k6 (canon.rs:17-28)
                d = distortion
                lp.distortion_coefficients = [d[0], d[1], d[6], d[7],
                                              d[2], d[3], d[4], d[5]]

    if md.lens_profile is None:
        imager = tag_map.get("imager", {})
        pfl = lens.get("pixel_focal_length")
        if imager.get("pixel_width") and imager.get("pixel_height") and \
                pfl is not None and len(pfl) == 2:
            fx, fy = pfl
            is_vertical = abs(video_rotation) in (90, 270)
            fl = lens.get("focal_length")
            focal_length_str = f"{fl:.2f} mm" if fl is not None else None
            name = lens.get("display_name", "")
            if name and focal_length_str:
                lens_model = f"{name} ({focal_length_str})"
            else:
                lens_model = name or (focal_length_str or "")
            md.lens_profile = {
                "calibrated_by": "Canon",
                "camera_brand": "Canon",
                "camera_model": camera_model,
                "lens_model": lens_model,
                "calib_dimension": {"w": size[0], "h": size[1]},
                "orig_dimension": {"w": size[0], "h": size[1]},
                "output_dimension": {"w": size[1] if is_vertical else size[0],
                                     "h": size[0] if is_vertical else size[1]},
                "frame_readout_time": md.frame_readout_time,
                "official": True,
                "asymmetrical": False,
                "note": "",
                "fisheye_params": {
                    "camera_matrix": [[fx, 0.0, size[0] / 2],
                                      [0.0, fy, size[1] / 2],
                                      [0.0, 0.0, 1.0]],
                    "distortion_coeffs": []},
                "distortion_model": "opencv_standard",
                "sync_settings": {"initial_offset": 0,
                                  "initial_offset_inv": False,
                                  "search_size": 0.3, "max_sync_points": 5,
                                  "every_nth_frame": 1,
                                  "time_per_syncpoint": 0.5,
                                  "do_autosync": False},
                "calibrator_version": "---",
            }


def get_time_offset(md: FileMetadata, tag_map: dict, sample_rate: float,
                    fps: float) -> Optional[float]:
    """canon.rs:94-100."""
    imager = tag_map.get("imager", {})
    exposure = imager.get("exposure_time")
    if exposure is None:
        return None
    frame_time = 1000.0 / (md.frame_rate or fps)
    frame_readout_time = md.frame_readout_time if md.frame_readout_time is not None else 14.0
    dt = 1000.0 / max(sample_rate, 1.0)
    return frame_time + frame_readout_time / 2.0 - exposure / 2.0 - dt / 2.0
