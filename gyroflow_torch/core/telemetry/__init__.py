"""Telemetry ingestion front-end.

The reference delegates to the external `telemetry-parser` crate
(src/core/Cargo.toml:14) for ~40 camera formats. We implement parsers natively,
starting with the documented open formats; MP4-embedded formats (GPMF etc.)
follow. Entry point mirrors GyroSource::parse_telemetry_file
(gyro_source/mod.rs:110).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

from ..file_metadata import FileMetadata
from .gcsv import parse_gcsv


class TelemetryError(Exception):
    pass


def parse_telemetry_file(path: str, options: Optional[dict] = None,
                         size=(0, 0), fps: float = 0.0,
                         progress_cb: Optional[Callable[[float], None]] = None) -> FileMetadata:
    """Dispatch by container; a damaged/mislabeled file of ANY format
    surfaces as TelemetryError, never a parser-internal traceback (telemetry
    decode is best-effort in the reference — lib.rs load path)."""
    try:
        return _parse_telemetry_file(path, options, size, fps, progress_cb)
    except TelemetryError:
        raise
    except Exception as e:  # noqa: BLE001 — struct/index/unicode internals
        raise TelemetryError(
            f"failed to parse {os.path.basename(path)}: {e}")


def _parse_telemetry_file(path, options, size, fps, progress_cb) -> FileMetadata:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gcsv":
        return parse_gcsv(path, progress_cb=progress_cb)
    if ext == ".csv":
        try:
            return parse_gcsv(path, progress_cb=progress_cb)
        except Exception:  # noqa: BLE001
            # vendor CSV dialects (Runcam/Hawkeye/XTU/phone apps/WitMotion
            # text export) share a header-row shape — generic importer
            from .generic_csv import parse_generic_csv
            try:
                return parse_generic_csv(path, options=options,
                                         progress_cb=progress_cb)
            except Exception as e:
                raise TelemetryError(
                    f"{os.path.basename(path)} is neither a gcsv nor a "
                    f"recognized vendor CSV gyro log: {e}")
    if ext in (".bin", ".log"):
        from .ardupilot import parse_ardupilot_bin, parse_ardupilot_log
        try:
            if ext == ".bin":
                return parse_ardupilot_bin(path, progress_cb=progress_cb)
            return parse_ardupilot_log(path, progress_cb=progress_cb)
        except ValueError as e:
            raise TelemetryError(str(e))
    if ext in (".bbl", ".bfl", ".txt"):
        from .blackbox_bin import parse_blackbox_bin
        from .blackbox_csv import parse_blackbox_csv
        try:
            return parse_blackbox_bin(path, progress_cb=progress_cb)
        except ValueError:
            pass
        if ext == ".txt":
            from .witmotion import looks_like_witmotion, parse_witmotion
            if looks_like_witmotion(path):
                return parse_witmotion(path, options=options,
                                       progress_cb=progress_cb)
        try:
            return parse_blackbox_csv(path, progress_cb=progress_cb)
        except Exception:  # noqa: BLE001
            if ext == ".txt":
                from .generic_csv import parse_generic_csv
                try:
                    return parse_generic_csv(path, options=options,
                                             progress_cb=progress_cb)
                except Exception as e:
                    raise TelemetryError(
                        f"{os.path.basename(path)} is not a blackbox, "
                        f"WitMotion, or delimited gyro log: {e}")
            raise TelemetryError(
                f"{os.path.basename(path)} is neither a binary nor a CSV "
                f"blackbox log")
    if ext == ".braw":
        from .blackmagic import parse_braw
        try:
            return parse_braw(path, fps=fps, progress_cb=progress_cb)
        except ValueError as e:
            raise TelemetryError(str(e))
    if ext == ".r3d":
        from .red import parse_r3d
        try:
            return parse_r3d(path, fps=fps, progress_cb=progress_cb)
        except ValueError as e:
            raise TelemetryError(str(e))
    if ext in (".gfpb", ".pb"):
        from .protobuf import parse_gyroflow_proto
        try:
            return parse_gyroflow_proto(path, progress_cb=progress_cb)
        except ValueError as e:
            raise TelemetryError(str(e))
    if ext in (".mp4", ".mov", ".360", ".insv", ".insp"):
        from .blackmagic import has_braw, parse_braw
        from .camm import parse_camm_mp4
        from .gpmf import has_gpmf, parse_gpmf_mp4
        from .insta360 import has_insv_trailer, parse_insv
        from .protobuf import has_gyroflow_proto, parse_gyroflow_proto
        from .sony import has_sony_rtmd, parse_sony_mp4
        if has_gyroflow_proto(path):
            return parse_gyroflow_proto(path, progress_cb=progress_cb)
        if has_insv_trailer(path):
            return parse_insv(path, fps=fps, progress_cb=progress_cb)
        if has_gpmf(path):
            return parse_gpmf_mp4(path, progress_cb=progress_cb)
        if has_sony_rtmd(path):
            return parse_sony_mp4(path, fps=fps, size=size,
                                  progress_cb=progress_cb)
        from .canon_ctmd import has_canon_ctmd, parse_ctmd_mp4
        if has_canon_ctmd(path):
            return parse_ctmd_mp4(path, fps=fps, size=size,
                                  progress_cb=progress_cb)
        from .dji import has_dji_meta, parse_dji_mp4
        if has_dji_meta(path):
            return parse_dji_mp4(path, fps=fps, progress_cb=progress_cb)
        if has_braw(path):
            return parse_braw(path, fps=fps, progress_cb=progress_cb)
        try:
            return parse_camm_mp4(path, progress_cb=progress_cb)
        except TelemetryError:
            raise TelemetryError(
                f"no telemetry track (GPMF/CAMM/RTMD/CTMD/djmd/insv) in "
                f"{os.path.basename(path)}")
    raise TelemetryError(f"Unsupported telemetry format: {ext} "
                         f"(supported: .gcsv, .csv, blackbox, ArduPilot "
                         f".bin/.log, WitMotion .txt, GPMF/CAMM/RTMD "
                         f"MP4, .insv, .braw, .r3d)")
