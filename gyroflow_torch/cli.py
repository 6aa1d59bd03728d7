"""Headless CLI, mirroring the reference's flags (src/cli.rs:36-117).

Usage:
  python -m gyroflow_torch.cli <inputs...> [--device cuda:0|cpu] [options]

Inputs may be videos, .gyroflow project files, lens profile .json files,
preset .json files, and gyro files.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

log = logging.getLogger("gyroflow_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gyroflow-torch",
        description="Video stabilization using gyroscope data (PyTorch / CUDA)")
    p.add_argument("input", nargs="*",
                   help="input files: videos, project files, lens profiles, presets")
    p.add_argument("-f", "--overwrite", action="store_true",
                   help="overwrite if output file exists")
    p.add_argument("-j", "--parallel-renders", type=int, default=1,
                   help="number of parallel renders")
    p.add_argument("-p", "--out-params", type=str, default=None,
                   help="output parameters JSON, eg. '{\"codec\": \"mp4v\"}'")
    p.add_argument("-t", "--suffix", type=str, default="_stabilized",
                   help="output suffix")
    p.add_argument("-s", "--sync-params", type=str, default=None,
                   help="synchronization parameters JSON")
    p.add_argument("--stdout-progress", action="store_true")
    p.add_argument("--export-project", type=int, default=0,
                   help="1 - default project, 2 - with gyro data, 3 - with "
                        "processed data, 4 - video + project file")
    p.add_argument("--export-metadata", type=str, default=None,
                   help="<type>:<path>; 1 full, 2 parsed, 3 camera data")
    p.add_argument("--export-metadata-fields", type=str, default=None)
    p.add_argument("--export-stmap", type=str, default=None,
                   help="<type>:<folder>; 1 single frame, 2 all frames")
    p.add_argument("--preset", type=str, default=None,
                   help="preset file or JSON content")
    p.add_argument("-g", "--gyro-file", type=str, default=None)
    p.add_argument("--watch", type=str, default=None,
                   help="watch folder for automated processing")
    p.add_argument("--autosync", action="store_true", help="run gyro autosync")
    p.add_argument("--trace", action="store_true",
                   help="log per-stage timing (decode/stabilize/encode), fps, each span's "
                        "ms a frame and the host syncs a frame")
    p.add_argument("--device", type=str, default="cuda:0",
                   help="torch device to stabilize on: a CUDA card (cuda:0, the "
                        "default) or cpu; a missing card is an error")
    p.add_argument("--version", action="store_true")
    return p


def _load_inputs(args):
    from .core.manager import StabilizationManager
    from .core.project_file import import_gyroflow_data
    from .render.video_io import probe_video

    mgr = StabilizationManager(device=args.device)
    video = None
    for inp in args.input:
        ext = os.path.splitext(inp)[1].lower()
        if ext == ".gyroflow":
            with open(inp) as f:
                import_gyroflow_data(mgr, f.read(), blocking=False)
            if mgr.input_file and video is None and os.path.exists(mgr.input_file):
                video = mgr.input_file
        elif ext == ".json":
            with open(inp) as f:
                content = f.read()
            obj = json.loads(content)
            if "fisheye_params" in obj or "calib_dimension" in obj:
                mgr.load_lens_profile(content)
            else:
                _apply_preset(mgr, obj)
        elif ext in (".gcsv", ".csv", ".bbl", ".bfl", ".bin", ".log", ".txt"):
            args.gyro_file = inp
        else:
            video = inp
    if video:
        info = probe_video(video)
        mgr.init_from_video_data(info.duration_ms, info.fps, info.frame_count,
                                 (info.width, info.height))
        mgr.input_file = video
    if args.gyro_file:
        from .core.telemetry import TelemetryError
        try:
            mgr.load_gyro_data(args.gyro_file)
        except TelemetryError as e:
            log.error("failed to load gyro data from %s: %s", args.gyro_file, e)
            raise SystemExit(2)
    elif video and not mgr.gyro.has_motion():
        # lib.rs:172-269: telemetry embedded in the video itself (GPMF etc.)
        try:
            mgr.load_gyro_data(video)
            log.info("loaded embedded telemetry: %s", mgr.gyro.file_metadata.detected_source)
        except Exception as e:  # decode is best-effort; plain videos have no telemetry
            log.debug("no embedded telemetry: %s", e)
    return mgr, video


def _apply_preset(mgr, obj: dict):
    """Apply a preset JSON (subset of the project schema)."""
    from .core.project_file import import_gyroflow_data
    base = {"title": "Gyroflow data file", "version": 4}
    base.update(obj)
    import_gyroflow_data(mgr, json.dumps(base), blocking=False)


VIDEO_EXTS = (".mp4", ".mov", ".avi", ".mkv", ".360", ".insv", ".braw",
              ".y4m", ".exr")


def _watch_scan(folder: str, args, processed: set) -> list:
    """One poll of the watch folder (cli.rs --watch): stabilize any video that
    has no output yet. Returns the newly processed paths."""
    done = []
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        base, ext = os.path.splitext(path)
        if ext.lower() not in VIDEO_EXTS or path in processed:
            continue
        if base.endswith(args.suffix):   # skip our own outputs only
            continue
        out = base + args.suffix + ext
        if os.path.exists(out) and not args.overwrite:
            processed.add(path)
            continue
        sub = build_parser().parse_args([path] + _passthrough_flags(args))
        try:
            rc = _run_single(sub)
            if rc == 0:
                done.append(path)
        except Exception as e:
            log.error("watch: failed to process %s: %s", path, e)
        processed.add(path)
    return done


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    # inputs may follow options (clip.y4m -g clip.gcsv lens.json), as the
    # reference's CLI takes them
    args = build_parser().parse_intermixed_args(argv)

    if args.version:
        from . import __version__
        print(f"gyroflow-torch {__version__}")
        return 0
    if args.watch:
        import time as _t
        processed: set = set()
        log.info("watching %s for new videos (Ctrl-C to stop)", args.watch)
        try:
            while True:
                newly = _watch_scan(args.watch, args, processed)
                for pth in newly:
                    log.info("watch: processed %s", pth)
                _t.sleep(2.0)
        except KeyboardInterrupt:
            return 0
    if not args.input:
        build_parser().print_help()
        return 1
    videos = [i for i in args.input
              if os.path.splitext(i)[1].lower() in VIDEO_EXTS]
    if len(videos) > 1:
        # multiple clips -> render queue, -j parallel (cli.rs:268)
        rc = 0
        from concurrent.futures import ThreadPoolExecutor
        non_video = [i for i in args.input if i not in videos]
        def one(v):
            sub_args = build_parser().parse_args(
                [v] + non_video + _passthrough_flags(args))
            return _run_single(sub_args)
        with ThreadPoolExecutor(max_workers=max(args.parallel_renders, 1)) as ex:
            for r in ex.map(one, videos):
                rc = rc or r
        return rc
    return _run_single(args)


def _passthrough_flags(args) -> list:
    out = ["--device", args.device]
    if args.gyro_file:
        out += ["-g", args.gyro_file]
    if args.preset:
        out += ["--preset", args.preset]
    if args.overwrite:
        out += ["-f"]
    if args.out_params:
        out += ["-p", args.out_params]
    if args.suffix:
        out += ["-t", args.suffix]
    if args.autosync:
        out += ["--autosync"]
    if args.sync_params:
        out += ["-s", args.sync_params]
    if args.trace:
        out += ["--trace"]
    return out


def _run_single(args) -> int:

    try:
        mgr, video = _load_inputs(args)
    except OSError as e:
        log.error("%s", e)
        return 2

    if args.preset:
        content = args.preset
        if os.path.exists(content):
            with open(content) as f:
                content = f.read()
        _apply_preset(mgr, json.loads(content) if isinstance(content, str) else content)

    if mgr.gyro.has_motion():
        if args.autosync and video:
            from .sync import autosync
            params = json.loads(args.sync_params) if args.sync_params else {}
            offsets = autosync.run_autosync(mgr, video, **params)
            log.info("autosync offsets: %s", offsets)
        mgr.recompute_blocking()

    def progress(p):
        if args.stdout_progress:
            print(f"progress: {p*100:.1f}%", flush=True)

    if args.export_project:
        # modes match cli.rs:70 / render_queue.rs:1018-1025 — 1 simple,
        # 2 with gyro data, 3 with processed data, 4 = write the project
        # (WithGyroData) AND continue to render the video
        from .core.project_file import GyroflowProjectType, export_gyroflow_data
        typ = {1: GyroflowProjectType.Simple, 2: GyroflowProjectType.WithGyroData,
               3: GyroflowProjectType.WithProcessedData,
               4: GyroflowProjectType.WithGyroData}.get(args.export_project,
                                                        GyroflowProjectType.Simple)
        out = (os.path.splitext(video or "project")[0]) + ".gyroflow"
        if os.path.exists(out) and not args.overwrite:
            log.error("%s exists (use -f)", out)
            return 2
        with open(out, "w") as f:
            f.write(export_gyroflow_data(mgr, typ))
        print(f"exported project: {out}")
        if args.export_project != 4:
            return 0

    if args.export_metadata:
        typ, _, path = args.export_metadata.partition(":")
        from .utils.gyro_export import (export_camera_data, export_full_metadata,
                                        export_parsed_metadata)
        fields = json.loads(args.export_metadata_fields) if args.export_metadata_fields else None
        content = {"1": lambda: export_full_metadata(mgr),
                   "2": lambda: export_parsed_metadata(mgr)}.get(
            typ, lambda: export_camera_data(mgr, fields))()
        with open(path or "camera.json", "w") as f:
            f.write(content)
        print(f"exported metadata: {path}")
        return 0

    if args.export_stmap:
        typ, _, folder = args.export_stmap.partition(":")
        from .utils.stmap import export_stmaps
        export_stmaps(mgr, folder or ".", single_frame=(typ != "2"))
        print(f"exported stmap(s) to {folder}")
        return 0

    if video:
        from .render.renderer import RenderOptions, render
        base, ext = os.path.splitext(video)
        if ext.lower() == ".dng":
            ext = ".png"    # DNG is input-only; stabilized raws export as PNG16
        output = base + args.suffix + (ext if ext else ".mp4")
        if os.path.exists(output) and not args.overwrite:
            log.error("%s exists (use -f)", output)
            return 2
        opts = RenderOptions()
        opts.trace = args.trace
        # render settings embedded in an imported project (reference
        # render_queue.rs:126-145); --out-params still overrides below
        if getattr(mgr, "render_output_settings", None):
            from .render.renderer import apply_output_settings
            apply_output_settings(opts, mgr.render_output_settings)
        if args.out_params:
            # route through the same mapper as project "output" settings so
            # reference value spellings work ("EWA: Robidoux", "H.265/HEVC");
            # a raw setattr would smuggle the STRING into cfg.interpolation
            from .render.renderer import apply_output_settings
            apply_output_settings(opts, json.loads(args.out_params))
        stats = render(mgr, video, output, opts, progress_cb=progress)
        print(f"rendered {stats['frames']} frames -> {output} [{stats['backend']}]")
        if args.trace and "trace" in stats:
            print(f"trace: {stats['trace']}")
        return 0

    log.error("nothing to do (no video input)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
